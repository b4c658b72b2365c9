"""Work counted from shapes: the chip's published peaks, the encoder's
convolution operations, and the physics' operations and bytes per point.
They count the work the algorithm needs, whatever implements it."""
