"""mfu.shoot: the work counted from shapes over the traced units' mean time,
as a share of the float32 peak, in %."""

from portbench import readers


def read(rec):
    return readers.mfu(rec)
