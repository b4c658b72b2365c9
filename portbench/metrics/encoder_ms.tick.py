"""encoder_ms.tick: the median over the traced ticks of the span around
MonoForce.encode, synchronised at both ends, in ms."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "encoder_ms")
