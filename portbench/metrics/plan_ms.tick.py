"""plan_ms.tick: the median over the traced ticks of the span from the
encoder's end to the chosen index on the host, in ms."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "plan_ms")
