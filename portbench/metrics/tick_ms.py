"""tick_ms: the whole window over the ticks completed, in ms."""

from portbench import readers


def read(rec):
    return readers.mean_unit_ms(rec)
