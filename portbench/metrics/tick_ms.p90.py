"""tick_ms.p90: the 90th percentile (nearest rank) of all ticks of the window,
in ms."""

from portbench import readers


def read(rec):
    return readers.percentile_ms(rec, 0.9)
