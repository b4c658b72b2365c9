"""idle_share.train: the share of the profiled span in which nothing ran on
the card, in %."""

from portbench import readers


def read(rec):
    return readers.idle_share(rec)
