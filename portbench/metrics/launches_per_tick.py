"""launches_per_tick: kernels on the card per profiled tick."""

from portbench import readers


def read(rec):
    return readers.launches_per_unit(rec)
