"""launches_per_step.train: kernels on the card per profiled train step."""

from portbench import readers


def read(rec):
    return readers.launches_per_unit(rec)
