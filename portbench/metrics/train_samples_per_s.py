"""train_samples_per_s: samples trained over the whole window, per second."""

from portbench import readers


def read(rec):
    return readers.rate(rec)
