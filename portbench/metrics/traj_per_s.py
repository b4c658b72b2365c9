"""traj_per_s: trajectories completed over the whole window, per second."""

from portbench import readers


def read(rec):
    return readers.rate(rec)
