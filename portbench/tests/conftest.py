"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests -q`` from the repository's root; the card tests run
where a CUDA device is: ``-m cuda``)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the cells at sizes a CPU test holds: a small image, a short depth range
# and horizon, few trajectories, a batch of two
TINY_CONFIG = {"final_dim": [32, 64], "dbound": [0.6, 3.0, 0.2],
               "n_sim_trajs": 16, "traj_sim_time": 0.3}
TINY_TRAFFIC = {"tick": {"frames": 2, "warmup": 1},
                "shoot": {"batch": 16, "steps": 20, "warmup": 1},
                "train": {"batch": 2, "pool": 3, "gt_poses": 5}}


@pytest.fixture
def tiny():
    """``tiny(cell)``: (manifest, the cell's spec at a CPU size with its
    own limits)."""
    from portbench import harness

    def make(cell):
        manifest = harness.load_manifest()
        spec = copy.deepcopy(harness.cell_spec(manifest, cell))
        spec["config"].update(TINY_CONFIG)
        spec["traffic"].update(TINY_TRAFFIC[spec["traffic"]["driver"]])
        # the train cell's checked step is the window's first, which a
        # window of any length holds
        train = spec["traffic"]["driver"] == "train"
        spec["limits"].update(profile_units=1, check_units=2,
                              check_within=1 if train else 3)
        return manifest, spec
    return make


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's card tests)")
    return torch.device("cuda", 0)


def run_cell(manifest, spec, cell, seconds=1.0, system="program",
             device="cpu", trace_on=False, seed=2 ** 31 + 11):
    import time
    from portbench import harness
    torch.manual_seed(0)
    return harness.run(cell, seed, seconds, trace_on, time.perf_counter(),
                       device=device, manifest=manifest, spec=spec,
                       system=system)
