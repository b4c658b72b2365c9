"""Golden parity of the port: its exact engine and its fast path against
trajectories from the REAL reference PyTorch engine.

``tests/golden/*.npz`` (made by ``scripts/make_golden.py``) hold 13 cases
of the reference engine with this repo's robot point clouds injected, each
B=4 x 500 steps on a 128 x 128 grid: 9 of the semi-implicit
``DPhysics.dynamics()`` (dphysics.py:467-497) and 4 of the reference's
default ``dynamics_odeint`` (dphys_config.py:153; fully explicit euler,
dphysics.py:499-528).  The gates are ``tests/test_golden.py``'s (copied
here, since that file imports JAX): position RMSE 1e-3 m (BASELINE.md
config #1), rotation entries 5e-3, velocities 2e-2, forces at the stride
within 0.05 of the peak spring force.  This file needs no JAX.
"""

import glob
import os

import numpy as np
import pytest
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.engine import (RobotModel, rollout,
                                                rollout_odeint)
from monoforce_tpu_torch.physics.fast import fast_rollout

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ALL_CASES = sorted(os.path.basename(p)[:-4]
                   for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))
CASES = [c for c in ALL_CASES if "odeint" not in c]
ODEINT_CASES = [c for c in ALL_CASES if "odeint" in c]

X_RMSE = 1e-3
R_RMSE = 5e-3
XD_RMSE = 2e-2
F_RTOL = 0.05


def load_case(name, device="cpu"):
    """(npz data, robot model, (B, H, W) grid, controls, joint angles or
    None, friction or None) of a golden case, on ``device``."""
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    # the exact contact cloud the reference ran with (voxel 0.1)
    cfg = PhysicsConfig(robot=str(d["robot"]), robot_points=d["robot_points"])
    model = RobotModel.from_config(cfg, device=device)
    B = d["controls"].shape[0]

    def batch(a):
        return torch.from_numpy(np.broadcast_to(a, (B,) + a.shape).copy()).to(
            device)

    z = batch(d["z_grid"])
    fr = batch(d["friction"]) if d["friction"].size else None
    ja = (torch.from_numpy(d["joint_angles"]).to(device)
          if d["joint_angles"].size else None)
    return d, model, z, torch.from_numpy(d["controls"]).to(device), ja, fr


def rmse(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def case_errors(name, states, forces=None) -> dict:
    """The RMSEs of a rollout against its golden case (forces relative to
    the peak spring force, at the case's stride)."""
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    err = {"x": rmse(states.x, d["Xs"]), "R": rmse(states.R, d["Rs"]),
           "xd": rmse(states.xd, d["Xds"])}
    if forces is not None:
        k = int(d["force_stride"])
        peak = float(np.abs(d["F_spring"]).max()) + 1e-6
        err["F_spring"] = rmse(forces[0][:, ::k], d["F_spring"]) / peak
        err["F_friction"] = rmse(forces[1][:, ::k], d["F_friction"]) / peak
    return err


GATES = {"x": X_RMSE, "R": R_RMSE, "xd": XD_RMSE, "F_spring": F_RTOL,
         "F_friction": F_RTOL}


def passes(err: dict) -> bool:
    return all(v < GATES[k] for k, v in err.items())


@pytest.mark.parametrize("name", CASES)
def test_engine_matches_reference(name):
    d, model, z, ctr, ja, fr = load_case(name)
    states, forces, _ = rollout(model, z, ctr, joint_angles=ja, friction=fr)
    assert states.x.shape == d["Xs"].shape
    err = case_errors(name, states, forces)
    assert passes(err), (name, err)


@pytest.mark.parametrize("name", CASES)
def test_fast_matches_reference(name):
    """The differentiable fast path (``fast_rollout``) holds the same
    trajectory gate, the marv cases with their moving flippers too."""
    d, model, z, ctr, ja, fr = load_case(name)
    states, _ = fast_rollout(model, z, ctr, joint_angles=ja, friction=fr)
    err = case_errors(name, states)
    assert passes(err), (name, err)


@pytest.mark.parametrize("name", ODEINT_CASES)
def test_odeint_matches_reference(name):
    """``rollout_odeint`` against the reference's default integrator, with
    the step of its linspace grid (T / (N - 1)); the force channels are
    time integrals."""
    d, model, z, ctr, ja, fr = load_case(name)
    dt_eff = 5.0 / (ctr.shape[1] - 1)
    states, forces = rollout_odeint(model, z, ctr, joint_angles=ja,
                                    friction=fr, dt=dt_eff)
    err = case_errors(name, states, forces)
    assert passes(err), (name, err)


def test_golden_set_is_whole():
    """13 cases: 9 euler (both robots, the frgrad friction case) and 4
    odeint, each B=4 x 500 steps on a 128 x 128 grid."""
    assert len(CASES) == 9 and len(ODEINT_CASES) == 4
    assert any("marv" in c for c in ODEINT_CASES)
    assert any("frgrad" in c for c in CASES)
    for name in ALL_CASES:
        d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
        assert d["controls"].shape == (4, 500, 2), name
        assert d["z_grid"].shape == (128, 128), name
