"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip (the
decision is taken inside the fixture, never at import).  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances are those of chip_smoke.py: |kernel - plain| <= 1e-5 + 1e-5|p|
for fk_interp and <= 1e-3 + 1e-4|p| for the steps (FMA contraction and
sums over points in another order), rollout positions within 1 mm RMSE.
"""

import numpy as np
import pytest
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.ops import fk_step_cuda, interp_cuda
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.engine import RobotModel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _setup(voxel, dev, B=64, seed=0):
    cfg = PhysicsConfig(robot="tradr", mesh_voxel_size=voxel)
    robot = RobotModel.from_config(cfg, device=dev)
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(scale=0.1, size=(128, 128)).astype(
        np.float32)).to(dev)
    fr = torch.from_numpy(rng.uniform(0.3, 3.9, (128, 128)).astype(
        np.float32)).to(dev)
    st = np.zeros((B, 18), np.float32)
    st[:, 0:2] = rng.uniform(-5.0, 5.0, (B, 2))
    st[:, 3:6] = rng.uniform(-1.0, 1.0, (B, 3))
    st[:, [6, 10, 14]] = 1.0
    st[:, 15:18] = rng.uniform(-1.0, 1.0, (B, 3))
    state = torch.from_numpy(st).to(dev)
    tv = torch.from_numpy(rng.uniform(-1, 1, (B, robot.n_tracks)).astype(
        np.float32)).to(dev)
    return robot, z, fr, state, tv


@pytest.mark.parametrize("fmt,voxel", [("zu", 0.15), ("zu", 0.1),
                                       ("muq", 0.1), ("pairmu", 0.15)])
def test_step_kernel_matches_plain(dev, fmt, voxel):
    robot, z, fr, state, tv = _setup(voxel, dev)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    d_max, res = robot.d_max, robot.grid_res
    if fmt == "zu":
        sxy, patch = fast._extract_windows_zpair(z, wx, wy, d_max, res)
    elif fmt == "muq":
        sxy, patch = fast._extract_windows_zmuq(
            z, fast.quantize_mu_grid(fr), wx, wy, d_max, res)
    else:
        sxy, patch = fast._extract_windows_packed1(z, fr, wx, wy, d_max, res)
    args = (fk_step_cuda.pack_consts(robot), patch, state, tv, sxy,
            fk_step_cuda.pack_points(robot))
    kernel = getattr(fk_step_cuda, f"fk_step_{fmt}")
    kernel.launches = 0
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    want = fk_step_cuda.fk_step_plain(fmt, *args)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_fk_interp_kernel_matches_plain(dev):
    robot, z, fr, state, _ = _setup(0.1, dev)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = fast._extract_windows(z, fr, wx, wy, robot.d_max,
                                       robot.grid_res)
    args = (patch, wx.contiguous(), wy.contiguous(), sxy, c.cst)
    got = interp_cuda.fk_interp(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, interp_cuda.fk_interp_plain(*args),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("voxel,friction,step", [
    (0.15, False, "fk_step_zu"), (0.15, True, "fk_step_pairmu"),
    (0.1, False, "fk_step_zu"), (0.1, True, "fk_step_muq")])
def test_rollout_runs_the_kernels(dev, voxel, friction, step):
    robot, z, fr, _, _ = _setup(voxel, dev, seed=3)
    fr = (fr.clamp(max=1.0) if friction else None)
    ctr = torch.rand((32, 40, 2), generator=torch.Generator(dev).manual_seed(0),
                     device=dev) * 2 - 1
    wrappers = {"fk_interp": interp_cuda.fk_interp,
                "fk_step_zu": fk_step_cuda.fk_step_zu,
                "fk_step_muq": fk_step_cuda.fk_step_muq,
                "fk_step_pairmu": fk_step_cuda.fk_step_pairmu}
    for w in wrappers.values():
        w.launches = 0
    states, stats = fast.planner_rollout(robot, z, ctr, friction=fr)
    torch.cuda.synchronize()
    want = {n: 0 for n in wrappers}
    want[step], want["fk_interp"] = 40, 1
    assert {n: w.launches for n, w in wrappers.items()} == want
    cpu = RobotModel.from_config(PhysicsConfig(robot="tradr",
                                               mesh_voxel_size=voxel),
                                 device="cpu")
    ref, _ = fast.planner_rollout(cpu, z.cpu(), ctr.cpu(),
                                  friction=None if fr is None else fr.cpu())
    rmse = float(((states.x.cpu() - ref.x) ** 2).mean().sqrt())
    assert rmse < 1e-3, rmse
    assert torch.isfinite(stats.spring_std).all()


def test_kernels_refuse_mixed_devices(dev):
    robot, z, fr, state, tv = _setup(0.1, dev)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = fast._extract_windows_zpair(z, wx, wy, robot.d_max,
                                             robot.grid_res)
    with pytest.raises(ValueError):
        fk_step_cuda.fk_step_zu(fk_step_cuda.pack_consts(robot), patch.cpu(),
                                state, tv, sxy, fk_step_cuda.pack_points(robot))
