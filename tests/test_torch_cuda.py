"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip (the
decision is taken inside the fixture, never at import).  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances are those of chip_smoke.py: |kernel - plain| <= 1e-5 + 1e-5|p|
for fk_interp, <= 1e-4 + 1e-5|p| for its backward (shared-memory atomics
add in another order) and <= 1e-3 + 1e-4|p| for the steps (FMA contraction
and sums over points in another order), rollout positions within 1 mm
RMSE, fit losses within rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.ops import fk_step_cuda, interp_cuda
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.engine import RobotModel
from monoforce_tpu_torch.training import (TerrainParams, make_optimizer,
                                          terrain_fit_step)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _setup(voxel, dev, B=64, seed=0, robot="tradr"):
    cfg = PhysicsConfig(robot=robot, mesh_voxel_size=voxel)
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


KERNEL = {"zu": fk_step_cuda.fk_step_zu, "muq": fk_step_cuda.fk_step_muq,
          "pairmu": fk_step_cuda.fk_step_pairmu,
          "pair3": fk_step_cuda.fk_step_pair3,
          "packed": fk_step_cuda.fk_step_packed, "exact": fk_step_cuda.fk_step}


def _step_args(fmt, robot, z, fr, state, tv):
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    d_max, res = robot.d_max, robot.grid_res
    if fmt == "zu":
        sxy, patch = fast._extract_windows_zpair(z, wx, wy, d_max, res)
    elif fmt == "muq":
        sxy, patch = fast._extract_windows_zmuq(
            z, fast.quantize_mu_grid(fr), wx, wy, d_max, res)
    elif fmt == "exact":
        sxy, patch = fast._extract_windows(z, fr, wx, wy, d_max, res)
    else:
        sxy, patch = fast._extract_windows_packed1(z, fr, wx, wy, d_max, res)
    return (fk_step_cuda.pack_consts(robot), patch, state, tv, sxy,
            fk_step_cuda.pack_points(robot))


@pytest.mark.parametrize("fmt,voxel,robot,B", [
    ("zu", 0.15, "tradr", 64), ("zu", 0.1, "tradr", 64),
    ("muq", 0.1, "tradr", 64), ("pairmu", 0.15, "tradr", 64),
    ("pair3", 0.1, "tradr", 64), ("exact", 0.1, "tradr", 62),
    ("packed", 0.1, "tradr", 50), ("packed", 0.1, "husky", 61)])
def test_step_kernel_matches_plain(dev, fmt, voxel, robot, B):
    args = _step_args(fmt, *_setup(voxel, dev, B=B, robot=robot))
    kernel = KERNEL[fmt]
    kernel.launches = 0
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    want = fk_step_cuda.fk_step_plain(fmt, *args)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_exact_step_gradient_matches_plain(dev):
    """fk_step's backward on the card: autograd through the plain version
    (the forward is the kernel), so the same as the CPU's to rounding."""
    args = _step_args("exact", *_setup(0.1, dev, B=16))
    g = torch.randn((16, 8), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    grads = []
    for a in (args, tuple(t.cpu() for t in args)):
        leaves = [t.clone().requires_grad_() for t in a[1:4]]
        out = fk_step_cuda.fk_step(a[0], *leaves, a[4], a[5])
        grads.append(torch.autograd.grad(out, leaves, g.to(out.device)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-4)


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


def test_fk_interp_bwd_kernel_matches_plain(dev):
    robot, z, fr, state, _ = _setup(0.1, dev, B=61)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = fast._extract_windows(z, fr, wx, wy, robot.d_max,
                                       robot.grid_res)
    args = (patch, wx.contiguous(), wy.contiguous(), sxy, c.cst)
    g = torch.randn((61, 5 * wx.shape[1]), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    interp_cuda.fk_interp_bwd.launches = 0
    got = interp_cuda.fk_interp_bwd(*args, g)
    torch.cuda.synchronize()
    assert interp_cuda.fk_interp_bwd.launches == 1
    for a, b in zip(got, interp_cuda.fk_interp_bwd_plain(*args, g)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    # autograd through fk_interp on the card runs the backward kernel
    leaves = [t.clone().requires_grad_() for t in args[:3]]
    via = torch.autograd.grad(interp_cuda.fk_interp(*leaves, sxy, c.cst),
                              leaves, g)
    assert interp_cuda.fk_interp_bwd.launches == 2
    for a, b in zip(via, got):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


WRAPPERS = {"fk_interp": interp_cuda.fk_interp,
            "fk_interp_bwd": interp_cuda.fk_interp_bwd,
            "fk_step_zu": fk_step_cuda.fk_step_zu,
            "fk_step_muq": fk_step_cuda.fk_step_muq,
            "fk_step_pairmu": fk_step_cuda.fk_step_pairmu,
            "fk_step_packed": fk_step_cuda.fk_step_packed}


@pytest.mark.parametrize("voxel,robot,B,friction,step", [
    (0.15, "tradr", 32, False, "fk_step_zu"),
    (0.15, "tradr", 32, True, "fk_step_pairmu"),
    (0.1, "tradr", 32, False, "fk_step_zu"),
    (0.1, "tradr", 32, True, "fk_step_muq"),
    (0.1, "tradr", 30, True, "fk_step_packed"),
    (0.1, "husky", 32, False, "fk_step_packed"),
    (None, "tradr", 32, True, "fallback")])
def test_rollout_runs_the_kernels(dev, voxel, robot, B, friction, step):
    """Each mode's launches: its step kernel once per step and fk_interp
    once; the fallback (rk4) fk_interp once per step and once more."""
    cfg = (PhysicsConfig(robot=robot, integration_mode="rk4") if voxel is None
           else PhysicsConfig(robot=robot, mesh_voxel_size=voxel))
    _, z, fr, _, _ = _setup(0.1, dev, seed=3)
    robot_m = RobotModel.from_config(cfg, device=dev)
    fr = (fr.clamp(max=1.0) if friction else None)
    ctr = torch.rand((B, 40, 2), generator=torch.Generator(dev).manual_seed(0),
                     device=dev) * 2 - 1
    for w in WRAPPERS.values():
        w.launches = 0
    states, stats = fast.planner_rollout(robot_m, z, ctr, friction=fr)
    torch.cuda.synchronize()
    want = {n: 0 for n in WRAPPERS}
    if step == "fallback":
        want["fk_interp"] = 41
    else:
        want[step], want["fk_interp"] = 40, 1
    assert {n: w.launches for n, w in WRAPPERS.items()} == want
    cpu = RobotModel.from_config(cfg, device="cpu")
    ref, _ = fast.planner_rollout(cpu, z.cpu(), ctr.cpu(),
                                  friction=None if fr is None else fr.cpu())
    rmse = float(((states.x.cpu() - ref.x) ** 2).mean().sqrt())
    assert rmse < 1e-3, rmse
    assert torch.isfinite(stats.spring_std).all()


def test_fit_steps_run_the_kernels(dev):
    """Three terrain_fit_steps on the card (tradr, B=4, N=12): fk_interp
    N+1 times forward and N+1 times backward per step, and the losses of
    the same steps on the CPU's plain versions within rtol 1e-3."""
    cfg = PhysicsConfig(robot="tradr", grid_res=0.4)
    gen = torch.Generator().manual_seed(4)
    ctr = torch.rand((4, 12, 2), generator=gen) * 2 - 1
    gt = torch.rand((4, 12, 3), generator=gen) * 0.1
    ts = (torch.arange(12.0) * 0.01).expand(4, 12).contiguous()
    losses = {}
    for d in (dev, torch.device("cpu")):
        robot = RobotModel.from_config(cfg, device=d)
        tp = TerrainParams(torch.zeros(cfg.grid_shape, device=d,
                                       requires_grad=True),
                           torch.full(cfg.grid_shape, 0.5, device=d,
                                      requires_grad=True))
        opt = make_optimizer()(tp)
        got = []
        for _ in range(3):
            interp_cuda.fk_interp.launches = 0
            interp_cuda.fk_interp_bwd.launches = 0
            tp, opt, loss = terrain_fit_step(tp, opt, robot, ctr.to(d),
                                             [gt.to(d)], ts.to(d), ts.to(d),
                                             None)
            got.append(float(loss))
            if d.type == "cuda":
                assert interp_cuda.fk_interp.launches == 13
                assert interp_cuda.fk_interp_bwd.launches == 13
        losses[d.type] = got
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


def test_kernels_refuse_mixed_devices(dev):
    robot, z, fr, state, tv = _setup(0.1, dev)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = fast._extract_windows_zpair(z, wx, wy, robot.d_max,
                                             robot.grid_res)
    with pytest.raises(ValueError):
        fk_step_cuda.fk_step_zu(fk_step_cuda.pack_consts(robot), patch.cpu(),
                                state, tv, sxy, fk_step_cuda.pack_points(robot))
