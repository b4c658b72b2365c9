"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip (the
decision is taken inside the fixture, never at import).  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances are those of chip_smoke.py: |kernel - plain| <= 1e-5 + 1e-5|p|
for fk_interp, <= 1e-4 + 1e-5|p| for its backward (its cell sums add in
another order than autograd's) and <= 1e-3 + 1e-4|p| for the steps (FMA
contraction and sums over points in another order), rollout positions
within 1 mm RMSE, fit losses within rtol 1e-3.
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


def _windows(fmt, z, fr, wx, wy, d_max, res):
    if fmt == "zu":
        return fast._extract_windows_zpair(z, wx, wy, d_max, res)
    if fmt == "muq":
        return fast._extract_windows_zmuq(z, fast.quantize_mu_grid(fr), wx,
                                          wy, d_max, res)
    if fmt == "exact":
        return fast._extract_windows(z, fr, wx, wy, d_max, res)
    return fast._extract_windows_packed1(z, fr, wx, wy, d_max, res)


def _step_args(fmt, robot, z, fr, state, tv):
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = _windows(fmt, z, fr, wx, wy, robot.d_max, robot.grid_res)
    return (fk_step_cuda.pack_consts(robot), patch, state, tv, sxy,
            fk_step_cuda.pack_points(robot))


# the robots' clouds at these P; the other P get synthetic point planes
# with this many driving parts
_CLOUDS = {62: ("tradr", 0.15), 148: ("tradr", 0.1), 202: ("husky", 0.1)}
_SYNTHETIC_PARTS = {1: 1, 31: 4, 33: 3, 256: 2}


def _rotations(rng, B):
    """(B, 9) row-major rotations: yaw in [-pi, pi], roll and pitch in
    [-0.3, 0.3]."""
    yaw, pitch, roll = (rng.uniform(-a, a, B) for a in (np.pi, 0.3, 0.3))
    cy, sy, cp, sp, cr, sr = (f(t) for t in (yaw, pitch, roll)
                              for f in (np.cos, np.sin))
    R = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                  sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                  -sp, cp * sr, cp * cr], axis=1)
    return R.astype(np.float32)


def _geometry_args(fmt, P, B, dev, seed=0):
    """Step inputs at any P (1-256) and B: a robot's cloud where one has P
    points, else synthetic point planes with cst[10] (n_real) set to P;
    tilted, yawed, moving bodies at the terrain's height on rough terrain."""
    rng = np.random.default_rng(seed)
    robot_name, voxel = _CLOUDS.get(P, ("tradr", 0.1))
    robot = RobotModel.from_config(
        PhysicsConfig(robot=robot_name, mesh_voxel_size=voxel), device=dev)
    cst = fk_step_cuda.pack_consts(robot)
    if P in _CLOUDS:
        pts, n_k = fk_step_cuda.pack_points(robot), robot.n_tracks
    else:
        n_k = _SYNTHETIC_PARTS[P]
        p = np.zeros((7, P), np.float32)
        p[0] = rng.uniform(-0.6, 0.6, P)
        p[1] = rng.uniform(-0.4, 0.4, P)
        p[2] = rng.uniform(-0.25, 0.05, P)
        p[3:3 + n_k] = rng.integers(0, 2, (n_k, P))
        pts = torch.from_numpy(p).to(dev)
        cst[10] = float(P)
    z = rng.normal(scale=0.1, size=(128, 128)).astype(np.float32)
    fr = torch.from_numpy(rng.uniform(0.3, 3.9, (128, 128)).astype(
        np.float32)).to(dev)
    st = np.zeros((B, 18), np.float32)
    st[:, 0:2] = rng.uniform(-5.0, 5.0, (B, 2))
    ij = ((st[:, 0:2] + float(robot.d_max)) / float(robot.grid_res)).astype(
        int)
    st[:, 2] = z[ij[:, 0], ij[:, 1]] + rng.uniform(-0.05, 0.1, B)
    st[:, 3:6] = rng.uniform(-1.0, 1.0, (B, 3))
    st[:, 6:15] = _rotations(rng, B)
    st[:, 15:18] = rng.uniform(-1.0, 1.0, (B, 3))
    state = torch.from_numpy(st).to(dev)
    tv = torch.from_numpy(rng.uniform(-1, 1, (B, n_k)).astype(
        np.float32)).to(dev)
    wx, wy = fast._world_planes(state.unbind(1), pts[0:1], pts[1:2],
                                pts[2:3])
    sxy, patch = _windows(fmt, torch.from_numpy(z).to(dev), fr, wx, wy,
                          robot.d_max, robot.grid_res)
    return cst, patch, state, tv, sxy, pts


@pytest.mark.parametrize("B", [1, 3, 64, 4096])
@pytest.mark.parametrize("P", [1, 31, 33, 62, 148, 202, 256])
@pytest.mark.parametrize("fmt", list(fk_step_cuda.FORMATS))
def test_step_kernel_matches_plain(dev, fmt, P, B):
    """Every format at every launch geometry: one block of
    32 * ceil(P / 32) threads a trajectory, the last warp ragged."""
    args = _geometry_args(fmt, P, B, dev)
    kernel = KERNEL[fmt]
    kernel.launches = 0
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    want = fk_step_cuda.fk_step_plain(fmt, *args)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("P", [33, 148, 256])
def test_muq_and_pair3_contact_counts_agree(dev, P):
    """The same z in both formats' windows gives bit-equal contact counts:
    the same taps, the same pinned bilinear sum and the same reduction
    tree (the JAX muq oracle holds the counts to rtol 1e-6)."""
    counts = [KERNEL[fmt](*_geometry_args(fmt, P, 4096, dev))[:, 7]
              for fmt in ("muq", "pair3")]
    assert bool((counts[0] > 0).any())
    assert torch.equal(counts[0], counts[1])


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


def _interp_args(P, B, dev, seed=0, kind="mixed"):
    """fk_interp's inputs at any P and B: rough [z | mu] windows at random
    corners of a 12.8 m grid (d_max 6.4, res 0.1) and queries given in
    cells.  kind "mixed": continuous queries over the window and one cell
    around it (so the index clamps at 0 and 14), the first quarter exactly
    on cell boundaries; "one_cell": every point of a trajectory in one
    cell; "outside": every query beyond the window, both sides (the index
    clamped to 0 and 14); "negative": corners at the grid's edge and
    queries at negative cell coordinates (truncation toward zero)."""
    rng = np.random.default_rng(seed)
    d_max, res = np.float32(6.4), np.float32(0.1)
    patch = np.concatenate([rng.normal(scale=0.2, size=(B, 256)),
                            rng.uniform(0.2, 1.5, (B, 256))], axis=1)
    sxy = rng.integers(0, 112, (B, 2)).astype(np.float32)
    if kind == "mixed":
        cells = sxy[:, None, :] + rng.uniform(-1.0, 17.0, (B, P, 2))
        cells[:, :P // 4] = np.floor(cells[:, :P // 4])
    elif kind == "one_cell":
        cells = (sxy[:, None, :] + rng.integers(0, 15, (B, 1, 2))
                 + rng.uniform(0.0, 1.0, (B, P, 2)))
    elif kind == "outside":
        side = rng.integers(0, 2, (B, P, 2))
        cells = sxy[:, None, :] + np.where(side, rng.uniform(16.5, 40.0,
                                                             (B, P, 2)),
                                           rng.uniform(-30.0, -0.5,
                                                       (B, P, 2)))
    else:
        sxy[:] = 0.0
        cells = rng.uniform(-3.0, 4.0, (B, P, 2))
    q = (cells * res - d_max).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    return (to(patch), to(q[..., 0]), to(q[..., 1]), to(sxy),
            to(np.array([d_max, res])))


INTERP_P = [1, 31, 33, 62, 97, 148, 202, 256, 300]
INTERP_B = [1, 3, 16, 61, 4096]
# the new design's edges: one cell (the cell sums' worst case), clamped and
# negative indices, and a block of eight 32-point slots with a ragged last
# block (B=61: seven blocks of eight and one of five)
INTERP_EDGES = [("one_cell", 97, 16), ("one_cell", 256, 61),
                ("one_cell", 300, 3), ("outside", 148, 61),
                ("negative", 62, 61), ("negative", 202, 16),
                ("mixed", 20, 61), ("mixed", 5, 7)]


def _check_fk_interp(dev, P, B, kind="mixed"):
    args = _interp_args(P, B, dev, kind=kind)
    interp_cuda.fk_interp.launches = 0
    got = interp_cuda.fk_interp(*args)
    torch.cuda.synchronize()
    assert interp_cuda.fk_interp.launches == 1
    assert got.shape == (B, 5 * P)
    torch.testing.assert_close(got, interp_cuda.fk_interp_plain(*args),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B", INTERP_B)
@pytest.mark.parametrize("P", INTERP_P)
def test_fk_interp_kernel_matches_plain(dev, P, B):
    _check_fk_interp(dev, P, B)


@pytest.mark.parametrize("kind,P,B", INTERP_EDGES)
def test_fk_interp_kernel_edges(dev, kind, P, B):
    _check_fk_interp(dev, P, B, kind)


def _check_fk_interp_bwd(dev, P, B, kind="mixed"):
    args = _interp_args(P, B, dev, kind=kind)
    g = torch.randn((B, 5 * P), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    interp_cuda.fk_interp_bwd.launches = 0
    got = interp_cuda.fk_interp_bwd(*args, g)
    torch.cuda.synchronize()
    assert interp_cuda.fk_interp_bwd.launches == 1
    for a, b in zip(got, interp_cuda.fk_interp_bwd_plain(*args, g)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    # the cell sums run in an order fixed by the inputs: the same d patch
    # from run to run
    again = interp_cuda.fk_interp_bwd(*args, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # autograd through fk_interp on the card runs the backward kernel
    leaves = [t.clone().requires_grad_() for t in args[:3]]
    via = torch.autograd.grad(interp_cuda.fk_interp(*leaves, *args[3:]),
                              leaves, g)
    assert interp_cuda.fk_interp_bwd.launches == 3
    for a, b in zip(via, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", INTERP_B)
@pytest.mark.parametrize("P", INTERP_P)
def test_fk_interp_bwd_kernel_matches_plain(dev, P, B):
    _check_fk_interp_bwd(dev, P, B)


@pytest.mark.parametrize("kind,P,B", INTERP_EDGES)
def test_fk_interp_bwd_kernel_edges(dev, kind, P, B):
    _check_fk_interp_bwd(dev, P, B, kind)


def test_fk_interp_kernels_on_a_robot_cloud(dev):
    """Both lookup kernels on windows cut by the settle step's extractor
    from rough terrain, at tradr's 0.1 m cloud (P=148)."""
    robot, z, fr, state, _ = _setup(0.1, dev, B=61)
    c = fast._make_consts(robot)
    wx, wy = fast._world_xy(c, state)
    sxy, patch = fast._extract_windows(z, fr, wx, wy, robot.d_max,
                                       robot.grid_res)
    args = (patch, wx.contiguous(), wy.contiguous(), sxy, c.cst)
    torch.testing.assert_close(interp_cuda.fk_interp(*args),
                               interp_cuda.fk_interp_plain(*args),
                               atol=1e-5, rtol=1e-5)
    g = torch.randn((61, 5 * wx.shape[1]), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    for a, b in zip(interp_cuda.fk_interp_bwd(*args, g),
                    interp_cuda.fk_interp_bwd_plain(*args, g)):
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


# ------------------------------------------------------ the online tick


def _tick_setup(dev, half=False, n_cams=2):
    """A MonoForce at a small size (32 x 64 images, the 128 x 128 grid,
    tradr's planner preset over 0.4 s, 16 trajectories: mode pair) on
    ``dev``, seeded weights perturbed by 0.05 noise, a rig of level
    cameras yawed off the axes, seeded images."""
    from monoforce_tpu_torch.config import LSSConfig
    from monoforce_tpu_torch.pipeline import MonoForce

    lss = LSSConfig(data_aug_conf={"final_dim": (32, 64)},
                    grid_conf={"xbound": (-6.4, 6.4, 0.1),
                               "ybound": (-6.4, 6.4, 0.1),
                               "zbound": (-3.2, 3.2, 6.4),
                               "dbound": (0.6, 3.0, 0.2)})
    cfg = PhysicsConfig.for_planner("tradr", traj_sim_time=0.4)
    cfg.n_sim_trajs = 16
    mf = MonoForce(cfg, lss, half=half, device=dev)
    mf.init_params(1)
    gen = torch.Generator().manual_seed(3)
    mf.load_state_dict({k: v.cpu() + 0.05 * torch.randn(v.shape, generator=gen)
                        if v.is_floating_point() else v.cpu()
                        for k, v in mf.model.state_dict().items()})
    rng = np.random.default_rng(0)
    to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    rots = []
    for k in range(n_cams):
        a = 0.3 + 2 * np.pi * k / n_cams
        rots.append(np.array([[np.cos(a), -np.sin(a), 0],
                              [np.sin(a), np.cos(a), 0], [0, 0, 1]]) @ to_ego)
    K = np.array([[41.3, 0, 32], [0, 41.3, 16], [0, 0, 1]])
    calib = [np.stack(rots), np.tile([0, 0, 0.53], (n_cams, 1)),
             np.tile(K, (n_cams, 1, 1)), np.tile(np.eye(3), (n_cams, 1, 1)),
             np.zeros((n_cams, 3))]
    imgs = rng.normal(size=(1, n_cams, 3, 32, 64))
    return mf, [torch.tensor(a, dtype=torch.float32, device=dev)
                for a in [imgs] + [c[None] for c in calib]]


@pytest.mark.parametrize("half", [False, True], ids=["f32", "half"])
def test_encoder_on_the_card_matches_cpu(dev, half):
    """The encoder's float32 forward on the card (TF32 off inside it)
    against the CPU within 2e-4 per head (chip_smoke.py's tolerance); the
    half mode's within RMSE 0.005 of the CPU's half mode."""
    mf, inputs = _tick_setup(dev, half)
    cpu, cpu_inputs = _tick_setup(torch.device("cpu"), half)
    got = mf.encode(*inputs)
    want = cpu.encode(*cpu_inputs)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        if half:
            assert float(((got[k].cpu() - v) ** 2).mean().sqrt()) < 0.005, k
        else:
            assert float((got[k].cpu() - v).abs().max()) <= 2e-4, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_voxel_pool_on_the_card_matches_cpu(dev, dtype):
    """index_add_ on the card adds with atomics, in another order than the
    CPU: float32 sums within 1e-5; bf16 sums, rounded to bf16 after every
    add, within 2^-6 of the sum of their terms' magnitudes (a point in
    the wrong cell would be off by its whole feature)."""
    from monoforce_tpu_torch.models.terrain_encoder.geometry import gen_dx_bx
    from monoforce_tpu_torch.ops.voxel_pool import voxel_pool

    rng = np.random.default_rng(8)
    dx, bx, nx = gen_dx_bx((-1.0, 1.0, 0.25), (-1.5, 1.5, 0.25), (-1.0, 1.0, 1.0))
    geom = rng.uniform([-1.2, -1.8, -1.2], [1.2, 1.8, 1.2],
                       (2, 2, 3, 4, 5, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 2, 3, 4, 5, 16)).astype(np.float32)
    args = [torch.from_numpy(geom), torch.from_numpy(feats).to(dtype),
            torch.from_numpy(dx), torch.from_numpy(bx)]
    want = voxel_pool(*args, nx).float()
    got = voxel_pool(*[a.to(dev) for a in args], nx).float().cpu()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        mags = voxel_pool(args[0], args[1].float().abs(), *args[2:], nx)
        assert bool(((got - want).abs() <= 2 ** -6 * mags).all())


def test_monoforce_run_launches_the_kernels(dev):
    """One tick on the card launches fk_step_pairmu once per step and
    fk_interp once (mode pair: the friction head is the friction grid),
    and plans as the CPU does on the card's terrain (positions within
    1 mm RMSE)."""
    from monoforce_tpu_torch.physics.controls import shooting_controls
    from monoforce_tpu_torch.planner.shooting import _plan

    mf, inputs = _tick_setup(dev)
    for w in WRAPPERS.values():
        w.launches = 0
    terrain, plan = mf.run(*inputs,
                           generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    want = {n: 0 for n in WRAPPERS}
    want["fk_step_pairmu"], want["fk_interp"] = 40, 1
    assert {n: w.launches for n, w in WRAPPERS.items()} == want
    assert torch.isfinite(plan.costs).all() and 0 <= int(plan.best) < 16
    cpu = RobotModel.from_config(mf.dphys_cfg, device="cpu")
    cfg = mf.dphys_cfg
    controls, _ = shooting_controls(torch.Generator(dev).manual_seed(0), 16,
                                    cfg.vel_max, cfg.omega_max,
                                    cfg.traj_sim_time, cfg.dt)
    ref = _plan(cpu, terrain["terrain"][0, 0].cpu(),
                terrain["friction"][0, 0].cpu(), controls.cpu(), None, mf.cost)
    rmse = float(((plan.xs.cpu() - ref.xs) ** 2).mean().sqrt())
    assert rmse < 1e-3, rmse


# ------------------------------------------ the exact engine and training


@pytest.mark.parametrize("name", ["marv_flat", "marv_hill", "marv_hill_odeint",
                                  "marv_sine", "marv_step", "tradr_flat",
                                  "tradr_flat_odeint", "tradr_hill",
                                  "tradr_hill_frgrad", "tradr_hill_odeint",
                                  "tradr_sine", "tradr_sine_odeint",
                                  "tradr_step"])
def test_golden_on_the_card(dev, name):
    """The reference engine's 13 golden cases through the port's exact
    engine on the card (and the 9 euler ones through fast_rollout) at
    tests/test_golden.py's gates."""
    from monoforce_tpu_torch.physics.engine import rollout, rollout_odeint
    from test_torch_golden import case_errors, load_case, passes

    d, model, z, ctr, ja, fr = load_case(name, dev)
    if "odeint" in name:
        states, forces = rollout_odeint(model, z, ctr, joint_angles=ja,
                                        friction=fr, dt=5.0 / (ctr.shape[1] - 1))
    else:
        states, forces, _ = rollout(model, z, ctr, joint_angles=ja,
                                    friction=fr)
        fast_states, _ = fast.fast_rollout(model, z, ctr, joint_angles=ja,
                                           friction=fr)
        err = case_errors(name, fast_states)
        assert passes(err), ("fast_rollout", err)
    assert states.x.device.type == "cuda"
    err = case_errors(name, states, forces)
    assert passes(err), err


def test_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """chip_smoke.py's comparison of the train step (no drop-connect, TF32
    off over forward and backward) at a small size: two 32 x 64 cameras,
    the 128 x 128 grid, tradr at 0.4 m, B=2 x 100 steps of bench_all.py's
    batch, with chip_smoke.py's tolerances: the losses within 1e-4
    relative (the physics on the card's maps on both devices), the
    gradients, Adam's first step, the BN statistics and the evaluator's
    metrics as its constants state."""
    import chip_smoke
    from monoforce_tpu_torch.config import LSSConfig

    lss = LSSConfig(data_aug_conf={"final_dim": (32, 64)},
                    grid_conf={"xbound": (-6.4, 6.4, 0.1),
                               "ybound": (-6.4, 6.4, 0.1),
                               "zbound": (-3.2, 3.2, 6.4),
                               "dbound": (0.6, 3.0, 0.2)})
    dphys = PhysicsConfig(robot="tradr", grid_res=0.4)
    ok, text = chip_smoke.compare_train_step(
        dev, lss, dphys, chip_smoke.bench_all_batch(2, lss, dphys, "cpu"),
        str(tmp_path))
    assert ok, text


def test_new_entry_points_run_on_the_card(dev, tmp_path):
    """DPhysics, the Trainer and fit_terrain's exact branch run on cuda
    when no device is named."""
    from monoforce_tpu_torch.physics import DPhysics
    from monoforce_tpu_torch.training import Trainer, fit_terrain

    cfg = PhysicsConfig(robot="marv", grid_res=0.4, traj_sim_time=0.1)
    assert DPhysics(cfg).robot.device.type == "cuda"
    assert Trainer(cfg, log_dir=str(tmp_path)).device.type == "cuda"
    ctr = np.random.default_rng(0).uniform(-1, 1, (2, 10, 2))
    ts = np.tile(np.arange(10) * 0.01, (2, 1))
    params, losses = fit_terrain(cfg, ctr, [np.zeros((2, 10, 3))], ts, ts,
                                 n_iters=2)
    assert params.z_grid.device.type == "cuda" and np.isfinite(losses).all()
