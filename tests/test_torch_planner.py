"""The port's planner rollout and Planner against the JAX package.

Inputs are made with numpy from a seed.  The JAX functions run on the CPU
with jit disabled: the same code op by op, which costs seconds here where
compiling the 32-step blocks costs ~25 s per mode.  B=32 and N=40 cross one
window refresh and a 8-step remainder block (the fallback mode's
fast_rollout refreshes every 8 steps).  Bounds: position RMSE
< 1e-4 m and spring_std within rtol 1e-4 (float32 sums in another order,
amplified over 40 steps); the costs within rtol 1e-4 and the same best path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics.controls import time_stamps as jax_time_stamps
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu.physics.fast import planner_kernel_mode as jax_mode
from monoforce_tpu.physics.fast import planner_rollout as jax_rollout
from monoforce_tpu.planner.shooting import Planner as JaxPlanner
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.ops.fk_step_cuda import (fk_step_plain, pack_consts,
                                                 pack_points)
from monoforce_tpu_torch.ops.interp_cuda import fk_interp
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.controls import time_stamps, vw_to_track_vels
from monoforce_tpu_torch.physics.engine import RigidState, RobotModel
from monoforce_tpu_torch.physics.fast import planner_kernel_mode, planner_rollout
from monoforce_tpu_torch.planner.shooting import Planner
from monoforce_tpu_torch.utils.profiling import recording, span

B, N = 32, 40


def _port_robot(jr):
    return robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")


def _terrain(cfg, seed):
    """Hill plus noise, friction in the JAX tests' range, mixed controls."""
    rng = np.random.default_rng(seed)
    gx, gy = cfg.grid_coords()
    z = (0.35 * np.exp(-((gx - 1.0) ** 2 / 2.0 + gy ** 2 / 3.0))
         + 0.05 * rng.normal(size=gx.shape)).astype(np.float32)
    fr = rng.uniform(0.4, 1.0, gx.shape).astype(np.float32)
    ctr = rng.uniform(-1.0, 1.0, (B, N, 2)).astype(np.float32)
    return z, fr, ctr


@pytest.mark.parametrize("robot", ["tradr", "marv", "husky"])
def test_kernel_mode_pins_presets(robot):
    """The same mode strings as tests/test_fast.py's pins, for both
    packages, on the planner presets and the 0.1 m reference resolution."""
    presets = [(JaxPhysicsConfig.for_planner(robot),
                PhysicsConfig.for_planner(robot)),
               (JaxPhysicsConfig(robot=robot, mesh_voxel_size=0.1),
                PhysicsConfig(robot=robot, mesh_voxel_size=0.1)),
               (JaxPhysicsConfig(robot=robot, integration_mode="rk4"),
                PhysicsConfig(robot=robot, integration_mode="rk4"))]
    for jcfg, cfg in presets:
        jr = JaxRobotModel.from_config(jcfg)
        tr = RobotModel.from_config(cfg, device="cpu")
        for b in (64, 50, 4096):
            for uniform in (True, False):
                assert planner_kernel_mode(tr, b, uniform) == jax_mode(
                    jr, b, uniform)
    tr = RobotModel.from_config(PhysicsConfig.for_planner(robot), device="cpu")
    assert planner_kernel_mode(tr, 64) == "pair_zu"
    assert planner_kernel_mode(tr, 64, uniform_friction=False) == "pair"
    ref = RobotModel.from_config(
        PhysicsConfig(robot=robot, mesh_voxel_size=0.1), device="cpu")
    # husky's 0.1 m cloud has 202 points: past pair3, into packed
    want = ("packed", "packed") if robot == "husky" else ("pair3_zu",
                                                          "pair3_muq")
    assert (planner_kernel_mode(ref, 64),
            planner_kernel_mode(ref, 64, uniform_friction=False)) == want


# mode, robot, config overrides, batch, friction grid: the four pair modes;
# then the modes for what cannot pair, packed (tradr 0.1 m at B=50, not a
# multiple of 16; husky 0.1 m, P=202, past pair3) and fallback (rk4:
# fast_rollout), each with and without friction
ROLLOUT_CASES = [
    ("pair_zu", "tradr", {"mesh_voxel_size": 0.15}, B, False),
    ("pair", "tradr", {"mesh_voxel_size": 0.15}, B, True),
    ("pair3_zu", "tradr", {"mesh_voxel_size": 0.1}, B, False),
    ("pair3_muq", "tradr", {"mesh_voxel_size": 0.1}, B, True),
] + [(mode, robot, kw, b, friction)
     for mode, robot, kw, b in (
         ("packed", "tradr", {"mesh_voxel_size": 0.1}, 50),
         ("packed", "husky", {"mesh_voxel_size": 0.1}, B),
         ("fallback", "tradr", {"integration_mode": "rk4"}, 8))
     for friction in (False, True)]


@pytest.mark.parametrize(
    "mode,robot,kw,b,friction", ROLLOUT_CASES,
    ids=[f"{m}-{r}-{b}-{'mu' if f else 'zu'}"
         for m, r, _, b, f in ROLLOUT_CASES])
def test_rollout_matches_jax(mode, robot, kw, b, friction):
    jcfg = JaxPhysicsConfig(robot=robot, **kw)
    jr = JaxRobotModel.from_config(jcfg)
    tr = _port_robot(jr)
    assert planner_kernel_mode(tr, b, uniform_friction=not friction) == mode
    z, fr, ctr = _terrain(jcfg, seed=7)
    # rk4 from the first eight controls: at step 13 one contact point of
    # trajectory 0 lies within an ulp of a cell boundary, and the two
    # packages' states, equal to 2e-7 m/s, put it in different cells (a
    # 44 N jump of its force, as the reference's lookup has); the next
    # eight stay clear of that
    ctr = np.concatenate([ctr, ctr])[8:8 + b] if mode == "fallback" else (
        np.concatenate([ctr, ctr])[:b])
    fr = fr if friction else None
    with jax.disable_jit():
        js, jst = jax_rollout(jr, jnp.asarray(z), jnp.asarray(ctr),
                              friction=None if fr is None else jnp.asarray(fr))
        jx, jstd = np.asarray(js.x), np.asarray(jst.spring_std)
    ts, tst = planner_rollout(tr, torch.from_numpy(z), torch.from_numpy(ctr),
                              friction=None if fr is None
                              else torch.from_numpy(fr))
    assert ts.x.shape == (b, N, 3) and ts.R.shape == (b, N, 3, 3)
    rmse = float(np.sqrt(np.mean((ts.x.numpy() - jx) ** 2)))
    assert rmse < 1e-4, rmse
    np.testing.assert_allclose(tst.spring_std.numpy(), jstd, rtol=1e-4)
    np.testing.assert_allclose(tst.abs_roll.numpy(),
                               np.asarray(jst.abs_roll), atol=1e-4)


@pytest.mark.parametrize("voxel", [0.15, 0.1])
def test_planner_plan_matches_jax(voxel):
    """Planner.plan (always with a friction grid: modes pair and
    pair3_muq) gives the JAX Planner's costs and the same best path."""
    jcfg = (JaxPhysicsConfig.for_planner("tradr") if voxel == 0.15
            else JaxPhysicsConfig(robot="tradr", mesh_voxel_size=voxel))
    cfg = (PhysicsConfig.for_planner("tradr") if voxel == 0.15
           else PhysicsConfig(robot="tradr", mesh_voxel_size=voxel))
    z, fr, ctr = _terrain(jcfg, seed=11)
    jp = JaxPlanner(jcfg)
    tp = Planner(cfg, device="cpu")
    with jax.disable_jit():
        want = jp.plan(jnp.asarray(z), jnp.asarray(ctr),
                       friction=jnp.asarray(fr))
        w_costs, w_best = np.asarray(want.costs), int(want.best)
        w_x = np.asarray(want.xs)
    got = tp.plan(torch.from_numpy(z), torch.from_numpy(ctr),
                  friction=torch.from_numpy(fr))
    np.testing.assert_allclose(got.costs.numpy(), w_costs, rtol=1e-4)
    assert int(got.best) == w_best
    assert float(np.sqrt(np.mean((got.xs.numpy() - w_x) ** 2))) < 1e-4


@pytest.mark.parametrize("moved", ["z_grid", "controls", "friction",
                                   "track_vels", "state0", "plan"])
def test_inputs_on_another_device_raise(moved):
    """A tensor on another device than the robot's raises; it is never
    copied over, so the rollout cannot quietly leave the caller's device
    ("meta" stands in for the card here)."""
    cfg = PhysicsConfig.for_planner("tradr")
    robot = RobotModel.from_config(cfg, device="cpu")
    args = dict(z_grid=torch.zeros((128, 128)), controls=torch.zeros((16, 8, 2)),
                friction=torch.ones((128, 128)))
    if moved == "plan":
        with pytest.raises(ValueError, match="z_grid is on meta"):
            Planner(cfg, device="cpu").plan(
                torch.zeros((128, 128), device="meta"), args["controls"])
        return
    if moved == "track_vels":
        args[moved] = torch.zeros((16, 8, robot.n_tracks), device="meta")
    elif moved == "state0":
        args[moved] = RigidState(*(torch.zeros((16,) + s, device="meta")
                                   for s in ((3,), (3,), (3, 3), (3,))))
    else:
        args[moved] = args[moved].to("meta")
    with pytest.raises(ValueError, match=" is on meta"):
        planner_rollout(robot, **args)


def test_entry_points_default_to_cuda():
    """Planner, RobotModel and the config's robot_model run on cuda unless
    told otherwise: with no card they raise instead of using the CPU."""
    cfg = PhysicsConfig.for_planner("tradr")
    if torch.cuda.is_available():
        assert Planner(cfg).device.type == "cuda"
        assert cfg.robot_model().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.robot_model()
    assert Planner(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("horizon,dt", [(5.0, 0.01), (0.37, 0.013)])
def test_time_stamps_match_jax(horizon, dt):
    """time_stamps on the CPU gives the JAX package's stamps; without a
    device it runs on cuda, so with no card it raises."""
    got = time_stamps(horizon, dt, device="cpu")
    want = np.asarray(jax_time_stamps(horizon, dt))
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if torch.cuda.is_available():
        assert time_stamps(horizon, dt).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        time_stamps(horizon, dt)


def test_sample_controls_shape_and_ranges():
    cfg = PhysicsConfig.for_planner("tradr", n_sim_trajs=16, traj_sim_time=0.5)
    p = Planner(cfg, device="cpu")
    ctr, ts = p.sample_controls(torch.Generator().manual_seed(0))
    assert ctr.shape == (16, 50, 2) and ts.shape == (50,)
    assert (ctr[:8, :, 0] >= cfg.vel_max / 2).all()
    assert (ctr[8:, :, 0] <= -cfg.vel_max / 2).all()
    assert (ctr[..., 1].abs() <= cfg.omega_max).all()


def _rollout_before(robot, z, ctr, friction, state0):
    """The serving loop as it ran before its steps were fused: per step one
    plain step call and a plain ``_integrate`` on the packed state, the
    states and spring std stacked at the end (positions, R, spring std)."""
    mode = planner_kernel_mode(robot, ctr.shape[0], friction is None)
    fmt = {"pair_zu": "zu", "pair3_zu": "zu", "pair3_muq": "muq",
           "pair": "pairmu", "packed": "packed"}[mode]
    c = fast._make_consts(robot)
    cst, pts = pack_consts(robot), pack_points(robot)
    d_max, res = robot.d_max, robot.grid_res
    mu = torch.ones_like(z) if friction is None else friction
    state = torch.stack(fast._unpack_state(state0), dim=1)
    wx0, wy0 = fast._world_xy(c, state)
    sxy0, patch0 = fast._extract_windows(z, mu, wx0, wy0, d_max, res)
    z0 = fk_interp(patch0, wx0.contiguous(), wy0.contiguous(), sxy0,
                   c.cst)[:, :wx0.shape[1]]
    state = state.clone()
    state[:, 2] = z0.sum(dim=1) / wx0.shape[1]

    def extract(wx, wy, dqx, dqy):
        if fmt == "zu":
            return fast._extract_windows_zpair(z, wx, wy, d_max, res, dqx,
                                               dqy)
        if fmt == "muq":
            return fast._extract_windows_zmuq(z, fast.quantize_mu_grid(mu),
                                              wx, wy, d_max, res, dqx, dqy)
        return fast._extract_windows_packed1(z, mu, wx, wy, d_max, res, dqx,
                                             dqy)

    tv_t = vw_to_track_vels(ctr[..., 0], ctr[..., 1], robot.robot_size,
                            robot.n_tracks).transpose(0, 1).contiguous()
    n_total = tv_t.shape[0]
    states, accs = [], []
    for start in range(0, n_total, 32):
        t_blk = min(32, n_total - start) * robot.dt
        wx, wy = fast._world_xy(c, state)
        sxy, patch = extract(wx, wy, state[:, 3:4] * t_blk,
                             state[:, 4:5] * t_blk)
        for k in range(start, min(start + 32, n_total)):
            acc8 = fk_step_plain(fmt, cst, patch, state, tv_t[k], sxy, pts)
            state = fast._integrate(state, acc8, robot.dt)
            states.append(state)
            accs.append(acc8)
    seq = torch.stack(states, dim=1)
    Rs = seq[..., 6:15].reshape(seq.shape[:2] + (3, 3))
    delta_h = robot.mass * robot.gravity / (robot.stiffness + 1e-6)
    xs = seq[..., 0:3] + Rs[..., :, 2] * delta_h
    return xs, Rs, torch.stack([a[:, 6] for a in accs], dim=1)


@pytest.mark.parametrize("n_steps", [1, 32, 33, 45])
@pytest.mark.parametrize("mode,kw,b,friction", [
    ("pair_zu", {"mesh_voxel_size": 0.15}, 16, False),
    ("pair", {"mesh_voxel_size": 0.15}, 16, True),
    ("pair3_muq", {"mesh_voxel_size": 0.1}, 16, True),
    ("packed", {"mesh_voxel_size": 0.1}, 10, True)])
def test_rollout_sequence_buffer_matches_the_step_loop(mode, kw, b, friction,
                                                       n_steps):
    """The fused steps writing into the (B, N, 18) sequence give the states
    and stats of the per-step loop they replaced, bit for bit: one step, a
    whole block, a block and one step, a block and a remainder of 13.  The
    bodies start at up to 6 m/s, so that a block's windows cut where the
    state read back from the sequence at its boundary puts them cover the
    footprint, and windows cut at a stale state do not."""
    cfg = PhysicsConfig(robot="tradr", **kw)
    robot = RobotModel.from_config(cfg, device="cpu")
    z, fr, _ = _terrain(cfg, seed=13)
    rng = np.random.default_rng(14)
    ctr = rng.uniform(-1.0, 1.0, (b, n_steps, 2)).astype(np.float32)
    xd = np.zeros((b, 3), np.float32)
    xd[:, :2] = rng.uniform(-6.0, 6.0, (b, 2))
    state0 = RigidState(torch.zeros((b, 3)), torch.from_numpy(xd),
                        torch.eye(3).expand(b, 3, 3).contiguous(),
                        torch.zeros((b, 3)))
    z, ctr = torch.from_numpy(z), torch.from_numpy(ctr)
    fr = torch.from_numpy(fr) if friction else None
    assert planner_kernel_mode(robot, b, fr is None) == mode
    states, stats = planner_rollout(robot, z, ctr, state0=state0, friction=fr)
    xs, Rs, spring = _rollout_before(robot, z, ctr, fr, state0)
    assert torch.equal(states.x, xs)
    assert torch.equal(states.R, Rs)
    assert torch.equal(stats.spring_std, spring)
    assert torch.equal(stats.abs_roll,
                       torch.atan2(Rs[..., 2, 1], Rs[..., 2, 2]).abs())


@pytest.mark.parametrize(
    "mode,robot,kw,b,friction", ROLLOUT_CASES,
    ids=[f"{m}-{r}-{b}-{'mu' if f else 'zu'}"
         for m, r, _, b, f in ROLLOUT_CASES])
def test_rollout_counts_fused_steps(mode, robot, kw, b, friction):
    """``rollout.fused_steps`` counts every step of a serving mode, as
    ``rollout.steps`` does, and none on ``fallback`` (fast_rollout)."""
    cfg = PhysicsConfig(robot=robot, **kw)
    tr = RobotModel.from_config(cfg, device="cpu")
    z, fr, ctr = _terrain(cfg, seed=7)
    n_steps = 9
    ctr = torch.from_numpy(np.concatenate([ctr, ctr])[:b, :n_steps])
    with recording() as rec:
        with span("request"):
            planner_rollout(tr, torch.from_numpy(z), ctr,
                            friction=torch.from_numpy(fr) if friction
                            else None)
        (counters,) = rec.take()["counters"].values()
    assert counters["rollout.steps"] == n_steps
    want = 0 if mode == "fallback" else n_steps
    assert counters.get("rollout.fused_steps", 0) == want
