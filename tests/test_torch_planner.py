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
from monoforce_tpu_torch.physics.controls import time_stamps
from monoforce_tpu_torch.physics.engine import RigidState, RobotModel
from monoforce_tpu_torch.physics.fast import planner_kernel_mode, planner_rollout
from monoforce_tpu_torch.planner.shooting import Planner

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
