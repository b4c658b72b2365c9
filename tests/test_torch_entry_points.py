"""The port's remaining entry points against the JAX package, on the CPU.

- ``rollout_single_odeint``: against the JAX function on a golden-like case
  (marv on a hill, flippers moving, 40 steps) within 1e-5 m, and against
  row b of the port's batched ``rollout_odeint`` (one body) within 1e-6:
  PyTorch's vectorised CPU kernels round a row's tail alone and inside a
  batch differently in the last bit.
- ``terrain_fit_chunk``: three steps against the JAX ``terrain_fit_chunk``
  from the same initial params (losses within rtol 1e-4).
- The scripts against the JAX scripts run in-process with their real
  ``sys.argv``, their library calls spied on: the JAX script's random
  draws (``generate_controls``, ``shooting_controls`` with ``PRNGKey(0)``)
  are handed to the port's computation, and the JAX script's outputs are
  read where it hands them on (to ``fit_terrain``, a figure, ``navigate``).
  ``fit_terrain.py`` at 0.5 s (the fast branch, 2 trajectories, 3
  iterations): the terrain exactly, losses within rtol 1e-4, z and
  friction within 1e-4 (the JAX fit runs in one ``terrain_fit_chunk``,
  the program the chunk test reuses; the script's verbose loop compiles
  another for the same steps).  ``robot_control shoot`` (4 x 500 on the
  hill): positions within 1e-4 m, costs within rtol 1e-4, the same
  argmin.  ``motion`` (marv, moving flippers): positions within 1e-4 m
  over the first second (the port's through its ``main``).
  ``navigate.py``: the three terrains exactly.
- Each script through ``python -m ... --device cpu`` at tiny arguments,
  in a subprocess.
"""

import importlib
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics import engine as jengine
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.physics import engine
from monoforce_tpu_torch.scripts import fit_terrain as fit_script
from monoforce_tpu_torch.scripts import navigate as nav_script
from monoforce_tpu_torch.scripts import robot_control
from monoforce_tpu_torch.training import TerrainParams, make_optimizer
from monoforce_tpu_torch.training.fit_terrain import terrain_fit_chunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jfit = importlib.import_module("monoforce_tpu.training.fit_terrain")
jcontrols = importlib.import_module("monoforce_tpu.physics.controls")
jvis = importlib.import_module("monoforce_tpu.vis")
jnav = importlib.import_module("monoforce_tpu.planner.navigator")
jtraining = importlib.import_module("monoforce_tpu.training")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _robots(robot, **kw):
    jr = jengine.RobotModel.from_config(JaxPhysicsConfig(robot=robot, **kw))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


def _spy(monkeypatch, module, name, record, call=None):
    """Replace ``module.name`` by a function that records its arguments
    (and result) in ``record`` and calls ``call`` (default: the original)."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        out = (call or orig)(*args, **kwargs)
        record.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, spy)


# --------------------------------------------------------- odeint, single


def test_rollout_single_odeint_matches_jax_and_the_batch():
    jr, tr = _robots("marv", grid_res=0.4)
    cfg = JaxPhysicsConfig(robot="marv", grid_res=0.4)
    gx, gy = cfg.grid_coords()
    z = (0.3 * np.exp(-((gx - 0.5) ** 2 + gy ** 2) / 2.0)).astype(np.float32)
    rng = np.random.default_rng(0)
    B, N = 3, 40
    fr = rng.uniform(0.4, 1.0, (B,) + z.shape).astype(np.float32)
    ctr = np.stack([rng.uniform(0.3, 1.0, (B, N)),
                    rng.uniform(0.2, 0.8, (B, N))], -1).astype(np.float32)
    t = np.linspace(0, 1, N, dtype=np.float32)
    ja = np.stack([0.4 * np.sin(3 * t)] * 2 + [-0.3 * np.cos(3 * t)] * 2,
                  1)[None].repeat(B, 0)
    s0 = jengine._default_state0(jnp.asarray(ctr))
    s0 = [np.asarray(a) for a in s0]
    dt = 1.0 / (N - 1)
    b = 1
    one = [a[b] for a in s0]
    want, (jfs, _) = jax.jit(jengine.rollout_single_odeint)(
        jr, jnp.asarray(z), jnp.asarray(fr[b]), jnp.asarray(ctr[b]),
        jnp.asarray(ja[b]), jengine.RigidState(*map(jnp.asarray, one)), dt)
    got, (fs, ff) = engine.rollout_single_odeint(
        tr, z, fr[b], ctr[b], ja[b], engine.RigidState(*one), dt)
    assert got.x.shape == (N, 3) and fs.shape == (N, tr.points.shape[0], 3)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jfs)).max())
    # the batch's row b is the single rollout: one body, so the same
    # operations; only the last bit may differ, where a kernel rounds by
    # the batch's shape: on the CPU the vectorised contact sigmoid computes
    # the tail of a row alone in its scalar path and inside the batch in
    # its vector one
    states, (bfs, bff) = engine.rollout_odeint(
        tr, np.broadcast_to(z, (B,) + z.shape), ctr, ja,
        engine.RigidState(*s0), fr, dt)
    for k in range(4):
        np.testing.assert_allclose(states[k][b].numpy(), got[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=str(k))
    for a, c in ((bfs[b], fs), (bff[b], ff)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=1e-6 * float(c.abs().max()))


# ------------------------------------------------------------ the fit script

FIT_ARGS = ["--n_iters", "3", "--n_trajs", "2", "--traj_sim_time", "0.5"]


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX fit script at FIT_ARGS with its calls recorded: its controls,
    its ground-truth rollout, and its fit, run as one terrain_fit_chunk."""
    mp = pytest.MonkeyPatch()
    out = str(tmp_path_factory.mktemp("fit") / "fit.png")
    rec = {"controls": [], "rollout": [], "fit": [], "out": out}
    try:
        mp.setattr(sys, "argv", ["fit_terrain.py", *FIT_ARGS, "--out", out])
        _spy(mp, jcontrols, "generate_controls", rec["controls"])
        _spy(mp, jengine, "rollout", rec["rollout"])
        fit = jtraining.fit_terrain
        _spy(mp, jtraining, "fit_terrain", rec["fit"], call=lambda *a, **k: fit(
            *a, **dict(k, verbose=False, device_chunk=k["n_iters"])))
        _jax_script("fit_terrain").main()
    finally:
        mp.undo()
    return rec


def test_fit_script_fast_branch_matches_jax(jax_fit):
    rec = jax_fit
    assert os.path.exists(rec["out"])
    (c_args, c_kw, (controls, ts)), = rec["controls"]
    (r_args, _, (jgt, _, _)), = rec["rollout"]
    (f_args, f_kw, (jparams, jlosses)), = rec["fit"]
    cfg = fit_script.config(0.5)
    # the same settings and terrain as the JAX script
    assert c_args[1:] == (2, cfg.traj_sim_time, cfg.dt)
    assert c_kw == {"v_range": (0.3, 1.0), "w_range": (-0.5, 0.5)}
    assert np.array_equal(fit_script.hill(cfg), np.asarray(r_args[1])[0])
    assert f_args[0].grid_res == cfg.grid_res == 0.4
    assert controls.shape[1] < 256          # the fast branch
    z_true, gt, params, losses = fit_script.fit(
        cfg, np.asarray(controls), np.asarray(ts), 3, 0.02, 0.01, 0.0, "cpu")
    np.testing.assert_allclose(gt.x.numpy(), np.asarray(jgt.x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for name in ("z_grid", "friction"):
        np.testing.assert_allclose(getattr(params, name).numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_terrain_fit_chunk_matches_jax(jax_fit):
    """Three steps in one chunk from the fit's flat start, on the JAX
    script's ground truth: the program the JAX fit compiled."""
    (f_args, f_kw, _), = jax_fit["fit"]
    jcfg, controls, states_gt, pred_ts, gt_ts = f_args
    jr = jengine.RobotModel.from_config(jcfg)
    opt = jfit.make_optimizer(0.02, 0.01)
    p0 = jfit.TerrainParams(jnp.zeros(jcfg.grid_shape, jnp.float32),
                            jnp.full(jcfg.grid_shape, 0.5, jnp.float32))
    jp, _, jlosses = jfit.terrain_fit_chunk(
        p0, opt.init(p0), jr, controls, [jnp.asarray(s) for s in states_gt],
        pred_ts, gt_ts, None, opt, 0.0, None, 3)
    _, tr = _robots("tradr", grid_res=0.4)
    tp = TerrainParams(torch.zeros(jcfg.grid_shape, requires_grad=True),
                       torch.full(jcfg.grid_shape, 0.5, requires_grad=True))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tp, _, losses = terrain_fit_chunk(
        tp, make_optimizer(0.02, 0.01)(tp), tr, t(controls),
        [t(s) for s in states_gt], t(pred_ts), t(gt_ts), None, 0.0, None, 3)
    assert isinstance(losses, torch.Tensor) and losses.shape == (3,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(tp.z_grid.detach().numpy(),
                               np.asarray(jp.z_grid), rtol=0, atol=1e-4)


# ------------------------------------------------------ the control script


@pytest.fixture(scope="module")
def jax_shoot(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    rec = {"controls": [], "plot": []}
    out = str(tmp_path_factory.mktemp("shoot") / "shoot.png")
    try:
        mp.setattr(sys, "argv", ["robot_control.py", "shoot", "--n_trajs",
                                 "4", "--repeats", "1", "--out", out])
        _spy(mp, jcontrols, "shooting_controls", rec["controls"])
        _spy(mp, jvis, "plot_terrain_with_trajs", rec["plot"],
             call=lambda *a, **k: k["path"])
        _jax_script("robot_control").main()
    finally:
        mp.undo()
    return rec


def test_shoot_matches_jax(jax_shoot):
    (c_args, _, (controls, _)), = jax_shoot["controls"]
    (p_args, p_kw, _), = jax_shoot["plot"]
    z, xs, costs, d_max = (np.asarray(a) for a in p_args)
    cfg = PhysicsConfig(robot="tradr")
    assert c_args[1:] == (4, cfg.vel_max, cfg.omega_max, cfg.traj_sim_time,
                          cfg.dt)
    assert np.array_equal(robot_control.make_terrain(cfg, "hill"), z)
    _, tr = _robots("tradr")
    got_xs, got_costs = robot_control.shoot_rollout(
        tr, torch.from_numpy(z), torch.from_numpy(np.asarray(controls)))
    assert got_xs.shape == (4, 500, 3)
    np.testing.assert_allclose(got_xs.numpy(), xs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_costs.numpy(), costs, rtol=1e-4)
    assert int(torch.argmin(got_costs)) == p_kw["best"] == int(costs.argmin())


def test_motion_matches_jax(tmp_path, monkeypatch):
    rec = []
    monkeypatch.setattr(sys, "argv", ["robot_control.py", "motion", "--out",
                                      str(tmp_path / "m.png")])
    _spy(monkeypatch, jvis, "plot_rollout_3d", rec,
         call=lambda *a, **k: k["path"])
    _jax_script("robot_control").main()
    monkeypatch.undo()
    (p_args, _, _), = rec
    z, xs = np.asarray(p_args[0]), np.asarray(p_args[1])
    cfg = PhysicsConfig(robot="marv")
    assert np.array_equal(robot_control.make_terrain(cfg, "hill"), z)
    states = robot_control.main(["motion", "--device", "cpu", "--out",
                                 str(tmp_path / "port.png")])
    assert states.x.shape == (1, 500, 3) and os.path.exists(tmp_path
                                                             / "port.png")
    steps = int(1.0 / cfg.dt)                       # the first second
    np.testing.assert_allclose(states.x[0, :steps].numpy(), xs[:steps],
                               rtol=0, atol=1e-4)
    assert np.isfinite(states.x.numpy()).all()


# -------------------------------------------------------- the navigate script


@pytest.mark.parametrize("terrain", ["hill", "ridge", "flat"])
def test_navigate_terrains_match_jax(terrain, tmp_path, monkeypatch):
    rec = []
    fake = types.SimpleNamespace(reached=True, times=[0.0], plans=[],
                                 positions=np.zeros((1, 3)))
    monkeypatch.setattr(sys, "argv", ["navigate.py", "--terrain", terrain,
                                      "--out", str(tmp_path / "n.png")])
    _spy(monkeypatch, jnav, "navigate", rec, call=lambda *a, **k: fake)
    _jax_script("navigate").main()
    (args, kw, _), = rec
    cfg = PhysicsConfig.for_planner("tradr")
    assert args[0].to_dict() == cfg.to_dict()
    z = nav_script.make_terrain(cfg, terrain)
    assert z.dtype == np.float32 and np.array_equal(z, np.asarray(args[1]))
    assert np.array_equal(nav_script.WAYPOINTS, args[2])
    assert (kw["n_trajs"], kw["max_time"]) == (64, 40.0)


# ---------------------------------------------------- the command lines


@pytest.mark.parametrize("argv", [
    ["fit_terrain", "--n_iters", "2", "--n_trajs", "1", "--traj_sim_time",
     "0.2"],
    ["robot_control", "shoot", "--n_trajs", "2", "--repeats", "1"],
    ["navigate", "--terrain", "ridge", "--n_trajs", "4", "--max_time", "0.3"],
], ids=["fit_terrain", "robot_control", "navigate"])
def test_scripts_run_from_the_command_line(argv, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", f"monoforce_tpu_torch.scripts.{argv[0]}",
         *argv[1:], "--out", str(tmp_path / "out.png"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.exists(tmp_path / "out.png")
    want = {"fit_terrain": "loss:", "robot_control": "trajs x 500 steps",
            "navigate": "route "}[argv[0]]
    assert want in r.stdout, r.stdout[-2000:]
