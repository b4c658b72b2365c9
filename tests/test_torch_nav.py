"""The port's navigation stack against the JAX package: the follower's
control law, the supervisor, the path costs and clearance check, the
waypoint route, one replan, and the whole closed loop.

Inputs are made with numpy from a seed and go through both packages on the
CPU.  Tolerances: follower commands within 1e-6 (float32 trigonometry of
O(1) values) with the same carrot point bit for bit; path time costs within
1e-5 (cumulative sums in another order); the selector's combined costs
within 1e-6 and the same best index and truncation.  The closed loop: the
JAX ``navigate`` (jitted, compiled once for the module) and the port's get
the same shooting controls per replan (``shooting_controls`` is replaced
in both navigator modules, the only way to give a ``jax.random`` key's and
a ``torch.Generator``'s draws the same numbers); they must take the same
decisions (ticks, replans, statuses, best paths) and drive within 1e-3 m of
each other at every tick (two float32 simulators, 1e-7-level differences
fed back through the follower).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics.engine import RigidState as JaxRigidState
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu.physics.fast import planner_rollout as jax_planner_rollout
from monoforce_tpu.planner import controller as jctl
from monoforce_tpu.planner import follower as jfol
from monoforce_tpu.planner import navigator as jnav
from monoforce_tpu.planner import selector as jsel
from monoforce_tpu.planner.shooting import force_variance_cost as jax_fv_cost
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.engine import RigidState, RobotModel
from monoforce_tpu_torch.physics.fast import planner_rollout
from monoforce_tpu_torch.planner import controller as tctl
from monoforce_tpu_torch.planner import follower as tfol
from monoforce_tpu_torch.planner import navigator as tnav
from monoforce_tpu_torch.planner import selector as tsel
from monoforce_tpu_torch.planner.shooting import force_variance_cost

CMD_ATOL = 1e-6
COST_ATOL = 1e-5
POS_ATOL_M = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _pose(rpy, xyz):
    from scipy.spatial.transform import Rotation
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", rpy).as_matrix()
    pose[:3, 3] = xyz
    return pose


def _curve(rng, M=30, start=(0.0, 0.0), heading=0.0, step=0.15):
    """A smooth random path of M points from ``start``."""
    yaw = heading + np.cumsum(rng.normal(scale=0.08, size=M))
    xy = np.asarray(start) + np.cumsum(
        step * np.stack([np.cos(yaw), np.sin(yaw)], 1), axis=0)
    z = 0.05 * np.sin(xy[:, 0])
    return np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)


# (name, pose roll/pitch/yaw, pose xyz, path heading, path length, params)
FOLLOWER_CASES = [
    ("ahead", (0.0, 0.0, 0.1), (0.0, 0.0, 0.0), 0.0, 30, {}),
    ("carrot_behind", (0.0, 0.0, np.pi), (0.0, 0.0, 0.0), 0.0, 30, {}),
    ("behind_no_backward", (0.0, 0.0, np.pi), (0.0, 0.0, 0.0), 0.0, 30,
     {"allow_backward": False}),
    ("turn_on_spot", (0.0, 0.0, -1.4), (0.0, 0.0, 0.0), 0.2, 30, {}),
    ("goal_reached", (0.0, 0.0, 0.0), None, 0.0, 8, {}),
    ("near_goal_not_reached", (0.0, 0.0, 0.3), "near_end", 0.0, 8, {}),
    ("roll_pitch_slowdown", (0.3, -0.2, 0.05), (0.0, 0.0, 0.0), 0.0, 30, {}),
    ("off_path_far", (0.1, 0.1, 2.0), (1.0, -2.5, 0.2), 0.5, 30,
     {"look_ahead": 0.5}),
]


@pytest.mark.parametrize("case", FOLLOWER_CASES, ids=[c[0] for c in
                                                      FOLLOWER_CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_follower_step_matches_jax(case, seed):
    name, rpy, xyz, heading, M, kw = case
    rng = np.random.default_rng(seed)
    path = _curve(rng, M, heading=heading)
    if xyz is None:
        xyz = path[-1] + np.array([0.1, -0.05, 0.0], np.float32)
    elif xyz == "near_end":
        xyz = path[-1] - np.array([0.6, 0.0, 0.0], np.float32)
    pose = _pose(rpy, xyz)
    got = tfol.follower_step(_t(pose), _t(path), tfol.FollowerParams(**kw))
    want = jfol.follower_step(jnp.asarray(pose), jnp.asarray(path),
                              jfol.FollowerParams(**kw))
    for a, b in ((got.linear, want.linear), (got.angular, want.angular)):
        np.testing.assert_allclose(float(a), float(b), atol=CMD_ATOL, rtol=0)
    assert bool(got.goal_reached) == bool(want.goal_reached)
    assert np.array_equal(got.carrot.numpy(), np.asarray(want.carrot))
    if name == "goal_reached":
        assert bool(got.goal_reached) and float(got.linear) == 0.0
    if name == "carrot_behind":
        assert float(got.linear) <= 0.0


def test_path_time_cost_matches_jax():
    rng = np.random.default_rng(3)
    path = _curve(rng, 40)
    rpy = np.stack([rng.uniform(-0.4, 0.4, 40), rng.uniform(-0.4, 0.4, 40),
                    np.linspace(-3.0, 3.0, 40)], 1)   # yaw crosses +-pi wrap
    Rs = np.stack([_pose(r, (0, 0, 0))[:3, :3] for r in rpy])
    for kw in ({}, {"max_speed": 0.7, "max_roll": 0.3}):
        a = tctl.path_time_cost(_t(path), **kw)
        b = jctl.path_time_cost(jnp.asarray(path), **kw)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=COST_ATOL)
        a = tctl.path_time_cost(_t(path), Rs=_t(Rs), **kw)
        b = jctl.path_time_cost(jnp.asarray(path), Rs=jnp.asarray(Rs), **kw)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=COST_ATOL)
        assert float(a[0]) == 0.0


def test_pose_clear_matches_jax():
    rng = np.random.default_rng(4)
    for k in range(12):
        pose = _pose(rng.uniform(-0.3, 0.3, 3) * [1, 1, 10],
                     rng.uniform(-1, 1, 3))
        n = int(rng.integers(0, 12))
        cloud = np.concatenate([
            pose[:3, 3] + rng.uniform(-0.3, 0.3, (n, 3)),
            rng.uniform(-4, 4, (40, 3))]).astype(np.float32)
        for min_points in (1, 5, n):
            got = bool(tctl.pose_clear(_t(cloud), _t(pose),
                                       min_points=min_points))
            want = bool(jctl.pose_clear(jnp.asarray(cloud), jnp.asarray(pose),
                                        min_points=min_points))
            assert got == want


@pytest.mark.parametrize("weights,lookahead,robot_dist", [
    ((1.0, 1.0), float("inf"), None), ((0.0, 1.0), float("inf"), None),
    ((2.0, 0.5), 2.0, 1.0), ((1.0, 1.0), 2.0, 3.5)])
def test_select_against_route_matches_jax(weights, lookahead, robot_dist):
    rng = np.random.default_rng(5)
    paths = np.stack([_curve(rng, 30, heading=h)
                      for h in np.linspace(-np.pi, np.pi, 12)])
    costs = rng.uniform(0, 3, 12).astype(np.float32)
    wp = np.array([2.0, 1.5, 0.0], np.float32)
    got = tsel.select_against_route(
        _t(paths), _t(costs), _t(wp), *weights,
        wp_lookahead_dist=lookahead, robot_xy_dist_to_wp=robot_dist)
    want = jsel.select_against_route(
        jnp.asarray(paths), jnp.asarray(costs), jnp.asarray(wp), *weights,
        wp_lookahead_dist=lookahead, robot_xy_dist_to_wp=robot_dist)
    assert int(got[0]) == int(want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=CMD_ATOL)
    assert (got[2] is None) == (want[2] is None)
    if got[2] is not None:
        assert int(got[2]) == int(want[2])
    d_t, i_t = tsel.path_dists_to_waypoint(_t(paths), _t(wp))
    d_j, i_j = jsel.path_dists_to_waypoint(jnp.asarray(paths), jnp.asarray(wp))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=CMD_ATOL)
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))


def test_waypoint_route_progression_matches_jax():
    wps = [[1.0, 0, 0], [2.0, 0, 0], [5.0, 0, 0]]
    routes = (tsel.WaypointRoute(wps, reach_dist=0.5),
              jsel.WaypointRoute(wps, reach_dist=0.5))
    rng = np.random.default_rng(6)
    paths = np.stack([_curve(rng, 20, heading=h) for h in (-0.5, 0.0, 0.5)])
    costs = np.array([0.3, 0.1, 0.2], np.float32)
    for x in (0.0, 0.9, 1.8, 3.0, 4.9, 6.0):
        robot = np.array([x, 0.0, 0.0], np.float32)
        cur = [r.update(robot) for r in routes]
        assert (cur[0] is None) == (cur[1] is None)
        if cur[0] is not None:
            assert np.array_equal(cur[0], cur[1])
        assert routes[0].wp_i == routes[1].wp_i
        got = routes[0].select(_t(paths), _t(costs), robot)
        want = routes[1].select(jnp.asarray(paths), jnp.asarray(costs), robot)
        assert got == want
    assert routes[0].done and routes[0].current is None


def _mode_sequence(ctl_mod, to, **kw):
    """tests/test_nav.py:62-97's supervisor sequence; returns its ticks."""
    ctl = ctl_mod.FollowerController(force_through_after=1.0,
                                     backtrack_after=2.0, **kw)
    path = np.stack([np.linspace(0, 5, 30), np.zeros(30), np.zeros(30)], -1)
    pose = np.eye(4, dtype=np.float32)
    out = [ctl.tick(to(pose), t=0.0)]
    ctl.set_path(to(path))
    out.append(ctl.tick(to(pose), t=0.1))
    cloud = np.tile(np.array([[1.0, 0.0, 0.2]], np.float32), (20, 1))
    out.append(ctl.tick(to(pose), t=0.2, cloud=to(cloud)))
    out.append(ctl.tick(to(pose), t=2.0, cloud=to(cloud)))
    pose_goal = np.eye(4, dtype=np.float32)
    pose_goal[0, 3] = 5.0
    out.append(ctl.tick(to(pose_goal), t=3.0))
    for i, x in enumerate(np.linspace(0, 3, 10)):
        p = np.eye(4, dtype=np.float32)
        p[0, 3] = x
        out.append(ctl.tick(to(p), t=4.0 + i * 0.01))
    out.append(ctl.tick(to(p), t=30.0))
    # and a tilted pose with its own path, then backtracking to the end
    p = _pose((0.2, -0.1, 0.4), (0.5, 0.2, 0.0))
    ctl.set_path(to(path[::-1].copy()))
    out.append(ctl.tick(to(p), t=31.0))
    return out


def test_follower_controller_modes_match_jax():
    got = _mode_sequence(tctl, _t, device="cpu")
    want = _mode_sequence(jctl, jnp.asarray)
    assert [s for _, _, s in got] == [s for _, _, s in want]
    assert [s for _, _, s in got][:5] == ["idle", "follow", "waiting",
                                          "force_through", "done"]
    assert got[-2][2] == "backtrack"
    np.testing.assert_allclose([c[:2] for c in got], [c[:2] for c in want],
                               atol=CMD_ATOL, rtol=0)


# ------------------------------------------------------------ the closed loop


def _hill(cfg):
    gx, gy = cfg.grid_coords()
    return (0.15 * np.exp(-((gx - 2.0) ** 2 + gy ** 2) / 3.0)).astype(
        np.float32)


def _shooting_bank(n_calls, n_trajs, n_steps, vel_max, omega_max, seed):
    """Front/back split constant controls (shooting_controls' recipe) for
    ``n_calls`` replans, made with numpy."""
    rng = np.random.default_rng(seed)
    h = n_trajs // 2
    bank = []
    for _ in range(n_calls):
        v = np.concatenate([rng.uniform(vel_max / 2, vel_max, h),
                            rng.uniform(-vel_max, -vel_max / 2, n_trajs - h)])
        w = rng.uniform(-omega_max, omega_max, n_trajs)
        c = np.stack([v, w], -1)[:, None, :].repeat(n_steps, axis=1)
        bank.append(c.astype(np.float32))
    return bank


def _feeder(bank, to):
    calls = iter(bank)

    def shooting_controls(key_or_generator, n_trajs, vel_max, omega_max,
                          time_horizon, dt):
        return to(next(calls)), None
    return shooting_controls


HILL_WAYPOINTS = np.asarray([[2.5, 1.0, 0.0]])


@pytest.fixture(scope="module")
def loops():
    """Both packages' navigate on tests/test_nav.py's hill with the same
    controls per replan; the JAX one compiled once here."""
    jcfg = JaxPhysicsConfig.for_planner("tradr")
    cfg = PhysicsConfig.for_planner("tradr")
    z = _hill(cfg)
    bank = _shooting_bank(80, 8, int(1.5 / cfg.dt), cfg.vel_max,
                          cfg.omega_max, seed=21)
    kw = dict(waypoints=HILL_WAYPOINTS, n_trajs=8, plan_horizon=1.5,
              max_time=25.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnav, "shooting_controls", _feeder(bank, jnp.asarray))
        mp.setattr(tnav, "shooting_controls", _feeder(bank, _t))
        jres = jnav.navigate(jcfg, jnp.asarray(z), **kw)
        tres = tnav.navigate(cfg, z, device="cpu", **kw)
    return jres, tres


def test_closed_loop_takes_the_jax_decisions(loops):
    jres, tres = loops
    assert jres.reached and tres.reached
    assert len(tres.times) == len(jres.times)
    assert len(tres.plans) == len(jres.plans) >= 2
    assert list(tres.statuses) == list(jres.statuses)
    assert [p[3] for p in tres.plans] == [p[3] for p in jres.plans]
    np.testing.assert_allclose(tres.times, jres.times, atol=1e-9)
    err = np.abs(tres.positions - jres.positions).max(axis=1)
    assert err.max() < POS_ATOL_M, (err.argmax(), err.max())
    np.testing.assert_allclose(tres.commands, jres.commands, atol=1e-3)
    # the plans are host copies
    t0, paths, costs, best = tres.plans[0]
    assert isinstance(paths, np.ndarray) and paths.shape == (8, 150, 3)
    assert isinstance(costs, np.ndarray) and isinstance(best, int)


def test_one_replan_matches_jax():
    """One replan from a moving, yawed state on the hill: the same controls
    through planner_rollout (tradr's planner preset with the friction grid
    navigate fills, B=16: mode pair), the force-variance cost and the
    route's arbitration; the same best path and truncation."""
    jcfg = JaxPhysicsConfig.for_planner("tradr")
    cfg = PhysicsConfig.for_planner("tradr")
    z = _hill(cfg)
    fr = np.full(z.shape, cfg.friction_coef, np.float32)
    ctr = _shooting_bank(1, 16, 60, cfg.vel_max, cfg.omega_max, seed=8)[0]
    R = _pose((0.0, 0.0, 0.6), (0, 0, 0))[:3, :3]
    x = np.array([[0.8, 0.3, 0.05]], np.float32)
    xd = np.array([[0.5, 0.3, 0.0]], np.float32)
    om = np.array([[0.0, 0.0, 0.2]], np.float32)
    B = 16
    rep = lambda a: np.repeat(a[None] if a.ndim == 2 and a.shape == (3, 3)
                              else a, B, axis=0)
    s_np = [rep(x), rep(xd), rep(R), rep(om)]
    with jax.disable_jit():
        js, jst = jax_planner_rollout(
            JaxRobotModel.from_config(jcfg), jnp.asarray(z), jnp.asarray(ctr),
            state0=JaxRigidState(*map(jnp.asarray, s_np)),
            friction=jnp.asarray(fr))
        jcost = jax_fv_cost(jst.spring_std)
        jx = np.asarray(js.x)
    ts, tst = planner_rollout(RobotModel.from_config(cfg, device="cpu"),
                              _t(z), _t(ctr), state0=RigidState(*map(_t, s_np)),
                              friction=_t(fr))
    tcost = force_variance_cost(tst.spring_std)
    assert float(np.sqrt(((ts.x.numpy() - jx) ** 2).mean())) < 1e-4
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), rtol=1e-3)
    for wps in ([[2.5, 1.0, 0.0]], [[1.2, 0.6, 0.0], [3.0, -1.0, 0.0]],
                [[6.0, 0.0, 0.0]]):
        got = tsel.WaypointRoute(wps).select(ts.x, tcost, x[0])
        want = jsel.WaypointRoute(wps).select(js.x, jcost, x[0])
        assert got == want


def test_port_closed_loop_navigation():
    """tests/test_nav.py::test_closed_loop_navigation's assertions on the
    port (its own generator's controls)."""
    cfg = PhysicsConfig.for_planner("tradr")
    res = tnav.navigate(cfg, _hill(cfg), waypoints=HILL_WAYPOINTS, n_trajs=8,
                        plan_horizon=1.5, max_time=25.0, device="cpu")
    assert res.reached, res.positions[-1]
    assert len(res.plans) >= 2
    assert np.isfinite(res.positions).all()
    steps = np.linalg.norm(np.diff(res.positions[:, :2], axis=0), axis=-1)
    assert steps.max() < cfg.vel_max * 0.1 * 1.5


def test_port_closed_loop_navigation_with_obstruction():
    """tests/test_nav.py::test_closed_loop_navigation_with_obstruction's
    scene and assertions on the port."""
    cfg = PhysicsConfig.for_planner("tradr")
    rng = np.random.default_rng(3)
    obstacles = (np.array([[1.1, 0.0, 0.1]], np.float32)
                 + rng.normal(scale=0.05, size=(30, 3)).astype(np.float32))
    ctl = tctl.FollowerController(tfol.FollowerParams(),
                                  force_through_after=0.5, device="cpu")
    res = tnav.navigate(cfg, np.zeros(cfg.grid_shape, np.float32),
                        waypoints=np.asarray([[2.8, 0.0, 0.0]]), n_trajs=8,
                        plan_horizon=1.5, max_time=30.0, obstacles=obstacles,
                        controller=ctl, device="cpu")
    assert "waiting" in res.statuses
    assert "force_through" in res.statuses
    assert res.statuses.index("waiting") < res.statuses.index("force_through")
    assert res.reached, (res.positions[-1], res.statuses[-5:])
    for i, s in enumerate(res.statuses):
        if s == "waiting":
            assert abs(res.commands[i][0]) < 1e-6
        if s == "force_through":
            assert abs(res.commands[i][0]) <= ctl.max_force_through_speed + 1e-6


# ------------------------------------------------------------ devices


def test_signatures_follow_jax_but_generator_and_device():
    """``navigate``: the JAX parameters with ``key`` replaced by
    ``generator`` and ``device`` added; ``FollowerController``: the JAX
    parameters plus ``device``; both default to ``cuda``."""
    j = list(inspect.signature(jnav.navigate).parameters)
    t = inspect.signature(tnav.navigate).parameters
    assert list(t) == [("generator" if p == "key" else p) for p in j] + [
        "device"]
    assert t["device"].default == "cuda" and t["generator"].default is None
    j = list(inspect.signature(jctl.FollowerController).parameters)
    t = inspect.signature(tctl.FollowerController).parameters
    assert list(t) == j + ["device"] and t["device"].default == "cuda"
    for mod in ("follower_step", "path_time_cost", "pose_clear"):
        src = tfol if mod == "follower_step" else tctl
        ref = jfol if mod == "follower_step" else jctl
        assert (list(inspect.signature(getattr(src, mod)).parameters)
                == list(inspect.signature(getattr(ref, mod)).parameters))


def test_entry_points_default_to_cuda():
    cfg = PhysicsConfig.for_planner("tradr")
    z = np.zeros(cfg.grid_shape, np.float32)
    if torch.cuda.is_available():
        assert tctl.FollowerController().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        tctl.FollowerController()
    with pytest.raises(RuntimeError):
        tnav.navigate(cfg, z, HILL_WAYPOINTS, max_time=0.1)


def test_mixed_devices_raise():
    """The meta device stands in for a second device: a tensor there is
    refused, never moved."""
    cfg = PhysicsConfig.for_planner("tradr")
    z = np.zeros(cfg.grid_shape, np.float32)
    meta = torch.zeros(cfg.grid_shape, device="meta")
    kw = dict(waypoints=HILL_WAYPOINTS, n_trajs=8, plan_horizon=0.2,
              max_time=0.1, device="cpu")
    with pytest.raises(ValueError):
        tnav.navigate(cfg, meta, **kw)
    with pytest.raises(ValueError):
        tnav.navigate(cfg, z, friction=meta, **kw)
    with pytest.raises(ValueError):
        tnav.navigate(cfg, z, obstacles=torch.zeros((4, 3), device="meta"),
                      **kw)
    with pytest.raises(ValueError):
        tnav.navigate(cfg, z, controller=tctl.FollowerController(
            device="meta"), **kw)
    ctl = tctl.FollowerController(device="cpu")
    with pytest.raises(ValueError):
        ctl.set_path(torch.zeros((5, 3), device="meta"))
    with pytest.raises(ValueError):
        ctl.tick(torch.eye(4, device="meta"), 0.0)
    # and the supervisor keeps what it is given on its own device
    ctl.set_path(np.zeros((5, 3)))
    assert ctl.path.device.type == "cpu" and ctl.path.dtype == torch.float32


# ------------------------------------------------------------ figures


def _pixels(path):
    from PIL import Image, ImageSequence
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def test_trajectory_figures_match_jax(loops, tmp_path):
    """vis.py's three trajectory plotters draw the same pixels from the
    port's tensors as the JAX package's from numpy arrays: the closed loop's
    first plan over the hill, its driven path in 3D, and an animation of a
    short rollout with contact points and forces."""
    from monoforce_tpu import vis as jvis
    from monoforce_tpu_torch import vis as tvis

    _, tres = loops
    cfg = PhysicsConfig.for_planner("tradr")
    z = _hill(cfg)
    _, paths, costs, best = tres.plans[0]
    for mod, to in ((tvis, _t), (jvis, np.asarray)):
        mod.plot_terrain_with_trajs(to(z), to(paths), to(costs), cfg.d_max,
                                    best=best,
                                    path=str(tmp_path / f"{mod is tvis}_a.png"))
        mod.plot_rollout_3d(to(z), to(tres.positions), cfg.d_max,
                            path=str(tmp_path / f"{mod is tvis}_b.png"))
    rng = np.random.default_rng(9)
    xs = np.cumsum(rng.uniform(0, 0.05, (20, 3)), axis=0).astype(np.float32)
    Rs = np.stack([_pose((0.0, 0.0, 0.1 * i), (0, 0, 0))[:3, :3]
                   for i in range(20)])
    pts = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32)
    forces = rng.normal(size=(20, 12, 3)).astype(np.float32)
    tvis.animate_rollout(_t(z), RigidState(_t(xs), None, _t(Rs), None),
                         robot_points=_t(pts), forces=_t(forces),
                         d_max=cfg.d_max, stride=10,
                         path=str(tmp_path / "True_c.gif"))
    jvis.animate_rollout(z, JaxRigidState(xs, None, Rs, None),
                         robot_points=pts, forces=forces, d_max=cfg.d_max,
                         stride=10, path=str(tmp_path / "False_c.gif"))
    for name in ("a.png", "b.png", "c.gif"):
        got, want = (_pixels(tmp_path / f"{k}_{name}") for k in (True, False))
        assert len(got) == len(want) >= 1
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), name
