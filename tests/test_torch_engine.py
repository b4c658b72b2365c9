"""The port's exact engine against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; the robots carry the JAX robot's
parameters bit for bit (``convert.robot_model_from_arrays``).  The JAX
functions run jitted (a rollout compiles in ~2 s on a CPU, where op by op
it runs ~20 s).  Bounds, all float32 rounding in another order:

- ``interpolate_grid``: within 1e-6 (the index path is the same IEEE
  divide and truncation, so every query lands in the same cell; on the
  rough grid used here a cell off would be off by ~0.1);
- ``integrate_rotation``, ``update_joints``: within 1e-6;
- ``forward_kinematics``, one step on rough terrain: within 1e-4 of each
  output's largest entry (forces ~1e2 N; the 3x3 inverse of the flippers'
  inertia in another LAPACK);
- whole rollouts on the smooth hill over 40 steps: positions and rotations
  within RMSE 1e-5, forces within 1e-4 of the peak (rough terrain would
  amplify the rounding, ROADMAP Queue 3);
- gradients of a rollout in z_grid and friction: within 1e-4 of the
  largest entry, against one jitted ``jax.value_and_grad`` (plain scan,
  BPTT clip at 1e-2, where it acts) shared by the remat cases: remat
  segments recompute the same values, so they change no gradient.
Controls turn (w != 0) so that no angular rate is exactly zero, where the
Rodrigues norm's derivative is infinite.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics import engine as jengine
from monoforce_tpu.physics.terrain import interpolate_grid as jax_interp
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.physics import DPhysics, engine
from monoforce_tpu_torch.physics.terrain import interpolate_grid

B, N = 3, 40
CLIP = 1e-2


def _robots(robot, **kw):
    jr = jengine.RobotModel.from_config(JaxPhysicsConfig(robot=robot, **kw))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


def _hill(cfg, rng=None, noise=0.0):
    gx, gy = cfg.grid_coords()
    z = 0.3 * np.exp(-((gx - 0.5) ** 2 + gy ** 2) / 2.0)
    if noise:
        z = z + noise * rng.normal(size=gx.shape)
    return z.astype(np.float32)


def _controls(rng, b=B, n=N):
    return np.stack([rng.uniform(-1.0, 1.0, (b, n)),
                     rng.choice([-1.0, 1.0], (b, n))
                     * rng.uniform(0.2, 1.0, (b, n))], axis=-1).astype(
        np.float32)


def _rotations(rng, b):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2).astype(np.float32)


def _flippers(b=B, n=N):
    t = np.arange(n, dtype=np.float32)[None, :, None] * 0.01
    phase = np.arange(4 * b, dtype=np.float32).reshape(b, 1, 4)
    return (0.4 * np.sin(3.0 * t + phase)).astype(np.float32)


def _close(got, want, rel, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


# --------------------------------------------------------------- terrain


def test_interpolate_grid_matches_jax():
    """Queries on and off a rough 16 x 16 grid (0.1 m cells, d_max 0.8):
    below -d_max (negative indices, truncated toward zero, then clamped),
    past +d_max, exactly on cell borders, and one grid per trajectory."""
    rng = np.random.default_rng(0)
    H, res, d_max = 16, 0.1, 0.8
    grids = rng.normal(scale=0.1, size=(2, H, H)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, (2, 2, 300)).astype(np.float32)
    borders = (-d_max + res * rng.integers(0, H, (2, 2, 40))).astype(np.float32)
    q[..., :40] = borders
    q[0, 0, 40:50] = rng.uniform(-0.9, -0.8, 10)   # index in (-1, 0): cell 0
    assert (q < -d_max).any() and (q > d_max).any()
    res_t, dmax_t = torch.tensor(res), torch.tensor(d_max)
    for b in range(2):
        want_z, want_n = jax_interp(jnp.asarray(grids[b]), jnp.asarray(q[b, 0]),
                                    jnp.asarray(q[b, 1]), d_max, res,
                                    return_normals=True)
        z, n = interpolate_grid(torch.from_numpy(grids[b]),
                                torch.from_numpy(q[b, 0]),
                                torch.from_numpy(q[b, 1]), dmax_t, res_t,
                                return_normals=True)
        np.testing.assert_allclose(z.numpy(), want_z, atol=1e-6, rtol=0)
        np.testing.assert_allclose(n.numpy(), want_n, atol=1e-6, rtol=0)
        mu = interpolate_grid(torch.from_numpy(grids[b]),
                              torch.from_numpy(q[b, 0]),
                              torch.from_numpy(q[b, 1]), dmax_t, res_t)
        np.testing.assert_array_equal(mu.numpy(), z.numpy())
    # a batch of grids: each trajectory reads its own
    zb, nb = interpolate_grid(torch.from_numpy(grids), torch.from_numpy(q[:, 0]),
                              torch.from_numpy(q[:, 1]), dmax_t, res_t,
                              return_normals=True)
    want_z, want_n = jax.vmap(functools.partial(
        jax_interp, d_max=d_max, grid_res=res, return_normals=True))(
        jnp.asarray(grids), jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))
    np.testing.assert_allclose(zb.numpy(), want_z, atol=1e-6, rtol=0)
    np.testing.assert_allclose(nb.numpy(), want_n, atol=1e-6, rtol=0)


def test_integrate_rotation_and_update_joints_match_jax():
    rng = np.random.default_rng(1)
    R = _rotations(rng, 6)
    omega = rng.normal(size=(6, 3)).astype(np.float32)
    omega[4] = 0.0            # the 1e-6 guard of the theta clip
    omega[5] = 1e-8
    want = jengine.integrate_rotation(jnp.asarray(R), jnp.asarray(omega), 0.01)
    got = engine.integrate_rotation(torch.from_numpy(R),
                                    torch.from_numpy(omega), 0.01)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), R[4])

    jr, tr = _robots("marv")
    angles = rng.uniform(-1.0, 1.0, (5, 4)).astype(np.float32)
    angles[0] = 0.0
    want = jax.vmap(lambda a: jengine.update_joints(jr, a))(jnp.asarray(angles))
    got = engine.update_joints(tr, torch.from_numpy(angles))
    assert got.shape == (5,) + tuple(tr.points.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), tr.points.numpy(), atol=1e-7,
                               rtol=0)
    assert np.abs(got[1].numpy() - tr.points.numpy()).max() > 0.05
    _, tradr = _robots("tradr")
    assert engine.update_joints(tradr, torch.from_numpy(angles)) is tradr.points


@pytest.mark.parametrize("robot", ["tradr", "marv"])
def test_forward_kinematics_matches_jax(robot):
    """One step of B=8 tilted, moving bodies near the terrain on rough
    terrain (0.05 m noise a cell) and a rough friction grid; marv with
    random flipper angles."""
    jr, tr = _robots(robot)
    cfg = JaxPhysicsConfig(robot=robot)
    rng = np.random.default_rng(2)
    b = 8
    z = _hill(cfg, rng, noise=0.05)
    zb = np.broadcast_to(z, (b,) + z.shape).copy()
    fb = rng.uniform(0.3, 1.0, zb.shape).astype(np.float32)
    x = np.zeros((b, 3), np.float32)
    x[:, :2] = rng.uniform(-3.0, 3.0, (b, 2))
    ij = ((x[:, :2] + cfg.d_max) / cfg.grid_res).astype(int)
    x[:, 2] = z[ij[:, 0], ij[:, 1]] + rng.uniform(-0.05, 0.1, b)
    xd = rng.uniform(-1.0, 1.0, (b, 3)).astype(np.float32)
    R = _rotations(rng, b)
    omega = rng.uniform(-1.0, 1.0, (b, 3)).astype(np.float32)
    ctrl = _controls(rng, b, 1)[:, 0]
    ja = rng.uniform(-0.8, 0.8, (b, 4)).astype(np.float32)
    state = (x, xd, R, omega)
    fk = jax.jit(jax.vmap(functools.partial(jengine.forward_kinematics, jr)))
    (_, jxdd, jomd), (jfs, jff) = fk(
        jnp.asarray(zb), jnp.asarray(fb),
        jengine.RigidState(*map(jnp.asarray, state)), jnp.asarray(ctrl),
        jnp.asarray(ja))
    (txd, txdd, tomd), (tfs, tff) = engine.forward_kinematics(
        tr, torch.from_numpy(zb), torch.from_numpy(fb),
        engine.RigidState(*map(torch.from_numpy, state)),
        torch.from_numpy(ctrl), torch.from_numpy(ja))
    assert np.abs(np.asarray(jfs)).max() > 10.0       # in contact
    assert np.array_equal(txd.numpy(), xd)
    for name, got, want in (("xdd", txdd, jxdd), ("omega_d", tomd, jomd),
                            ("F_spring", tfs, jfs), ("F_friction", tff, jff)):
        _close(got, want, 1e-4, name)


def _case_inputs(seed=3):
    cfg = JaxPhysicsConfig(robot="tradr", grid_res=0.4)
    rng = np.random.default_rng(seed)
    z = _hill(cfg)
    zb = np.broadcast_to(z, (B,) + z.shape).copy()
    fb = rng.uniform(0.5, 1.0, zb.shape).astype(np.float32)
    return zb, fb, _controls(rng)


ROLLOUTS = {"euler": ("tradr", {}), "rk4": ("tradr",
                                             {"integration_mode": "rk4"}),
            "odeint": ("tradr", {}), "marv_flippers": ("marv", {})}


@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_rollout_matches_jax(case):
    """B=3 x 40 steps on the smooth hill (grid 0.4 m) with a friction grid:
    the semi-implicit rollout (euler, rk4, marv with moving flippers) and
    the reference's odeint integrator."""
    robot, kw = ROLLOUTS[case]
    jr, tr = _robots(robot, grid_res=0.4, **kw)
    zb, fb, ctr = _case_inputs()
    ja = _flippers() if case == "marv_flippers" else None
    j = {k: None if v is None else jnp.asarray(v)
         for k, v in dict(z=zb, f=fb, c=ctr, ja=ja).items()}
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(z=zb, f=fb, c=ctr, ja=ja).items()}
    if case == "odeint":
        dt = 0.4 / (N - 1)
        js, jf = jengine.rollout_odeint(jr, j["z"], j["c"], friction=j["f"],
                                        dt=dt)
        ts, tf = engine.rollout_odeint(tr, t["z"], t["c"], friction=t["f"],
                                       dt=dt)
    else:
        js, jf, _ = jengine.rollout(jr, j["z"], j["c"], joint_angles=j["ja"],
                                    friction=j["f"])
        ts, tf, _ = engine.rollout(tr, t["z"], t["c"], joint_angles=t["ja"],
                                   friction=t["f"])
    assert ts.x.shape == (B, N, 3) and tf[0].shape == (B, N) + tuple(
        tr.points.shape)
    for name in ("x", "R", "xd", "omega"):
        got, want = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        rmse = float(np.sqrt(np.mean((got - want) ** 2)))
        assert rmse < 1e-5, (name, rmse)
    peak = float(np.abs(np.asarray(jf[0])).max())
    for got, want in zip(tf, jf):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * peak)
    if case == "marv_flippers":   # the flippers moved the body
        still, _, _ = engine.rollout(tr, t["z"], t["c"], friction=t["f"])
        assert float((still.x - ts.x).abs().max()) > 1e-3
    if case == "euler":           # rollout_single is rollout on a batch of 1
        s0 = engine._default_state0(t["c"])
        one, forces, _ = engine.rollout_single(
            tr, t["z"][1], t["f"][1], t["c"][1], torch.zeros((N, 4)),
            engine.RigidState(*(v[1] for v in s0)))
        # one body, so the same operations; only the last bit may differ,
        # where a kernel rounds by the batch's shape: on the CPU the
        # vectorised contact sigmoid computes the tail of a row alone in
        # its scalar path and inside the batch in its vector one (one ulp
        # of the sigmoid, two of a force entry)
        for k in range(4):
            np.testing.assert_allclose(one[k].numpy(), ts[k][1].numpy(),
                                       rtol=0, atol=1e-6, err_msg=str(k))
        for a, c in zip(forces, tf):
            np.testing.assert_allclose(a.numpy(), c[1].numpy(), rtol=0,
                                       atol=1e-6 * float(c[1].abs().max()))


@functools.lru_cache(maxsize=None)
def _jax_gradient():
    """d loss / d (z_grid, friction) of the JAX rollout with the BPTT clip
    at CLIP and no remat, jitted once for every case of the file."""
    jr, _ = _robots("tradr", grid_res=0.4)
    zb, fb, ctr = _case_inputs(seed=4)
    zb = zb + np.random.default_rng(5).normal(scale=0.02, size=zb.shape).astype(
        np.float32)

    def loss(z, f):
        s, _, _ = jengine.rollout(jr, z, jnp.asarray(ctr[:, :20]), friction=f,
                                  return_forces=False, bptt_grad_clip=CLIP)
        return jnp.mean(s.x[..., 2] ** 2) + jnp.mean(s.x[..., :2] ** 2)

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(zb), jnp.asarray(fb))
    return zb, fb, ctr[:, :20], float(val), [np.asarray(g) for g in grads]


def _port_gradient(zb, fb, ctr, clip, remat):
    _, tr = _robots("tradr", grid_res=0.4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (zb, fb)]
    s, _, _ = engine.rollout(tr, leaves[0], torch.from_numpy(ctr),
                             friction=leaves[1], return_forces=False,
                             bptt_grad_clip=clip, remat_segment=remat)
    loss = (s.x[..., 2] ** 2).mean() + (s.x[..., :2] ** 2).mean()
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", [None, 5, 10])
def test_rollout_gradient_matches_jax(remat):
    """20 steps on the hill with 0.02 m noise, the clip acting (a rollout
    without it has other gradients); remat segments of 5 and 10 steps
    under ``torch.utils.checkpoint`` give the plain scan's gradient."""
    zb, fb, ctr, want_val, want = _jax_gradient()
    val, got = _port_gradient(zb, fb, ctr, CLIP, remat)
    np.testing.assert_allclose(val, want_val, rtol=1e-5)
    for name, g, w in zip(("z_grid", "friction"), got, want):
        assert np.abs(w).max() > 0, name
        _close(g, w, 1e-4, name)
    _, unclipped = _port_gradient(zb, fb, ctr, None, remat)
    assert float((unclipped[0] - got[0]).abs().max()) > 0.1 * np.abs(want[0]).max()


def test_remat_segment_must_divide_the_horizon():
    zb, fb, ctr = _case_inputs()
    _, tr = _robots("tradr", grid_res=0.4)
    with pytest.raises(ValueError, match="must divide"):
        engine.rollout(tr, torch.from_numpy(zb), torch.from_numpy(ctr),
                       remat_segment=7)


def test_dphysics_matches_jax():
    """``DPhysics`` truncates to ``n_sim_steps``; with ``use_odeint`` it
    takes the linspace step T / (n - 1) and refuses ``extras_fn``; the
    euler branch returns the extras stacked over the steps."""
    from monoforce_tpu.physics.engine import DPhysics as JaxDPhysics

    kw = dict(robot="tradr", grid_res=0.4, traj_sim_time=0.3)
    zb, fb, ctr = _case_inputs(seed=6)      # 40 controls, 30 steps used

    def extras(state, forces):
        return state.x[..., 2], forces[0].sum(-2)

    for odeint in (True, False):
        jeng = JaxDPhysics(JaxPhysicsConfig(use_odeint=odeint, **kw))
        teng = DPhysics(PhysicsConfig(use_odeint=odeint, **kw), device="cpu")
        want = jeng(jnp.asarray(zb), jnp.asarray(ctr), friction=jnp.asarray(fb),
                    extras_fn=None if odeint else extras)
        got = teng(torch.from_numpy(zb), torch.from_numpy(ctr),
                   friction=torch.from_numpy(fb),
                   extras_fn=None if odeint else extras)
        assert got[0].x.shape == (B, 30, 3)
        _close(got[0].x, want[0].x, 1e-5, f"x odeint={odeint}")
        _close(got[1][0], want[1][0], 1e-4, f"F_spring odeint={odeint}")
        if not odeint:
            for g, w in zip(got[2], want[2]):
                _close(g, w, 1e-4, "extras")
    with pytest.raises(ValueError, match="extras_fn"):
        teng = DPhysics(PhysicsConfig(use_odeint=True, **kw), device="cpu")
        teng(torch.from_numpy(zb), torch.from_numpy(ctr), extras_fn=extras)
