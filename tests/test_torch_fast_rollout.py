"""The port's differentiable rollout (``fast_rollout``) against the JAX
package's, forward and gradient.

Inputs are made with numpy from a seed.  The JAX function runs on the CPU
with jit disabled (the same code op by op); the port's runs its plain
versions on the CPU.  B=4 and N=40 cross five 8-step window refreshes.
Bounds: position RMSE < 1e-4 m and spring_std within rtol 1e-4 (float32
sums in another order, amplified over 40 steps), the gradients within
1e-3 of the largest entry.  Controls turn (w != 0) so that no angular rate
is exactly zero, where sqrt's derivative is infinite in both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu.physics.fast import fast_rollout as jax_fast_rollout
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.physics.fast import fast_rollout

B, N = 4, 40


def _robots(robot, **kw):
    jr = JaxRobotModel.from_config(JaxPhysicsConfig(robot=robot, **kw))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


def _inputs(seed, n=N):
    """Hill plus noise, friction in the JAX tests' range, turning controls."""
    rng = np.random.default_rng(seed)
    gx, gy = JaxPhysicsConfig().grid_coords()
    z = (0.35 * np.exp(-((gx - 1.0) ** 2 / 2.0 + gy ** 2 / 3.0))
         + 0.05 * rng.normal(size=gx.shape)).astype(np.float32)
    fr = rng.uniform(0.4, 1.0, gx.shape).astype(np.float32)
    ctr = np.stack([rng.uniform(-1.0, 1.0, (B, n)),
                    rng.choice([-1.0, 1.0], (B, n))
                    * rng.uniform(0.2, 1.0, (B, n))], axis=-1)
    return z, fr, ctr.astype(np.float32)


CASES = {
    "tradr_euler": ("tradr", {}),
    "tradr_rk4": ("tradr", {"integration_mode": "rk4"}),
    "husky": ("husky", {"mesh_voxel_size": 0.1}),
    "marv_flippers": ("marv", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fast_rollout_matches_jax(case):
    robot, kw = CASES[case]
    jr, tr = _robots(robot, **kw)
    z, fr, ctr = _inputs(seed=3)
    ja = None
    if case == "marv_flippers":
        t = np.arange(N, dtype=np.float32)[None, :, None] * 0.01
        phase = np.arange(4 * B, dtype=np.float32).reshape(B, 1, 4)
        ja = (0.4 * np.sin(3.0 * t + phase)).astype(np.float32)
    with jax.disable_jit():
        js, jst = jax_fast_rollout(
            jr, jnp.asarray(z), jnp.asarray(ctr), friction=jnp.asarray(fr),
            joint_angles=None if ja is None else jnp.asarray(ja))
        jx, jstd = np.asarray(js.x), np.asarray(jst.spring_std)
    ts, tst = fast_rollout(tr, torch.from_numpy(z), torch.from_numpy(ctr),
                           friction=torch.from_numpy(fr),
                           joint_angles=None if ja is None
                           else torch.from_numpy(ja))
    assert ts.x.shape == (B, N, 3) and ts.R.shape == (B, N, 3, 3)
    rmse = float(np.sqrt(np.mean((ts.x.numpy() - jx) ** 2)))
    assert rmse < 1e-4, rmse
    np.testing.assert_allclose(tst.spring_std.numpy(), jstd, rtol=1e-4)
    np.testing.assert_allclose(tst.abs_pitch.numpy(),
                               np.asarray(jst.abs_pitch), atol=1e-4)
    if ja is not None:  # the flippers moved the contact points
        with jax.disable_jit():
            still, _ = jax_fast_rollout(jr, jnp.asarray(z), jnp.asarray(ctr),
                                        friction=jnp.asarray(fr))
        assert np.abs(np.asarray(still.x) - jx).max() > 1e-3


def test_fast_rollout_gradient_matches_jax():
    """d mean(z^2) / d (z_grid, friction) through every step's fk_interp,
    against jax.grad (tradr, B=4, per-trajectory grids).  N=9 crosses one
    window refresh; JAX's gradient op by op costs ~2.5 s a step on a CPU."""
    jr, tr = _robots("tradr")
    z, fr, ctr = _inputs(seed=4, n=9)
    zb = np.broadcast_to(z, (B,) + z.shape).copy()
    fb = np.broadcast_to(fr, (B,) + fr.shape).copy()

    def jloss(zg, f):
        s, _ = jax_fast_rollout(jr, zg, jnp.asarray(ctr), friction=f,
                                with_stats=False)
        return jnp.mean(s.x[..., 2] ** 2)

    with jax.disable_jit():
        want = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(zb), jnp.asarray(fb))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (zb, fb)]
    s, _ = fast_rollout(tr, leaves[0], torch.from_numpy(ctr),
                        friction=leaves[1], with_stats=False)
    got = torch.autograd.grad((s.x[..., 2] ** 2).mean(), leaves)
    for name, g, w in zip(("z_grid", "friction"), got, want):
        scale = np.abs(w).max()
        assert scale > 0, name
        assert (g.numpy() != 0).sum() == (w != 0).sum(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)
