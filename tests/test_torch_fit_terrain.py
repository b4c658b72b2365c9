"""The port's losses and terrain fitting against the JAX package.

Inputs are made with numpy from a seed.  The losses: the same values
within rtol 1e-6.  Terrain fitting: three ``terrain_fit_step``s from the
same initial ``TerrainParams`` (tradr, grid_res 0.4, B=2, N=16).  The JAX
reference is its fit step's own body (the value and gradient of
``_loss_fn``, the total-variation term, the optax Adam of
``make_optimizer``) under one ``jax.jit`` for both ``tv_weight`` cases:
compiling the JAX fit step for each case, or running it op by op, takes
~40 s a step on a CPU.  Bounds: losses within rtol 1e-4 and params within atol 1e-5
(Adam moves each touched cell by ~lr a step whatever its gradient's size,
so the params agree as far as the gradients' signs and ratios do).  The
exact-engine branch (marv, B=2, N=16; tradr, N=256 with remat segments)
is held the same way against the JAX package's exact branch of
``_loss_fn``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monoforce_tpu import losses as jlosses
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu_torch import losses
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.physics.engine import auto_remat_segment, rollout
from monoforce_tpu_torch.physics.fast import fast_rollout
from monoforce_tpu_torch.training import (TerrainParams, fit_terrain,
                                          make_optimizer, terrain_fit_step)

# the module (the package's name fit_terrain is the function)
jfit = importlib.import_module("monoforce_tpu.training.fit_terrain")

B, N = 2, 16


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(3, 20, 3)).astype(np.float32)
    gt = rng.normal(size=(3, 12, 3)).astype(np.float32)
    pred_ts = np.sort(rng.uniform(0, 1, (3, 20)), axis=1).astype(np.float32)
    gt_ts = np.sort(rng.uniform(0, 1, (3, 12)), axis=1).astype(np.float32)
    gt_ts[:, 0] = pred_ts[:, 0]  # an exact match, and ties broken alike
    q = rng.normal(size=(2, 3, 20, 4))
    R = np.stack([np.linalg.qr(m)[0] for m in
                  rng.normal(size=(60 + 36, 3, 3))]).astype(np.float32)
    Rp, Rg = R[:60].reshape(3, 20, 3, 3), R[60:].reshape(3, 12, 3, 3)
    hm_p = rng.normal(size=(2, 16, 16)).astype(np.float32)
    hm_g = rng.normal(size=(2, 16, 16)).astype(np.float32)
    hm_p[0, :3] = np.nan
    hm_g[1, 5:7] = np.nan
    w = rng.uniform(0, 1, hm_g.shape).astype(np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    pairs = [
        (losses.physics_loss([t(pred)], [t(gt)], t(pred_ts), t(gt_ts)),
         jlosses.physics_loss([j(pred)], [j(gt)], j(pred_ts), j(gt_ts))),
        (losses.physics_loss([t(pred), None, t(Rp)], [t(gt), None, t(Rg)],
                             t(pred_ts), t(gt_ts), rotation_loss=True)[1],
         jlosses.physics_loss([j(pred), None, j(Rp)], [j(gt), None, j(Rg)],
                              j(pred_ts), j(gt_ts), rotation_loss=True)[1]),
        (losses.total_variation(t(hm_g[0])),
         jlosses.total_variation(j(hm_g[0]))),
        (losses.hm_loss(t(hm_p), t(hm_g)), jlosses.hm_loss(j(hm_p), j(hm_g))),
        (losses.hm_loss(t(hm_p), t(hm_g), t(w), h_max=0.5),
         jlosses.hm_loss(j(hm_p), j(hm_g), j(w), h_max=0.5)),
        (losses.translation_difference(t(pred), t(pred[::-1].copy())),
         jlosses.translation_difference(j(pred), j(pred[::-1]))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(i))
    qn = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tt = np.linspace(0, 1, 7, dtype=np.float32)
    for q1, q2 in ((qn[0, 0, 0], qn[0, 0, 1]), (qn[0, 0, 0], qn[0, 0, 0])):
        np.testing.assert_allclose(
            losses.slerp(t(q1), t(q2), t(tt)).numpy(),
            np.asarray(jlosses.slerp(j(q1), j(q2), j(tt))), atol=1e-6)


@functools.lru_cache(maxsize=None)
def _fit_case():
    """Robots, controls and ground truth (the port's fast_rollout on a
    hill), and the JAX reference step, compiled once."""
    jcfg = JaxPhysicsConfig(robot="tradr", grid_res=0.4)
    jr = JaxRobotModel.from_config(jcfg)
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    rng = np.random.default_rng(1)
    ctr = np.stack([rng.uniform(0.3, 1.0, (B, N)),
                    rng.uniform(0.2, 0.8, (B, N))], axis=-1).astype(np.float32)
    gx, gy = jcfg.grid_coords()
    hill = (0.3 * np.exp(-((gx - 0.5) ** 2 + gy ** 2) / 2.0)).astype(
        np.float32)
    gt, _ = fast_rollout(tr, torch.from_numpy(hill), torch.from_numpy(ctr),
                         with_stats=False)
    ts = np.tile(np.arange(N, dtype=np.float32)[None] * 0.01, (B, 1))
    gt = gt.x.numpy()
    jopt = jfit.make_optimizer(0.02, 0.01)
    args = (jr, jnp.asarray(ctr), [jnp.asarray(gt)], jnp.asarray(ts),
            jnp.asarray(ts), None)

    @jax.jit
    def jax_step(params, opt_state, tv_weight):
        # terrain_fit_step's body, the total-variation term added outside
        # _loss_fn so that one program serves every tv_weight
        loss, grads = jax.value_and_grad(jfit._loss_fn)(params, *args, 0.0)
        tv, d_tv = jax.value_and_grad(jlosses.total_variation)(params.z_grid)
        loss = loss + tv_weight * tv
        grads = grads._replace(z_grid=grads.z_grid + tv_weight * d_tv)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jcfg, jopt, jax_step, tr, ctr, gt, ts


@pytest.mark.parametrize("tv_weight", [0.0, 0.1])
def test_three_fit_steps_match_jax(tv_weight):
    """From rough initial params: where two neighbours are equal, as on
    flat zeros, |a - b|'s gradient turns on the last bit of each Adam step
    and the two fits part at the second step."""
    jcfg, jopt, jax_step, tr, ctr, gt, ts = _fit_case()
    rng = np.random.default_rng(2)
    z0 = rng.normal(scale=0.05, size=jcfg.grid_shape).astype(np.float32)
    f0 = rng.uniform(0.4, 0.6, jcfg.grid_shape).astype(np.float32)
    jp = jfit.TerrainParams(jnp.asarray(z0), jnp.asarray(f0))
    jstate = jopt.init(jp)
    # copies: Adam updates the port's params in place
    tp = TerrainParams(torch.tensor(z0, requires_grad=True),
                       torch.tensor(f0, requires_grad=True))
    opt_state = make_optimizer(0.02, 0.01)(tp)
    args_t = (tr, torch.from_numpy(ctr), [torch.from_numpy(gt)],
              torch.from_numpy(ts), torch.from_numpy(ts), None)
    for step in range(3):
        jp, jstate, loss_j = jax_step(jp, jstate, tv_weight)
        tp, opt_state, loss_t = terrain_fit_step(tp, opt_state, *args_t,
                                                 tv_weight=tv_weight)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                   err_msg=f"step {step}")
    # three Adam steps of ~lr on the cells under the footprints
    assert np.abs(np.asarray(jp.z_grid) - z0).max() > 0.03
    for name in ("z_grid", "friction"):
        np.testing.assert_allclose(getattr(tp, name).detach().numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=1e-5, err_msg=name)


@functools.lru_cache(maxsize=None)
def _exact_case(case):
    """A fit that takes the exact engine: marv (flippers) over 16 steps, or
    tradr over 256 steps (remat segments of 16); ground truth from the
    port's exact rollout on a hill; the JAX reference step from
    ``_loss_fn``'s exact branch and the optax Adam, compiled once."""
    robot, n = ("marv", 16) if case == "flippers" else ("tradr", 256)
    jcfg = JaxPhysicsConfig(robot=robot, grid_res=0.4)
    jr = JaxRobotModel.from_config(jcfg)
    tr = robot_model_from_arrays(
        {k: np.asarray(getattr(jr, k)) for k in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    rng = np.random.default_rng(1)
    ctr = np.stack([rng.uniform(0.3, 1.0, (B, n)),
                    rng.uniform(0.2, 0.8, (B, n))], axis=-1).astype(np.float32)
    gx, gy = jcfg.grid_coords()
    hill = (0.3 * np.exp(-((gx - 0.5) ** 2 + gy ** 2) / 2.0)).astype(
        np.float32)
    gt, _, _ = rollout(tr, torch.from_numpy(hill).expand((B,) + hill.shape),
                       torch.from_numpy(ctr), return_forces=False)
    gt = gt.x.numpy()
    ts = np.tile(np.arange(n, dtype=np.float32)[None] * 0.01, (B, 1))
    remat = auto_remat_segment(n, threshold=256)
    jopt = jfit.make_optimizer(0.02, 0.01)
    args = (jr, jnp.asarray(ctr), [jnp.asarray(gt)], jnp.asarray(ts),
            jnp.asarray(ts), None, 0.0, remat)

    @jax.jit
    def jax_step(params, opt_state):
        loss, grads = jax.value_and_grad(jfit._loss_fn)(params, *args)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jcfg, jopt, jax_step, tr, ctr, gt, ts, remat


@pytest.mark.parametrize("case", ["flippers", "long_horizon"])
def test_exact_engine_branch_raises(case):
    """fit_terrain's exact-engine branch (robots with flippers, horizons of
    256 steps or more) no longer raises: three ``terrain_fit_step``s
    through the port's exact engine against the JAX package's exact
    branch, from rough initial params (same bounds as the fast path's),
    and ``fit_terrain``'s first loss from its flat start."""
    jcfg, jopt, jax_step, tr, ctr, gt, ts, remat = _exact_case(case)
    assert (remat is not None) == (case == "long_horizon")
    rng = np.random.default_rng(2)
    z0 = rng.normal(scale=0.05, size=jcfg.grid_shape).astype(np.float32)
    f0 = rng.uniform(0.4, 0.6, jcfg.grid_shape).astype(np.float32)
    jp = jfit.TerrainParams(jnp.asarray(z0), jnp.asarray(f0))
    jstate = jopt.init(jp)
    tp = TerrainParams(torch.tensor(z0, requires_grad=True),
                       torch.tensor(f0, requires_grad=True))
    opt_state = make_optimizer(0.02, 0.01)(tp)
    args_t = (tr, torch.from_numpy(ctr), [torch.from_numpy(gt)],
              torch.from_numpy(ts), torch.from_numpy(ts), None)
    for step in range(3):
        jp, jstate, loss_j = jax_step(jp, jstate)
        tp, opt_state, loss_t = terrain_fit_step(tp, opt_state, *args_t,
                                                 remat_segment=remat)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                   err_msg=f"step {step}")
    assert np.abs(np.asarray(jp.z_grid) - z0).max() > 0.03
    for name in ("z_grid", "friction"):
        np.testing.assert_allclose(getattr(tp, name).detach().numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    flat = jfit.TerrainParams(jnp.zeros(jcfg.grid_shape, jnp.float32),
                              jnp.full(jcfg.grid_shape, 0.5, jnp.float32))
    _, _, want = jax_step(flat, jopt.init(flat))
    _, got = fit_terrain(PhysicsConfig(robot=jcfg.robot, grid_res=0.4), ctr,
                         [gt], ts, ts, n_iters=1, device="cpu")
    np.testing.assert_allclose(got[0], float(want), rtol=1e-4)


def test_fit_terrain_reads_losses_per_chunk():
    """A short fit on the CPU: one float loss per step, finite, read back
    in chunks that need not divide the steps."""
    *_, ctr, gt, ts = _fit_case()
    params, got = fit_terrain(PhysicsConfig(robot="tradr", grid_res=0.4),
                              ctr, [gt], ts, ts, n_iters=3, device_chunk=2,
                              device="cpu")
    assert len(got) == 3 and all(np.isfinite(got))
    assert isinstance(got[0], float)
    assert not params.z_grid.requires_grad
    assert params.z_grid.shape == (32, 32)
