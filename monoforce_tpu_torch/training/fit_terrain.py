"""Inverse physics: fit terrain elevation and friction to observed
trajectories by gradient descent through the rollout.

Port of ``monoforce_tpu/training/fit_terrain.py``; reference parity:
monoforce/scripts/fit_terrain.py:12-96.  Adam with separate learning rates
for the heightmap (0.02) and friction (0.01), the trajectory MSE
(``losses.physics_loss``) and optional total-variation regularization.

The gradient runs through :func:`~monoforce_tpu_torch.physics.fast.fast_rollout`,
whose every terrain lookup is the ``fk_interp`` kernel forward and its
backward kernel on the card.  Robots with flippers, and horizons of 256
steps or more (remat segments), take the exact engine
(:func:`~monoforce_tpu_torch.physics.engine.rollout`, plain PyTorch), as
in the JAX package (``_loss_fn``, fit_terrain.py:49-72).

PyTorch runs eagerly, so the JAX package's chunked programs become a loop
of steps whose losses stay on the device and are read back once per
``device_chunk`` steps: no step waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from monoforce_tpu_torch.losses import physics_loss, total_variation
from monoforce_tpu_torch.physics.engine import (RigidState, RobotModel,
                                                auto_remat_segment, on_device,
                                                rollout)

__all__ = ["fit_terrain", "terrain_fit_step", "make_optimizer",
           "TerrainParams"]


class TerrainParams(NamedTuple):
    z_grid: torch.Tensor    # (H, W) shared elevation estimate
    friction: torch.Tensor  # (H, W) shared friction estimate


def make_optimizer(lr_z: float = 0.02, lr_friction: float = 0.01):
    """Per-parameter-group Adam like the reference's parameter groups
    (fit_terrain.py:46-47), with optax's defaults: betas (0.9, 0.999) and
    eps 1e-8 outside the square root.  Returns a function that builds the
    ``torch.optim.Adam`` over a :class:`TerrainParams` of leaf tensors; the
    Adam object is the optimizer state."""
    def init(params: TerrainParams) -> torch.optim.Adam:
        return torch.optim.Adam(
            [{"params": [params.z_grid], "lr": lr_z},
             {"params": [params.friction], "lr": lr_friction}],
            betas=(0.9, 0.999), eps=1e-8)
    return init


def _loss_fn(params: TerrainParams, robot: RobotModel, controls, states_gt,
             pred_ts, gt_ts, state0, tv_weight: float, remat_segment=None):
    from monoforce_tpu_torch.physics.fast import fast_rollout

    B = controls.shape[0]
    zb = params.z_grid.expand((B,) + params.z_grid.shape)
    fb = params.friction.expand((B,) + params.friction.shape)
    if not robot.has_flippers and remat_segment is None:
        # the fast path: every terrain lookup a kernel on the card
        states, _ = fast_rollout(robot, zb, controls, state0=state0,
                                 friction=fb, with_stats=False)
    else:
        # fast_rollout has no remat: long horizons keep their
        # O(N/K + K) BPTT memory in the exact engine
        states, _, _ = rollout(robot, zb, controls, state0=state0,
                               friction=fb, return_forces=False,
                               remat_segment=remat_segment)
    loss = physics_loss([states.x], [states_gt[0]], pred_ts, gt_ts)
    if tv_weight > 0:
        loss = loss + tv_weight * total_variation(params.z_grid)
    return loss


def terrain_fit_step(params: TerrainParams, opt_state: torch.optim.Adam,
                     robot: RobotModel, controls, states_gt, pred_ts, gt_ts,
                     state0: Optional[RigidState], tv_weight: float = 0.0,
                     remat_segment=None):
    """One optimization step; returns (params, opt_state, loss).

    ``opt_state`` is the Adam that ``make_optimizer(...)(params)`` built;
    it carries its learning rates, so the JAX signature's ``optimizer``
    argument has no counterpart.  ``params``' tensors are updated in place
    and returned; ``loss`` is a 0-d tensor on the device.
    """
    opt_state.zero_grad(set_to_none=True)
    loss = _loss_fn(params, robot, controls, states_gt, pred_ts, gt_ts,
                    state0, tv_weight, remat_segment)
    loss.backward()
    opt_state.step()
    return params, opt_state, loss.detach()


def fit_terrain(cfg, controls, states_gt, pred_ts, gt_ts, state0=None,
                n_iters: int = 100, lr_z: float = 0.02,
                lr_friction: float = 0.01, friction_init: float = 0.5,
                tv_weight: float = 0.0, verbose: bool = False,
                device_chunk: int = 25, device="cuda"):
    """Optimize (z_grid, friction) to explain ground-truth trajectories.

    Args:
      cfg: PhysicsConfig.
      controls: (B, N, 2) control sequences driven during the demonstrations.
      states_gt: sequence whose first element is GT positions (B, T, 3).
      pred_ts / gt_ts: (B, N) / (B, T) timestamps for alignment.
      state0: optional initial RigidState with (B, ...) leaves.
      device_chunk: steps between reads of the losses by the host.  With
        ``verbose`` every step's loss is read and every tenth printed.
      device: where the fit runs; ``cuda`` unless the caller names another.

    Returns (TerrainParams, list of float losses).
    """
    robot = RobotModel.from_config(cfg, device=device)
    # O(N) BPTT memory is trivial at fit-terrain scales; only genuinely
    # long horizons take remat segments (and the exact engine)
    remat = auto_remat_segment(controls.shape[1], threshold=256)
    dev = robot.device
    params = TerrainParams(
        z_grid=torch.zeros(cfg.grid_shape, device=dev, requires_grad=True),
        friction=torch.full(cfg.grid_shape, friction_init, device=dev,
                            requires_grad=True))
    opt_state = make_optimizer(lr_z, lr_friction)(params)
    controls = on_device(controls, dev, "controls")
    states_gt = [on_device(s, dev, "states_gt") for s in states_gt]
    pred_ts = on_device(pred_ts, dev, "pred_ts")
    gt_ts = on_device(gt_ts, dev, "gt_ts")
    chunk = 1 if verbose else max(device_chunk, 1)
    losses, pending = [], []
    for it in range(n_iters):
        params, opt_state, loss = terrain_fit_step(
            params, opt_state, robot, controls, states_gt, pred_ts, gt_ts,
            state0, tv_weight, remat_segment=remat)
        pending.append(loss)
        if len(pending) == chunk or it == n_iters - 1:
            losses.extend(torch.stack(pending).tolist())
            pending = []
        if verbose and it % 10 == 0:
            print(f"iter {it}: loss {losses[-1]:.6f}")
    return TerrainParams(params.z_grid.detach(),
                         params.friction.detach()), losses
