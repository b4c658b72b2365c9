"""The train step's losses and optimizer chain, plain.

Frozen copy of the port's ``training/trainer.py`` pieces that one train
step runs (``compute_losses`` and what it calls, ``GradientChain``), as
they stood when this benchmark was written, plus :func:`train_step`, the
body of the port's ``make_train_step``: forward and backward with TF32 off,
then zero non-finite, clip by global norm, L2 and Adam.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference.engine import (RigidState, RobotModel,
                                        auto_remat_segment, rollout)
from portbench.reference.losses import hm_loss, physics_loss
from portbench.reference.lss import LiftSplatShoot, float32_math

__all__ = ["GradientChain", "compute_losses", "train_step"]


def zero_non_finite(grads):
    """Zero NaN and +-inf gradient entries in place (the JAX chain's first
    stage: an inf entry would make the global norm inf, and the clip would
    then turn it into inf * 0 = NaN)."""
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)


def clip_by_global_norm_(grads, max_norm: float):
    """optax's ``clip_by_global_norm`` in place: where the global norm
    reaches ``max_norm`` every entry becomes ``(g / norm) * max_norm``,
    below it the gradients stay as they are.  Not ``clip_grad_norm_``,
    which divides by ``norm + 1e-6``.  No host synchronisation."""
    if not grads:
        return
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


class GradientChain:
    """zero non-finite -> clip by global norm -> L2 -> Adam(0.8, 0.999) ->
    -lr: ``trainer.make_optimizer``'s optax chain over a model's parameters
    (the last three stages are ``torch.optim.Adam(weight_decay=...)``)."""

    def __init__(self, params, lr: float, weight_decay: float,
                 max_grad_norm: float):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.8, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def stages(self) -> tuple:
        """(name, stage) in the order ``step`` runs them; each stage takes
        the list of gradients."""
        return (("zero_non_finite", zero_non_finite),
                ("clip_by_global_norm",
                 lambda grads: clip_by_global_norm_(grads,
                                                    self.max_grad_norm)),
                ("adam", lambda grads: self.adam.step()))

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        for _, stage in self.stages():
            stage(grads)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state_dict: dict):
        self.adam.load_state_dict(state_dict)



def avg_pool_grid(x, k: int):
    """(B, C, H, W) average pool by factor k (train.py:96-99 bridge)."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // k, k, W // k, k).mean(dim=(3, 5))


def _physics_states(robot: RobotModel, terrain: Dict, pose0, controls, k: int):
    """Predicted trajectories on the pooled predicted terrain
    (train.py:231-246), from the gravity-aligned initial pose at rest.
    ``bptt_grad_clip`` bounds the per-step backward signal through the
    stiff contact dynamics; remat segments bound BPTT memory."""
    z = avg_pool_grid(terrain["terrain"], k)[:, 0]
    friction = avg_pool_grid(terrain["friction"], k)[:, 0]
    x0 = pose0[:, :3, 3]
    R0 = pose0[:, :3, :3]
    state0 = RigidState(x0, torch.zeros_like(x0), R0, torch.zeros_like(x0))
    states, _, _ = rollout(robot, z, controls, state0=state0,
                           friction=friction, return_forces=False,
                           bptt_grad_clip=1e3,
                           remat_segment=auto_remat_segment(controls.shape[1]))
    return states


def compute_losses(model: LiftSplatShoot, robot: RobotModel, batch,
                   train: bool, generator: Optional[torch.Generator] = None,
                   geom_weight: float = 1.0, terrain_weight: float = 2.0,
                   phys_weight: float = 1.0, pool_k: int = 4):
    """The weighted loss of one batch (the 16-tuple of the ROUGH loader) and
    its parts.  ``train`` puts the model in train mode (BN batch
    statistics, drop-connect masks from ``generator``), else eval mode.
    Each loss is the batch's own mean.
    Returns (total, {"geom", "terrain", "phys", "total"})."""
    (imgs, rots, trans, intrins, post_rots, post_trans,
     hm_geom, hm_terrain, control_ts, controls, pose0,
     traj_ts, Xs, Xds, Rs, Omegas) = batch
    hm, phys = hm_loss, physics_loss
    model.train(train)
    terrain = model(imgs, rots, trans, intrins, post_rots, post_trans,
                    generator=generator)
    loss_geom = hm(terrain["geom"], hm_geom[:, 0:1], hm_geom[:, 1:2])
    loss_terrain = hm(terrain["terrain"], hm_terrain[:, 0:1],
                      hm_terrain[:, 1:2])
    if phys_weight > 0:
        states_pred = _physics_states(robot, terrain, pose0, controls, pool_k)
        loss_phys = phys([states_pred.x], [Xs], control_ts, traj_ts)
    else:
        loss_phys = torch.zeros((), device=loss_geom.device)
    total = (geom_weight * loss_geom + terrain_weight * loss_terrain
             + phys_weight * loss_phys)
    aux = {"geom": loss_geom, "terrain": loss_terrain, "phys": loss_phys,
           "total": total}
    return total, aux




def train_step(model: LiftSplatShoot, robot: RobotModel,
               optimizer: GradientChain, batch, generator,
               **weights) -> Dict[str, torch.Tensor]:
    """One train step in place (the port's ``make_train_step``); returns
    the losses as 0-d tensors.  The forward and backward run with TF32
    off."""
    optimizer.zero_grad()
    with float32_math():
        total, aux = compute_losses(model, robot, batch, True, generator,
                                    **weights)
        total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in aux.items()}
