"""End-to-end trainer: terrain encoder + differentiable-physics loss.

Port of ``monoforce_tpu/training/trainer.py``; reference parity:
monoforce/scripts/train.py --

- losses: geom/terrain heightmap MSE against the 2-channel (height, mask)
  labels (train.py:389,395) + the trajectory physics loss through the exact
  engine's rollout (train.py:399-406), weighted geom 1.0, terrain 2.0,
  phys 1.0 (train.py:34-36),
- the physics runs on 4x avg-pooled grids (0.1 m -> 0.4 m, train.py:96-99)
  with the ground-truth controls and the gravity-aligned initial pose
  (train.py:231-246), remat segments over long horizons and the BPTT
  gradient clip,
- zero NaN/inf gradient entries, clip to global norm 1.0, L2 1e-7, Adam
  (0.8, 0.999) (train.py:151,167,374-375),
- NaN-loss guard -> emergency checkpoint + raise (train.py:161-163),
- best-train / best-val checkpoints (train.py:199-226), saved as torch
  ``state_dict``s under the reference's names.

PyTorch is eager and stateful, so a train step updates the model's
parameters and its BN running statistics in place; the stochastic-depth
masks come from the trainer's own ``torch.Generator``, seeded from its
seed, where the JAX trainer splits ``PRNGKey(seed)``.  A train step keeps
TF32 off over the forward and the backward (cuDNN's backward convolutions
default to TF32, and ``loss.backward()`` runs outside the encoder's own
``float32_math``).  Entry points run on ``cuda`` unless the caller names
another device.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.losses import hm_loss, physics_loss
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.models.terrain_encoder.lss import float32_math
from monoforce_tpu_torch.physics.engine import (RigidState, RobotModel,
                                                auto_remat_segment, rollout)

__all__ = ["Trainer", "make_train_step", "make_optimizer", "avg_pool_grid",
           "compute_losses", "zero_non_finite", "clip_by_global_norm_",
           "read_state_dict"]


def read_state_dict(path: str) -> dict:
    """The encoder's state_dict from a checkpoint file: a ``.pth``/``.pt``
    state_dict (the ``Trainer``'s, or a reference checkpoint under the same
    names) or a ``full`` checkpoint's ``model`` entry."""
    stored = torch.load(path, map_location="cpu")
    if isinstance(stored, dict) and isinstance(stored.get("model"), dict):
        return stored["model"]
    return stored


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

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        zero_non_finite(grads)
        clip_by_global_norm_(grads, self.max_grad_norm)
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state_dict: dict):
        self.adam.load_state_dict(state_dict)


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-7,
                   max_grad_norm: float = 1.0):
    """zero-non-finite -> clip 1.0 -> L2 1e-7 -> Adam(0.8, 0.999) (reference
    train.py:151,374-375; zeroing non-finite entries is the JAX package's
    guard against stray overflow in the stiff-contact BPTT).  Returns a
    function that builds the :class:`GradientChain` over parameters."""
    def init(params) -> GradientChain:
        return GradientChain(params, lr, weight_decay, max_grad_norm)
    return init


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
    Returns (total, {"geom", "terrain", "phys", "total"})."""
    (imgs, rots, trans, intrins, post_rots, post_trans,
     hm_geom, hm_terrain, control_ts, controls, pose0,
     traj_ts, Xs, Xds, Rs, Omegas) = batch
    model.train(train)
    terrain = model(imgs, rots, trans, intrins, post_rots, post_trans,
                    generator=generator)
    loss_geom = hm_loss(terrain["geom"], hm_geom[:, 0:1], hm_geom[:, 1:2])
    loss_terrain = hm_loss(terrain["terrain"], hm_terrain[:, 0:1],
                           hm_terrain[:, 1:2])
    if phys_weight > 0:
        states_pred = _physics_states(robot, terrain, pose0, controls, pool_k)
        loss_phys = physics_loss([states_pred.x], [Xs], control_ts, traj_ts)
    else:
        loss_phys = torch.zeros((), device=loss_geom.device)
    total = (geom_weight * loss_geom + terrain_weight * loss_terrain
             + phys_weight * loss_phys)
    aux = {"geom": loss_geom, "terrain": loss_terrain, "phys": loss_phys,
           "total": total}
    return total, aux


def make_train_step(model: LiftSplatShoot, robot: RobotModel,
                    optimizer: GradientChain, geom_weight: float = 1.0,
                    terrain_weight: float = 2.0, phys_weight: float = 1.0,
                    pool_k: int = 4):
    """Train and eval steps closed over the model and its optimizer.

    ``train_step(batch, generator)`` updates the model's parameters and BN
    statistics in place and returns the losses as 0-d tensors on the
    device; ``eval_step(batch)`` returns the eval-mode losses."""
    weights = dict(geom_weight=geom_weight, terrain_weight=terrain_weight,
                   phys_weight=phys_weight, pool_k=pool_k)

    def train_step(batch, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        # TF32 stays off over the backward too
        with float32_math():
            total, aux = compute_losses(model, robot, batch, True, generator,
                                        **weights)
            total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def eval_step(batch):
        with torch.no_grad(), float32_math():
            _, aux = compute_losses(model, robot, batch, False, **weights)
        return aux

    return train_step, eval_step


class Trainer:
    """Training loop with metrics logging, NaN guard and best checkpoints."""

    def __init__(self, dphys_cfg: Optional[PhysicsConfig] = None,
                 lss_cfg: Optional[LSSConfig] = None,
                 lr: float = 1e-4, geom_weight: float = 1.0,
                 terrain_weight: float = 2.0, phys_weight: float = 1.0,
                 log_dir: str = "runs/lss",
                 pretrained: Optional[str] = None, device="cuda",
                 drop_connect_rate: float = 0.2):
        """``pretrained``: a ``.pth``/``.pt`` state_dict overlaid onto the
        fresh weights by ``init_state`` (a partial load).
        ``drop_connect_rate``: the B0 trunk's stochastic depth."""
        self.dphys_cfg = dphys_cfg or PhysicsConfig(robot="marv", grid_res=0.4)
        self.lss_cfg = lss_cfg or LSSConfig()
        self.robot = RobotModel.from_config(self.dphys_cfg, device=device)
        self.device = self.robot.device
        self.model = LiftSplatShoot(
            self.lss_cfg.grid_conf, self.lss_cfg.data_aug_conf,
            outC=self.lss_cfg.outC, camC=self.lss_cfg.camC,
            downsample=self.lss_cfg.downsample,
            drop_connect_rate=drop_connect_rate).to(self.device)
        self.lr = lr
        self.weights = dict(geom_weight=geom_weight,
                            terrain_weight=terrain_weight,
                            phys_weight=phys_weight)
        enc_res = self.lss_cfg.grid_conf["xbound"][2]
        self.pool_k = int(round(self.dphys_cfg.grid_res / enc_res))
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.min_train_loss = np.inf
        self.min_val_loss = np.inf
        self.optimizer: Optional[GradientChain] = None
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self._pretrained = pretrained

    # ------------------------------------------------------------------ setup
    def init_state(self, example_batch=None, seed: int = 0) -> dict:
        """Seeded weights (``LiftSplatShoot.init_weights`` from a CPU
        generator, as ``MonoForce.init_params``), the pretrained overlay if
        one was given, a fresh optimizer, and the drop-connect generator
        seeded from ``seed``.  ``example_batch`` is not needed (the JAX
        package traces its shapes from it).  Returns the state_dict."""
        self.model.init_weights(torch.Generator().manual_seed(seed))
        if self._pretrained:
            self.load_pretrained(self._pretrained)
        self.optimizer = make_optimizer(lr=self.lr)(self.model.parameters())
        self.train_step, self.eval_step = make_train_step(
            self.model, self.robot, self.optimizer, pool_k=self.pool_k,
            **self.weights)
        self.generator.manual_seed(seed)
        self.step = 0
        return self.model.state_dict()

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, name: str, full: bool = False) -> str:
        """``<log_dir>/<name>.pth``: the model's state_dict (the reference's
        checkpoint, train.py:204); with ``full``, ``<name>.pt`` also holds
        the optimizer state, the step and the generator for an exact
        resume.  Returns the path."""
        sd = self.model.state_dict()
        if not full:
            path = os.path.join(self.log_dir, name + ".pth")
            torch.save(sd, path)
            return path
        path = os.path.join(self.log_dir, name + ".pt")
        torch.save({"model": sd, "optimizer": self.optimizer.state_dict(),
                    "step": self.step,
                    "generator": self.generator.get_state()}, path)
        return path

    def resume(self, name: str) -> dict:
        """Restore a ``full`` checkpoint into the live model, optimizer,
        step and generator."""
        assert self.optimizer is not None, "call init_state first"
        ckpt = torch.load(os.path.join(self.log_dir, name + ".pt"),
                          map_location="cpu")
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step"])
        self.generator.set_state(ckpt["generator"])
        return self.model.state_dict()

    def load_pretrained(self, path: str) -> dict:
        """Partial load: overlay the stored entries onto the model's current
        (fresh) weights, for the keys the model has (the reference's
        dict-update ``from_pretrained``, lss.py:293-302).  Takes a
        ``.pth``/``.pt`` state_dict, or a ``full`` checkpoint's model.
        Returns the state_dict."""
        merged = _overlay(self.model.state_dict(), read_state_dict(path))
        self.model.load_state_dict(merged)
        return self.model.state_dict()

    # ---------------------------------------------------------------- logging
    def log_metrics(self, split: str, metrics: Dict[str, float], step: int):
        rec = {"step": step, "split": split, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------ loops
    def _batch(self, batch):
        return tuple(torch.as_tensor(b, dtype=torch.float32).to(self.device)
                     for b in batch)

    def epoch(self, loader, train: bool = True,
              generator: Optional[torch.Generator] = None, step0: int = 0):
        """One pass over ``loader`` (any iterable of the 16-tuple batch);
        train steps draw their masks from ``generator`` (the trainer's own
        if None).  Returns (mean losses, step)."""
        assert self.optimizer is not None, "call init_state first"
        gen = self.generator if generator is None else generator
        sums, count, step = {}, 0, step0
        for batch in loader:
            batch = self._batch(batch)
            self._last_batch = batch
            if train:
                aux = self.train_step(batch, gen)
                self.step += 1
            else:
                aux = self.eval_step(batch)
            vals = dict(zip(aux, torch.stack(list(aux.values())).tolist()))
            if math.isnan(vals["total"]):
                # emergency checkpoint, then fail loudly (train.py:161-163)
                self.save_checkpoint("nan_emergency")
                raise ValueError("Loss is NaN")
            for k, v in vals.items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            step += 1
            self.log_metrics("train" if train else "val",
                             {f"iter_loss_{k}": v for k, v in vals.items()},
                             step)
        return ({k: v / max(count, 1) for k, v in sums.items()}, step)

    @torch.no_grad()
    def log_prediction_figure(self, batch, tag: str) -> str:
        """Save the per-epoch prediction figure (the reference logs one to
        TensorBoard each epoch, train.py:207-226): predicted and label
        heightmaps, friction, and the predicted-vs-GT trajectory."""
        from monoforce_tpu_torch import vis
        (imgs, rots, trans, intrins, post_rots, post_trans,
         hm_geom, hm_terrain, control_ts, controls, pose0,
         traj_ts, Xs, *_rest) = batch
        self.model.eval()
        with float32_math():
            terrain = self.model(imgs, rots, trans, intrins, post_rots,
                                 post_trans)
            states = _physics_states(self.robot, terrain, pose0, controls,
                                     self.pool_k)
        figs_dir = os.path.join(self.log_dir, "figures")
        os.makedirs(figs_dir, exist_ok=True)
        path = os.path.join(figs_dir, f"prediction_{tag}.png")
        return vis.save_prediction_figure(
            terrain, hm_geom[0, 0:1], hm_terrain[0, 0:1], states.x[0], Xs[0],
            d_max=float(self.dphys_cfg.d_max), path=path)

    def train(self, train_loader, val_loader, n_epochs: int = 1, seed: int = 0,
              save_figures: bool = True):
        """``n_epochs`` of training and validation, with the best-train and
        best-val checkpoints and a prediction figure per epoch.  The
        drop-connect generator is seeded from ``seed``."""
        self.generator.manual_seed(seed)
        tr_step = va_step = 0
        history = []
        for e in range(n_epochs):
            train_losses, tr_step = self.epoch(train_loader, True, None,
                                               tr_step)
            self.log_metrics("train", {f"epoch_loss_{k}": v
                                       for k, v in train_losses.items()}, e)
            if train_losses["total"] < self.min_train_loss:
                self.min_train_loss = train_losses["total"]
                self.save_checkpoint("train_best")
            val_losses, va_step = self.epoch(val_loader, False, None, va_step)
            self.log_metrics("val", {f"epoch_loss_{k}": v
                                     for k, v in val_losses.items()}, e)
            if val_losses["total"] < self.min_val_loss:
                self.min_val_loss = val_losses["total"]
                self.save_checkpoint("val_best")
            if save_figures and getattr(self, "_last_batch", None) is not None:
                self.log_prediction_figure(self._last_batch, f"epoch_{e}")
            history.append({"train": train_losses, "val": val_losses})
        return history


def _overlay(base, stored):
    """Recursively overlay stored entries onto a fresh tree for the keys it
    has (partial load)."""
    if not isinstance(base, dict) or not isinstance(stored, dict):
        return stored if stored is not None else base
    out = dict(base)
    for k, v in stored.items():
        if k in out:
            out[k] = _overlay(out[k], v)
    return out
