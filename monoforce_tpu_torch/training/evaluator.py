"""Validation harness: per-batch heightmap and trajectory metrics -> CSV.

Port of ``monoforce_tpu/training/evaluator.py`` (whole module); reference
parity: monoforce/scripts/eval.py -- geom/terrain heightmap losses plus
trajectory XYZ (translation) and rotation losses from rolling the exact
engine from the ground-truth initial state on the predicted terrain,
written per batch to ``losses.csv`` (eval.py:120,156-157).

The JAX ``Evaluator`` takes the model's variables at each call; the port's
model carries its weights, so ``_metrics`` and ``run`` take none.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from monoforce_tpu_torch.losses import (hm_loss, rotation_difference,
                                        translation_difference)
from monoforce_tpu_torch.models.terrain_encoder.lss import float32_math
from monoforce_tpu_torch.physics.engine import RigidState, RobotModel, rollout
from monoforce_tpu_torch.training.trainer import avg_pool_grid

__all__ = ["Evaluator"]


class Evaluator:
    """Runs a trained terrain encoder over a validation loader, on the
    model's device (the robot's must be the same)."""

    def __init__(self, model, robot: RobotModel, pool_k: int = 4,
                 out_dir: str = "runs/eval"):
        self.model = model
        self.robot = robot
        self.pool_k = pool_k
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    @torch.no_grad()
    def _metrics(self, batch):
        """(metrics dict of 0-d tensors, terrain maps, predicted positions
        at the ground-truth stamps (B, T, 3)) of one batch."""
        (imgs, rots, trans, intrins, post_rots, post_trans,
         hm_geom, hm_terrain, control_ts, controls, pose0,
         traj_ts, Xs, Xds, Rs, Omegas) = batch
        self.model.eval()
        with float32_math():
            terrain = self.model(imgs, rots, trans, intrins, post_rots,
                                 post_trans)
            loss_geom = hm_loss(terrain["geom"], hm_geom[:, 0:1],
                                hm_geom[:, 1:2])
            loss_terrain = hm_loss(terrain["terrain"], hm_terrain[:, 0:1],
                                   hm_terrain[:, 1:2])

            # trajectory losses from the GT initial state (eval.py:93-104)
            z = avg_pool_grid(terrain["terrain"], self.pool_k)[:, 0]
            friction = avg_pool_grid(terrain["friction"], self.pool_k)[:, 0]
            state0 = RigidState(Xs[:, 0], Xds[:, 0], Rs[:, 0], Omegas[:, 0])
            states, _, _ = rollout(self.robot, z, controls, state0=state0,
                                   friction=friction, return_forces=False)
        # align to GT stamps (nearest predicted step)
        ids = torch.argmin(torch.abs(control_ts[:, None, :]
                                     - traj_ts[:, :, None]), dim=2)
        batch_ix = torch.arange(Xs.shape[0], device=Xs.device)[:, None]
        X_pred = states.x[batch_ix, ids]
        R_pred = states.R[batch_ix, ids]
        loss_xyz = translation_difference(X_pred, Xs)
        loss_rot = rotation_difference(R_pred, Rs)
        metrics = {"hm_geom": loss_geom, "hm_terrain": loss_terrain,
                   "traj_xyz": loss_xyz, "traj_rot": loss_rot}
        return metrics, terrain, X_pred

    def run(self, loader, csv_name: str = "losses.csv",
            save_figures: bool = False, d_max: float = 6.4):
        """Evaluate the loader (any iterable of the 16-tuple batch); with
        ``save_figures`` also write the per-batch 3x4 diagnostic panel
        (reference eval.py:159-265) to out_dir.  Returns the mean metrics."""
        from monoforce_tpu_torch import vis
        device = next(self.model.parameters()).device
        path = os.path.join(self.out_dir, csv_name)
        rows = []
        for i, batch in enumerate(loader):
            batch = tuple(torch.as_tensor(b, dtype=torch.float32).to(device)
                          for b in batch)
            metrics, terrain, X_pred = self._metrics(batch)
            m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            rows.append(m)
            with open(path, "a") as f:
                if i == 0 and f.tell() == 0:
                    f.write("batch," + ",".join(m.keys()) + "\n")
                f.write(f"{i}," + ",".join(f"{v:.6f}" for v in m.values()) + "\n")
            if save_figures:
                vis.save_eval_figure(
                    batch, terrain, X_pred, d_max=d_max,
                    path=os.path.join(self.out_dir, f"batch_{i:04d}.png"))
        return ({k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
                if rows else {})
