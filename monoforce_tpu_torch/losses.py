"""Training losses of the PyTorch port.

Port of ``monoforce_tpu/losses.py`` (whole module); reference parity:
monoforce/src/monoforce/losses.py.  Weighted masked MSE heightmap loss,
time-discounted trajectory MSE with timestamp alignment, geodesic rotation
loss, total variation and slerp, as pure tensor functions.  NaN masking has
fixed shapes (``torch.where`` and a count of valid cells), like the JAX
package's, and ``argmin`` ties go to the first index in both frameworks.
"""

from __future__ import annotations

import torch

__all__ = [
    "hm_loss",
    "physics_loss",
    "rotation_difference",
    "translation_difference",
    "total_variation",
    "slerp",
]


def _reduce(x, reduction: str):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def translation_difference(x1, x2, reduction: str = "mean"):
    """Norm of pairwise translation error (reference: losses.py:36-45)."""
    return _reduce(torch.linalg.norm(x1 - x2, dim=-1), reduction)


def rotation_difference(R1, R2, reduction: str = "mean"):
    """Squared geodesic angle between rotations (reference: losses.py:48-65)."""
    dR = torch.matmul(R1, R2.transpose(-2, -1))
    tr = torch.diagonal(dR, dim1=-2, dim2=-1).sum(-1)[..., None]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return _reduce(torch.arccos(cos) ** 2, reduction)


def total_variation(heightmap):
    """Mean absolute first differences along both axes (losses.py:68-74)."""
    h, w = heightmap.shape[-2], heightmap.shape[-1]
    tv = (torch.sum(torch.abs(heightmap[..., :, :-1] - heightmap[..., :, 1:]))
          + torch.sum(torch.abs(heightmap[..., :-1, :]
                                - heightmap[..., 1:, :])))
    return tv / (h * w)


def hm_loss(height_pred, height_gt, weights=None, h_max=None):
    """Weighted masked MSE between heightmaps (reference: losses.py:77-99).

    NaN cells in either map are excluded from the mean (fixed-shape
    masking).  If ``h_max`` is given, predictions are squashed to
    [-h_max, h_max] with tanh first.
    """
    if weights is None:
        weights = torch.ones_like(height_gt)
    if h_max is not None:
        height_pred = h_max * torch.tanh(height_pred)
    valid = ~(torch.isnan(height_pred) | torch.isnan(height_gt))
    pred = torch.where(valid, height_pred, 0.0) * weights
    gt = torch.where(valid, height_gt, 0.0) * weights
    n_valid = torch.clamp(valid.sum(), min=1)
    return torch.sum(torch.where(valid, (pred - gt) ** 2, 0.0)) / n_valid


def physics_loss(states_pred, states_gt, pred_ts, gt_ts, gamma: float = 0.9,
                 rotation_loss: bool = False):
    """Time-discounted trajectory MSE with timestamp alignment
    (reference: losses.py:102-138).

    Args:
      states_pred / states_gt: sequences whose first element is positions
        (N, T, 3) (and third element rotations (N, T, 3, 3) if
        ``rotation_loss``).
      pred_ts: (N, T1) prediction timestamps.
      gt_ts: (N, T2) ground-truth timestamps.
      gamma: time-discount factor, weights w = 1 / (1 + gamma * t).
    """
    X_gt = states_gt[0]
    X_pred = states_pred[0]

    # nearest predicted step for every ground-truth timestamp
    ts_ids = torch.argmin(torch.abs(pred_ts[:, None, :] - gt_ts[:, :, None]),
                          dim=2)
    batch = torch.arange(X_gt.shape[0], device=X_gt.device)[:, None]
    X_pred_aligned = X_pred[batch, ts_ids]

    time_weights = 1.0 / (1.0 + gamma * gt_ts[..., None])
    loss = torch.mean((X_pred_aligned * time_weights
                       - X_gt * time_weights) ** 2)

    if rotation_loss:
        R_gt = states_gt[2]
        R_pred_aligned = states_pred[2][batch, ts_ids]
        loss_rot = rotation_difference(R_pred_aligned, R_gt, reduction="none")
        loss_rot = (loss_rot * time_weights).mean()
        return loss, loss_rot
    return loss


def slerp(q1, q2, t, diff_thresh: float = 0.9995):
    """Spherical quaternion interpolation (reference: losses.py:14-34), with
    the near-parallel branch taken by ``torch.where`` (fixed-shape).

    q1, q2: (4,) unit quaternions; t: (T,) interpolation fractions.
    Returns (T, 4).
    """
    dot = torch.sum(q1 * q2)
    # linear branch
    lin = q1[None, :] + t[:, None] * (q2 - q1)[None, :]
    lin = lin / torch.linalg.norm(lin, dim=-1, keepdim=True)
    # spherical branch
    theta_0 = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta_0 = torch.sin(theta_0)
    theta = theta_0 * t
    s0 = torch.cos(theta) - dot * torch.sin(theta) / torch.clamp(
        sin_theta_0, min=1e-12)
    s1 = torch.sin(theta) / torch.clamp(sin_theta_0, min=1e-12)
    sph = s0[:, None] * q1[None, :] + s1[:, None] * q2[None, :]
    sph = sph / torch.linalg.norm(sph, dim=-1, keepdim=True)
    return torch.where(dot > diff_thresh, lin, sph)
