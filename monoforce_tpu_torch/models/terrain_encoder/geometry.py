"""Camera frustum geometry for the lift step.

Port of ``monoforce_tpu/models/terrain_encoder/geometry.py:19-61``; reference
parity: LiftSplatShoot.create_frustum / get_geometry (reference:
monoforce/src/monoforce/models/terrain_encoder/lss.py:191-224) and gen_dx_bx
(terrain_encoder/utils.py:136-141).

The frustum is built with numpy exactly as the JAX package builds it, so the
depth bins and the sample positions are bit-equal; the geometry is float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gen_dx_bx", "create_frustum", "get_geometry"]


def gen_dx_bx(xbound, ybound, zbound):
    """Grid cell sizes dx, first-cell centers bx, cell counts nx (numpy)."""
    bounds = [xbound, ybound, zbound]
    dx = np.array([row[2] for row in bounds], dtype=np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], dtype=np.float32)
    nx = np.array([(row[1] - row[0]) / row[2] for row in bounds]).astype(np.int64)
    return dx, bx, nx


def create_frustum(final_dim, dbound, downsample: int = 16):
    """(D, fH, fW, 3) float32 frustum of (u, v, depth) samples in
    final-image pixels."""
    ogfH, ogfW = final_dim
    fH, fW = ogfH // downsample, ogfW // downsample
    ds = np.arange(*dbound, dtype=np.float32)
    xs = np.linspace(0, ogfW - 1, fW, dtype=np.float32)
    ys = np.linspace(0, ogfH - 1, fH, dtype=np.float32)
    frustum = np.stack(np.broadcast_arrays(
        xs[None, None, :], ys[None, :, None], ds[:, None, None]), axis=-1)
    return torch.from_numpy(np.ascontiguousarray(frustum))


def get_geometry(frustum, rots, trans, intrins, post_rots, post_trans):
    """Ego-frame (x, y, z) of every frustum sample.

    Args:
      frustum: (D, fH, fW, 3) pixel-space frustum.
      rots, intrins, post_rots: (B, N, 3, 3) camera rotations / intrinsics /
        image-aug rotations.
      trans, post_trans: (B, N, 3).

    Returns (B, N, D, fH, fW, 3).
    """
    # undo the post-augmentation homography
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    inv_post = torch.linalg.inv(post_rots)
    pts = torch.einsum("bnij,bndhwj->bndhwi", inv_post, pts)
    # pixel (u, v, d) -> camera ray (u*d, v*d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", rots, torch.linalg.inv(intrins))
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    return pts + trans[:, :, None, None, None, :]
