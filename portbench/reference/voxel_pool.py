"""BEV splat: add frustum features into the voxel grid.

Port of ``monoforce_tpu/ops/voxel_pool.py:23-59``, the fixed-shape
replacement of the reference's filter -> rank-sort -> QuickCumsum segment
sum -> scatter (reference: lss.py:238-280, terrain_encoder/utils.py:144-181):
every frustum point gets a flat voxel id, out-of-bounds points go to one
trash row, and one ``index_add_`` sums the rows.  The JAX package computes
it with XLA's scatter, not a Pallas kernel, so it stays plain PyTorch here.

On CUDA ``index_add_`` adds with atomics: the sums differ from run to run
in the last bits.  The sum runs in the features' dtype (bf16 in the half
serving mode, as the JAX segment sum does).
"""

from __future__ import annotations

import torch

__all__ = ["voxel_pool"]


def voxel_pool(geom, feats, dx, bx, nx):
    """Pool frustum features into the BEV grid.

    Args:
      geom: (B, N, D, fH, fW, 3) float32 ego-frame sample locations.
      feats: (B, N, D, fH, fW, C) lifted features.
      dx, bx: (3,) float32 tensors of cell sizes and first-cell centers,
        on ``geom``'s device; nx: the (3,) cell counts (``gen_dx_bx``).

    Returns (B, C * Z, X, Y) BEV features (Z = nx[2], 1 for the default
    grid), channel ``c * Z + z`` like the JAX package's (C, Z) fold.
    """
    B, N, D, fH, fW, C = feats.shape
    nx0, nx1, nx2 = int(nx[0]), int(nx[1]), int(nx[2])

    # voxel indices: subtract, divide, then truncate toward zero like the
    # reference's `.long()` (a multiply by 1/dx would move points across
    # cell borders)
    vox = ((geom - (bx - dx / 2.0)) / dx).to(torch.int32)
    ix, iy, iz = vox[..., 0], vox[..., 1], vox[..., 2]
    kept = ((ix >= 0) & (ix < nx0) & (iy >= 0) & (iy < nx1)
            & (iz >= 0) & (iz < nx2))

    n_cells = nx0 * nx1 * nx2
    batch_ix = torch.arange(B, dtype=torch.int64,
                            device=geom.device).reshape(B, 1, 1, 1, 1)
    flat_ids = (((batch_ix * nx0 + ix.clamp(0, nx0 - 1)) * nx1
                 + iy.clamp(0, nx1 - 1)) * nx2 + iz.clamp(0, nx2 - 1))
    # dropped points go to the trash row
    flat_ids = torch.where(kept, flat_ids, B * n_cells)

    pooled = torch.zeros((B * n_cells + 1, C), dtype=feats.dtype,
                         device=feats.device)
    pooled.index_add_(0, flat_ids.reshape(-1), feats.reshape(-1, C))
    pooled = pooled[:-1].reshape(B, nx0, nx1, nx2, C)
    # (B, X, Y, Z, C) -> (B, C, Z, X, Y) -> Z folded into channels
    return pooled.permute(0, 4, 3, 1, 2).reshape(B, C * nx2, nx0, nx1)
