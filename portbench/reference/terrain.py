"""Bilinear heightmap interpolation with surface normals.

Port of ``monoforce_tpu/physics/terrain.py`` (whole module); reference:
``DPhysics.interpolate_grid`` (dphysics.py:385-455).  Its quirks are part of
the parity spec and are kept:

- continuous index ``(q + d_max) / grid_res``, an IEEE divide (never a
  multiply by the reciprocal: the swapped weight pairing below makes the
  lookup discontinuous at cell borders, so the last bit of the index
  matters), truncated toward zero (``.to(torch.int32)``, the reference's
  ``.long()``),
- flat index ``i = y + H * x`` (square grids), all four taps clamped to
  ``[0, H*W - 1]``,
- the reference's swapped weight pairing (y_frac on the +x tap),
- normals from forward differences of the two x/y taps,
  ``n = normalize([-dz/dx, -dz/dy, 1])``.

The JAX function takes one (H, W) grid and is vmapped by its engine; this
one takes either one (H, W) grid for queries of any shape, or a batch of
grids (B, H, W) with one grid per leading index of the queries (B, ...).
The taps are index gathers, plain PyTorch on every device.
"""

from __future__ import annotations

import torch

__all__ = ["interpolate_grid", "normalized"]


def normalized(x, eps: float = 1e-6, dim: int = -1):
    """x / max(||x||, eps) along ``dim`` (reference: dphysics.py:7-19)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def _taps(grid, idx):
    """grid (H, W) or (B, H, W); idx int64 of the queries' shape."""
    if grid.dim() == 2:
        return grid.reshape(-1)[idx]
    B = grid.shape[0]
    flat = grid.reshape(B, -1)
    return torch.gather(flat, 1, idx.reshape(B, -1)).reshape(idx.shape)


def interpolate_grid(grid, x_query, y_query, d_max, grid_res,
                     return_normals: bool = False):
    """Bilinear interpolation of ``grid`` at metric coordinates.

    Args:
      grid: (H, W) values, or (B, H, W) with one grid per trajectory; the
        first grid axis is x.
      x_query, y_query: metric coordinates in [-d_max, d_max), of any shape
        for an (H, W) grid, (B, ...) for a batch of grids.
      d_max: half-extent of the grid in metres.
      grid_res: cell size in metres.
      return_normals: also return forward-difference surface normals.

    Returns:
      z of the queries' shape, and optionally n: (..., 3) unit normals.
    """
    H, W = grid.shape[-2], grid.shape[-1]
    xi = (x_query + d_max) / grid_res
    yi = (y_query + d_max) / grid_res
    # truncation toward zero matches the reference's `.long()` cast
    x_i = xi.to(torch.int32)
    y_i = yi.to(torch.int32)
    x_frac = xi - x_i.to(xi.dtype)
    y_frac = yi - y_i.to(yi.dtype)

    last = H * W - 1
    x_i, y_i = x_i.long(), y_i.long()
    z_c = _taps(grid, torch.clamp(y_i + H * x_i, 0, last))
    z_f = _taps(grid, torch.clamp(y_i + H * (x_i + 1), 0, last))
    z_l = _taps(grid, torch.clamp((y_i + 1) + H * x_i, 0, last))
    z_fl = _taps(grid, torch.clamp((y_i + 1) + H * (x_i + 1), 0, last))

    # the reference's pairing (dphysics.py:442-445): y_frac on the +x tap,
    # x_frac on the +y tap, compensating the data layer's heightmap `.T`
    z = ((1 - x_frac) * (1 - y_frac) * z_c
         + (1 - x_frac) * y_frac * z_f
         + x_frac * (1 - y_frac) * z_l
         + x_frac * y_frac * z_fl)

    if not return_normals:
        return z

    dz_dx = (z_f - z_c) / grid_res
    dz_dy = (z_l - z_c) / grid_res
    n = torch.stack([-dz_dx, -dz_dy, torch.ones_like(dz_dx)], dim=-1)
    return z, normalized(n)
