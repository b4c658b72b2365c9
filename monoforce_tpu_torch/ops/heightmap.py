"""Point-cloud -> heightmap rasterization and related grid ops.

Port of ``monoforce_tpu/ops/heightmap.py`` (whole module) in plain
PyTorch (the JAX module is XLA; it holds no Pallas kernel); reference:
monoforce/src/monoforce/cloudproc.py.  Each function computes on its
input's device; numpy inputs become float32 tensors on the CPU.

- ``estimate_heightmap`` (cloudproc.py:88-148): max-z rasterization onto the
  BEV grid.  Invalid points go to a trash cell of a fixed-shape
  ``scatter_reduce_(amax)``.  The bins are ``np.arange`` in float32, as
  ``jnp.arange`` makes them: ``torch.arange`` (in float32 or in float64
  cast down) differs from them by up to ~1e-4 at d_max 12.8, which moves
  points near a cell border into the next cell.  A max is exact and
  independent of order, so every device gives the same cells bit for bit.
  The final transpose quirk (cloudproc.py:142-144) is kept: it makes the
  heightmap layout match the physics engine's ``i = y + H*x`` lookup.
- ``filter_grid`` (cloudproc.py:55-86): keep one point per cell
  (host-side numpy; a data-prep op, not a device op).
- ``hm_to_cloud`` (cloudproc.py:151-173): heightmap back to a point cloud.
- ``inpaint_heightmap`` / ``local_heightmap``: the GT gridmap publisher's
  pipeline (publish_gt_gridmap:105-244).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["estimate_heightmap", "filter_grid", "hm_to_cloud",
           "inpaint_heightmap", "local_heightmap"]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def estimate_heightmap(points, grid_res: float, d_max: float, h_max: float,
                       r_min: float | None = None, h_min: float | None = None):
    """Rasterize a point cloud into a (2, H, W) heightmap + measurement mask.

    Args:
      points: (P, 3) xyz, NaNs allowed (ignored).
      grid_res, d_max, h_max: grid geometry; cells cover [-d_max, d_max).
      r_min: optional inner radius to drop robot-body returns.
      h_min: lower height bound (defaults to -h_max).

    Returns (2, H, W): channel 0 max-z per cell (0 where unmeasured),
    channel 1 the measurement mask.
    """
    points = _f32(points)
    if h_min is None:
        h_min = -h_max
    x, y, z = points[:, 0], points[:, 1], points[:, 2]

    valid = ~torch.isnan(points).any(dim=1)
    if r_min is not None:
        valid &= torch.sqrt(x ** 2 + y ** 2) > r_min
    valid &= ((x > -d_max) & (x < d_max) & (y > -d_max) & (y < d_max)
              & (z > h_min) & (z < h_max))

    bins = torch.from_numpy(np.arange(-d_max, d_max, grid_res,
                                      dtype=np.float32)).to(points.device)
    n = bins.shape[0]
    xi = torch.searchsorted(bins, x.contiguous(), right=True) - 1
    yi = torch.searchsorted(bins, y.contiguous(), right=True) - 1
    flat = yi * n + xi
    flat = torch.where(valid, torch.clamp(flat, 0, n * n - 1),
                       n * n)  # trash cell

    zmax = torch.full((n * n + 1,), -torch.inf, device=points.device)
    zmax.scatter_reduce_(0, flat, torch.where(valid, z, -torch.inf),
                         reduce="amax")
    zmax = zmax[:-1]
    measured = zmax > -torch.inf
    hm = torch.where(measured, zmax, 0.0).reshape(n, n)
    mask = measured.reshape(n, n)
    # layout quirk preserved: transpose so that hm[x_idx, y_idx]
    return torch.stack([hm.T, mask.T.float()], dim=0)


def filter_grid(points: np.ndarray, grid_res: float, keep: str = "first",
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Keep a single point per grid cell (order not preserved). Host-side."""
    assert keep in ("first", "random", "last")
    pts = np.asarray(points)
    if keep == "random":
        rng = rng or np.random.default_rng(135)
        pts = pts[rng.permutation(len(pts))]
    elif keep == "last":
        pts = pts[::-1]
    keys = np.floor(pts[:, :3] / grid_res).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[idx]


def hm_to_cloud(height, d_max: float, mask=None):
    """Heightmap (H, W) -> point cloud (H*W | mask.sum(), 3)."""
    height = _f32(height)
    H, W = height.shape
    xg = torch.linspace(-d_max, d_max, H, device=height.device)
    yg = torch.linspace(-d_max, d_max, W, device=height.device)
    gx, gy = torch.meshgrid(xg, yg, indexing="ij")
    cloud = torch.stack([gx, gy, height], dim=-1).reshape(-1, 3)
    if mask is not None:
        keep = (mask if isinstance(mask, torch.Tensor) else
                torch.as_tensor(np.asarray(mask), device=height.device))
        keep = keep.reshape(-1).bool()
        cloud = cloud[keep]
    return cloud


def inpaint_heightmap(hm, mask, iters: int = 16):
    """Fill unmeasured cells by iterative neighbor averaging (a stand-in for
    the scipy ``griddata`` interpolation the reference's GT gridmap
    publisher uses, monoforce_navigation/nodes/publish_gt_gridmap:169-184)."""
    h = _f32(hm)
    w = _f32(mask)
    for _ in range(iters):
        hp = F.pad(h * w, (1, 1, 1, 1))
        wp = F.pad(w, (1, 1, 1, 1))
        num = (hp[:-2, 1:-1] + hp[2:, 1:-1] + hp[1:-1, :-2] + hp[1:-1, 2:])
        den = (wp[:-2, 1:-1] + wp[2:, 1:-1] + wp[1:-1, :-2] + wp[1:-1, 2:])
        fill = num / torch.clamp(den, min=1e-6)
        new_w = torch.clamp(w + (den > 0) * (1 - w), 0.0, 1.0)
        h = torch.where(w > 0, h, fill)
        w = new_w
    return h


def _robot_frame(cloud, robot_pose):
    """(P, 3) world points in the yaw-only frame of a (4, 4) pose.

    The yaw's cosine and sine are taken in float64 and rounded to float32
    (the devices' float64 libraries differ far below float32's last bit),
    and the rotation is written out as products and sums, each one
    correctly rounded operation: so the local points, and with them the
    cells, are the same on every device.  A float32 ``cos`` or a matmul's
    fused products differ between devices in the last bit, enough to move
    a point that lies on a cell border."""
    cloud = _f32(cloud)
    pose = _f32(robot_pose)
    yaw = torch.atan2(pose[1, 0].double(), pose[0, 0].double())
    c, s = torch.cos(yaw).float(), torch.sin(yaw).float()
    d = cloud - pose[:3, 3]
    dx, dy = d[:, 0], d[:, 1]
    # (cloud - t) @ Rz with Rz = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return torch.stack([dx * c + dy * s, dy * c - dx * s, d[:, 2]], dim=1)


def local_heightmap(cloud, robot_pose, grid_res: float, d_max: float,
                    h_max: float, inpaint_iters: int = 16):
    """Robot-centric heightmap from a global cloud: transform the cloud into
    the (yaw-only) robot frame, rasterize, inpaint gaps (the GT gridmap
    publisher pipeline, publish_gt_gridmap:105-244)."""
    hm = estimate_heightmap(_robot_frame(cloud, robot_pose), grid_res, d_max,
                            h_max)
    return inpaint_heightmap(hm[0], hm[1], inpaint_iters)
