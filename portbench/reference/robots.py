"""Robot rigid-body models: contact-point clouds and driving-part masks.

Port of ``monoforce_tpu/robots.py`` (whole module), kept as an own copy so
that the PyTorch package imports nothing of the JAX package.  The outputs
must stay identical to the reference module's: the same procedural clouds,
the same numpy voxel downsample (open3d ``voxel_down_sample`` semantics) and
the same geometric driving-part rules (reference: monoforce/src/monoforce/
models/traj_predictor/dphys_config.py:8-74).  numpy only.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "load_obj_vertices",
    "voxel_downsample",
    "robot_point_cloud",
    "driving_part_masks",
    "ROBOT_PRESETS",
]


def load_obj_vertices(path: str) -> np.ndarray:
    """Parse vertex positions from a Wavefront OBJ file. Returns (N, 3) f32."""
    verts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError(f"no vertices found in {path}")
    return np.asarray(verts, dtype=np.float32)


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Downsample a point cloud by averaging points within each voxel.

    Matches open3d ``voxel_down_sample``: voxel index is
    ``floor((p - min_bound) / voxel_size)`` and the representative point is
    the centroid of the points in the voxel.
    """
    assert points.ndim == 2 and points.shape[1] == 3
    if voxel_size <= 0:
        return points.astype(np.float32)
    origin = points.min(axis=0)
    keys = np.floor((points - origin) / voxel_size).astype(np.int64)
    # Unique voxel per point -> mean of member points.
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inverse, points.astype(np.float64))
    return (sums / counts[:, None]).astype(np.float32)


def _box_points(x0, x1, y0, y1, z0, z1, step=0.05) -> np.ndarray:
    """Surface points of an axis-aligned box sampled on a regular grid."""
    xs = np.arange(x0, x1 + 1e-9, step)
    ys = np.arange(y0, y1 + 1e-9, step)
    zs = np.arange(z0, z1 + 1e-9, step)
    pts = []
    # top and bottom faces
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    for z in (z0, z1):
        pts.append(np.stack([gx, gy, np.full_like(gx, z)], axis=-1).reshape(-1, 3))
    # front and rear faces
    gy2, gz2 = np.meshgrid(ys, zs, indexing="ij")
    for x in (x0, x1):
        pts.append(np.stack([np.full_like(gy2, x), gy2, gz2], axis=-1).reshape(-1, 3))
    # left and right faces
    gx3, gz3 = np.meshgrid(xs, zs, indexing="ij")
    for y in (y0, y1):
        pts.append(np.stack([gx3, np.full_like(gx3, y), gz3], axis=-1).reshape(-1, 3))
    return np.concatenate(pts, axis=0)


def _tracked_robot_points(body, tracks, step=0.05, voxel=0.1) -> np.ndarray:
    """Body box + track boxes, voxel-downsampled like the reference mesh path."""
    parts = [_box_points(*body, step=step)]
    for t in tracks:
        parts.append(_box_points(*t, step=step))
    cloud = np.concatenate(parts, axis=0).astype(np.float32)
    return voxel_downsample(cloud, voxel)


# Procedural geometry per robot. Dimensions chosen to match the reference
# robots' footprint scale (joint positions at dphys_config.py:85-118 put the
# track centers near x=+-0.25, y=+-0.272..0.285).
def _tradr_points(voxel: float = 0.1) -> np.ndarray:
    body = (-0.30, 0.30, -0.20, 0.20, 0.05, 0.22)
    tracks = [
        (-0.40, 0.40, 0.22, 0.32, -0.09, 0.04),   # left track
        (-0.40, 0.40, -0.32, -0.22, -0.09, 0.04),  # right track
    ]
    return _tracked_robot_points(body, tracks, voxel=voxel)


def _marv_points(voxel: float = 0.1) -> np.ndarray:
    body = (-0.30, 0.30, -0.20, 0.20, 0.05, 0.25)
    flippers = [
        (0.10, 0.45, 0.222, 0.322, -0.09, 0.02),    # front-left
        (0.10, 0.45, -0.322, -0.222, -0.09, 0.02),  # front-right
        (-0.45, -0.10, 0.222, 0.322, -0.09, 0.02),  # rear-left
        (-0.45, -0.10, -0.322, -0.222, -0.09, 0.02),  # rear-right
    ]
    return _tracked_robot_points(body, flippers, voxel=voxel)


def _husky_points(voxel: float = 0.1) -> np.ndarray:
    body = (-0.40, 0.40, -0.28, 0.28, 0.10, 0.30)
    wheels = [
        (0.156, 0.356, 0.235, 0.335, -0.13, 0.05),    # front-left
        (0.156, 0.356, -0.335, -0.235, -0.13, 0.05),  # front-right
        (-0.356, -0.156, 0.235, 0.335, -0.13, 0.05),  # rear-left
        (-0.356, -0.156, -0.335, -0.235, -0.13, 0.05),  # rear-right
    ]
    return _tracked_robot_points(body, wheels, voxel=voxel)


ROBOT_PRESETS = {
    "tradr": _tradr_points,
    "marv": _marv_points,
    "husky": _husky_points,
}


def robot_point_cloud(robot: str, voxel_size: float = 0.1,
                      mesh_path: str | None = None) -> np.ndarray:
    """Contact point cloud for a robot: from an OBJ mesh if given, else the
    procedural preset. Mirrors get_points_from_robot_mesh
    (dphys_config.py:8-35) without the open3d dependency."""
    if mesh_path is not None:
        return voxel_downsample(load_obj_vertices(mesh_path), voxel_size)
    for key, fn in ROBOT_PRESETS.items():
        if key in robot:
            return fn(voxel=voxel_size)
    raise ValueError(f"Robot {robot!r} not supported. Available: {list(ROBOT_PRESETS)}")


def driving_part_masks(robot: str, points: np.ndarray):
    """Split the point cloud into driving parts with the reference's geometric
    rules (dphys_config.py:38-74).

    Returns (masks, robot_size):
      masks: (K, P) bool — K=2 for tracked robots (left, right track),
             K=4 for flipper/wheel robots (fl, fr, rl, rr).
      robot_size: (s_x, s_y) extents of the cloud.
    """
    s_x = float(points[:, 0].max() - points[:, 0].min())
    s_y = float(points[:, 1].max() - points[:, 1].min())
    cog = points.mean(axis=0)
    if any(k in robot for k in ("tradr",)):
        mask_l = (points[:, 1] > cog[1] + s_y / 4.0) & (points[:, 2] < cog[2])
        mask_r = (points[:, 1] < cog[1] - s_y / 4.0) & (points[:, 2] < cog[2])
        masks = np.stack([mask_l, mask_r], axis=0)
    elif any(k in robot for k in ("marv", "husky")):
        fwd = points[:, 0] > cog[0] + s_x / 8.0
        rear = points[:, 0] < cog[0] - s_x / 8.0
        left = points[:, 1] > cog[1] + s_y / 3.0
        right = points[:, 1] < cog[1] - s_y / 3.0
        masks = np.stack([fwd & left, fwd & right, rear & left, rear & right], axis=0)
    else:
        raise ValueError(f"Robot {robot!r} not supported. Available: tradr, marv, husky")
    return masks, (s_x, s_y)
