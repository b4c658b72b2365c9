"""Pinhole camera projection helpers (host-side numpy).

Own copy of ``monoforce_tpu/datasets/camera.py``.

Reference parity: ego_to_cam / cam_to_ego / get_only_in_img_mask
(reference: monoforce/src/monoforce/models/terrain_encoder/utils.py:13-43).
Used by the dataset layer to paint lidar points with per-camera segmentation
labels (rough.py:545-601).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ego_to_cam", "cam_to_ego", "in_image_mask",
           "depth_to_cloud"]


def ego_to_cam(points: np.ndarray, rot: np.ndarray, trans: np.ndarray,
               intrins: np.ndarray) -> np.ndarray:
    """(3, N) ego points -> pixel coords (u, v, depth)."""
    p = rot.T @ (points - trans[:, None])
    p = intrins @ p
    out = p.copy()
    out[:2] /= p[2:3]
    return out


def cam_to_ego(points: np.ndarray, rot: np.ndarray, trans: np.ndarray,
               intrins: np.ndarray) -> np.ndarray:
    """(3, N) pixel (u, v, depth) -> ego frame."""
    p = np.concatenate([points[:2] * points[2:3], points[2:3]], axis=0)
    p = np.linalg.inv(intrins) @ p
    return rot @ p + trans[:, None]


def in_image_mask(pts: np.ndarray, H: int, W: int) -> np.ndarray:
    """Mask of projected points with positive depth inside the image."""
    return ((pts[2] > 0)
            & (pts[0] > 1) & (pts[0] < W - 1)
            & (pts[1] > 1) & (pts[1] < H - 1))


def depth_to_cloud(depth: np.ndarray, K: np.ndarray,
                   depth_scale: float = 1000.0) -> np.ndarray:
    """Back-project a depth image to a camera-frame point cloud
    (reference: examples/rgbd_data.ipynb `depth_to_pc`).

    depth: (H, W) raw depth (millimeters by default); K: (3, 3) intrinsics.
    Returns (H*W, 3) xyz in meters (invalid/zero depth rows have z == 0).
    """
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xx, yy = np.meshgrid(np.arange(W) - cx, np.arange(H) - cy)
    Z = np.asarray(depth, np.float64) / depth_scale
    X = xx * Z / fx
    Y = yy * Z / fy
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
