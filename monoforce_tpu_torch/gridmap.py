"""Grid-map interchange (ROS-free), the PyTorch port's own copy.

Port of ``monoforce_tpu/gridmap.py`` (whole module, numpy): the same code,
but :func:`heightmap_to_cloud_points` takes ``quat_to_rot`` from the port's
``transformations``.

The reference bridges heightmaps to/from ROS ``grid_map_msgs/GridMap``
(reference: monoforce/src/monoforce/ros.py:14-64, 233-256) whose storage
convention is: row-major float lists per layer, the array transposed and
rotated 180 degrees relative to the numpy heightmap, plus circular-buffer
start indices.  This module keeps that interchange format as a plain
``GridMapData`` dataclass so recorded GridMap data (e.g. rosbag exports, the
elevation_mapping pipeline's maps) can round-trip into the framework without
ROS being installed:

- :func:`heightmap_to_gridmap` — heightmap (+ optional mask layer) -> layers
  stored with the reference's ``rotate(data.T, 180)`` convention
  (ros.py:32),
- :func:`gridmap_to_heightmap` — layers -> numpy heightmap, undoing the
  circular start indices (ros.py:247-254) and the transpose/rotation,
- :func:`heightmap_to_cloud_points` — heightmap -> world-frame points (the
  PointCloud2 payload of ros.py:67-88 without the message wrapper).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["GridMapData", "heightmap_to_gridmap", "gridmap_to_heightmap",
           "heightmap_to_cloud_points"]


def _rot180(a: np.ndarray) -> np.ndarray:
    return a[::-1, ::-1]


@dataclass
class GridMapData:
    """grid_map_msgs/GridMap payload without ROS."""

    resolution: float
    length_x: float
    length_y: float
    layers: Dict[str, np.ndarray] = field(default_factory=dict)  # stored layout
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation_xyzw: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0, 0, 1]))
    outer_start_index: int = 0
    inner_start_index: int = 0


def heightmap_to_gridmap(height: np.ndarray, grid_res: float,
                         xyz=np.zeros(3), q=np.array([0.0, 0, 0, 1]),
                         height_layer: str = "elevation",
                         mask: Optional[np.ndarray] = None,
                         mask_layer: str = "mask") -> GridMapData:
    """numpy heightmap -> GridMapData with the reference storage convention."""
    assert height.ndim == 2
    H, W = height.shape
    gm = GridMapData(resolution=grid_res, length_x=W * grid_res,
                     length_y=H * grid_res, position=np.asarray(xyz, float),
                     orientation_xyzw=np.asarray(q, float))
    gm.layers[height_layer] = _rot180(np.asarray(height, np.float32).T)
    if mask is not None:
        assert mask.shape == height.shape
        gm.layers[mask_layer] = _rot180(np.asarray(mask, np.float32).T)
    return gm


def gridmap_to_heightmap(gm: GridMapData,
                         layer: str = "elevation") -> np.ndarray:
    """GridMapData layer -> numpy heightmap (undo start indices, transpose,
    rotation — ros.py:233-256)."""
    data = np.asarray(gm.layers[layer], np.float32)
    data = np.roll(data, shift=-gm.outer_start_index, axis=1)
    data = np.roll(data, shift=-gm.inner_start_index, axis=0)
    return _rot180(data.T)


def heightmap_to_cloud_points(height: np.ndarray, grid_res: float,
                              xyz=np.zeros(3),
                              q=np.array([0.0, 0, 0, 1])) -> np.ndarray:
    """Heightmap cells -> (H*W, 3) world-frame points (the reference's
    PointCloud2 payload, ros.py:67-88)."""
    import torch

    from monoforce_tpu_torch.transformations import quat_to_rot

    H, W = height.shape
    half_x = H * grid_res / 2.0
    half_y = W * grid_res / 2.0
    gx, gy = np.meshgrid(np.linspace(-half_x, half_x, H),
                         np.linspace(-half_y, half_y, W), indexing="ij")
    pts = np.stack([gx, gy, np.asarray(height)], axis=-1).reshape(-1, 3)
    R = quat_to_rot(torch.as_tensor(np.asarray(q, np.float32))).numpy()
    return pts @ R.T + np.asarray(xyz, np.float32)
