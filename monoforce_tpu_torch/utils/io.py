"""YAML / calibration IO (reference: monoforce/src/monoforce/utils.py:59-121);
own copy of ``monoforce_tpu/utils/io.py``."""

from __future__ import annotations

import os

import numpy as np
import yaml

__all__ = ["read_yaml", "write_to_yaml", "load_calib"]


def read_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def write_to_yaml(data: dict, path: str):
    def _clean(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_clean(x) for x in v]
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        return v
    with open(path, "w") as f:
        yaml.safe_dump(_clean(data), f)


def load_calib(calib_path: str):
    """Load the per-sequence calibration directory:
    ``cameras/<cam>.yaml`` intrinsics + ``transformations.yaml`` extrinsics.
    Returns None when no camera calibration exists (reference behavior)."""
    calib = {}
    cams_path = os.path.join(calib_path, "cameras")
    if not os.path.exists(cams_path):
        return None
    for fname in sorted(os.listdir(cams_path)):
        if fname.endswith(".yaml"):
            calib[fname[:-5]] = read_yaml(os.path.join(cams_path, fname))
    calib["transformations"] = read_yaml(
        os.path.join(calib_path, "transformations.yaml"))
    T = np.asarray(calib["transformations"]["T_base_link__base_footprint"]["data"],
                   dtype=np.float32).reshape(4, 4)
    calib["clearance"] = float(abs(T[2, 3]))
    return calib
