"""Small numeric helpers (reference: utils.py:15-57); own copy of
``monoforce_tpu/utils/misc.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["normalize", "position"]


def normalize(x, qlow: float = 0.0, qhigh: float = 1.0, eps: float = 1e-6):
    """Quantile-scale an array to [0, 1] (reference: utils.py:43-57)."""
    x = np.asarray(x, dtype=np.float32)
    lo = np.percentile(x, 100 * qlow)
    hi = np.percentile(x, 100 * qhigh)
    return np.clip((x - lo) / max(hi - lo, eps), 0.0, 1.0)


def position(cloud: np.ndarray) -> np.ndarray:
    """Structured or plain cloud -> (N, 3) xyz."""
    if cloud.dtype.names:
        return np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=-1)
    return cloud
