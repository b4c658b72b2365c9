"""ctypes bindings for the native host-ops library.

Own copy of ``monoforce_tpu/native/__init__.py``.  ``hostops.cpp`` is
compiled with g++ at first use (never at import) into
``monoforce_tpu_torch/_build/``, keyed by a hash of the source and the
flags, never next to the source; the library is written under a
process-unique name and renamed into place, so concurrent first uses do not
race.  The wrappers are numpy in, numpy out.  Every op has a numpy version
elsewhere in the package (``datasets.rough.estimate_heightmap_np``'s
fallback, ``ops.heightmap``); ``available()`` reports whether the native
library loaded, and the wrappers return None when it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "estimate_heightmap", "voxel_downsample", "filter_grid"]

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded library or None once a load was tried


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhostops-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    out = _target()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out


def _load():
    """The library, built and declared on the first call; None when it
    cannot be built or loaded (no g++, a read-only checkout)."""
    if "lib" in _state:
        return _state["lib"]
    with _lock:
        if "lib" not in _state:
            _state["lib"] = _declare(_build())
    return _state["lib"]


def _declare(path: Path | None):
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.estimate_heightmap_f32.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, f32p, f32p,
        ctypes.c_int64]
    lib.estimate_heightmap_f32.restype = None
    lib.voxel_downsample_f32.argtypes = [f32p, ctypes.c_int64,
                                         ctypes.c_float, f32p]
    lib.voxel_downsample_f32.restype = ctypes.c_int64
    lib.filter_grid_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_float,
                                    i64p]
    lib.filter_grid_f32.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(points: np.ndarray) -> np.ndarray:
    """(N, >= 3) points as a contiguous float32 (N, 3) array."""
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    return np.ascontiguousarray(pts[:, :3], dtype=np.float32)


def estimate_heightmap(points: np.ndarray, grid_res: float, d_max: float,
                       h_max: float, r_min: float | None = None,
                       h_min: float | None = None) -> np.ndarray | None:
    """Native max-z rasterization; returns (2, n, n) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = _points(points)
    n = int(len(np.arange(-d_max, d_max, grid_res)))
    out_h = np.empty(n * n, np.float32)
    out_m = np.empty(n * n, np.float32)
    lib.estimate_heightmap_f32(
        _fptr(pts), len(pts), ctypes.c_float(grid_res),
        ctypes.c_float(d_max), ctypes.c_float(h_max),
        ctypes.c_float(-1.0 if r_min is None else r_min),
        ctypes.c_float(-h_max if h_min is None else h_min),
        _fptr(out_h), _fptr(out_m), n)
    return np.stack([out_h.reshape(n, n), out_m.reshape(n, n)], axis=0)


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray | None:
    """Centroid of the points in each voxel, in first-seen order; None if
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = _points(points)
    out = np.empty_like(pts)
    m = lib.voxel_downsample_f32(_fptr(pts), len(pts),
                                 ctypes.c_float(voxel_size), _fptr(out))
    return out[:m].copy()


def filter_grid(points: np.ndarray, grid_res: float) -> np.ndarray | None:
    """Indices of one (first) point per cell, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = _points(points)
    idx = np.empty(len(pts), np.int64)
    m = lib.filter_grid_f32(_fptr(pts), len(pts), ctypes.c_float(grid_res),
                            idx.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int64)))
    return idx[:m].copy()
