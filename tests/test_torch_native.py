"""The port's native host ops (``monoforce_tpu_torch.native``: an own copy
of the C++ library, built with g++ at first use into the package's build
directory) against the JAX package's ``native`` and against numpy, on
seeded clouds with NaN rows and points on cell borders."""

import shutil

import numpy as np
import pytest

from monoforce_tpu import native as jnative
from monoforce_tpu_torch import native
from monoforce_tpu_torch.datasets.rough import estimate_heightmap_np
from monoforce_tpu_torch.ops.heightmap import filter_grid as np_filter_grid
from monoforce_tpu_torch.robots import voxel_downsample as np_voxel_downsample
from test_torch_datasets import _border_cloud


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host ops cannot be built here")
    assert native.available() and jnative.available()
    target = native._target()
    assert target.parent == native.BUILD_DIR and target.exists()
    assert target.parent.name == "_build"
    return native


@pytest.mark.parametrize("kw", [{}, {"r_min": 0.6}, {"h_min": -0.5}],
                            ids=["plain", "r_min", "h_min"])
def test_estimate_heightmap_matches_jax_native(lib, kw):
    rng = np.random.default_rng(11)
    pts = _border_cloud(rng)
    for res, d_max in ((0.1, 6.4), (0.4, 6.4), (0.1, 12.8)):
        got = lib.estimate_heightmap(pts, res, d_max, 2.0, **kw)
        want = jnative.estimate_heightmap(pts, res, d_max, 2.0, **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), (res, d_max)


def _numpy(pts, *args, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        return estimate_heightmap_np(pts, *args, **kw)


def test_estimate_heightmap_against_numpy(lib, monkeypatch):
    """The native rasterization equals the numpy fallback on points that
    lie on the float32 cell edges and off the borders.  On the decimal
    borders k * 0.1 - 6.4 the two differ, as the JAX package's do: the
    library takes the cell in float32, floor((x + d_max) / res), where
    numpy compares with float64 bins; both keep their reference's cells."""
    rng = np.random.default_rng(12)
    pts = _border_cloud(rng)
    n = (len(pts)) // 3
    edges, decimal, rand = pts[:n], pts[n:2 * n], pts[2 * n:]
    for part in (edges, rand, np.concatenate([edges, rand])):
        got = lib.estimate_heightmap(part, 0.1, 6.4, 2.0, r_min=0.6)
        want = _numpy(part, 0.1, 6.4, 2.0, r_min=0.6, monkeypatch=monkeypatch)
        assert np.array_equal(got, want)
    got = lib.estimate_heightmap(decimal, 0.1, 6.4, 2.0)
    want = _numpy(decimal, 0.1, 6.4, 2.0, monkeypatch=monkeypatch)
    assert not np.array_equal(got, want)
    # the library's cells are float32 floor((x + d_max) / res), exactly
    ok = ~np.isnan(decimal).any(axis=1) & (np.abs(decimal[:, 2]) < 2.0)
    ok &= (np.abs(decimal[:, :2]) < 6.4).all(axis=1)
    p = decimal[ok]
    ix = np.floor((p[:, 0] + np.float32(6.4)) / np.float32(0.1)).astype(int)
    iy = np.floor((p[:, 1] + np.float32(6.4)) / np.float32(0.1)).astype(int)
    inside = (ix >= 0) & (ix < 128) & (iy >= 0) & (iy < 128)
    z = np.full((128, 128), -np.inf, np.float32)
    np.maximum.at(z, (ix[inside], iy[inside]), p[inside, 2])
    assert np.array_equal(got[1], np.isfinite(z).astype(np.float32))
    assert np.array_equal(got[0], np.where(np.isfinite(z), z, 0.0))


def test_voxel_downsample_matches_jax_and_numpy(lib):
    rng = np.random.default_rng(13)
    pts = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    pts[:500] = np.round(pts[:500] * 10) / 10     # on voxel borders
    got = lib.voxel_downsample(pts, 0.1)
    assert np.array_equal(got, jnative.voxel_downsample(pts, 0.1))
    want = np_voxel_downsample(pts, 0.1)
    assert got.shape == want.shape
    # the same centroids as sets (first-seen order against key order)
    np.testing.assert_allclose(got[np.lexsort(got.T)],
                               want[np.lexsort(want.T)], atol=1e-5)


def test_filter_grid_matches_jax_and_numpy(lib):
    rng = np.random.default_rng(14)
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    pts[:300] = np.round(pts[:300] * 5) / 5       # on cell borders
    idx = lib.filter_grid(pts, 0.2)
    assert np.array_equal(idx, jnative.filter_grid(pts, 0.2))
    assert np.all(np.diff(idx) > 0)               # the first of each cell
    keys = np.floor(pts[idx] / np.float32(0.2)).astype(np.int64)
    assert len(np.unique(keys, axis=0)) == len(idx)
    want = np_filter_grid(pts, 0.2)
    got = pts[idx]
    assert np.array_equal(got[np.lexsort(got.T)], want[np.lexsort(want.T)])


def test_bad_points_rejected(lib):
    with pytest.raises(ValueError):
        lib.estimate_heightmap(np.zeros((4, 2), np.float32), 0.1, 6.4, 2.0)
    # extra columns (intensity) are dropped, not read as points
    pts = np.random.default_rng(15).uniform(-3, 3, (100, 4)).astype(np.float32)
    assert np.array_equal(lib.estimate_heightmap(pts, 0.1, 6.4, 2.0),
                          lib.estimate_heightmap(pts[:, :3], 0.1, 6.4, 2.0))
