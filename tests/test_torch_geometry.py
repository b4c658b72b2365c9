"""The port's SE(3) helpers, heightmap ops and grid-map interchange against
the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU.  Tolerances: the rotation and quaternion helpers within 1e-6 (float32
trigonometry and norms of O(1) values, rounded in another order); the
rasterization cell for cell, bit for bit (bins, comparisons and a max have
no rounding to differ in), including points on the float32 bin borders;
the inpainting within 1e-6 (the same sums and divides); ``hm_to_cloud``
within 1e-6 (``linspace`` rounds its grid differently); the grid-map copy
bit for bit, its cloud points within 1e-5 (float64 cell centres through a
float32 rotation).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from monoforce_tpu import gridmap as jgm
from monoforce_tpu import transformations as jtf
from monoforce_tpu.ops import heightmap as jhm
from monoforce_tpu_torch import gridmap as tgm
from monoforce_tpu_torch import transformations as ttf
from monoforce_tpu_torch.ops import heightmap as thm

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _rot(axis, angle):
    return Rotation.from_rotvec(np.asarray(axis, float) * angle).as_matrix(
    ).astype(np.float32)


# ------------------------------------------------------------ transformations


def test_rpy_and_cloud_helpers_match_jax():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)
    for r in rpy:
        R_t = ttf.rpy2rot(*(float(a) for a in r))
        _close(R_t, jtf.rpy2rot(*(float(a) for a in r)))
        _close(torch.stack(ttf.rot2rpy(R_t)), jnp.stack(jtf.rot2rpy(
            jnp.asarray(R_t.numpy()))))
    # batched angles
    _close(ttf.rpy2rot(*_t(rpy).unbind(1)), jtf.rpy2rot(*jnp.asarray(rpy).T))
    v = np.array([1.0, 2.0, 3.0, 0.1, -0.2, 0.3], np.float32)
    T_t = ttf.xyz_rpy_to_matrix(_t(v))
    _close(T_t, jtf.xyz_rpy_to_matrix(jnp.asarray(v)))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    _close(ttf.transform_cloud(_t(pts), T_t),
           jtf.transform_cloud(jnp.asarray(pts), jnp.asarray(T_t.numpy())),
           atol=1e-5)


# rot_to_quat's four Shepperd candidates: the largest diagonal term decides
# which is well conditioned (identity: w; near 180 degrees about x, y, z:
# that axis), an exact half turn has R[2,1] - R[1,2] = +0 (copysign of +0),
# and a random rotation
QUAT_CASES = {
    "random": Rotation.random(random_state=3).as_matrix().astype(np.float32),
    "identity": np.eye(3, dtype=np.float32),
    "near_pi_x": _rot([1, 0, 0], np.pi - 1e-3),
    "near_pi_y": _rot([0, 1, 0], np.pi - 2e-3),
    "near_pi_z": _rot([0, 0, 1], np.pi - 1e-3),
    "near_pi_xy": _rot(np.array([1, 1, 0]) / np.sqrt(2), np.pi - 1e-4),
    "half_turn_x": np.diag([1.0, -1.0, -1.0]).astype(np.float32),
    "half_turn_z": np.diag([-1.0, -1.0, 1.0]).astype(np.float32),
}


@pytest.mark.parametrize("case", list(QUAT_CASES))
def test_rot_to_quat_shepperd_branches(case):
    R = QUAT_CASES[case]
    q_t = ttf.rot_to_quat(_t(R))
    q_j = np.asarray(jtf.rot_to_quat(jnp.asarray(R)))
    _close(q_t, q_j)
    # the same sign choice, not only the same rotation
    assert np.array_equal(np.sign(q_t.numpy()), np.sign(q_j))
    _close(ttf.quat_to_rot(q_t), jtf.quat_to_rot(jnp.asarray(q_j)), atol=2e-6)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, [4.0, -5.0, 6.0]
    _close(ttf.pose_to_xyz_q(_t(T)), jtf.pose_to_xyz_q(jnp.asarray(T)))


def test_quat_to_rot_matches_jax_and_guards_zero():
    rng = np.random.default_rng(1)
    for q in rng.normal(size=(8, 4)).astype(np.float32):   # unnormalised
        _close(ttf.quat_to_rot(_t(q)), jtf.quat_to_rot(jnp.asarray(q)))
    zero = np.zeros(4, np.float32)
    R0 = ttf.quat_to_rot(_t(zero))
    assert torch.equal(R0, torch.eye(3))
    assert np.array_equal(R0.numpy(), np.asarray(jtf.quat_to_rot(
        jnp.asarray(zero))))


# ------------------------------------------------------------ heightmap ops


def _border_cloud(d_max, res, rng):
    """Points on every float32 bin border (np.arange's), one ulp either side
    of it, on torch.arange's borders (the trap), plus NaN returns, points
    out of range in x, y and z, points near the origin (r_min) and a
    continuous scatter, with random heights."""
    bins = np.arange(-d_max, d_max, res, dtype=np.float32)
    torch_bins = torch.arange(-d_max, d_max, res, dtype=torch.float32).numpy()
    edges = np.concatenate([bins, np.nextafter(bins, np.float32(np.inf)),
                            np.nextafter(bins, np.float32(-np.inf)),
                            torch_bins, [np.float32(d_max),
                                         np.float32(-d_max)]])
    xy = np.stack([edges, rng.permutation(edges)], axis=1)
    xy = np.concatenate([xy, xy[:, ::-1],
                         rng.uniform(-1.1 * d_max, 1.1 * d_max, (4000, 2))])
    z = rng.uniform(-2.5, 2.5, len(xy))
    pts = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    nan = rng.choice(len(pts), 50, replace=False)
    pts[nan, rng.integers(0, 3, 50)] = np.nan
    near = rng.uniform(-0.8, 0.8, (200, 3)).astype(np.float32)
    return np.concatenate([pts, near])


@pytest.mark.parametrize("d_max,res,r_min,h_min", [
    (6.4, 0.1, None, None), (6.4, 0.1, 0.6, -0.5), (12.8, 0.1, None, None),
    (12.8, 0.1, 1.0, 0.2), (3.2, 0.05, None, None)])
def test_estimate_heightmap_cell_exact(d_max, res, r_min, h_min):
    rng = np.random.default_rng(int(d_max * 10) + (r_min is not None))
    pts = _border_cloud(d_max, res, rng)
    got = thm.estimate_heightmap(_t(pts), res, d_max, 2.0, r_min=r_min,
                                 h_min=h_min).numpy()
    want = np.asarray(jhm.estimate_heightmap(jnp.asarray(pts), res, d_max,
                                             2.0, r_min=r_min, h_min=h_min))
    assert got.shape == want.shape == (2,) + (int(round(2 * d_max / res)),) * 2
    assert got[1].sum() > 100
    assert np.array_equal(got, want)


def test_hm_to_cloud_matches_jax():
    rng = np.random.default_rng(2)
    hm = rng.normal(size=(64, 48)).astype(np.float32)
    mask = rng.uniform(size=(64, 48)) > 0.6
    _close(thm.hm_to_cloud(_t(hm), 3.2), jhm.hm_to_cloud(jnp.asarray(hm), 3.2))
    got = thm.hm_to_cloud(_t(hm), 3.2, mask=mask)
    assert got.shape == (int(mask.sum()), 3)
    _close(got, jhm.hm_to_cloud(jnp.asarray(hm), 3.2, mask=mask))
    _close(thm.hm_to_cloud(_t(hm), 3.2, mask=_t(mask)), got, atol=0)


@pytest.mark.parametrize("iters", [1, 16, 40])
def test_inpaint_heightmap_matches_jax(iters):
    rng = np.random.default_rng(iters)
    hm = rng.normal(size=(48, 40)).astype(np.float32)
    mask = (rng.uniform(size=(48, 40)) > 0.85).astype(np.float32)
    hm *= mask
    got = thm.inpaint_heightmap(_t(hm), _t(mask), iters)
    _close(got, jhm.inpaint_heightmap(jnp.asarray(hm), jnp.asarray(mask),
                                      iters))
    assert torch.equal(got[mask > 0], _t(hm)[mask > 0])


def _yawed_pose(yaw, xyz):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("z", yaw).as_matrix()
    pose[:3, 3] = xyz
    return pose


@pytest.mark.parametrize("yaw", [0.0, 0.7, -2.3])
def test_local_heightmap_matches_jax(yaw):
    """A hill cloud with NaN returns through both packages at a yawed pose.
    The port takes the yaw's cosine and sine in float64 (so that every
    device gets the same cells), XLA in float32: they may differ in the last
    bit, which moves only a point within a float32 ulp of a cell border."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(-7.0, 7.0, (6000, 2))
    z = 0.4 * np.exp(-((xy[:, 0] - 2.0) ** 2 / 4.0 + xy[:, 1] ** 2 / 8.0))
    cloud = np.concatenate([xy, z[:, None] + rng.normal(scale=0.01,
                                                        size=(6000, 1))],
                           axis=1).astype(np.float32)
    cloud[rng.choice(6000, 60, replace=False), 2] = np.nan
    pose = _yawed_pose(yaw, [1.0, -0.5, 0.05])
    got = thm.local_heightmap(_t(cloud), _t(pose), 0.1, 3.2, 2.0)
    want = jhm.local_heightmap(jnp.asarray(cloud), jnp.asarray(pose), 0.1,
                               3.2, 2.0)
    assert got.shape == (64, 64)
    _close(got, want)
    # tests/test_nav.py's flat cloud: the median height survives
    flat = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    flat[:, 2] = 0.3
    lm = thm.local_heightmap(flat, pose, 0.1, 3.2, 2.0)
    _close(lm, jhm.local_heightmap(flat, pose, 0.1, 3.2, 2.0))
    assert abs(float(lm.median()) - 0.3) < 0.05


@pytest.mark.parametrize("keep", ["first", "random", "last"])
def test_filter_grid_matches_jax(keep):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 2, (3000, 4)).astype(np.float32)
    got = thm.filter_grid(pts, 0.25, keep=keep)
    want = jhm.filter_grid(pts, 0.25, keep=keep)
    assert np.array_equal(got, want)
    assert len(got) < len(pts)


# ------------------------------------------------------------ grid maps


def test_gridmap_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    hm = rng.normal(size=(16, 20)).astype(np.float32)
    mask = (rng.uniform(size=(16, 20)) > 0.5).astype(np.float32)
    gm_t = tgm.heightmap_to_gridmap(hm, 0.1, mask=mask)
    gm_j = jgm.heightmap_to_gridmap(hm, 0.1, mask=mask)
    assert (gm_t.length_x, gm_t.length_y) == (gm_j.length_x, gm_j.length_y)
    for k in ("elevation", "mask"):
        assert np.array_equal(gm_t.layers[k], gm_j.layers[k])
        assert np.array_equal(tgm.gridmap_to_heightmap(gm_t, k),
                              jgm.gridmap_to_heightmap(gm_j, k))
    np.testing.assert_array_equal(tgm.gridmap_to_heightmap(gm_t), hm)
    # circular-buffer start indices are undone (ros.py:247-254)
    layer = np.roll(np.roll(gm_t.layers["elevation"], 3, axis=1), 5, axis=0)
    shifted = [m.GridMapData(resolution=0.1, length_x=gm_t.length_x,
                             length_y=gm_t.length_y,
                             layers={"elevation": layer},
                             outer_start_index=3, inner_start_index=5)
               for m in (tgm, jgm)]
    back = tgm.gridmap_to_heightmap(shifted[0])
    np.testing.assert_array_equal(back, hm)
    np.testing.assert_array_equal(back, jgm.gridmap_to_heightmap(shifted[1]))


@pytest.mark.parametrize("q", [[0.0, 0, 0, 1], [0.1, -0.2, 0.3, 0.9]])
def test_heightmap_to_cloud_points_matches_jax(q):
    rng = np.random.default_rng(6)
    hm = rng.normal(size=(16, 16)).astype(np.float32)
    xyz = np.array([1.0, 2.0, 0.5])
    got = tgm.heightmap_to_cloud_points(hm, 0.1, xyz=xyz, q=np.asarray(q))
    want = jgm.heightmap_to_cloud_points(hm, 0.1, xyz=xyz, q=np.asarray(q))
    assert got.shape == want.shape == (256, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------ devices


def test_pure_functions_stay_on_their_inputs_device():
    """The meta device stands in for a second device here: each function's
    output lies where its input does, and mixing devices raises."""
    meta = torch.zeros((10, 3), device="meta")
    assert thm.estimate_heightmap(meta, 0.1, 3.2, 2.0).device.type == "meta"
    assert ttf.transform_cloud(meta, torch.eye(4, device="meta")).device.type \
        == "meta"
    assert thm.hm_to_cloud(torch.zeros((8, 8), device="meta"),
                           3.2).device.type == "meta"
    with pytest.raises((RuntimeError, ValueError)):
        ttf.transform_cloud(meta, torch.eye(4))
    with pytest.raises((RuntimeError, ValueError)):
        thm.inpaint_heightmap(torch.zeros((8, 8)),
                              torch.zeros((8, 8), device="meta"))


def test_heightmap_module_keeps_the_jax_signatures():
    for name in thm.__all__:
        if name == "filter_grid":
            continue
        assert (list(inspect.signature(getattr(thm, name)).parameters)
                == list(inspect.signature(getattr(jhm, name)).parameters))
    for name in ttf.__all__:
        assert (list(inspect.signature(getattr(ttf, name)).parameters)
                == list(inspect.signature(getattr(jtf, name)).parameters))
