"""The port's host data path against the JAX package's, on the synthetic
ROUGH sequence of ``tests/fixtures.py``: the reader, its cached labels and
resized images, the heightmap rasterization, the split and the loaders,
calibration and YAML IO, the camera and augmentation helpers, and the
dataset explorer's figure.  Both sides are numpy and PIL, so every result
is held equal, not close."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_sequence, tiny_lss_cfg
from monoforce_tpu import vis as jvis
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.datasets import augment as jaug
from monoforce_tpu.datasets import camera as jcam
from monoforce_tpu.datasets import rough as jrough
from monoforce_tpu.utils import data as jdata
from monoforce_tpu.utils import io as jio
from monoforce_tpu_torch import native, vis
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.datasets import augment, camera, rough
from monoforce_tpu_torch.utils import data, io

N_FRAMES = 6
DPHYS = dict(robot="tradr", traj_sim_time=0.5)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """Two byte-equal copies of one sequence, one per reader, so that each
    reader writes its own label and image caches."""
    return {side: make_sequence(str(tmp_path_factory.mktemp(side)),
                                n_frames=N_FRAMES)
            for side in ("jax", "torch")}


def _readers(seqs, is_train, seed=0):
    lss = tiny_lss_cfg()
    return (jrough.ROUGH(seqs["jax"], lss_cfg=lss,
                         dphys_cfg=JaxPhysicsConfig(**DPHYS),
                         is_train=is_train, seed=seed),
            rough.ROUGH(seqs["torch"], lss_cfg=lss,
                        dphys_cfg=PhysicsConfig(**DPHYS),
                        is_train=is_train, seed=seed))


def _equal(a, b, what=""):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{k}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True), what


def _cached(seq, sub):
    d = os.path.join(seq, *sub.split("/"))
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("is_train", [False, True], ids=["val", "train"])
def test_reader_matches_jax(seqs, is_train):
    """ids, poses and every element of get_sample's 16-tuple for two
    indices, in val mode and in train mode (the same seed draws the same
    augmentations), and the caches each reader wrote."""
    jds, tds = _readers(seqs, is_train, seed=3)
    assert isinstance(tds, torch.utils.data.Dataset)
    assert tds.ids == jds.ids and len(tds) == len(jds) == N_FRAMES
    assert tds.camera_names == jds.camera_names
    _equal(tds.poses_ts, jds.poses_ts, "poses_ts")
    _equal(tds.poses, jds.poses, "poses")
    for i in (0, 2):
        _equal(tds.get_sample(i), jds.get_sample(i), f"sample {i}")
        _equal(tds.get_initial_pose_on_heightmap(i),
               jds.get_initial_pose_on_heightmap(i))
        _equal(tds.get_footprint_traj_points(i),
               jds.get_footprint_traj_points(i))
    for sub in ("terrain/geom", "terrain/rigid"):
        names = _cached(seqs["torch"], sub)
        assert names and names == _cached(seqs["jax"], sub), sub
        for name in names:
            _equal(*(np.load(os.path.join(s, *sub.split("/"), name))
                     for s in (seqs["torch"], seqs["jax"])), name)
    names = _cached(seqs["torch"], "images/resized")
    assert names and names == _cached(seqs["jax"], "images/resized")
    for name in names:
        pix = []
        for s in (seqs["torch"], seqs["jax"]):
            with Image.open(os.path.join(s, "images", "resized", name)) as im:
                pix.append(np.asarray(im))
        _equal(*pix, name)


def test_labels_without_cache_match_jax(seqs):
    """Labels computed afresh (cached=False) equal the JAX reader's, and the
    semantic cloud from the seg PNGs too."""
    jds, tds = _readers(seqs, False)
    for i in (1, N_FRAMES - 1):
        _equal(tds.get_geom_height_map(i, cached=False),
               jds.get_geom_height_map(i, cached=False))
        _equal(tds.get_terrain_height_map(i, cached=False),
               jds.get_terrain_height_map(i, cached=False))
        _equal(tds.get_semantic_cloud(i, ["rock"]),
               jds.get_semantic_cloud(i, ["rock"]))
        _equal(tds.get_controls(i), jds.get_controls(i))
        _equal(tds.get_states_traj(i), jds.get_states_traj(i))


def test_read_only_dataset_falls_back(seqs, tmp_path, monkeypatch):
    """A dataset directory that cannot be written: the resized image is
    made in memory, the labels are computed and not cached, and the sample
    is the one the writable reader gives."""
    import shutil

    seq = shutil.copytree(seqs["torch"], str(tmp_path / "ro"),
                          ignore=shutil.ignore_patterns("resized", "terrain"))
    want = _readers(seqs, False)[1].get_sample(4)

    def denied(*args, **kwargs):
        raise PermissionError("read-only")

    ds = rough.ROUGH(seq, lss_cfg=tiny_lss_cfg(),
                     dphys_cfg=PhysicsConfig(**DPHYS))
    monkeypatch.setattr(rough.os, "makedirs", denied)
    _equal(ds.get_sample(4), want)
    assert not os.path.exists(os.path.join(seq, "terrain"))
    assert not os.path.exists(os.path.join(seq, "images", "resized"))


def _border_cloud(rng, n=4000):
    """Points on the float32 cell edges and on the decimal borders
    k * 0.1 - 6.4, random points, NaN rows."""
    bins = np.arange(-6.4, 6.4, 0.1, dtype=np.float32)
    ix, iy = rng.integers(0, 128, n), rng.integers(0, 128, n)
    z = rng.uniform(-2.5, 2.5, n)
    edges = np.stack([bins[ix], bins[iy], z], 1)
    decimal = np.stack([ix * 0.1 - 6.4, iy * 0.1 - 6.4, z], 1)
    rand = rng.uniform(-7, 7, (n, 3))
    pts = np.concatenate([edges, decimal, rand]).astype(np.float32)
    pts[::97] = np.nan
    pts[5::101, 1] = np.nan
    return pts


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_estimate_heightmap_np_matches_jax(path, monkeypatch):
    """estimate_heightmap_np through the native library and through its
    numpy fallback, against the JAX package's same path."""
    from monoforce_tpu import native as jnative

    if path == "native":
        assert native.available() and jnative.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    rng = np.random.default_rng(4)
    pts = _border_cloud(rng)
    for kw in ({}, {"r_min": 0.6}, {"h_min": -0.5}):
        got = rough.estimate_heightmap_np(pts, 0.1, 6.4, 2.0, **kw)
        want = jrough.estimate_heightmap_np(pts, 0.1, 6.4, 2.0, **kw)
        _equal(got, want, str(kw))
        assert got.shape == (2, 128, 128) and got[1].sum() > 1000


def test_rough_seq_dirs(seqs, tmp_path):
    root = os.path.dirname(os.path.dirname(seqs["torch"]))
    assert rough.rough_seq_dirs(root) == jrough.rough_seq_dirs(root) == [
        seqs["torch"]]
    assert rough.rough_seq_dirs(str(tmp_path)) == []


def _datasets(seqs, side, small=False):
    lss = tiny_lss_cfg()
    if side == "jax":
        def Data(path, is_train=False):
            return jrough.ROUGH(path, lss_cfg=lss,
                                dphys_cfg=JaxPhysicsConfig(**DPHYS),
                                is_train=is_train)
        return jdata.compile_data([seqs["jax"]], Data, small_data=small,
                                  val_fraction=0.34)

    def Data(path, is_train=False):
        return rough.ROUGH(path, lss_cfg=lss, dphys_cfg=PhysicsConfig(**DPHYS),
                           is_train=is_train)
    return data.compile_data([seqs["torch"]], Data, small_data=small,
                             val_fraction=0.34)


def test_compile_data_and_loaders_match_jax(seqs):
    """The seeded split, NumpyLoader's shuffled batches over two epochs
    (seed 0, a short last batch) and PrefetchLoader's batches."""
    (jtr, jva), (ttr, tva) = _datasets(seqs, "jax"), _datasets(seqs, "torch")
    assert len(ttr) == len(jtr) == 4 and len(tva) == len(jva) == 2
    for t, j in ((ttr, jtr), (tva, jva)):
        assert [list(p.indices) for p in t.datasets] == [
            list(p.indices) for p in j.datasets]
    (_, jsmall), (tsmall, _) = (_datasets(seqs, "jax", small=True),
                                _datasets(seqs, "torch", small=True))
    assert len(tsmall) == 2 and len(jsmall) == 2
    tl = data.NumpyLoader(ttr, batch_size=3, shuffle=True, seed=0)
    jl = jdata.NumpyLoader(jtr, batch_size=3, shuffle=True, seed=0)
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert [b[0].shape[0] for b in got] == [3, 1]
        _equal(got, want)
    tl = data.PrefetchLoader(data.NumpyLoader(tva, batch_size=1))
    jl = jdata.PrefetchLoader(jdata.NumpyLoader(jva, batch_size=1))
    assert len(tl) == 2
    _equal(list(tl), list(jl))


class _Failing:
    def __init__(self, n_ok):
        self.n_ok = n_ok

    def __iter__(self):
        for i in range(self.n_ok):
            yield (np.full(2, i, np.float32),)
        raise OSError("truncated PNG")


def test_prefetch_loader_passes_errors_and_stops():
    """An error while loading reaches the consumer after the batches before
    it; a consumer that stops early leaves no thread behind."""
    import threading

    it = iter(data.PrefetchLoader(_Failing(2), prefetch=1))
    assert next(it)[0][0] == 0 and next(it)[0][0] == 1
    with pytest.raises(OSError, match="truncated"):
        next(it)
    before = threading.active_count()
    it = iter(data.PrefetchLoader(_Failing(50), prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() <= before


def test_calib_yaml_camera_and_augment_match_jax(seqs, tmp_path):
    calib_dir = os.path.join(seqs["torch"], "calibration")
    got, want = io.load_calib(calib_dir), jio.load_calib(calib_dir)
    assert got == want and got["clearance"] == pytest.approx(0.1)
    assert io.load_calib(str(tmp_path)) is None
    rec = {"a": np.arange(3.0), "b": {"c": np.float32(1.5), "d": (1, 2)},
           "e": [np.int64(4)]}
    io.write_to_yaml(rec, str(tmp_path / "t.yaml"))
    jio.write_to_yaml(rec, str(tmp_path / "j.yaml"))
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert io.read_yaml(str(tmp_path / "t.yaml")) == {
        "a": [0.0, 1.0, 2.0], "b": {"c": 1.5, "d": [1, 2]}, "e": [4]}

    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (3, 50))
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    trans = rng.normal(size=3)
    K = np.array([[50.0, 0, 40], [0, 50, 30], [0, 0, 1]])
    for fn in ("ego_to_cam", "cam_to_ego"):
        _equal(getattr(camera, fn)(pts, rot, trans, K),
               getattr(jcam, fn)(pts, rot, trans, K), fn)
    proj = camera.ego_to_cam(pts, rot, trans, K)
    _equal(camera.in_image_mask(proj, 60, 80), jcam.in_image_mask(proj, 60, 80))
    depth = rng.integers(0, 5000, (6, 8)).astype(np.uint16)
    _equal(camera.depth_to_cloud(depth, K), jcam.depth_to_cloud(depth, K))

    img = Image.fromarray(rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
    lss = tiny_lss_cfg()
    for is_train in (False, True):
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(4):
            aug = augment.sample_augmentation(lss, is_train, rng=a)
            assert aug == jaug.sample_augmentation(lss, is_train, rng=b)
            eye, zero = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
            t_img, *t_post = augment.img_transform(img, eye, zero, *aug)
            j_img, *j_post = jaug.img_transform(img, eye, zero, *aug)
            _equal(np.asarray(t_img), np.asarray(j_img))
            _equal(t_post, j_post)
            _equal(augment.normalize_img(t_img), jaug.normalize_img(j_img))
            chw = augment.normalize_img(t_img)
            _equal(augment.denormalize_img(chw), jaug.denormalize_img(chw))
    big = Image.fromarray(rng.integers(0, 255, (600, 960, 3), dtype=np.uint8))
    _equal(np.asarray(augment.resize_img(big)), np.asarray(jaug.resize_img(big)))
    assert augment.resize_img(big).size == (819, 512)
    _equal(augment.IMG_MEAN, jaug.IMG_MEAN)
    _equal(augment.IMG_STD, jaug.IMG_STD)
    assert vis.denormalize_img is augment.denormalize_img


def test_explore_sample_matches_jax(seqs, tmp_path):
    """vis.explore_sample draws the same pixels as the JAX package's."""
    sample = _readers(seqs, False)[1].get_sample(1)
    vis.explore_sample(sample, d_max=6.4, path=str(tmp_path / "t.png"))
    jvis.explore_sample(sample, d_max=6.4, path=str(tmp_path / "j.png"))
    with Image.open(tmp_path / "t.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.size == b.size
        assert np.array_equal(np.asarray(a), np.asarray(b))
