"""ROUGH dataset reader (host-side numpy).

Reference parity: monoforce/src/monoforce/datasets/rough.py — per-sequence
directories of lidar clouds (``clouds/*.npz``), four cameras
(``images/<stamp>_<cam>.png`` + ``images/wildscenes_seg/seg``), poses
(``poses/lidar_poses.csv``), commands (``controls/cmd_vel.csv``) and
calibration (``calibration/``).  ``get_sample`` yields the same 16-tuple the
reference trainer consumes (rough.py:651-663):

  (imgs, rots, trans, intrins, post_rots, post_trans,
   hm_geom, hm_terrain, control_ts, controls, pose0,
   traj_ts, Xs, Xds, Rs, Omegas)

Port of ``monoforce_tpu/datasets/rough.py``, whole.  Everything here is
numpy/PIL data preparation, as in the JAX package, so that the two readers
give equal samples; device work starts at the trainer's inputs.  ``ROUGH``
is a ``torch.utils.data.Dataset`` that returns numpy.  Heightmap labels are
cached to ``terrain/{geom,rigid}`` as in the reference.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image
from torch.utils.data import Dataset

from monoforce_tpu_torch import native
from monoforce_tpu_torch.config import PhysicsConfig, DEFAULT_LSS_CONFIG
from monoforce_tpu_torch.datasets.augment import (
    img_transform, normalize_img, resize_img, sample_augmentation,
)
from monoforce_tpu_torch.datasets.camera import ego_to_cam, in_image_mask
from monoforce_tpu_torch.datasets.wildscenes import METAINFO, rigid_classes
from monoforce_tpu_torch.utils.io import load_calib
from monoforce_tpu_torch.utils.misc import position

__all__ = ["ROUGH", "estimate_heightmap_np", "rough_seq_dirs"]


def rough_seq_dirs(data_dir: str):
    """All ROUGH sequence directories under ``data_dir`` (the reference pins
    an explicit list, rough.py:31-60; we glob the same layout)."""
    root = os.path.join(data_dir, "ROUGH")
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def estimate_heightmap_np(points: np.ndarray, grid_res: float, d_max: float,
                          h_max: float, r_min: Optional[float] = None,
                          h_min: Optional[float] = None) -> np.ndarray:
    """Host max-z rasterization, same semantics as ops.heightmap (see
    cloudproc.py:88-148 incl. the final transpose).  Uses the native C++
    hostops library when available (the label-generation hot loop over
    multi-million-point clouds); numpy otherwise."""
    out = native.estimate_heightmap(points, grid_res, d_max, h_max,
                                    r_min=r_min, h_min=h_min)
    if out is not None:
        return out
    pts = points[~np.isnan(points).any(axis=1)]
    if r_min is not None:
        pts = pts[np.linalg.norm(pts[:, :2], axis=1) > r_min]
    if h_min is None:
        h_min = -h_max
    m = ((pts[:, 0] > -d_max) & (pts[:, 0] < d_max)
         & (pts[:, 1] > -d_max) & (pts[:, 1] < d_max)
         & (pts[:, 2] > h_min) & (pts[:, 2] < h_max))
    pts = pts[m]
    bins = np.arange(-d_max, d_max, grid_res)
    n = len(bins)
    xi = np.searchsorted(bins, pts[:, 0], side="right") - 1
    yi = np.searchsorted(bins, pts[:, 1], side="right") - 1
    flat = np.full(n * n, -np.inf, dtype=np.float32)
    np.maximum.at(flat, yi * n + xi, pts[:, 2].astype(np.float32))
    grid = flat.reshape(n, n)
    mask = np.isfinite(grid)
    grid = np.where(mask, grid, 0.0)
    return np.stack([grid.T, mask.T.astype(np.float32)], axis=0)


def _save_label(fpath: str, hm: np.ndarray):
    """Cache a label as ``fpath`` (.npy), written under a process-unique
    name and renamed into place, so that an interrupted write leaves no
    truncated file behind the reader's ``exists()`` check; a dataset
    directory that cannot be written keeps no cache (the JAX reader raises
    there)."""
    tmp = fpath + f".tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(fpath), exist_ok=True)
        with open(tmp, "wb") as f:
            np.save(f, hm)
        os.replace(tmp, fpath)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)


class ROUGH(Dataset):
    """One ROUGH sequence; indexable by sample id."""

    CAMERAS = ("camera_left", "camera_front", "camera_right", "camera_rear")

    def __init__(self, path: str, lss_cfg: Optional[dict] = None,
                 dphys_cfg: Optional[PhysicsConfig] = None,
                 is_train: bool = False, seed: int = 0):
        self.path = path
        self.name = os.path.basename(os.path.normpath(path))
        self.cloud_dir = os.path.join(path, "clouds")
        self.poses_path = os.path.join(path, "poses", "lidar_poses.csv")
        self.controls_path = os.path.join(path, "controls", "cmd_vel.csv")
        self.dphys_cfg = dphys_cfg or PhysicsConfig()
        self.lss_cfg = lss_cfg or dict(DEFAULT_LSS_CONFIG)
        self.grid_res = float(self.lss_cfg["grid_conf"]["xbound"][2])
        self.is_train = is_train
        self.calib = load_calib(os.path.join(path, "calibration"))
        self.ids = sorted(f[:-4] for f in os.listdir(self.cloud_dir))
        self.poses_ts, self.poses = self._load_poses()
        self.camera_names = [c for c in self.CAMERAS
                             if c in (self.calib or {})] or list(self.CAMERAS)
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- indexing
    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.get_sample(i)

    def stamp(self, i: int) -> float:
        return float(self.ids[i].replace("_", "."))

    # ----------------------------------------------------------------- poses
    def _load_poses(self):
        data = np.loadtxt(self.poses_path, delimiter=",", skiprows=1)
        data = np.atleast_2d(data)
        stamps = data[:, 0]
        mats = np.tile(np.eye(4, dtype=np.float32), (len(data), 1, 1))
        mats[:, :3, :4] = data[:, 1:13].reshape(-1, 3, 4)
        # lidar poses -> robot (base_link) poses
        T_rl = np.asarray(self.calib["transformations"]["T_base_link__os_sensor"]["data"],
                          dtype=np.float32).reshape(4, 4)
        return stamps, mats @ np.linalg.inv(T_rl)

    def get_pose(self, i: int) -> np.ndarray:
        return self.poses[np.argmin(np.abs(self.poses_ts - self.stamp(i)))]

    def get_initial_pose_on_heightmap(self, i: int) -> np.ndarray:
        """Gravity-aligned initial pose: keep roll/pitch, drop yaw+translation
        (rough.py:151-157)."""
        from scipy.spatial.transform import Rotation
        R_map = self.get_pose(i)[:3, :3]
        roll, pitch, _ = Rotation.from_matrix(R_map).as_euler("xyz")
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = Rotation.from_euler("xyz", [roll, pitch, 0.0]).as_matrix()
        return out

    # ---------------------------------------------------------------- clouds
    def get_raw_cloud(self, i: int) -> np.ndarray:
        cloud = np.load(os.path.join(self.cloud_dir, f"{self.ids[i]}.npz"))["cloud"]
        if cloud.ndim == 2 and cloud.dtype.names:
            cloud = cloud.reshape(-1)
        return cloud

    def get_cloud(self, i: int, gravity_aligned: bool = True) -> np.ndarray:
        pts = position(self.get_raw_cloud(i)).astype(np.float32)
        T = np.asarray(self.calib["transformations"]["T_base_link__os_sensor"]["data"],
                       dtype=np.float32).reshape(4, 4)
        pts = pts @ T[:3, :3].T + T[:3, 3]
        if gravity_aligned:
            G = self.get_initial_pose_on_heightmap(i)
            pts = pts @ G[:3, :3].T + G[:3, 3]
        return pts

    # -------------------------------------------------------------- controls
    def get_controls(self, i: int):
        """(v, w) commands interpolated onto the physics dt grid
        (rough.py:168-204)."""
        T, dt = self.dphys_cfg.traj_sim_time, self.dphys_cfg.dt
        horizon_ts = np.arange(0.0, T, dt, dtype=np.float32)
        if not os.path.exists(self.controls_path):
            return horizon_ts, np.zeros((len(horizon_ts), 2), np.float32)
        data = np.atleast_2d(np.loadtxt(self.controls_path, delimiter=",",
                                        skiprows=1))
        stamps, vals = data[:, 0], data[:, 1:3]
        t0 = self.stamp(i) - stamps[0]
        stamps = stamps - stamps[0]
        if t0 > stamps[-1] or t0 + T < stamps[0]:
            return horizon_ts, np.zeros((len(horizon_ts), 2), np.float32)
        il = int(np.argmin(np.abs(stamps - t0)))
        ir = int(np.argmin(np.abs(stamps - (t0 + T))))
        ir = min(max(il + 1, ir), len(stamps))
        seg_ts = stamps[il:ir] - stamps[il]
        seg = vals[il:ir]
        out = np.stack([np.interp(horizon_ts, seg_ts, seg[:, j],
                                  left=0.0, right=0.0) for j in range(2)],
                       axis=1).astype(np.float32)
        return horizon_ts, out

    # ------------------------------------------------------------ trajectory
    def get_traj(self, i: int, T_horizon: Optional[float] = None):
        """Future robot poses over the horizon, expressed in the local
        gravity-aligned frame (rough.py:213-259). Pose rate is 10 Hz."""
        T = T_horizon if T_horizon is not None else self.dphys_cfg.traj_sim_time
        dt = 0.1
        t_i = self.stamp(i)
        il = int(np.argmin(np.abs(self.poses_ts - t_i)))
        ir = int(np.argmin(np.abs(self.poses_ts - (self.poses_ts[il] + T))))
        ir = min(max(ir, il + 1), len(self.poses_ts))
        poses = self.poses[il:ir]
        stamps = self.poses_ts[il:ir].copy()
        poses = np.linalg.inv(poses[0]) @ poses
        stamps -= stamps[0]
        keep = stamps <= T
        poses, stamps = poses[keep], stamps[keep]
        n = int(np.ceil(T / dt))
        if len(poses) < n:
            pad = n - len(poses)
            poses = np.concatenate([poses, np.tile(poses[-1:], (pad, 1, 1))])
            stamps = np.concatenate(
                [stamps, stamps[-1] + np.arange(1, pad + 1) * dt])
        poses, stamps = poses[:n], stamps[:n]
        G = self.get_initial_pose_on_heightmap(i).astype(poses.dtype)
        return {"stamps": stamps.astype(np.float32), "poses": G @ poses}

    def get_states_traj(self, i: int):
        """GT state trajectory with finite-difference velocities
        (rough.py:261-296)."""
        traj = self.get_traj(i)
        poses, ts = traj["poses"], traj["stamps"] - traj["stamps"][0]
        xs = poses[:, :3, 3].astype(np.float32)
        Rs = poses[:, :3, :3].astype(np.float32)
        dps = np.diff(xs, axis=0)
        dts = np.diff(ts).reshape(-1, 1).astype(np.float32)
        dts = np.where(dts == 0, 1e-6, dts)
        theta = np.arctan2(dps[:, 1], dps[:, 0]).reshape(-1, 1)
        theta = np.concatenate([theta[:1], theta], axis=0)
        xds = np.zeros_like(xs)
        xds[:-1] = dps / dts
        omegas = np.zeros_like(xs)
        omegas[:-1, 2:3] = np.diff(theta, axis=0) / dts
        return ts.astype(np.float32), [xs, xds, Rs, omegas.astype(np.float32)]

    # -------------------------------------------------------------- heightmaps
    def get_geom_height_map(self, i: int, cached: bool = True) -> np.ndarray:
        """Lidar max-z heightmap, cached under terrain/geom (rough.py:319-341)."""
        fpath = os.path.join(self.path, "terrain", "geom", f"{self.ids[i]}.npy")
        if cached and os.path.exists(fpath):
            return np.load(fpath).astype(np.float32)
        hm = estimate_heightmap_np(self.get_cloud(i), grid_res=self.grid_res,
                                   d_max=self.dphys_cfg.d_max,
                                   h_max=self.dphys_cfg.h_max,
                                   r_min=self.dphys_cfg.r_min)
        _save_label(fpath, hm)
        return hm

    def get_footprint_traj_points(self, i: int, robot_size=(0.7, 1.0),
                                  T_horizon: Optional[float] = None) -> np.ndarray:
        """Points swept by the robot footprint along the future trajectory
        (rough.py:343-365)."""
        width, length = robot_size
        x = np.arange(-length / 2, length / 2, self.grid_res)
        y = np.arange(-width / 2, width / 2, self.grid_res)
        gx, gy = np.meshgrid(x, y)
        fp = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
        clearance = self.calib.get("clearance", 0.0)
        poses = self.get_traj(i, T_horizon=T_horizon)["poses"].copy()
        poses[:, 2, 3] -= abs(clearance)
        pts = np.einsum("tij,pj->tpi", poses[:, :3, :3], fp) + poses[:, None, :3, 3]
        return pts.reshape(-1, 3).astype(np.float32)

    def get_seg_label(self, i: int, camera: str) -> np.ndarray:
        seg_path = os.path.join(self.path, "images", "wildscenes_seg", "seg",
                                f"{self.ids[i]}_{camera}.png")
        seg = Image.open(seg_path)
        raw_h, raw_w = self.get_raw_img_size(i, camera)
        if seg.size != (raw_w, raw_h):
            seg = seg.resize((raw_w, raw_h), Image.NEAREST)
        return np.asarray(seg)

    def get_semantic_cloud(self, i: int, classes) -> np.ndarray:
        """Lidar points painted with per-camera segmentation labels and kept
        if their class is in ``classes`` (rough.py:545-601)."""
        cidx = [METAINFO["cidx"][METAINFO["classes"].index(c)] for c in classes]
        pts_ego = self.get_cloud(i, gravity_aligned=False)
        kept = []
        for cam in self.camera_names[::-1]:
            try:
                seg = self.get_seg_label(i, cam)
            except FileNotFoundError:
                continue
            K = np.asarray(self.calib[cam]["camera_matrix"]["data"],
                           dtype=np.float32).reshape(3, 3)
            E = np.asarray(self.calib["transformations"][f"T_base_link__{cam}"]["data"],
                           dtype=np.float32).reshape(4, 4)
            proj = ego_to_cam(pts_ego.T, E[:3, :3], E[:3, 3], K)
            m = in_image_mask(proj, seg.shape[0], seg.shape[1])
            uv = proj[:2, m].astype(int)
            labels = seg[uv[1], uv[0]]
            sel = np.isin(labels, cidx)
            kept.append(pts_ego[m][sel])
        if not kept:
            return np.zeros((0, 3), np.float32)
        pts = np.concatenate(kept, axis=0)
        G = self.get_initial_pose_on_heightmap(i)
        return (pts @ G[:3, :3].T + G[:3, 3]).astype(np.float32)

    def get_terrain_height_map(self, i: int, cached: bool = True) -> np.ndarray:
        """Supporting-terrain heightmap from rigid-class semantic points +
        footprint trajectory points, cached under terrain/rigid
        (rough.py:621-649)."""
        fpath = os.path.join(self.path, "terrain", "rigid", f"{self.ids[i]}.npy")
        if cached and os.path.exists(fpath):
            return np.load(fpath).astype(np.float32)
        traj_pts = self.get_footprint_traj_points(i, T_horizon=10.0)
        rigid = rigid_classes(self.lss_cfg["soft_classes"])
        seg_pts = self.get_semantic_cloud(i, classes=rigid)
        pts = np.concatenate([seg_pts, traj_pts], axis=0)
        hm = estimate_heightmap_np(pts, grid_res=self.grid_res,
                                   d_max=self.dphys_cfg.d_max,
                                   h_max=self.dphys_cfg.h_max)
        _save_label(fpath, hm)
        return hm

    # ---------------------------------------------------------------- images
    def get_raw_image(self, i: int, camera: str) -> Image.Image:
        return Image.open(os.path.join(self.path, "images",
                                       f"{self.ids[i]}_{camera}.png"))

    def get_raw_img_size(self, i: int = 0, camera: Optional[str] = None):
        with self.get_raw_image(i, camera or self.camera_names[0]) as img:
            return img.size[1], img.size[0]

    def get_image(self, i: int, camera: str):
        img = self.get_raw_image(i, camera)
        K = np.asarray(self.calib[camera]["camera_matrix"]["data"],
                       dtype=np.float32).reshape(3, 3)
        return img, K

    def get_cached_resized_img(self, i: int, camera: str):
        """Shorter-side-512 resized image, cached on disk next to the raw
        images (reference rough.py:442-457: the dataset path feeds
        ``img_transform`` the RESIZED image — a load-speed optimization that
        also changes the interpolation chain, so parity requires it).  Falls
        back to an in-memory resize when the dataset directory is not
        writable (the reference unconditionally ``os.makedirs``)."""
        cache_dir = os.path.join(self.path, "images", "resized")
        fpath = os.path.join(cache_dir, f"{self.ids[i]}_{camera}.png")
        if os.path.exists(fpath):
            K = np.asarray(self.calib[camera]["camera_matrix"]["data"],
                           dtype=np.float32).reshape(3, 3)
            # decode eagerly inside the context so the fd is closed (a
            # lazily-open handle per camera per frame leaks fds over an
            # epoch)
            with Image.open(fpath) as im:
                im.load()
                return im, K
        img, K = self.get_image(i, camera)
        img = resize_img(img)
        try:
            # write-then-rename so an interrupted save can never leave a
            # truncated PNG behind the exists() check above
            os.makedirs(cache_dir, exist_ok=True)
            tmp = fpath + f".tmp{os.getpid()}"
            img.save(tmp, format="PNG")
            os.replace(tmp, fpath)
        except OSError:
            pass
        return img, K

    def get_images_data(self, i: int):
        """Augmented image batch + calibration for the lift step
        (rough.py:459-514; images go through the shorter-side-512 resize
        cache first, rough.py:471)."""
        imgs, rots, trans, intrins, post_rots, post_trans = [], [], [], [], [], []
        G = self.get_initial_pose_on_heightmap(i)
        for cam in self.camera_names:
            img, K = self.get_cached_resized_img(i, cam)
            post_rot2 = np.eye(2, dtype=np.float32)
            post_tran2 = np.zeros(2, dtype=np.float32)
            aug = sample_augmentation(self.lss_cfg, is_train=self.is_train,
                                      rng=self._rng)
            img, post_rot2, post_tran2 = img_transform(
                img, post_rot2, post_tran2, *aug)
            post_rot = np.eye(3, dtype=np.float32)
            post_tran = np.zeros(3, dtype=np.float32)
            post_rot[:2, :2] = post_rot2
            post_tran[:2] = post_tran2

            E = np.asarray(self.calib["transformations"][f"T_base_link__{cam}"]["data"],
                           dtype=np.float32).reshape(4, 4)
            rot = G[:3, :3] @ E[:3, :3]

            imgs.append(normalize_img(img))
            rots.append(rot)
            trans.append(E[:3, 3])
            intrins.append(K)
            post_rots.append(post_rot)
            post_trans.append(post_tran)
        return [np.stack(a).astype(np.float32) for a in
                (imgs, rots, trans, intrins, post_rots, post_trans)]

    # ---------------------------------------------------------------- sample
    def get_sample(self, i: int):
        imgs, rots, trans, intrins, post_rots, post_trans = self.get_images_data(i)
        control_ts, controls = self.get_controls(i)
        traj_ts, (Xs, Xds, Rs, Omegas) = self.get_states_traj(i)
        hm_geom = self.get_geom_height_map(i)
        hm_terrain = self.get_terrain_height_map(i)
        pose0 = self.get_initial_pose_on_heightmap(i).astype(np.float32)
        return (imgs, rots, trans, intrins, post_rots, post_trans,
                hm_geom, hm_terrain, control_ts, controls, pose0,
                traj_ts, Xs, Xds, Rs, Omegas)
