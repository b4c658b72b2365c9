"""Configuration layer of the PyTorch port.

Port of ``monoforce_tpu/config.py`` (``PhysicsConfig``, :37-234;
``DEFAULT_LSS_CONFIG`` and ``LSSConfig``, :236-324), kept as an own copy so
that the port imports nothing of the JAX package.  The field
surface mirrors the reference ``DPhysConfig`` (reference: monoforce/src/
monoforce/models/traj_predictor/dphys_config.py:77-188): robot presets
(tradr/marv/husky), contact points, driving-part masks, grid geometry,
terrain defaults and shooting parameters, with a YAML round trip.

The config is host side (numpy and Python scalars).  Device tensors are made
once by :meth:`PhysicsConfig.robot_model`, on ``cuda`` unless the caller
asks for another device.  ``LSSConfig`` mirrors the reference's
``lss_cfg.yaml`` (reference: monoforce/config/lss_cfg.yaml) for the terrain
encoder: grid and depth bounds and image augmentation.  PyYAML is imported
inside the YAML methods only.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from portbench.reference import robots as _robots

__all__ = ["PhysicsConfig", "LSSConfig", "DEFAULT_LSS_CONFIG"]


_ROBOT_MASS = {"tradr": 40.0, "marv": 60.0, "husky": 50.0}

_JOINT_POSITIONS = {
    "tradr": {
        "fl": [0.250, 0.272, 0.019],
        "fr": [0.250, -0.272, 0.019],
        "rl": [-0.250, 0.272, 0.019],
        "rr": [-0.250, -0.272, 0.019],
    },
    "marv": {
        "fl": [0.250, 0.272, 0.019],
        "fr": [0.250, -0.272, 0.019],
        "rl": [-0.250, 0.272, 0.019],
        "rr": [-0.250, -0.272, 0.019],
    },
    "husky": {
        "fl": [0.256, 0.285, 0.033],
        "fr": [0.256, -0.285, 0.033],
        "rl": [-0.256, 0.285, 0.033],
        "rr": [-0.256, -0.285, 0.033],
    },
}


def _robot_key(robot: str) -> str:
    for key in _ROBOT_MASS:
        if key in robot:
            return key
    raise ValueError(f"Robot {robot!r} not supported. Available: {list(_ROBOT_MASS)}")


@dataclass
class PhysicsConfig:
    """Physics / terrain / shooting configuration (host side).

    Field set matches DPhysConfig (dphys_config.py:77-153); array-valued
    members (robot_points, driving_parts, ...) are numpy and derived in
    ``__post_init__``.
    """

    robot: str = "tradr"
    grid_res: float = 0.1

    # robot limits
    vel_max: float = 1.0     # m/s
    omega_max: float = 2.0   # rad/s

    # gravity
    gravity: float = 9.81
    gravity_direction: tuple = (0.0, 0.0, -1.0)

    # heightmap geometry
    r_min: float = 0.6   # min distance of terrain measurements from the robot [m]
    d_max: float = 6.4   # half-size of the terrain; range [-d_max, d_max)
    h_max: float = 2.0   # terrain height range [-h_max, h_max]

    # terrain defaults
    stiffness: float = 50_000.0  # N/m
    friction_coef: float = 1.0

    # trajectory shooting
    traj_sim_time: float = 5.0
    dt: float = 0.01
    n_sim_trajs: int = 64
    integration_mode: str = "euler"  # 'euler' | 'rk4'
    # which reference integrator the exact engine dispatches to (reference
    # default True, dphys_config.py:153); kept for the YAML round trip, the
    # exact engine comes with a later slice
    use_odeint: bool = False

    # optional mesh source for contact points
    mesh_path: Optional[str] = None
    mesh_voxel_size: float = 0.11

    # derived (filled in __post_init__)
    robot_mass: float = field(default=0.0)
    damping: float = field(default=0.0)
    robot_points: np.ndarray = field(default=None, repr=False)
    driving_parts: np.ndarray = field(default=None, repr=False)  # (K, P) bool
    robot_size: tuple = field(default=(0.0, 0.0))
    joint_positions: dict = field(default_factory=dict)
    joint_angles: dict = field(default_factory=dict)

    @classmethod
    def for_planner(cls, robot: str = "tradr", **overrides) -> "PhysicsConfig":
        """Serving-grade config: the coarsest contact preset that keeps the
        point count within 64 (the ``pair`` planner modes)."""
        key = _robot_key(robot)
        voxel = {"tradr": 0.15, "marv": 0.13, "husky": 0.16}[key]
        overrides.setdefault("mesh_voxel_size", voxel)
        cfg = cls(robot=robot, **overrides)
        if cfg.robot_points.shape[0] > 64:
            raise ValueError(f"planner preset for {robot} yields "
                             f"{cfg.robot_points.shape[0]} > 64 contact points")
        return cfg

    def __post_init__(self):
        key = _robot_key(self.robot)
        self.robot_mass = _ROBOT_MASS[key]
        # critical damping sqrt(4 m k) (dphys_config.py:143)
        self.damping = math.sqrt(4.0 * self.robot_mass * self.stiffness)
        if self.robot_points is None:
            self.robot_points = _robots.robot_point_cloud(
                key, voxel_size=self.mesh_voxel_size, mesh_path=self.mesh_path)
        self.robot_points = np.asarray(self.robot_points, dtype=np.float32)
        if self.driving_parts is None:
            self.driving_parts, self.robot_size = _robots.driving_part_masks(
                key, self.robot_points)
        self.driving_parts = np.asarray(self.driving_parts)
        if not self.joint_positions:
            self.joint_positions = dict(_JOINT_POSITIONS[key])
        if not self.joint_angles:
            self.joint_angles = {k: 0.0 for k in ("fl", "fr", "rl", "rr")}

    # ------------------------------------------------------------------ grids
    @property
    def grid_shape(self) -> tuple:
        n = int(round(2 * self.d_max / self.grid_res))
        return (n, n)

    @property
    def n_sim_steps(self) -> int:
        return int(self.traj_sim_time / self.dt)

    def grid_coords(self):
        """(x_grid, y_grid) 'ij' meshgrids like dphys_config.py:137-139."""
        ax = np.arange(-self.d_max, self.d_max, self.grid_res, dtype=np.float32)
        return np.meshgrid(ax, ax, indexing="ij")

    def default_friction(self, batch_shape=()) -> np.ndarray:
        return np.full(batch_shape + self.grid_shape, self.friction_coef,
                       dtype=np.float32)

    def default_z_grid(self, batch_shape=()) -> np.ndarray:
        return np.zeros(batch_shape + self.grid_shape, dtype=np.float32)

    # ------------------------------------------------------------- device side
    def robot_model(self, device="cuda"):
        """The device-side RobotModel for the physics code, on ``device``."""
        from portbench.reference.engine import RobotModel
        return RobotModel.from_config(self, device=device)

    # ------------------------------------------------------------------- yaml
    _YAML_SKIP = ("robot_points", "driving_parts")

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            if f.name in self._YAML_SKIP:
                continue
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = v.tolist()
            if isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    def to_yaml(self, path: str):
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f)

    # Fields recomputed by __post_init__; they must be restored AFTER
    # construction so saved (possibly user-modified) values win.
    _YAML_DERIVED = ("robot_mass", "damping", "robot_size",
                     "joint_positions", "joint_angles")

    @classmethod
    def from_yaml(cls, path: str) -> "PhysicsConfig":
        """Restore every serialized attribute, like the reference
        ``DPhysConfig.from_yaml`` (dphys_config.py:173-188), derived fields
        included."""
        import yaml
        with open(path, "r") as f:
            params = yaml.safe_load(f)
        init_names = {f.name for f in dataclasses.fields(cls) if f.init}
        kwargs = {k: v for k, v in params.items()
                  if k in init_names and k not in cls._YAML_DERIVED}
        if "gravity_direction" in kwargs:
            kwargs["gravity_direction"] = tuple(kwargs["gravity_direction"])
        cfg = cls(**kwargs)
        for k in cls._YAML_DERIVED:
            if k in params:
                v = params[k]
                if k == "robot_size":
                    v = tuple(v)
                setattr(cfg, k, v)
        return cfg


# ---------------------------------------------------------------------- LSS
DEFAULT_LSS_CONFIG = {
    # image augmentation (lss_cfg.yaml:1-17)
    "data_aug_conf": {
        "H": 1200,
        "W": 1920,
        "final_dim": (256, 416),
        "resize_lim": (0.193, 0.225),
        "bot_pct_lim": (0.0, 0.0),
        "rot_lim": (-5.4, 5.4),
        "rand_flip": False,
    },
    # BEV grid / depth bins (lss_cfg.yaml:19-34)
    "grid_conf": {
        "xbound": (-6.4, 6.4, 0.1),
        "ybound": (-6.4, 6.4, 0.1),
        "zbound": (-3.2, 3.2, 6.4),
        "dbound": (0.6, 6.4, 0.1),
    },
    "img_mean": (0.485, 0.456, 0.406),
    "img_std": (0.229, 0.224, 0.225),
    # terrain classes considered soft / traversable (lss_cfg.yaml:55-60)
    "soft_classes": ("tree-foliage", "bush", "grass", "sky", "unlabelled"),
}


@dataclass
class LSSConfig:
    """Terrain-encoder configuration (grid + augmentation), LSS-compatible."""

    data_aug_conf: dict = field(default_factory=lambda: dict(DEFAULT_LSS_CONFIG["data_aug_conf"]))
    grid_conf: dict = field(default_factory=lambda: dict(DEFAULT_LSS_CONFIG["grid_conf"]))
    img_mean: tuple = DEFAULT_LSS_CONFIG["img_mean"]
    img_std: tuple = DEFAULT_LSS_CONFIG["img_std"]
    soft_classes: tuple = DEFAULT_LSS_CONFIG["soft_classes"]
    outC: int = 1
    camC: int = 64
    downsample: int = 16

    @classmethod
    def preset(cls, name: str) -> "LSSConfig":
        """Named presets matching the two committed reference configs:

        - ``default``: the offline/training geometry (lss_cfg.yaml --
          1200x1920 raw images, train-time augmentation limits),
        - ``resize``: the online geometry (lss_cfg_resize.yaml + the
          img_preproc.launch 480x300 resize nodelets) -- raw images arrive
          pre-resized to 300x480 and the aug-limit keys are absent (val-mode
          augmentation touches only bot_pct_lim/final_dim).
        """
        if name == "default":
            return cls()
        if name == "resize":
            return cls(data_aug_conf={
                "H": 300, "W": 480,
                "final_dim": (256, 416),
                "bot_pct_lim": (0.0, 0.0),
            })
        raise ValueError(f"unknown LSS preset {name!r} "
                         "(expected 'default' or 'resize')")

    @classmethod
    def from_yaml(cls, path: str) -> "LSSConfig":
        import yaml
        with open(path, "r") as f:
            params = yaml.safe_load(f)
        kw = {}
        for k in ("data_aug_conf", "grid_conf", "img_mean", "img_std", "soft_classes"):
            if k in params:
                v = params[k]
                if isinstance(v, list):
                    v = tuple(v)
                kw[k] = v
        for conf_key in ("data_aug_conf", "grid_conf"):
            if conf_key in kw:
                kw[conf_key] = {k: tuple(v) if isinstance(v, list) else v
                                for k, v in kw[conf_key].items()}
        return cls(**kw)

    def to_yaml(self, path: str):
        import yaml
        out = dataclasses.asdict(self)

        def _clean(v):
            if isinstance(v, tuple):
                return [_clean(x) for x in v]
            if isinstance(v, dict):
                return {k: _clean(x) for k, x in v.items()}
            return v
        with open(path, "w") as f:
            yaml.safe_dump(_clean(out), f)
