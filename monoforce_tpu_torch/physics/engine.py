"""Rigid-body state and robot parameters of the PyTorch port.

Port of ``monoforce_tpu/physics/engine.py``: ``RigidState`` (:64-70),
``RobotModel.from_config`` (:82-133), ``inertia_tensor`` (:136-152),
``auto_remat_segment`` (:483-494) and ``_default_state0`` (:497-505).  The
exact engine (``rollout`` and its integrators) comes with a later slice.

``RobotModel`` holds the robot's parameter set as float32 tensors on one
device; scalars are 0-d tensors so that the port's arithmetic runs in
float32 like the reference's.  It has no learned weights: the robot model
is the whole parameter set of the planner path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["RigidState", "RobotModel", "inertia_tensor", "on_device",
           "resolve_device", "auto_remat_segment"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  A CUDA device without a visible card raises here rather than
    letting the caller carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return device


def on_device(x, device: torch.device, name: str) -> torch.Tensor:
    """``x`` as float32 on ``device``.  Arrays and lists are copied there;
    a tensor already on another device raises instead of being moved, so
    an entry point never carries on quietly on a device it was not given."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"{name} is on {x.device}, the robot on {device}")
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class RigidState(NamedTuple):
    """State of the rigid body: position, velocity, rotation, angular rate."""

    x: torch.Tensor      # (..., 3)
    xd: torch.Tensor     # (..., 3)
    R: torch.Tensor      # (..., 3, 3)
    omega: torch.Tensor  # (..., 3)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Device-side robot + terrain-interaction parameters (float32).

    ``n_tracks`` / ``has_flippers`` / ``integration_mode`` are the static
    fields that select code paths; every other field is a tensor.
    """

    points: torch.Tensor            # (P, 3) body-frame contact points
    driving_masks: torch.Tensor     # (K, P) 0/1 disjoint driving parts
    mass: torch.Tensor              # ()
    inertia_inv: torch.Tensor       # (3, 3) inverse inertia of the points
    joint_positions: torch.Tensor   # (4, 3) flipper joint positions (marv)
    robot_size: torch.Tensor        # (2,) (s_x, s_y)
    gravity: torch.Tensor           # ()
    gravity_direction: torch.Tensor  # (3,)
    stiffness: torch.Tensor         # () N/m
    damping: torch.Tensor           # () N s/m
    omega_max: torch.Tensor         # () clamp for angular acceleration
    d_max: torch.Tensor             # () heightmap half-extent
    grid_res: torch.Tensor          # () heightmap cell size
    dt: torch.Tensor                # () integration step
    n_tracks: int = 2
    has_flippers: bool = False
    integration_mode: str = "euler"

    @property
    def device(self) -> torch.device:
        return self.points.device

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "RobotModel":
        device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32).to(device)

        # the inverse is taken on the CPU so that every device gets the same
        # float32 parameters
        pts = torch.as_tensor(cfg.robot_points, dtype=torch.float32)
        inertia_inv = torch.linalg.inv(inertia_tensor(cfg.robot_mass, pts))
        return cls(
            points=pts.to(device),
            driving_masks=f32(cfg.driving_parts.astype("float32")),
            mass=f32(cfg.robot_mass),
            inertia_inv=inertia_inv.to(device),
            joint_positions=f32(
                [cfg.joint_positions[k] for k in ("fl", "fr", "rl", "rr")]),
            robot_size=f32(cfg.robot_size),
            gravity=f32(cfg.gravity),
            gravity_direction=f32(cfg.gravity_direction),
            stiffness=f32(cfg.stiffness),
            damping=f32(cfg.damping),
            omega_max=f32(cfg.omega_max),
            d_max=f32(cfg.d_max),
            grid_res=f32(cfg.grid_res),
            dt=f32(cfg.dt),
            n_tracks=int(cfg.driving_parts.shape[0]),
            has_flippers=("marv" in cfg.robot),
            integration_mode=cfg.integration_mode,
        )


def inertia_tensor(mass, points: torch.Tensor) -> torch.Tensor:
    """Inertia tensor of equal point masses (reference: dphysics.py:107-141).

    points: (P, 3) -> (3, 3).
    """
    m_pt = mass / points.shape[0]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ixx = torch.sum(m_pt * (y ** 2 + z ** 2))
    iyy = torch.sum(m_pt * (x ** 2 + z ** 2))
    izz = torch.sum(m_pt * (x ** 2 + y ** 2))
    ixy = -torch.sum(m_pt * x * y)
    ixz = -torch.sum(m_pt * x * z)
    iyz = -torch.sum(m_pt * y * z)
    return torch.stack([torch.stack([ixx, ixy, ixz]),
                        torch.stack([ixy, iyy, iyz]),
                        torch.stack([ixz, iyz, izz])])


def auto_remat_segment(n: int, threshold: int = 64) -> Optional[int]:
    """Pick a remat segment length for an N-step BPTT horizon: the divisor of
    N closest to sqrt(N) (minimizing stored-boundaries + recompute-window
    memory).  Returns None for short horizons where remat only adds
    recompute."""
    if n < threshold:
        return None
    target = max(1, int(round(n ** 0.5)))
    divisors = [k for k in range(2, n) if n % k == 0]
    if not divisors:
        return None
    return min(divisors, key=lambda k: abs(k - target))


def _default_state0(controls: torch.Tensor) -> RigidState:
    """Reference default initial state (dphysics.py:554-559): at the origin,
    moving with the first commanded (v, w)."""
    B = controls.shape[0]
    kw = dict(dtype=controls.dtype, device=controls.device)
    x = torch.zeros((B, 3), **kw)
    xd = torch.zeros((B, 3), **kw)
    xd[:, 0] = controls[:, 0, 0]
    R = torch.eye(3, **kw).expand(B, 3, 3)
    omega = torch.zeros((B, 3), **kw)
    omega[:, 2] = controls[:, 0, 1]
    return RigidState(x, xd, R, omega)
