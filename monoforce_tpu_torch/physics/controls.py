"""Control sampling and track-velocity kinematics of the PyTorch port.

Port of ``monoforce_tpu/physics/controls.py`` (whole module); reference
parity: generate_controls (dphysics.py:42-72) and vw_to_track_vels
(dphysics.py:75-104).  Sampling draws from a caller-owned
``torch.Generator``; its numbers differ from ``jax.random``'s for the same
seed, so the tests hand both packages the same numpy-made controls.
"""

from __future__ import annotations

import torch

from monoforce_tpu_torch.physics.engine import resolve_device

__all__ = ["generate_controls", "vw_to_track_vels", "time_stamps",
           "shooting_controls"]


def time_stamps(time_horizon: float = 5.0, dt: float = 0.01, device="cuda"):
    """linspace(0, T, int(T/dt)) like the reference's `ts`
    (dphysics.py:60,167), on ``cuda`` unless the caller names another
    device."""
    n = int(time_horizon / dt)
    return torch.linspace(0.0, time_horizon, n, device=resolve_device(device))


def generate_controls(generator: torch.Generator, n_trajs: int = 10,
                      time_horizon: float = 5.0, dt: float = 0.01,
                      v_range=(-1.0, 1.0), w_range=(-1.0, 1.0)):
    """Sample constant (v, w) command sequences for trajectory shooting on
    the generator's device.

    Returns controls (n_trajs, N, 2) and stamps (N,) with N = int(T/dt).
    """
    n = int(time_horizon / dt)
    device = generator.device
    v = torch.rand(n_trajs, generator=generator, device=device)
    w = torch.rand(n_trajs, generator=generator, device=device)
    v = v_range[0] + (v_range[1] - v_range[0]) * v
    w = w_range[0] + (w_range[1] - w_range[0]) * w
    controls = torch.stack([v, w], dim=-1)[:, None, :].expand(n_trajs, n, 2)
    return controls.contiguous(), time_stamps(time_horizon, dt, device)


def shooting_controls(generator: torch.Generator, n_trajs: int,
                      vel_max: float, omega_max: float,
                      time_horizon: float = 5.0, dt: float = 0.01):
    """Front/back split shooting controls like the online planner
    (monoforce_ros/nodes/monoforce_node.py:43-53): half the trajectories drive
    forward with v in [vel_max/2, vel_max], half backward in
    [-vel_max, -vel_max/2]; yaw rate in [-omega_max, omega_max]."""
    front, _ = generate_controls(generator, n_trajs // 2, time_horizon, dt,
                                 v_range=(vel_max / 2, vel_max),
                                 w_range=(-omega_max, omega_max))
    back, ts = generate_controls(generator, n_trajs - n_trajs // 2,
                                 time_horizon, dt,
                                 v_range=(-vel_max, -vel_max / 2),
                                 w_range=(-omega_max, omega_max))
    return torch.cat([front, back], dim=0), ts


def vw_to_track_vels(v, w, robot_size, n_tracks: int):
    """(v, w) twist -> per-track linear velocities.

    For 2 tracks: [left, right]; for 4: [fl, fr, rl, rr] (front/rear pairs
    identical, differential drive).  ``v``/``w`` may carry leading batch dims.
    """
    Ly = robot_size[1]
    v_l = v - w * (Ly / 2.0)
    v_r = v + w * (Ly / 2.0)
    if n_tracks == 2:
        return torch.stack([v_l, v_r], dim=-1)
    if n_tracks == 4:
        return torch.stack([v_l, v_r, v_l, v_r], dim=-1)
    raise ValueError("n_tracks must be 2 or 4")
