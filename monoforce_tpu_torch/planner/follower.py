"""Path-follower control law as a pure function.

Port of ``monoforce_tpu/planner/follower.py`` (whole module); it computes
on its inputs' device and reads nothing back to the host.  Re-implements
the carrot-chasing P-controller of the reference follower node (reference:
monoforce_navigation/nodes/path_follower:475-626) without ROS:

- nearest path point within look-ahead, carrot advanced along the path until
  the accumulated arc length reaches the look-ahead distance (:498-528),
- heading P-control with clamped angular rate, speed ramp that vanishes when
  turning on the spot (:588-617),
- roll/pitch slow-down: speed /= (1 + |roll|/max_roll + |pitch|/max_pitch)
  (:466-473, :607),
- optional backward driving when the goal is behind (:588-592),
- goal-reached detection at the final path point (:575-585).

The kd-tree of the reference is replaced by an argmin over the path points
(paths here are short, N <= 500).  Ties go to the first index, as in
``jnp.argmin``/``jnp.argmax``; the backward heading wraps with a floored
modulo (``torch.remainder``, as ``jnp.mod``; ``torch.fmod`` truncates).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["FollowerParams", "FollowerCommand", "follower_step"]


class FollowerParams(NamedTuple):
    look_ahead: float = 1.0          # carrot distance [m]
    max_speed: float = 1.0           # [m/s]
    max_angular_rate: float = 1.0    # [rad/s]
    turn_on_spot_angle: float = 1.0  # [rad] heading error that zeroes speed
    p_angle: float = 1.5             # heading P gain
    p_dist: float = 1.5              # speed P gain
    max_roll: float = 0.5            # [rad]
    max_pitch: float = 0.5           # [rad]
    goal_reached_dist: float = 0.3   # [m]
    allow_backward: bool = True


class FollowerCommand(NamedTuple):
    linear: torch.Tensor    # () commanded forward speed
    angular: torch.Tensor   # () commanded yaw rate
    goal_reached: torch.Tensor  # () bool
    carrot: torch.Tensor    # (3,) look-ahead point in the path frame


def follower_step(pose, path, params: FollowerParams = FollowerParams()):
    """One 10 Hz control tick.

    Args:
      pose: (4, 4) robot pose in the path frame.
      path: (M, 3) path points in the same frame and on the same device.
      params: controller gains/limits.

    Returns a FollowerCommand of tensors on the inputs' device.
    """
    pos = pose[:3, 3]
    R = pose[:3, :3]

    # nearest path point, then advance the carrot by accumulated arc length
    d = torch.linalg.vector_norm(path - pos[None, :], dim=-1)
    i0 = torch.argmin(d)
    seg = torch.linalg.vector_norm(torch.diff(path, dim=0), dim=-1)
    seg = torch.cat([seg.new_zeros(1), seg])
    arc = torch.cumsum(seg, dim=0)
    # arc length from the nearest point; carrot = first point at >= look_ahead
    rel = arc - arc[i0]
    reachable = torch.arange(path.shape[0], device=path.device) >= i0
    past_la = reachable & (rel >= params.look_ahead)
    last = path.shape[0] - 1
    carrot_i = torch.where(past_la.any(),
                           torch.argmax(past_la.to(torch.int32)), last)
    goal = path[carrot_i]

    # goal in the robot frame
    local = R.T @ (goal - pos)
    dist = torch.linalg.vector_norm(local)
    angle = torch.atan2(local[1], local[0])

    # drive backward if the carrot is behind and allowed (:588-592)
    backward = (torch.abs(angle) > math.pi / 2) & bool(params.allow_backward)
    angle = torch.where(
        backward, torch.remainder(angle + math.pi / 2, math.pi) - math.pi / 2,
        angle)
    vel_sign = torch.where(backward, -1.0, 1.0)

    angular = torch.clamp(params.p_angle * angle,
                          -params.max_angular_rate, params.max_angular_rate)

    # speed: P on distance, quadratic ramp-down with heading error (:601)
    gain = params.p_dist * torch.clamp(
        1.0 - (torch.abs(angle) / params.turn_on_spot_angle) ** 2, min=0.0)
    speed = gain * dist

    # inclination slow-down (:466-473, :607)
    roll = torch.atan2(R[2, 1], R[2, 2])
    pitch = torch.atan2(-R[2, 0], torch.sqrt(R[2, 1] ** 2 + R[2, 2] ** 2))
    pose_cost = (torch.abs(roll) / params.max_roll
                 + torch.abs(pitch) / params.max_pitch)
    speed = speed / (1.0 + pose_cost)
    speed = vel_sign * torch.clamp(speed, 0.0, params.max_speed)

    reached = (carrot_i == last) & (dist <= params.goal_reached_dist)
    speed = torch.where(reached, 0.0, speed)
    angular = torch.where(reached, 0.0, angular)
    return FollowerCommand(speed, angular, reached, goal)
