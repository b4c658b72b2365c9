"""Stateful follower controller: the path_follower node's supervisory logic
around the pure control law in :mod:`monoforce_tpu_torch.planner.follower`.

Port of ``monoforce_tpu/planner/controller.py`` (whole module).  Reference
parity (monoforce_navigation/nodes/path_follower):

- path time-cost estimate: cumulative per-segment cost from distance,
  inclination and turning (:414-440),
- clearance-box obstacle check against a point cloud (:282-302),
- stuck detection with force-through after a timeout (:532-547): when the
  next carrot pose is obstructed, stop; after ``force_through_after``
  seconds, proceed at a reduced speed cap,
- traversed-path recording and idle backtracking (:443-458, :475-485):
  when no path arrives for ``backtrack_after`` seconds, follow the recorded
  path backwards.

The geometry pieces are pure functions on their inputs' device.  The
supervisor is a small host-side class (timers and mode switches are control
flow, not tensor math) that keeps its path, its pose and the traversed path
as tensors on its own device; ``bool`` and ``float`` of a result are the
only reads back to the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from monoforce_tpu_torch.physics.engine import on_device, resolve_device
from monoforce_tpu_torch.planner.follower import FollowerParams, follower_step

__all__ = ["path_time_cost", "pose_clear", "FollowerController"]


def path_time_cost(path, Rs=None, max_speed: float = 1.0,
                   max_angular_rate: float = 1.0,
                   max_roll: float = 0.5, max_pitch: float = 0.5):
    """Cumulative time estimate along a path (path_follower:414-440).

    path: (M, 3); Rs: optional (M, 3, 3) orientations for the inclination
    term.  Returns (M,) cumulative cost, cost[0] = 0.
    """
    seg = torch.linalg.vector_norm(torch.diff(path, dim=0), dim=-1)
    dist_cost = seg / max_speed
    cost = dist_cost
    if Rs is not None:
        roll = torch.atan2(Rs[1:, 2, 1], Rs[1:, 2, 2])
        pitch = torch.atan2(-Rs[1:, 2, 0],
                            torch.sqrt(Rs[1:, 2, 1] ** 2 + Rs[1:, 2, 2] ** 2))
        pose_cost = torch.abs(roll) / max_roll + torch.abs(pitch) / max_pitch
        cost = cost + 1.08 * dist_cost * pose_cost
        yaw = torch.atan2(Rs[:, 1, 0], Rs[:, 0, 0])
        yaw_diff = torch.abs(torch.diff(yaw))
        yaw_diff = torch.minimum(yaw_diff, 2 * math.pi - yaw_diff)
        cost = cost + 0.24 * yaw_diff / max_angular_rate
    return torch.cat([cost.new_zeros(1), torch.cumsum(cost, dim=0)])


def pose_clear(cloud, pose, box_size=(1.0, 0.8, 0.6), min_points: int = 5):
    """True (a 0-d bool tensor) when fewer than ``min_points`` cloud points
    fall inside the robot-sized box at ``pose`` (path_follower:282-302).

    cloud: (M, 3) obstacle points in the same frame as pose (4, 4).
    """
    local = (cloud - pose[:3, 3]) @ pose[:3, :3]
    half = torch.tensor(box_size, dtype=local.dtype, device=local.device) / 2.0
    inside = torch.all(torch.abs(local) <= half, dim=-1)
    return inside.sum() < min_points


class FollowerController:
    """10 Hz supervisor: follow / wait-on-obstacle / force-through /
    backtrack.

    ``device`` (an argument the JAX class does not have) is where the path,
    the poses and the clearance check live: ``cuda`` unless the caller
    passes another device; a CUDA device without a card raises.
    """

    def __init__(self, params: FollowerParams = FollowerParams(),
                 force_through_after: float = 10.0,
                 max_force_through_speed: float = 0.3,
                 backtrack_after: float = 30.0,
                 traversed_keep: int = 3000, device="cuda"):
        self.params = params
        self.force_through_after = force_through_after
        self.max_force_through_speed = max_force_through_speed
        self.backtrack_after = backtrack_after
        self.traversed_keep = traversed_keep
        # with its index ('cuda:0'), as the tensors made there carry it
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.path: Optional[torch.Tensor] = None
        self.traversed: list = []
        self.stuck_since: Optional[float] = None
        self.idle_since: Optional[float] = None
        self.backtracking = False

    def set_path(self, path):
        self.path = on_device(path, self.device, "path")
        self.idle_since = None
        self.backtracking = False

    def _record(self, pos):
        if not self.traversed or bool(torch.linalg.vector_norm(
                pos - self.traversed[-1]) > 0.1):
            self.traversed.append(pos.clone())
            self.traversed = self.traversed[-self.traversed_keep:]

    def tick(self, pose, t: float, cloud=None):
        """One control tick.

        Args:
          pose: (4, 4) robot pose in the path frame.
          t: current time [s] (monotonic).
          cloud: optional obstacle points for the clearance check.

        Returns (linear, angular, status) with status in
        {'follow', 'force_through', 'waiting', 'idle', 'backtrack', 'done'}.
        """
        pose = on_device(pose, self.device, "pose")
        self._record(pose[:3, 3])

        if self.path is None or len(self.path) < 2:
            # no path: maybe backtrack after an idle period (:443-458)
            if self.idle_since is None:
                self.idle_since = t
            if (t - self.idle_since > self.backtrack_after
                    and len(self.traversed) > 2):
                self.backtracking = True
                back = torch.stack(self.traversed[::-1])
                cmd = follower_step(pose, back, self.params)
                if bool(cmd.goal_reached):
                    self.traversed = []
                    self.backtracking = False
                    return 0.0, 0.0, "idle"
                return float(cmd.linear), float(cmd.angular), "backtrack"
            return 0.0, 0.0, "idle"

        params = self.params
        status = "follow"
        if cloud is not None:
            cmd_probe = follower_step(pose, self.path, params)
            carrot_pose = torch.eye(4, device=pose.device)
            carrot_pose[:3, 3] = cmd_probe.carrot
            carrot_pose[:3, :3] = pose[:3, :3]
            if not bool(pose_clear(on_device(cloud, self.device,
                                             "cloud"),
                                   carrot_pose)):
                if self.stuck_since is None:
                    self.stuck_since = t
                if t - self.stuck_since < self.force_through_after:
                    return 0.0, 0.0, "waiting"
                # obstructed too long: force through at reduced speed
                params = params._replace(
                    max_speed=self.max_force_through_speed)
                status = "force_through"
            else:
                self.stuck_since = None

        cmd = follower_step(pose, self.path, params)
        if bool(cmd.goal_reached):
            self.path = None
            return 0.0, 0.0, "done"
        return float(cmd.linear), float(cmd.angular), status
