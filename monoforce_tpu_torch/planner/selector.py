"""Waypoint-route arbitration: the path_selector node's logic without ROS.

Port of ``monoforce_tpu/planner/selector.py`` (whole module).  Reference
parity: monoforce_navigation/nodes/path_selector --

- per-path distance to the current waypoint (closest path point,
  path_selector:140-160 get_path_dist_to_wp),
- combined cost: waypoint_weight * norm(dists) + path_weight * norm(costs)
  (path_selector:249-251, normalization utils.py:43-57),
- waypoint progression when the robot gets within ``wp_reach_dist``
  (path_selector:88-111 wp_dist_callback),
- look-ahead truncation: follow the selected path only up to the point
  closest to the waypoint unless it is farther than ``wp_lookahead_dist``
  (path_selector:252-259).

The cost math computes on the paths' device; ``WaypointRoute`` is a small
host-side state machine (waypoint index progression is sequential control
flow) that reads the chosen index back with ``int``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from monoforce_tpu_torch.planner.shooting import normalize_costs

__all__ = ["WaypointRoute", "select_against_route", "path_dists_to_waypoint"]


def path_dists_to_waypoint(paths, wp_xyz):
    """paths: (B, N, 3); wp: (3,) in the same frame.

    Returns (dists (B,), closest_ids (B,)) -- min distance of each path to
    the waypoint and the index of the closest point (the first on a tie).
    """
    d = torch.linalg.vector_norm(paths - wp_xyz[None, None, :], dim=-1)
    return d.amin(dim=1), d.argmin(dim=1)


def select_against_route(paths, path_costs, wp_xyz,
                         waypoint_weight: float = 1.0,
                         path_weight: float = 1.0,
                         wp_lookahead_dist: float = float("inf"),
                         robot_xy_dist_to_wp: Optional[float] = None):
    """Pick the path that best trades off its own cost against reaching the
    waypoint; optionally truncate it at the waypoint-closest point.

    Returns (best index, combined costs (B,), truncate_at | None), the
    index and truncation as 0-d tensors on the paths' device.
    """
    dists, closest = path_dists_to_waypoint(paths, wp_xyz)
    combined = (waypoint_weight * normalize_costs(dists)
                + path_weight * normalize_costs(path_costs))
    best = torch.argmin(combined)
    truncate_at = closest[best]
    if waypoint_weight <= 0.0:
        truncate_at = None
    elif (robot_xy_dist_to_wp is not None
          and robot_xy_dist_to_wp > wp_lookahead_dist):
        truncate_at = None  # waypoint far: follow the complete path
    return best, combined, truncate_at


class WaypointRoute:
    """Host-side waypoint progression (path_selector:88-111)."""

    def __init__(self, waypoints, reach_dist: float = 0.8,
                 lookahead_dist: float = 2.0):
        self.waypoints = np.asarray(waypoints, dtype=np.float32)
        assert self.waypoints.ndim == 2 and self.waypoints.shape[1] >= 3
        self.reach_dist = reach_dist
        self.lookahead_dist = lookahead_dist
        self.wp_i = 0

    @property
    def done(self) -> bool:
        return self.wp_i >= len(self.waypoints)

    @property
    def current(self):
        return None if self.done else self.waypoints[self.wp_i, :3]

    def update(self, robot_xyz) -> Optional[np.ndarray]:
        """Advance past reached waypoints; returns the active one (or None).
        ``robot_xyz`` is a host array."""
        robot_xyz = np.asarray(robot_xyz)
        while not self.done:
            d = float(np.linalg.norm(
                self.waypoints[self.wp_i, :2] - robot_xyz[:2]))
            if d > self.reach_dist:
                break
            self.wp_i += 1
        return self.current

    def select(self, paths, path_costs, robot_xyz,
               waypoint_weight: float = 1.0, path_weight: float = 1.0):
        """Full arbitration for one planning tick: ``paths`` (B, N, 3) and
        ``path_costs`` (B,) on one device, ``robot_xyz`` on the host.

        Returns (best index, truncate_at | None) as ints; falls back to pure
        path cost when the route is exhausted.
        """
        wp = self.update(robot_xyz)
        if wp is None:
            return int(torch.argmin(normalize_costs(path_costs))), None
        d_robot = float(np.linalg.norm(np.asarray(robot_xyz[:2]) - wp[:2]))
        best, _, trunc = select_against_route(
            paths, path_costs, torch.from_numpy(wp).to(paths.device),
            waypoint_weight=waypoint_weight, path_weight=path_weight,
            wp_lookahead_dist=self.lookahead_dist,
            robot_xy_dist_to_wp=d_robot)
        return int(best), (None if trunc is None else int(trunc))
