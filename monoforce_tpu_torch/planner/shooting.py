"""Trajectory shooting planner: sampled controls -> rollouts -> path costs
-> the best path.

Port of ``monoforce_tpu/planner/shooting.py`` (whole module): the costs
(force variance, monoforce_node.py:91; inclination, diff_physics.py:262-266),
``select_path`` (path_selector:249-251), ``PlanResult``, ``_plan`` and
``Planner``.  The rollout is the serving ``planner_rollout``; ``Planner``
runs on ``cuda`` unless the caller names another device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import (RigidState, RobotModel,
                                                on_device)
from monoforce_tpu_torch.utils.profiling import span

__all__ = [
    "Planner", "PlanResult", "force_variance_cost", "inclination_cost",
    "select_path", "normalize_costs", "roll_pitch",
]


def roll_pitch(R):
    """Roll/pitch Euler angles from rotation matrices (..., 3, 3)
    (reference: transformations.py:50-57 rot2rpy)."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.atan2(-R[..., 2, 0],
                        torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    return roll, pitch


def force_variance_cost(spring_std_t):
    """std over time (ddof 0, like jnp.std) of the per-step spring-norm std
    (B, N) -> (B,) (reference: monoforce_node.py:91)."""
    return torch.std(spring_std_t, dim=-1, correction=0)


def inclination_cost(abs_roll_t, abs_pitch_t):
    """mean |roll| + mean |pitch| over time (B, N) -> (B,)
    (reference: diff_physics.py:262-266)."""
    return abs_roll_t.mean(dim=-1) + abs_pitch_t.mean(dim=-1)


def normalize_costs(x, eps: float = 1e-6):
    """Scale to [0, 1] over the path batch (reference: utils.py:43-57 with
    qlow=0, qhigh=1 as used by path_selector:249)."""
    x_min, x_max = x.min(), x.max()
    return torch.clamp((x - x_min) / torch.clamp(x_max - x_min, min=eps),
                       0.0, 1.0)


def select_path(path_costs, path_dists_to_wp=None,
                waypoint_weight: float = 1.0, path_weight: float = 1.0):
    """Arbitrate sampled paths against a waypoint objective
    (reference: path_selector:249-251).  Returns (index, combined costs)."""
    combined = path_weight * normalize_costs(path_costs)
    if path_dists_to_wp is not None:
        combined = combined + waypoint_weight * normalize_costs(path_dists_to_wp)
    return torch.argmin(combined), combined


class PlanResult(NamedTuple):
    xs: torch.Tensor     # (B, N, 3) positions
    Rs: torch.Tensor     # (B, N, 3, 3) rotations
    costs: torch.Tensor  # (B,) per-path cost
    best: torch.Tensor   # () index of the lowest-cost path


def _plan(robot: RobotModel, z_grid, friction, controls, state0,
          cost: str) -> PlanResult:
    from monoforce_tpu_torch.physics.fast import planner_rollout

    states, stats = planner_rollout(robot, z_grid, controls, state0=state0,
                                    friction=friction)
    with span("plan.cost"):
        if cost == "force_variance":
            costs = force_variance_cost(stats.spring_std)
        elif cost == "inclination":
            costs = inclination_cost(stats.abs_roll, stats.abs_pitch)
        else:
            raise ValueError(f"unknown cost {cost!r}")
        return PlanResult(states.x, states.R, costs, torch.argmin(costs))


class Planner:
    """Shooting planner over one terrain estimate, on one device.

    Equivalent of the fused online node (monoforce_ros/nodes/
    monoforce_node.py:54-96): repeat the terrain across ``n_sim_trajs``
    sampled control sequences, roll out, cost, pick the best.
    """

    def __init__(self, cfg, cost: str = "force_variance", device="cuda"):
        self.cfg = cfg
        self.cost = cost
        self.robot = RobotModel.from_config(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.robot.device

    def sample_controls(self, generator: torch.Generator):
        """(n_sim_trajs, N, 2) front/back shooting controls and stamps,
        drawn from ``generator`` (on this planner's device)."""
        return shooting_controls(
            generator, self.cfg.n_sim_trajs, self.cfg.vel_max,
            self.cfg.omega_max, self.cfg.traj_sim_time, self.cfg.dt)

    def plan(self, z_grid, controls, state0: Optional[RigidState] = None,
             friction=None) -> PlanResult:
        """z_grid: (H, W) terrain; controls: (B, N, 2); state0 with (B, ...)
        leaves; friction: (H, W) grid, else uniform ``cfg.friction_coef``.
        Tensors must be on this planner's device (else ValueError)."""
        z_grid = on_device(z_grid, self.device, "z_grid")
        if friction is None:
            friction = torch.full(z_grid.shape[-2:], self.cfg.friction_coef,
                                  dtype=torch.float32, device=self.device)
        return _plan(self.robot, z_grid, friction, controls, state0,
                     self.cost)
