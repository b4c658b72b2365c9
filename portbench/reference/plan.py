"""The shooting planner's cost and choice, plain (frozen copy of the
port's ``planner/shooting.py``: ``force_variance_cost`` and ``_plan``)."""

from __future__ import annotations

import torch

from portbench.reference.fast import planner_rollout

__all__ = ["force_variance_cost", "plan"]


def force_variance_cost(spring_std_t):
    """std over time (ddof 0) of the per-step spring-norm std (B, N) ->
    (B,) (reference: monoforce_node.py:91)."""
    return torch.std(spring_std_t, dim=-1, correction=0)


def plan(robot, z_grid, friction, controls, state_round=None):
    """(positions (B, N, 3), costs (B,), best index) of the serving rollout
    on one terrain and friction grid."""
    states, stats = planner_rollout(robot, z_grid, controls,
                                    friction=friction,
                                    state_round=state_round)
    costs = force_variance_cost(stats.spring_std)
    return states.x, costs, torch.argmin(costs)
