from monoforce_tpu_torch.planner.shooting import (
    Planner,
    force_variance_cost,
    inclination_cost,
    select_path,
    normalize_costs,
)
from monoforce_tpu_torch.planner.follower import follower_step, FollowerParams
from monoforce_tpu_torch.planner.selector import (
    WaypointRoute, select_against_route, path_dists_to_waypoint,
)
from monoforce_tpu_torch.planner.controller import (
    FollowerController, path_time_cost, pose_clear,
)
from monoforce_tpu_torch.planner.navigator import NavigationResult, navigate

__all__ = [
    "Planner",
    "force_variance_cost",
    "inclination_cost",
    "select_path",
    "normalize_costs",
    "follower_step",
    "FollowerParams",
    "WaypointRoute",
    "select_against_route",
    "path_dists_to_waypoint",
    "FollowerController",
    "path_time_cost",
    "pose_clear",
    "NavigationResult",
    "navigate",
]
