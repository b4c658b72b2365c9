from monoforce_tpu_torch.planner.shooting import (
    Planner,
    force_variance_cost,
    inclination_cost,
    select_path,
    normalize_costs,
)

__all__ = [
    "Planner",
    "force_variance_cost",
    "inclination_cost",
    "select_path",
    "normalize_costs",
]
