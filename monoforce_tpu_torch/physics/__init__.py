from monoforce_tpu_torch.physics.engine import (
    DPhysics,
    RobotModel,
    RigidState,
    rollout,
    rollout_single,
    inertia_tensor,
    integrate_rotation,
)
from monoforce_tpu_torch.physics.terrain import interpolate_grid
from monoforce_tpu_torch.physics.controls import (
    generate_controls,
    shooting_controls,
    vw_to_track_vels,
)

__all__ = [
    "DPhysics",
    "RobotModel",
    "RigidState",
    "rollout",
    "rollout_single",
    "inertia_tensor",
    "integrate_rotation",
    "interpolate_grid",
    "generate_controls",
    "shooting_controls",
    "vw_to_track_vels",
]
