from monoforce_tpu_torch.physics.engine import (
    RobotModel,
    RigidState,
    inertia_tensor,
)
from monoforce_tpu_torch.physics.controls import (
    generate_controls,
    shooting_controls,
    vw_to_track_vels,
)

__all__ = [
    "RobotModel",
    "RigidState",
    "inertia_tensor",
    "generate_controls",
    "shooting_controls",
    "vw_to_track_vels",
]
