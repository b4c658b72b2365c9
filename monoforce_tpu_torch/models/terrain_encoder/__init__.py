from monoforce_tpu_torch.models.terrain_encoder.lss import LiftSplatShoot, CamEncode
from monoforce_tpu_torch.models.terrain_encoder.bev import BevEncode
from monoforce_tpu_torch.models.terrain_encoder.geometry import (
    gen_dx_bx, create_frustum, get_geometry,
)

__all__ = [
    "LiftSplatShoot", "CamEncode", "BevEncode",
    "gen_dx_bx", "create_frustum", "get_geometry",
]
