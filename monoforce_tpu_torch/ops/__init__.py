from monoforce_tpu_torch.ops.interp_cuda import fk_interp
from monoforce_tpu_torch.ops.fk_step_cuda import (
    fk_step_muq,
    fk_step_pairmu,
    fk_step_zu,
)

__all__ = ["fk_interp", "fk_step_zu", "fk_step_muq", "fk_step_pairmu"]
