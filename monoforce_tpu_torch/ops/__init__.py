from monoforce_tpu_torch.ops.interp_cuda import fk_interp, fk_interp_bwd
from monoforce_tpu_torch.ops.fk_step_cuda import (
    fk_step,
    fk_step_muq,
    fk_step_packed,
    fk_step_pair3,
    fk_step_pairmu,
    fk_step_zu,
)
from monoforce_tpu_torch.ops.voxel_pool import voxel_pool
from monoforce_tpu_torch.ops.heightmap import (estimate_heightmap, filter_grid,
                                               hm_to_cloud)

__all__ = ["fk_interp", "fk_interp_bwd", "fk_step_zu", "fk_step_muq",
           "fk_step_pairmu", "fk_step_pair3", "fk_step_packed", "fk_step",
           "voxel_pool", "estimate_heightmap", "hm_to_cloud", "filter_grid"]
