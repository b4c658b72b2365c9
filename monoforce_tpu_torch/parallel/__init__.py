"""Sharding and data parallelism of the PyTorch port (the counterpart of
``monoforce_tpu/parallel/``): meshes and batch sharding, the sharded
shooting batch, and the data-parallel train step over a
``torch.distributed`` process group."""

from monoforce_tpu_torch.parallel.sharding import (
    make_mesh,
    data_sharding,
    replicated,
    shard_batch,
    gather_batch,
)
from monoforce_tpu_torch.parallel.rollout import sharded_shoot
from monoforce_tpu_torch.parallel.data_parallel import (
    global_batch_norm,
    global_losses,
    global_share,
    make_dp_train_step,
    run_ranks,
)

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch",
           "gather_batch", "sharded_shoot", "global_batch_norm",
           "global_share", "global_losses", "make_dp_train_step",
           "run_ranks"]
