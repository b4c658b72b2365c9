"""Training of the PyTorch port: the terrain encoder's trainer and
evaluator, and terrain fitting through the differentiable rollout.  The
two ``make_optimizer``s keep their modules, as in the JAX package."""

from monoforce_tpu_torch.training.fit_terrain import (
    TerrainParams,
    fit_terrain,
    make_optimizer,
    terrain_fit_step,
)
from monoforce_tpu_torch.training.trainer import (
    Trainer,
    avg_pool_grid,
    make_train_step,
)
from monoforce_tpu_torch.training.evaluator import Evaluator

__all__ = ["fit_terrain", "terrain_fit_step", "Trainer", "make_train_step",
           "avg_pool_grid", "Evaluator", "TerrainParams", "make_optimizer"]
