"""Training of the PyTorch port: so far, terrain fitting through the
differentiable rollout (``training/trainer.py`` of the JAX package comes
with a later slice)."""

from monoforce_tpu_torch.training.fit_terrain import (
    TerrainParams,
    fit_terrain,
    make_optimizer,
    terrain_fit_step,
)

__all__ = ["TerrainParams", "fit_terrain", "make_optimizer",
           "terrain_fit_step"]
