"""The ROUGH sequence reader and the class tables (the JAX package's
``monoforce_tpu.datasets``, own copies; host-side numpy and PIL)."""

from monoforce_tpu_torch.datasets.rough import (ROUGH, rough_seq_dirs,
                                                estimate_heightmap_np)
from monoforce_tpu_torch.datasets.wildscenes import METAINFO as WILDSCENES_METAINFO
from monoforce_tpu_torch.datasets.coco import COCO_CATEGORIES

__all__ = [
    "ROUGH", "rough_seq_dirs", "estimate_heightmap_np",
    "WILDSCENES_METAINFO", "COCO_CATEGORIES",
]
