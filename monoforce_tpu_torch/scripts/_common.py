"""What the entry points share: the reader's view of an ``LSSConfig``, the
``--device`` argument, and whether figures can be drawn."""

from __future__ import annotations

import importlib.util

from monoforce_tpu_torch.config import LSSConfig


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; cuda "
                             "raises without a card, cpu runs the plain "
                             "PyTorch versions)")


def lss_dict(lss_cfg: LSSConfig) -> dict:
    """The dict the ROUGH reader takes for its augmentation and labels."""
    return {"data_aug_conf": lss_cfg.data_aug_conf,
            "grid_conf": lss_cfg.grid_conf,
            "soft_classes": lss_cfg.soft_classes}


def have_matplotlib() -> bool:
    """matplotlib draws the figures; it is an optional dependency (the
    ``train`` extra), so the entry points skip a figure they would write
    by the way when it is not installed."""
    return importlib.util.find_spec("matplotlib") is not None

