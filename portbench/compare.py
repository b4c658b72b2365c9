"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict

import torch


def rel_max_gap(got: torch.Tensor, want: torch.Tensor,
                floor: float = 1e-12) -> float:
    """max |got - want| over the largest |want|, or over ``floor`` where
    that is larger (inf if not finite)."""
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, floor)


def choice_gap(best: int, costs: torch.Tensor) -> float:
    """How far the chosen path's reference cost lies above the reference's
    best, as a share of the reference costs' range (0: the best path)."""
    c = costs.double()
    lo, hi = float(c.min()), float(c.max())
    return (float(c[best]) - lo) / max(hi - lo, 1e-30)


def leaf_norm_gaps(got: Dict[str, float], want: Dict[str, float],
                   keep=None) -> Dict[str, float]:
    """Each leaf's gap between two norms, |got - want|, over the larger of
    that leaf's reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in names}


@contextlib.contextmanager
def tf32_math():
    """Convolutions and matmuls in TF32 (the control's lower precision)."""
    matmul = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=True):
            yield
    finally:
        torch.set_float32_matmul_precision(matmul)


@contextlib.contextmanager
def reference_in_tf32():
    """The reference encoder's own float32 context swapped for TF32, so that
    its forward (and backward) run one precision below the configuration's
    float32 with TF32 off."""
    from portbench.reference import lss, train
    saved = lss.float32_math, train.float32_math
    lss.float32_math = train.float32_math = tf32_math
    try:
        yield
    finally:
        lss.float32_math, train.float32_math = saved
