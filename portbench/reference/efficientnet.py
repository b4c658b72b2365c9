"""EfficientNet-B0 trunk with its /16 and /32 endpoints (NCHW).

Port of ``monoforce_tpu/models/terrain_encoder/efficientnet.py:24-118``:
MBConv with expansion, depthwise conv, squeeze-excitation (biased 1x1
convs), swish, BN eps 1e-3, drop-connect in train mode only, and the full
B0 stage table.  Module names follow ``efficientnet_pytorch`` (the
reference's trunk, lss.py:73-94): ``_conv_stem``, ``_bn0`` and
``_blocks.{i}._expand_conv|_bn0|_depthwise_conv|_bn1|_se_reduce|_se_expand|
_project_conv|_bn2``, so that a reference checkpoint loads directly.  The
stem and the depthwise convs pad "SAME" as flax and efficientnet_pytorch's
static-padding convs do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from portbench.reference.layers import (
    BN_MOMENTUM, BatchNorm2d, Conv2dSame, swish)

__all__ = ["EfficientNetB0", "MBConv", "B0_STAGES"]

# (expand_ratio, kernel, stride, out_channels, repeats): the B0 stage table
B0_STAGES: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

_BN_EPS = 1e-3
_SE_RATIO = 0.25
_STEM_CH = 32


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=_BN_EPS, momentum=BN_MOMENTUM)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int, drop_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.expand, self.drop_rate = expand, drop_rate
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self._expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = Conv2dSame(mid, mid, kernel, stride=stride,
                                          groups=mid, bias=False)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * _SE_RATIO))
        self._se_reduce = nn.Conv2d(mid, se_ch, 1)
        self._se_expand = nn.Conv2d(se_ch, mid, 1)
        self._project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = x
        if self.expand != 1:
            h = swish(self._bn0(self._expand_conv(h)))
        h = swish(self._bn1(self._depthwise_conv(h)))
        # squeeze-excitation
        se = h.mean(dim=(2, 3), keepdim=True)
        se = self._se_expand(swish(self._se_reduce(se)))
        h = torch.sigmoid(se) * h
        h = self._bn2(self._project_conv(h))
        if self.residual:
            if self.training and self.drop_rate > 0:
                # stochastic depth: drop the whole branch per sample,
                # rescaled by 1/keep like the reference
                if generator is None:
                    raise ValueError(
                        "a train-mode forward with drop-connect draws its "
                        "masks from an explicit torch.Generator: pass "
                        "generator=, or build the model with "
                        "drop_connect_rate=0")
                keep = 1.0 - self.drop_rate
                mask = torch.bernoulli(torch.full(
                    (h.shape[0], 1, 1, 1), keep, dtype=h.dtype,
                    device=h.device), generator=generator)
                h = h * mask / keep
            h = h + x
        return h


class EfficientNetB0(nn.Module):
    """B0 trunk returning its endpoints: ``reduction_i`` is the feature map
    just before the i-th spatial reduction, the last one the trunk's
    output (``reduction_4``: /16, 112 ch; ``reduction_5``: /32, 320 ch).
    Block i drops its residual branch at rate ``drop_connect_rate * i / 16``
    in train mode."""

    def __init__(self, drop_connect_rate: float = 0.2):
        super().__init__()
        self._conv_stem = Conv2dSame(3, _STEM_CH, 3, stride=2, bias=False)
        self._bn0 = _bn(_STEM_CH)
        blocks = []
        in_ch, idx = _STEM_CH, 0
        total = sum(s[-1] for s in B0_STAGES)
        for (expand, k, stride, out_ch, repeats) in B0_STAGES:
            for r in range(repeats):
                blocks.append(MBConv(in_ch, out_ch, k, stride if r == 0 else 1,
                                     expand,
                                     drop_rate=drop_connect_rate * idx / total))
                in_ch = out_ch
                idx += 1
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = swish(self._bn0(self._conv_stem(x)))
        endpoints = {}
        prev = h
        for block in self._blocks:
            h = block(h, generator)
            if prev.shape[2] > h.shape[2]:
                endpoints[f"reduction_{len(endpoints) + 1}"] = prev
            prev = h
        endpoints[f"reduction_{len(endpoints) + 1}"] = h
        return endpoints
