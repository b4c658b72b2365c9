"""BEV encoder with three terrain heads (NCHW).

Port of ``monoforce_tpu/models/terrain_encoder/bev.py:20-96``; reference
parity: BevEncode (lss.py:101-165) -- ResNet-18 layers 1-3 over the
splatted BEV features, an Up fusion back to half resolution, and three
upsampling heads: geom (ScaledTanh(-1, 1)), diff (ReLU), friction (ReLU),
with ``terrain = geom - diff`` (lss.py:158).  The convs pad symmetrically,
as torchvision's do (padding 1 at stride 2 too; the 7x7 stem pads 3).
Each head's 3x3 convolution steps around one slow cuDNN path
(:class:`HeadConv`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.layers import (
    BN_MOMENTUM, BatchNorm2d, ScaledTanh, Up, UpsampleAlignCorners)

__all__ = ["BevEncode", "BasicBlock", "HeadConv", "cudnn_slow_path"]


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """ResNet-18 basic block (two 3x3 convs + identity/projection skip).
    ``bn2``'s scale starts at zero (``init_weights``), as resnet18's
    ``zero_init_residual=True``."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, features, 1, stride=stride, bias=False),
                _bn(features))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


# cuDNN 9.2 on the H100 runs the heads' 3x3 convolution (256 -> 128
# channels) in float32 with TF32 off as ~33,000 kernel launches, 0.3-0.5 s
# a call (8,329 launches at 64 x 64), wherever the batch is not a multiple
# of 8 and the output holds at least 6 x 64 x 64 pixels: on the 128 x 128
# grid, batches 2-7, 9-15 and 17-23.  Batches 1, 8, 16, 24, the 32 x 32
# grid, TF32 on and every backward take a few launches.  Measured by
# chip_smoke.study_bev_convs: float32 at batches 1-24 on the 128 x 128 and
# 64 x 64 grids and 1-8, 16, 24 on 32 x 32; TF32 on and the half model
# (whose BEV encoder is float32) at batches 1, 2, 4, 6, 8 and 24.
_SLOW_MIN_PIXELS = 6 * 64 * 64


def cudnn_slow_path(x) -> bool:
    """Whether cuDNN would run a head's 3x3 convolution on ``x`` through
    its many-launch path."""
    return (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cudnn.enabled
            and not torch.backends.cudnn.allow_tf32
            and x.shape[0] % 8 != 0
            and x.shape[0] * x.shape[-2] * x.shape[-1] >= _SLOW_MIN_PIXELS)


class HeadConv(nn.Conv2d):
    """A head's 3x3 convolution.  Where :func:`cudnn_slow_path` holds, its
    forward runs without cuDNN (PyTorch's own CUDA convolution: 7-19
    launches, under 3 ms at batches 2-6 on 128 x 128); the flag is set for
    this call only, and the backward and every other case keep cuDNN."""

    def forward(self, x):
        if not cudnn_slow_path(x):
            return super().forward(x)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=cudnn.allow_tf32):
            return super().forward(x)


class _Head(nn.Sequential):
    """Upsample x2 + 3x3 conv + BN + GELU + 1x1 conv + activation
    (reference: lss.py:115-138; indices 1, 2 and 4 hold the weights)."""

    def __init__(self, in_ch: int, out_ch: int, final_act: nn.Module):
        super().__init__(
            UpsampleAlignCorners(2),
            HeadConv(in_ch, 128, 3, padding=1, bias=False),
            _bn(128),
            nn.GELU(),
            nn.Conv2d(128, out_ch, 1),
            final_act)


class BevEncode(nn.Module):
    def __init__(self, in_ch: int, out_ch: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, stride=2),
                                    BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, stride=2),
                                    BasicBlock(256, 256))
        self.up1 = Up(64 + 256, 256, scale_factor=4)
        self.up_geom = _Head(256, out_ch, ScaledTanh(-1.0, 1.0))
        self.up_diff = _Head(256, out_ch, nn.ReLU())
        self.up_friction = _Head(256, out_ch, nn.ReLU())

    def forward(self, x):
        """x: (B, C, X, Y) BEV features -> dict of (B, out_ch, X, Y) maps."""
        h = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(h)
        h = self.layer3(self.layer2(x1))
        h = self.up1(h, x1)
        geom = self.up_geom(h)
        diff = self.up_diff(h)
        return {
            "geom": geom,
            "terrain": geom - diff,
            "diff": diff,
            "friction": self.up_friction(h),
        }
