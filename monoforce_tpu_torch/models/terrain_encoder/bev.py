"""BEV encoder with three terrain heads (NCHW).

Port of ``monoforce_tpu/models/terrain_encoder/bev.py:20-96``; reference
parity: BevEncode (lss.py:101-165) -- ResNet-18 layers 1-3 over the
splatted BEV features, an Up fusion back to half resolution, and three
upsampling heads: geom (ScaledTanh(-1, 1)), diff (ReLU), friction (ReLU),
with ``terrain = geom - diff`` (lss.py:158).  The convs pad symmetrically,
as torchvision's do (padding 1 at stride 2 too; the 7x7 stem pads 3).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from monoforce_tpu_torch.models.terrain_encoder.layers import (
    BN_MOMENTUM, BatchNorm2d, ScaledTanh, Up, UpsampleAlignCorners)

__all__ = ["BevEncode", "BasicBlock"]


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


class _Head(nn.Sequential):
    """Upsample x2 + 3x3 conv + BN + GELU + 1x1 conv + activation
    (reference: lss.py:115-138; indices 1, 2 and 4 hold the weights)."""

    def __init__(self, in_ch: int, out_ch: int, final_act: nn.Module):
        super().__init__(
            UpsampleAlignCorners(2),
            nn.Conv2d(in_ch, 128, 3, padding=1, bias=False),
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
