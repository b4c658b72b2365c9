"""Shared building blocks of the terrain encoder (NCHW).

Port of ``monoforce_tpu/models/terrain_encoder/layers.py:24-91``.  The JAX
package reproduces torch's ``Upsample(mode='bilinear', align_corners=True)``
with interpolation matrices (:34-54); the port calls the reference's op,
``F.interpolate``.  ``Conv2dSame`` pads like flax's default ``"SAME"``
(TensorFlow's rule), which is asymmetric at stride 2: 256 -> (0, 1) for
k=3; ``nn.Conv2d(padding=k // 2)`` would shift every window by a pixel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ScaledTanh", "Up", "conv_bn_act", "upsample_align_corners",
           "swish", "Conv2dSame", "UpsampleAlignCorners", "BatchNorm2d",
           "BN_MOMENTUM"]

# flax's BatchNorm momentum 0.99 is torch's 0.01 (the weight of the batch)
BN_MOMENTUM = 0.01


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running statistics follow flax's
    update: ``ra = 0.99 ra + 0.01 batch``, with the *biased* batch variance
    (torch's own update takes the unbiased one, n/(n-1) larger).  The
    normalization, inference and the ``state_dict`` names are torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        # normalized by the biased batch statistics, as in torch and flax
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def swish(x):
    """x * sigmoid(x)."""
    return F.silu(x)


def upsample_align_corners(x, scale: int):
    """Bilinear align-corners upsample of (B, C, H, W) by an integer factor."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)


class UpsampleAlignCorners(nn.Module):
    """:func:`upsample_align_corners` as a module (no parameters)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_align_corners(x, self.scale)


class ScaledTanh(nn.Module):
    """min + (max - min) * (tanh(x) + 1) / 2 (reference: lss.py:17-24)."""

    def __init__(self, min_val: float = -1.0, max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val

    def forward(self, x):
        return self.min_val + (self.max_val - self.min_val) * (torch.tanh(x) + 1) / 2


class Conv2dSame(nn.Conv2d):
    """Conv2d with flax/TensorFlow ``"SAME"`` padding from the input's size:
    out = ceil(n / stride), the padding's odd pixel at the end."""

    def forward(self, x):
        pads = []
        for n, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1],
                           self.stride[::-1]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (pads[2], pads[0]), 1, self.groups)
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride,
                        0, 1, self.groups)


def conv_bn_act(in_ch: int, out_ch: int):
    """[3x3 conv (no bias, padding 1), BN, GELU]: the JAX ``ConvBNAct`` as
    three modules, so that a Sequential of them keeps the reference's
    indices.  ``nn.GELU`` is the exact erf form (reference Up and head
    blocks, lss.py:39-41,118), which the JAX package pins as
    ``gelu_exact``."""
    return [nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm2d(out_ch, momentum=BN_MOMENTUM),
            nn.GELU()]


class Up(nn.Module):
    """Upsample + skip-concat + double conv (reference: lss.py:27-46)."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = nn.Sequential(*conv_bn_act(in_channels, out_channels),
                                  *conv_bn_act(out_channels, out_channels))

    def forward(self, x1, x2):
        x1 = upsample_align_corners(x1, self.scale_factor)
        return self.conv(torch.cat([x2, x1], dim=1))
