"""Lift-Splat-Shoot terrain encoder (NCHW, fixed shapes).

Port of ``monoforce_tpu/models/terrain_encoder/lss.py``: ``CamEncode``
(:70-98), ``LiftSplatShoot`` (:101-146) and the half serving mode
(``half_inference_variables``, :38-67); reference: monoforce/src/monoforce/
models/terrain_encoder/lss.py:167-302.

- lift: per-camera EfficientNet-B0 features, a 1x1 depth net giving a
  softmax depth distribution (D bins) times context (C channels),
- splat: ``ops.voxel_pool``'s fixed-shape masked segment sum,
- shoot: the planner consumes the predicted grids (``pipeline``).

The public convention is the reference's: images (B, N_cams, 3, H, W) in, a
dict of (B, 1, X, Y) heads out.  Module and ``state_dict`` names are the
reference's, so a reference ``.pth`` loads directly.  The float32 forward
runs with TF32 off in cuDNN and in matmuls, scoped to the call.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from monoforce_tpu_torch.models.terrain_encoder.bev import BasicBlock, BevEncode
from monoforce_tpu_torch.models.terrain_encoder.efficientnet import EfficientNetB0
from monoforce_tpu_torch.models.terrain_encoder.geometry import (
    create_frustum, gen_dx_bx, get_geometry)
from monoforce_tpu_torch.models.terrain_encoder.layers import Up
from monoforce_tpu_torch.ops.voxel_pool import voxel_pool

__all__ = ["LiftSplatShoot", "CamEncode", "half_inference_model",
           "float32_math"]

# flax's lecun_normal draws from a normal truncated at 2 standard
# deviations and divides by this, the truncated law's standard deviation
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def float32_math():
    """Convolutions and matmuls in full float32 (TF32 off in cuDNN and in
    matmuls) for the duration of the block; the previous settings come
    back on leaving."""
    matmul = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(matmul)


def half_inference_model(model: "LiftSplatShoot") -> "LiftSplatShoot":
    """Serving-precision copy of ``model``: the camera encoder
    (``camencode``: EfficientNet-B0, Up fusion, depth net; its parameters
    and its BN statistics) in bf16, the BEV encoder and the three heads in
    float32, as ``half_inference_variables`` casts the JAX variables.  Feed
    it bf16 images; the lifted features and their splat stay bf16, and the
    BEV input is cast to float32, so the heads are float32."""
    half = copy.deepcopy(model)
    half.camencode.to(torch.bfloat16)
    return half


class CamEncode(nn.Module):
    """Per-camera feature + depth-distribution encoder (lss.py:49-99)."""

    def __init__(self, D: int, C: int, drop_connect_rate: float = 0.2):
        super().__init__()
        self.D, self.C = D, C
        self.trunk = EfficientNetB0(drop_connect_rate)
        self.up1 = Up(320 + 112, 512)
        self.depthnet = nn.Conv2d(512, D + C, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B*, 3, H, W) -> (B*, D, fH, fW, C) lifted features;
        ``generator`` draws the trunk's drop-connect masks in train mode."""
        endpoints = self.trunk(x, generator)
        h = self.up1(endpoints["reduction_5"], endpoints["reduction_4"])
        h = self.depthnet(h)
        depth = h[:, :self.D].softmax(dim=1)              # (B*, D, fH, fW)
        ctx = h[:, self.D:self.D + self.C].permute(0, 2, 3, 1)
        return depth[..., None] * ctx[:, None]            # outer product


class LiftSplatShoot(nn.Module):
    """grid_conf/data_aug_conf-driven LSS encoder with three terrain heads.
    ``drop_connect_rate`` is the B0 trunk's (the JAX ``EfficientNetB0``
    field); it acts in train mode only."""

    def __init__(self, grid_conf, data_aug_conf, outC: int = 1,
                 camC: int = 64, downsample: int = 16,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        self.grid_conf, self.data_aug_conf = grid_conf, data_aug_conf
        dx, bx, nx = gen_dx_bx(grid_conf["xbound"], grid_conf["ybound"],
                               grid_conf["zbound"])
        self.nx = nx
        # constants of the geometry, outside the state_dict
        self.register_buffer("dx", torch.from_numpy(dx), persistent=False)
        self.register_buffer("bx", torch.from_numpy(bx), persistent=False)
        self.register_buffer("frustum", create_frustum(
            data_aug_conf["final_dim"], grid_conf["dbound"], downsample),
            persistent=False)
        self.D = int(self.frustum.shape[0])
        self.camC = camC
        self.camencode = CamEncode(self.D, camC, drop_connect_rate)
        self.bevencode = BevEncode(camC * int(nx[2]), outC)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers, drawn from ``generator`` (a CPU
        generator, so that every device gets the same weights): convs
        lecun-normal (truncated at 2 sigma, fan in = in channels per group
        x kernel area), biases zero; BN scale one (zero for each
        BasicBlock's ``bn2``), bias zero, running mean zero, variance
        one."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.zero_()

    def get_cam_feats(self, imgs, generator: Optional[torch.Generator] = None):
        """imgs: (B, N, 3, H, W) -> (B, N, D, fH, fW, C)."""
        B, N = imgs.shape[:2]
        feats = self.camencode(imgs.reshape((B * N,) + imgs.shape[2:]),
                               generator)
        return feats.reshape((B, N) + feats.shape[1:])

    def get_voxels(self, imgs, rots, trans, intrins, post_rots, post_trans,
                   generator: Optional[torch.Generator] = None):
        geom = get_geometry(self.frustum, rots, trans, intrins, post_rots,
                            post_trans)
        return voxel_pool(geom, self.get_cam_feats(imgs, generator), self.dx,
                          self.bx, self.nx)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Returns {'geom', 'terrain', 'diff', 'friction'}: (B, outC, X, Y).
        The images take the camera encoder's dtype; the calibrations are
        float32.  In train mode the trunk's drop-connect masks come from
        ``generator`` (on the model's device), which must then be given
        unless the model was built with ``drop_connect_rate=0``; BN updates
        its running statistics as flax does."""
        with float32_math():
            bev = self.get_voxels(imgs, rots, trans, intrins, post_rots,
                                  post_trans, generator)
            # torch does not promote inside a conv: the BEV input takes the
            # BEV encoder's dtype (float32 in the half mode too)
            return self.bevencode(bev.to(self.bevencode.conv1.weight.dtype))
