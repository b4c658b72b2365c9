"""The terrain encoder's convolution operations, counted from its layer
shapes.

The reference encoder is built on the ``meta`` device, where tensors have
shapes and no values, and run forward once at the cell's batch; a hook on
every convolution adds ``2 x out elements x in channels per group x
kernel area`` (a multiply and an add per tap).  The camera encoder runs on
the images and the BEV encoder on a BEV tensor of its input's shape, so
the splat, whose work is data-dependent adds, is left out, as are the
elementwise operations.  Training counts the forward and twice the
forward for the backward (input and weight gradients).
"""

from __future__ import annotations

import torch

from portbench.reference.lss import LiftSplatShoot


def encoder_flops(grid_conf: dict, data_aug_conf: dict, camC: int,
                  downsample: int, batch: int, n_cams: int,
                  train: bool) -> int:
    """Operations of one encoder forward (``train``: forward and backward)
    over ``batch`` frames of ``n_cams`` images at ``final_dim``."""
    with torch.device("meta"):
        model = LiftSplatShoot(grid_conf, data_aug_conf, outC=1, camC=camC,
                               downsample=downsample).eval()
    total = [0]

    def hook(mod, _inputs, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * k

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    H, W = data_aug_conf["final_dim"]
    nx = model.nx
    with torch.no_grad():
        model.camencode(torch.empty((batch * n_cams, 3, H, W),
                                    device="meta"))
        model.bevencode(torch.empty((batch, camC * int(nx[2]), int(nx[0]),
                                     int(nx[1])), device="meta"))
    return 3 * total[0] if train else total[0]
