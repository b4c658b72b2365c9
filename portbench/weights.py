"""Seeded encoder weights, made on the device in one draw.

The names and shapes come from the reference encoder's ``state_dict``; one
``torch.randn`` over their total size, on the device, is cut into the
leaves and scaled by a rule on each leaf's role:

- a convolution's weight: lecun-normal, std 1 / sqrt(fan in);
- a 1-D ``weight`` (a BN scale): 1 + ``bn_noise`` x N(0, 1);
- a ``bias`` and a BN ``running_mean``: ``bn_noise`` x N(0, 1);
- a BN ``running_var``: exp(``bn_noise`` x N(0, 1));
- ``num_batches_tracked``: 0.

``scale`` multiplies the leaves under given name prefixes (the heads' last
convolutions, so that the maps have the tenths of a metre of real
terrain), and ``shift`` adds to them (the friction head's bias).  The
program and the reference load the same tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.traffic import generator


def seeded_state(template: Dict[str, torch.Tensor], seed: int, rule: dict,
                 device) -> Dict[str, torch.Tensor]:
    floats = {k: v for k, v in template.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    draw = torch.randn((total,), generator=generator(device, seed, "weights"),
                       device=device)
    noise = float(rule["bn_noise"])
    out, at = {}, 0
    for k, v in template.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
            continue
        z = draw[at:at + v.numel()].view(v.shape)
        at += v.numel()
        if v.ndim == 4:
            w = z / float(v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            w = torch.exp(noise * z)
        elif k.endswith("weight"):
            w = 1.0 + noise * z
        else:
            w = noise * z
        for prefix, s in rule.get("scale", {}).items():
            if k.startswith(prefix):
                w = w * s
        for prefix, s in rule.get("shift", {}).items():
            if k.startswith(prefix):
                w = w + s
        out[k] = w.contiguous()
    return out
