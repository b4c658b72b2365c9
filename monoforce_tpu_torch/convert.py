"""Carry the JAX package's parameters across to the PyTorch port.

- :func:`robot_model_from_arrays` turns the leaves of a JAX ``RobotModel``
  (``monoforce_tpu/physics/engine.py:82-107``), given as a dict of numpy
  arrays plus its three static fields, into the port's
  :class:`~monoforce_tpu_torch.physics.engine.RobotModel`, bit for bit.  The
  caller reads the leaves (``np.asarray(getattr(model, name))``).
- :func:`variables_to_state_dict` turns the JAX ``LiftSplatShoot``'s
  variables (``{"params", "batch_stats"}`` as nested dicts of arrays) into
  the port's ``state_dict``, under the reference checkpoint's names.  It is
  the inverse of ``monoforce_tpu/models/terrain_encoder/torch_port.py:171-183``
  (``state_dict_to_variables``): conv kernels (kH, kW, I, O) -> (O, I, kH,
  kW), BN scale/bias -> weight/bias, mean/var -> running_mean/running_var,
  and ``num_batches_tracked`` zero, which torch's BatchNorm keeps.

This module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monoforce_tpu_torch.models.terrain_encoder.efficientnet import B0_STAGES
from monoforce_tpu_torch.physics.engine import RobotModel, resolve_device

__all__ = ["ROBOT_LEAVES", "robot_model_from_arrays",
           "variables_to_state_dict"]

ROBOT_LEAVES = tuple(f.name for f in dataclasses.fields(RobotModel)
                     if f.name not in ("n_tracks", "has_flippers",
                                       "integration_mode"))


def robot_model_from_arrays(leaves: dict, n_tracks: int, has_flippers: bool,
                            integration_mode: str,
                            device="cuda") -> RobotModel:
    """``leaves`` maps every name of :data:`ROBOT_LEAVES` to a float32
    array (0-d for scalars).  Values are copied unchanged."""
    device = resolve_device(device)
    missing = set(ROBOT_LEAVES) - set(leaves)
    if missing:
        raise KeyError(f"robot leaves missing: {sorted(missing)}")
    tensors = {}
    for name in ROBOT_LEAVES:
        a = np.asarray(leaves[name])
        if a.dtype != np.float32:
            raise TypeError(f"leaf {name!r} is {a.dtype}, expected float32")
        tensors[name] = torch.from_numpy(a.copy()).to(device)
    return RobotModel(**tensors, n_tracks=int(n_tracks),
                      has_flippers=bool(has_flippers),
                      integration_mode=str(integration_mode))


def _up_layers(tprefix: str, fpath: tuple):
    """An Up block: Sequential indices 0/1 (conv, BN) and 3/4."""
    out = []
    for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
        f = fpath + (f"ConvBNAct_{i}",)
        out += [(f"{tprefix}.conv.{ci}", f + ("Conv_0",), "conv"),
                (f"{tprefix}.conv.{bi}", f + ("BatchNorm_0",), "bn")]
    return out


def _lss_layers():
    """(torch module name, flax path, "conv" or "bn") of every layer of
    ``LiftSplatShoot`` with weights, the B0 trunk's table in full."""
    eff = ("camencode", "EfficientNetB0_0")
    out = [("camencode.trunk._conv_stem", eff + ("Conv_0",), "conv"),
           ("camencode.trunk._bn0", eff + ("BatchNorm_0",), "bn")]
    idx = 0
    for expand, _k, _s, _ch, repeats in B0_STAGES:
        for _ in range(repeats):
            t = f"camencode.trunk._blocks.{idx}"
            f = eff + (f"MBConv_{idx}",)
            convs = (["_expand_conv"] if expand != 1 else []) + [
                "_depthwise_conv", "_se_reduce", "_se_expand", "_project_conv"]
            bns = (["_bn0"] if expand != 1 else []) + ["_bn1", "_bn2"]
            out += [(f"{t}.{n}", f + (f"Conv_{i}",), "conv")
                    for i, n in enumerate(convs)]
            out += [(f"{t}.{n}", f + (f"BatchNorm_{i}",), "bn")
                    for i, n in enumerate(bns)]
            idx += 1
    out += _up_layers("camencode.up1", ("camencode", "Up_0"))
    out.append(("camencode.depthnet", ("camencode", "Conv_0"), "conv"))
    bev = ("bevencode",)
    out += [("bevencode.conv1", bev + ("Conv_0",), "conv"),
            ("bevencode.bn1", bev + ("BatchNorm_0",), "bn")]
    block = 0
    for layer in (1, 2, 3):
        for j in range(2):
            t = f"bevencode.layer{layer}.{j}"
            f = bev + (f"BasicBlock_{block}",)
            names = [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
                     ("conv2", "Conv_1", "conv"), ("bn2", "BatchNorm_1", "bn")]
            if layer > 1 and j == 0:
                names += [("downsample.0", "Conv_2", "conv"),
                          ("downsample.1", "BatchNorm_2", "bn")]
            out += [(f"{t}.{a}", f + (b,), kind) for a, b, kind in names]
            block += 1
    out += _up_layers("bevencode.up1", bev + ("Up_0",))
    for i, head in enumerate(("up_geom", "up_diff", "up_friction")):
        f = bev + (f"_Head_{i}",)
        out += [(f"bevencode.{head}.1", f + ("Conv_0",), "conv"),
                (f"bevencode.{head}.2", f + ("BatchNorm_0",), "bn"),
                (f"bevencode.{head}.4", f + ("Conv_1",), "conv")]
    return out


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def _f32(node, name: str, path) -> np.ndarray:
    """A float32 copy of the leaf ``name`` of ``node`` (TypeError else)."""
    a = np.asarray(node[name])
    if a.dtype != np.float32:
        raise TypeError(f"{'/'.join(path)}/{name} is {a.dtype}, "
                        "expected float32")
    return a.copy()


def variables_to_state_dict(variables) -> dict:
    """The JAX ``LiftSplatShoot``'s variables -> the port's ``state_dict``
    (float32 CPU tensors; ``num_batches_tracked`` int64 zeros).  Raises
    KeyError if the variables hold a leaf no layer takes, TypeError for a
    leaf that is not float32."""
    sd, used = {}, 0
    for tname, path, kind in _lss_layers():
        p = variables["params"]
        for k in path:
            p = p[k]
        if kind == "conv":
            sd[tname + ".weight"] = torch.from_numpy(np.ascontiguousarray(
                _f32(p, "kernel", path).transpose(3, 2, 0, 1)))
            if "bias" in p:
                sd[tname + ".bias"] = torch.from_numpy(_f32(p, "bias", path))
            used += len(p)
            continue
        s = variables["batch_stats"]
        for k in path:
            s = s[k]
        for tkey, node, name in (("weight", p, "scale"), ("bias", p, "bias"),
                                 ("running_mean", s, "mean"),
                                 ("running_var", s, "var")):
            sd[f"{tname}.{tkey}"] = torch.from_numpy(_f32(node, name, path))
        sd[tname + ".num_batches_tracked"] = torch.tensor(0)
        used += len(p) + len(s)
    n = _n_leaves(variables["params"]) + _n_leaves(variables["batch_stats"])
    if used != n:
        raise KeyError(f"the variables hold {n} leaves, the layers take {used}")
    return sd
