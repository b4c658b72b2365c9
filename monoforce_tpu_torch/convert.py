"""Carry the JAX package's robot parameters across to the PyTorch port.

The planner path has no learned weights: its parameter set is the robot
model.  :func:`robot_model_from_arrays` turns the leaves of a JAX
``RobotModel`` (``monoforce_tpu/physics/engine.py:82-107``), given as a dict
of numpy arrays plus its three static fields, into the port's
:class:`~monoforce_tpu_torch.physics.engine.RobotModel`, bit for bit.  The
caller reads the leaves (``np.asarray(getattr(model, name))``); this module
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monoforce_tpu_torch.physics.engine import RobotModel, resolve_device

__all__ = ["ROBOT_LEAVES", "robot_model_from_arrays"]

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
