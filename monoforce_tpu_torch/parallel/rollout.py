"""Shooting with the rollout batch sharded over a mesh.

Port of ``monoforce_tpu/parallel/rollout.py:30-68``.  The rollout batch
(sampled control sequences) is embarrassingly parallel: each trajectory
only reads the shared terrain.  The JAX ``sharded_shoot`` runs one SPMD
program (``shard_map``) over the ``('data',)`` mesh; here one process
drives every shard: the terrain and the robot are placed once on each
distinct device of the mesh, the controls and the initial states are split
with ``shard_batch``, each shard runs the serving rollout
(``physics.fast.planner_rollout``) and its cost at its *local* batch, and
the results come back in batch order on the mesh's first device.

Shards on one device run one after another: on one card, a mesh of n
shards costs about n unsharded calls of the local batch, and gives the
unsharded result.  The kernel mode follows the local batch, as in JAX
(``planner_kernel_mode``: the pair formats need B % 16 == 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from monoforce_tpu_torch.parallel.sharding import Mesh, shard_batch
from monoforce_tpu_torch.physics.engine import RigidState, RobotModel
from monoforce_tpu_torch.physics.fast import planner_rollout
from monoforce_tpu_torch.planner.shooting import (force_variance_cost,
                                                  inclination_cost)

__all__ = ["sharded_shoot"]

_COSTS = ("force_variance", "inclination")


def _robot_on(robot: RobotModel, dev: torch.device) -> RobotModel:
    """``robot`` with its tensors on ``dev`` (itself if they are there)."""
    if robot.device == dev:
        return robot
    return dataclasses.replace(robot, **{
        f.name: getattr(robot, f.name).to(dev)
        for f in dataclasses.fields(robot)
        if isinstance(getattr(robot, f.name), torch.Tensor)})


def sharded_shoot(mesh: Mesh, robot: RobotModel, z_grid, controls,
                  state0: Optional[RigidState] = None, friction=None,
                  cost: str = "force_variance"):
    """Shooting batch sharded over ``mesh``'s devices.

    Args:
      mesh: a 1-D mesh (``parallel.make_mesh``).
      robot: RobotModel (no flipper articulation).
      z_grid/friction: (H, W) shared terrain, placed on every shard device;
        ``friction=None`` is a grid of ones, as in the JAX function
        (rollout.py:43-44), so the friction modes run (``pair``,
        ``pair3_muq``), never the ``_zu`` ones.
      controls: (B, N, 2) with B divisible by the mesh size.
      state0: optional (B, ...) initial states, split alongside.
      cost: ``"force_variance"`` or ``"inclination"``.

    Returns (xs (B, N, 3), costs (B,)) on ``mesh.devices[0]``.
    """
    if cost not in _COSTS:
        raise ValueError(f"cost must be one of {_COSTS}, got {cost!r}")
    z_grid = torch.as_tensor(z_grid, dtype=torch.float32)
    friction = (torch.ones_like(z_grid) if friction is None else
                torch.as_tensor(friction, dtype=torch.float32))
    ctr = shard_batch(torch.as_tensor(controls, dtype=torch.float32), mesh)
    st = (None if state0 is None else
          shard_batch(RigidState(*(torch.as_tensor(v, dtype=torch.float32)
                                   for v in state0)), mesh))
    placed = {}
    xs, costs = [], []
    for i, dev in enumerate(mesh.devices):
        if dev not in placed:
            placed[dev] = (_robot_on(robot, dev), z_grid.to(dev),
                           friction.to(dev))
        r, z, fr = placed[dev]
        s0 = None if st is None else RigidState(*(v.shards[i] for v in st))
        states, stats = planner_rollout(r, z, ctr.shards[i], state0=s0,
                                        friction=fr)
        if cost == "force_variance":
            c = force_variance_cost(stats.spring_std)
        else:
            c = inclination_cost(stats.abs_roll, stats.abs_pitch)
        xs.append(states.x)
        costs.append(c)
    out = mesh.devices[0]
    return (torch.cat([x.to(out) for x in xs]),
            torch.cat([c.to(out) for c in costs]))
