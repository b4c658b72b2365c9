"""Device meshes and batch sharding of the PyTorch port.

Port of ``monoforce_tpu/parallel/sharding.py:30-53``.  JAX places a pytree
on a ``Mesh`` with a ``NamedSharding`` and lets SPMD run one program over
it; PyTorch has no such program, so here a mesh is a tuple of devices and
a sharded leaf is the tuple of its parts, one per device, that records its
sharding.  Whoever consumes the parts runs each on its device
(``parallel.sharded_shoot``) or hands each to a process of a
``torch.distributed`` group (``parallel.data_parallel``).

- ``make_mesh()`` takes the first ``n_devices`` cards; a specific device
  (``"cuda:0"``, ``"cpu"``) gives ``n_devices`` shards on that one device,
  the counterpart of the JAX tests' virtual 8-device CPU mesh.
- ``shard_batch`` splits every leaf on its leading (batch) dim into
  ``mesh.size`` equal parts; ``gather_batch`` is its inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from monoforce_tpu_torch.physics.engine import resolve_device

__all__ = ["Mesh", "NamedSharding", "Sharded", "make_mesh", "data_sharding",
           "replicated", "shard_batch", "gather_batch"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices along the first axis; any further axes have
    size 1 (room for model sharding, as in the JAX helpers)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's ``Mesh.shape``."""
        return {name: (self.size if i == 0 else 1)
                for i, name in enumerate(self.axis_names)}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a leaf lives on a mesh: ``spec[d]`` names the mesh axis that
    dim d is split over, or None (replicated along it)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf split over a mesh: ``shards[i]`` lives on
    ``sharding.mesh.devices[i]``."""

    shards: Tuple[torch.Tensor, ...]
    sharding: NamedSharding


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              device="cuda") -> Mesh:
    """A 1-D mesh.  A device type (``"cuda"``) takes the first
    ``n_devices`` cards (all of them by default) and raises when fewer
    exist; a specific device (``"cuda:0"``, ``"cpu"``) gives ``n_devices``
    shards (default 1) on that one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise RuntimeError(
                f"a mesh of {n} cards asked for, {have} available; name one "
                f"device (device='cuda:0' or 'cpu') to put several shards on "
                f"it")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        device = resolve_device(device)
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"n_devices must be at least 1, got {n}")
        devs = (device,) * n
    return Mesh(devs, tuple(axis_names))


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``; rest replicated."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of {mesh.axis_names}")
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _map(fn, batch):
    """``fn`` over the leaves of a tuple, list, named tuple or dict."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map(fn, v) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _split(x, mesh: Mesh, axis: str) -> Sharded:
    x = torch.as_tensor(x)
    n = mesh.size
    if x.ndim == 0 or x.shape[0] % n:
        raise ValueError(f"a leading dim of {tuple(x.shape)[:1]} does not "
                         f"split into {n} equal shards")
    parts = x.split(x.shape[0] // n)
    return Sharded(tuple(p.to(d) for p, d in zip(parts, mesh.devices)),
                   data_sharding(mesh, x.ndim, axis))


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """Every leaf of ``batch`` (tensors or arrays in tuples, lists or
    dicts) split on its leading dim into ``mesh.size`` equal parts, each on
    its shard's device, as a :class:`Sharded`.  Raises ValueError when a
    leading dim does not divide."""
    return _map(lambda x: _split(x, mesh, axis), batch)


def gather_batch(batch):
    """The inverse of :func:`shard_batch`: each :class:`Sharded` leaf
    concatenated in shard order on the mesh's first device."""
    def gather(s: Sharded):
        dev = s.sharding.mesh.devices[0]
        return torch.cat([p.to(dev) for p in s.shards])
    return _map(gather, batch)
