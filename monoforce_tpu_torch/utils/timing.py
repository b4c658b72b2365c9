"""Wall-clock timing helpers (reference: utils.py:32-40 ``timing`` decorator).

Port of ``monoforce_tpu/utils/timing.py``.  ``Timer.block_on`` takes the
tensors whose work must be finished before the clock stops: CUDA kernels
run asynchronously, so the timer synchronises the devices they lie on
(``torch.cuda.synchronize(device)``), where the JAX version calls
``jax.block_until_ready``.
"""

from __future__ import annotations

import functools
import time

import torch

__all__ = ["timing", "Timer", "synchronize"]


def timing(fn):
    """Decorator printing the wall-clock time of each call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"{fn.__name__} took {time.perf_counter() - t0:.3f} s")
        return out

    return wrapper


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def synchronize(tree) -> None:
    """Wait for the work of every CUDA device that holds a tensor of
    ``tree`` (a tensor, or dicts, lists and tuples of them; other leaves
    and CPU tensors need no wait)."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class Timer:
    """Context manager: ``with Timer("rollout") as t: ...`` then ``t.dt``.

    If ``block_on`` is given, waits for the devices of those tensors before
    stopping the clock (CUDA launches are asynchronous).
    """

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.dt = None
        self._block = None

    def block_on(self, tree):
        self._block = tree
        return tree

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._block is not None:
            synchronize(self._block)
        self.dt = time.perf_counter() - self.t0
        if self.verbose:
            print(f"{self.name} took {self.dt:.4f} s")
        return False
