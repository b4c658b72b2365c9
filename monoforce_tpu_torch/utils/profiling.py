"""Device profiling helpers.

Port of ``monoforce_tpu/utils/profiling.py``.  The reference's
observability is wall-clock prints (``@timing``, utils.py:32-40).  Here
``trace`` captures a ``torch.profiler`` trace of the host and the card
(CPU and CUDA activities) and writes it to ``log_dir`` as a Chrome trace,
viewable in Perfetto or ``chrome://tracing``; ``measure`` times a call with
CUDA events on the card, or on the host clock after a synchronise.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from monoforce_tpu_torch.utils.timing import _tensors, synchronize

__all__ = ["trace", "measure"]


@contextmanager
def trace(log_dir: str = "runs/profile"):
    """Capture a trace: ``with trace('runs/profile') as prof: step()``.

    Yields the ``torch.profiler.profile`` object (``key_averages()`` sums
    the kernels by name); on leaving, the trace is written to
    ``<log_dir>/trace.json``.  The CUDA activity is traced where a card is
    visible."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(out) -> bool:
    return any(t.device.type == "cuda" for t in _tensors(out))


def measure(fn, *args, reps: int = 5, warmup: int = 1, transfer=False):
    """Best-of-``reps`` latency of ``fn(*args)`` in milliseconds.

    When the result holds CUDA tensors, each rep is timed between CUDA
    events recorded on the current stream (the device's time, host time
    inside the call included); otherwise on the host clock after
    synchronising the result's devices.  With ``transfer`` the result is
    copied to the host each rep, inside the timed region.
    """
    for _ in range(max(warmup, 1)):
        out = fn(*args)
        synchronize(out)
    cuda = _on_cuda(out)
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            if transfer:
                _to_host(out)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            if transfer:
                _to_host(out)
            synchronize(out)
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _to_host(out):
    return [t.cpu() for t in _tensors(out)]
