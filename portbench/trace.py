"""The profiled part of a traced run, reduced to numbers.

A fixed count of units of work runs under ``torch.profiler`` with the
card's activity only, so that the host pays little for the trace; one more
unit runs with the host's activity too, to name what the host did while
the card was idle.  The reduction reads the profiler's raw events
(``prof.profiler.kineto_results.events()``), never ``key_averages()``,
which takes minutes over a train step's ~90k launches.

- device operations: every event on the card (kernels, copies, sets);
  kernels are those whose names do not start with ``Memcpy``/``Memset``;
- the span: from the first device operation's start to the last one's end
  (host annotations of the units, where traced, widen it);
- busy: the union of the device operations' intervals inside the span;
- idle by host operation (the named unit): the parts of its span outside
  that union, each named by the innermost host operation running at its
  midpoint (CUDA API calls left out), summed by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List

import torch

UNIT = "portbench.unit"
_NOT_KERNELS = ("Memcpy", "Memset", "[memory]")
# host events that are not the program's work: CUDA API calls and the
# profiler's own buffer requests
_NOT_HOST = ("cuda", "Activity Buffer Request")
NAME_CHARS = 160


def profile_units(run_unit: Callable[[int, None], int], first: int,
                  n: int, device):
    """Run units ``first .. first + n - 1`` under the profiler of the
    card's activity, then unit ``first + n`` under the host's too; returns
    (the trace reduced, see the module's docstring; the work of the
    ``n + 1`` units)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda d: None)
    sync(device)
    work = 0
    # a machine without a card traces its host: no device operation then
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        for i in range(first, first + n):
            work += run_unit(i, None)
        sync(device)
    reduced = reduce_events(prof.profiler.kineto_results.events(), n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(UNIT):
            work += run_unit(first + n, None)
        sync(device)
    named = reduce_events(prof.profiler.kineto_results.events(), 1)
    if reduced:
        reduced["idle_by_host"] = named.get("idle_by_host", {})
    return reduced, work


def reduce_events(events, n_units: int) -> Dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, units = [], [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if name == UNIT:
            # the annotation shows on the card's timeline too; only the
            # host's copy marks the span
            if e.device_type() != cuda:
                units.append((start, end))
        elif e.device_type() == cuda:
            dev.append((start, end, name))
        elif not name.startswith(_NOT_HOST):
            host.append((start, end, name))
    if not units and not dev:
        return {}
    t0 = min([u[0] for u in units] + [a for a, _, _ in dev])
    t1 = max([u[1] for u in units] + [b for _, b, _ in dev])
    dev = [(max(a, t0), min(b, t1), n) for a, b, n in dev if b > t0 and a < t1]
    dev.sort()

    by_name = defaultdict(lambda: [0.0, 0])
    kernels = 0
    for a, b, name in dev:
        rec = by_name[name]
        rec[0] += (b - a) / 1e9
        rec[1] += 1
        if not name.startswith(_NOT_KERNELS):
            kernels += 1

    busy, gaps, cur_a, cur_b = 0, [], t0, t0
    for a, b, _ in dev:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if t1 > cur_b:
        gaps.append((cur_b, t1))

    return {"units": n_units, "span_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
            "kernels": kernels, "device_ops": dict(by_name),
            "idle_by_host": _name_gaps(gaps, host)}


def _name_gaps(gaps: List, host: List) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host operation at each
    gap's midpoint."""
    # by start, and of operations that start together the outer first, so
    # that the last one started is the innermost
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(Python between operations)"
        # the latest-starting operation still running at the midpoint
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += (b - a) / 1e9
    return dict(out)


def top(d: Dict, k: int = 10, key=lambda v: v) -> List:
    """The ``k`` largest entries of ``d`` as [name, value] pairs, each name
    cut to its first :data:`NAME_CHARS` characters."""
    ranked = sorted(d.items(), key=lambda kv: -key(kv[1]))[:k]
    return [[n[:NAME_CHARS], key(v)] for n, v in ranked]
