"""What the metric readers under ``metrics/`` share: each reads one number
from a run's record (``harness.run``'s ``rec``), or returns None where the
run holds nothing for it to read."""

from __future__ import annotations

import math
import statistics
from typing import Optional

from portbench.counts.peaks import PEAK_F32_PER_S, bound_s


def timed_units(rec):
    """The window's units that ran outside the profiler."""
    return [u for u in rec["units"] if not u["profiled"]]


def rate(rec) -> Optional[float]:
    """Work completed over the whole window, per second."""
    if not rec["units"] or rec["window_s"] <= 0:
        return None
    return sum(u["work"] for u in rec["units"]) / rec["window_s"]


def mean_unit_ms(rec) -> Optional[float]:
    """The whole window over the units completed, in ms."""
    n = sum(u["n"] for u in rec["units"])
    return rec["window_s"] / n * 1e3 if n else None


def percentile_ms(rec, q: float) -> Optional[float]:
    """The ``q`` quantile (nearest rank) of the units' times, in ms."""
    times = sorted(u["end"] - u["start"] for u in timed_units(rec))
    if not times:
        return None
    return times[max(math.ceil(q * len(times)) - 1, 0)] * 1e3


def span_ms(rec, name: str) -> Optional[float]:
    """The median over the traced window's units of span ``name``."""
    vals = [u["spans"][name] for u in timed_units(rec) if name in u["spans"]]
    return statistics.median(vals) if vals else None


def launches_per_unit(rec) -> Optional[float]:
    p = rec["profile"]
    return p["kernels"] / p["units"] if p else None


def idle_share(rec) -> Optional[float]:
    """The share of the profiled span in which nothing ran on the card."""
    p = rec["profile"]
    if not p or p["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])


def mfu(rec) -> Optional[float]:
    """The work counted from shapes per unit over the traced window's mean
    time per unit, as a share of the card's float32 peak."""
    units = timed_units(rec)
    flops = rec["counts"].get("flops_per_unit")
    if not units or not flops:
        return None
    t = sum(u["end"] - u["start"] for u in units) / sum(u["n"] for u in units)
    return 100.0 * flops / t / PEAK_F32_PER_S


def kernel_name(op: str) -> str:
    """A device operation's kernel, without its return type, namespace
    qualifier or arguments: ``fk_step_kernel<2>`` for ``void (anonymous
    namespace)::fk_step_kernel<2>(float const*, ...)``."""
    name = op.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(", 1)[0]


def roofline(rec, count_key: str, kernel: str) -> Optional[float]:
    """The least time of one launch's work (``counts[count_key]``) over the
    mean device time of the profiled kernel named exactly ``kernel`` (as
    :func:`kernel_name` gives it).  None where no profiled operation has
    that name, or where two differently named operations both do."""
    p, work = rec["profile"], rec["counts"].get(count_key)
    if not p or not work:
        return None
    hits = [(n, v) for n, v in p["device_ops"].items()
            if kernel_name(n) == kernel]
    if len(hits) != 1:
        return None
    seconds, launches = hits[0][1][0], hits[0][1][1]
    if not launches:
        return None
    return 100.0 * bound_s(work["bytes"], work["flops"]) / (
        seconds / launches)
