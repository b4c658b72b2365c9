"""One run of one cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json``, its configuration's file, its traffic mix under
``traffic/`` (which names its driver under ``drivers/``), its limits under
``workloads/``, and each metric's reader under ``metrics/``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import trace
from portbench.drivers import sync
from portbench.traffic import load_traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (compared whole: the
# program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "monoforce_tpu")


class RunError(Exception):
    """A run that must print no result."""


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(manifest: dict, name: str) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{name}.json") as f:
        limits = json.load(f)
    return {"cell": w, "config": config, "traffic": load_traffic(w["traffic"]),
            "limits": limits}


def cell_metrics(manifest: dict, name: str, traced: bool) -> List[dict]:
    """The end-to-end metrics a cell reports, or with ``traced`` its
    per-layer metrics."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metric(name: str, rec: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(rec)``: a number, or None where the
    run holds nothing for it to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def make_driver(spec: dict, seed: int, device, trace_on: bool,
                system: str = "program"):
    drv = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    return drv.Driver(spec["config"], spec["traffic"], spec["limits"], seed,
                      device, trace_on=trace_on, system=system)


def measure(driver, seconds: float, trace_on: bool, profile_units: int):
    """The window: units back to back for ``seconds``; a unit started
    before the close runs to its end and counts.  With ``trace_on``, the
    units from the window's middle on run ``profile_units`` at a time
    once under the profiler, and one more with the host traced too
    (``trace.profile_units``).  Returns (units, profile or None)."""
    units, profile, i = [], None, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace_on and profile is None and \
                time.perf_counter() - t0 >= seconds / 2:
            a = time.perf_counter()
            profile, work = trace.profile_units(driver.unit, i,
                                                profile_units, driver.device)
            units.append({"start": a - t0, "end": time.perf_counter() - t0,
                          "work": work, "n": profile_units + 1,
                          "profiled": True, "spans": {}})
            i += profile_units + 1
            continue
        spans = {} if trace_on else None
        a = time.perf_counter()
        work = driver.unit(i, spans)
        b = time.perf_counter()
        units.append({"start": a - t0, "end": b - t0, "work": work, "n": 1,
                      "profiled": False, "spans": spans or {}})
        i += 1
    return units, profile


def host_state() -> dict:
    """How fast the host runs at this moment: the load average over a
    minute, the cores' mean clock as the kernel reports it, and the time
    of a fixed pure-Python loop (the kind of work a launch-bound unit
    does), in us."""
    out = {}
    try:
        with open("/proc/loadavg") as f:
            out["load_1m"] = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        if mhz:
            out["cpu_mhz_mean"] = statistics.mean(mhz)
    except (OSError, ValueError, IndexError):
        pass
    a = time.perf_counter()
    x = 0
    for k in range(200_000):
        x += k & 7
    out["probe_us"] = (time.perf_counter() - a) * 1e6
    return out


def host_setting() -> dict:
    """What the run inherits: the cores it may use and its threads."""
    try:
        affinity = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        affinity = None
    return {"cpus": os.cpu_count(), "affinity": affinity,
            "torch_threads": torch.get_num_threads(),
            "interop_threads": torch.get_num_interop_threads(),
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS")}


def window_drift(units) -> Optional[float]:
    """The mean time of the window's last third of timed units over that
    of its first third (1: no drift within the run)."""
    times = [u["end"] - u["start"] for u in units if not u["profiled"]]
    k = len(times) // 3
    if k == 0:
        return None
    return statistics.mean(times[-k:]) / statistics.mean(times[:k])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(name: str, seed: int, seconds: float, trace_on: bool,
        t_start: float, device=None, manifest: Optional[dict] = None,
        spec: Optional[dict] = None, system: str = "program") -> Dict:
    """One run of cell ``name``; returns the result line's object.  The
    device defaults to the first card; tests pass a small ``spec`` and
    the CPU."""
    manifest = manifest or load_manifest()
    spec = spec or cell_spec(manifest, name)
    device = torch.device(device or "cuda:0")
    started = time.perf_counter() - t_start
    driver = make_driver(spec, seed, device, trace_on, system)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    host = {"before": host_state()}
    units, profile = measure(driver, seconds, trace_on,
                             spec["limits"]["profile_units"])
    sync(device)
    host["after"] = host_state()
    host.update(host_setting(), drift=window_drift(units))
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    failed = driver.failed
    driver.finish()
    readings = driver.readings()
    checks = {}
    for k, limit in spec["limits"]["checks"].items():
        v = readings.get(k)
        checks[k] = {"value": v, "limit": limit}
    correct = failed == 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())

    rec = {"setup_s": setup_s,
           "window_s": units[-1]["end"] if units else 0.0,
           "units": units, "profile": profile, "counts": driver.counts()}
    metrics = {}
    for m in cell_metrics(manifest, name, trace_on):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak), "power_limit": power_limit()
           if on_card else "none"}
    out = {"correct": bool(correct),
           "attempted": sum(u["n"] for u in units), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace_on and profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["span_s"]
        out["breakdown"] = {
            "device_ops": trace.top(profile["device_ops"], key=lambda v: v[0]),
            "idle_gaps": trace.top(profile["idle_by_host"])}
    out["info"] = {k: v for k, v in readings.items() if k not in checks}
    # where set-up went: interpreter and imports, then the traffic driver's
    # build (inputs, weights, the program) and its warm-up
    out["info"]["setup_parts_s"] = {"imports": started,
                                    "build": setup_s - started
                                    - driver.warmup_s,
                                    "warmup": driver.warmup_s}
    out["info"]["host"] = host
    out["checks"] = checks
    return out
