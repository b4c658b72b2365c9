#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of the repository:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build  -- compile every CUDA kernel of ``monoforce_tpu_torch/ops/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once); print the card's
   name and power limit.
2. kernels -- call each kernel's wrapper at the main path's shapes (B=4096;
   P=62 and P=148) on windows cut by the port's extractors from a seeded
   rough terrain, and hold it against its plain PyTorch version on the same
   inputs; print the largest difference, the tolerance, the kernel's mean
   device time from the profiler's trace, the median time of a wrapper call
   and of the plain version between CUDA events, and the bound.
3. main path -- ``Planner.plan`` at the online node's shape (64 x 500 steps,
   friction grid) for the 0.15 m planner preset (mode pair) and the 0.1 m
   cloud (pair3_muq); ``planner_rollout`` on bench.py's three workloads at
   4096 x 100 on the 128 x 128 gaussian hill (pair3_zu, pair3_muq, pair_zu).
   Each run starts with every launch count at 0 and must launch its step
   kernel once per step and fk_interp once; its outputs must be finite and
   its positions must agree with the same rollout through the plain
   versions on the card.  Prints ms per batch (median, synchronised).
4. one JSON line listing every kernel with its launches on the main path,
   its largest difference from the plain version, its time, the plain
   version's time and its bound on this card.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.ops import _build, fk_step_cuda, interp_cuda
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.engine import RobotModel
from monoforce_tpu_torch.planner.shooting import Planner, PlanResult

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# float operations per contact point of one step, counted from
# fk_step_plain (each exp, rsqrt, sqrt and divide counted as one): the
# rotation, world point and velocity (30), index and weights (12), taps to
# normals (18), contact and spring force (32), friction force (29 with two
# driving parts), torques and the eight sums (18), n_cp (1); friction adds
# 15 (muq: decode, bilinear, scale, 3 products) or 3 (pairmu)
STEP_FLOPS_PER_POINT = {"zu": 147, "muq": 162, "pairmu": 150}
# fk_interp per point: index (8), weights (6), z and mu (14), normals (12)
INTERP_FLOPS_PER_POINT = 40

KERNELS = {
    "fk_interp": dict(source="monoforce_tpu_torch/ops/csrc/fk_interp.cu",
                      replaces="monoforce_tpu/ops/interp_pallas.py:140"),
    "fk_step_zu": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                       replaces="monoforce_tpu/ops/fk_step_pallas.py:779 "
                                "(fk_step_pair_zu), :944 (fk_step_pair3_zu)"),
    "fk_step_muq": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                        replaces="monoforce_tpu/ops/fk_step_pallas.py:968"),
    "fk_step_pairmu": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                           replaces="monoforce_tpu/ops/fk_step_pallas.py:763"),
}
WRAPPERS = {"fk_interp": interp_cuda.fk_interp,
            "fk_step_zu": fk_step_cuda.fk_step_zu,
            "fk_step_muq": fk_step_cuda.fk_step_muq,
            "fk_step_pairmu": fk_step_cuda.fk_step_pairmu}

# kernel against plain version on the same inputs: |k - p| <= ATOL + RTOL |p|
# fk_interp: FMA contraction in the bilinear sums and rsqrtf, O(1) outputs;
# steps: the same, plus the per-trajectory sums over up to 192 points in
# another order (forces of ~1e2 N, accelerations of ~1e1 m/s^2)
TOL = {"fk_interp": (1e-5, 1e-5), "step": (1e-3, 1e-4)}
# positions of a whole rollout, kernels against plain versions: rounding
# differences grow over the steps; 1 mm RMSE is 1% of a 0.1 m grid cell
POS_RMSE_TOL_M = 1e-3


def _say(*parts):
    print(*parts, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gaussian_hill(cfg):
    """bench.py's terrain: a gaussian hill on the 128 x 128 grid."""
    gx, gy = cfg.grid_coords()
    return (0.4 * np.exp(-((gx - 2.0) ** 2 / 4.0 + gy ** 2 / 8.0))).astype(
        np.float32)


def bench_friction(cfg):
    """bench.py's friction grid, shaped like the encoder's friction head."""
    gx, gy = cfg.grid_coords()
    return (0.7 + 0.25 * np.sin(1.3 * gx) * np.cos(0.9 * gy)).astype(np.float32)


def rough_terrain(cfg, rng):
    return (gaussian_hill(cfg) + 0.05 * rng.normal(size=cfg.grid_shape)).astype(
        np.float32)


def kernel_ms(fn, kernel: str, reps: int = 100, flush=None):
    """Mean device ms of the CUDA kernel named ``kernel`` over ``reps``
    calls of ``fn``, from the profiler's trace of the card; None when the
    trace holds no such kernel.  With ``flush`` (a tensor larger than the
    50 MB L2), it is zeroed before every call, so the kernel finds its
    inputs in device memory and not in L2."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += ev.device_time_total
            count += ev.count
    return total_us / count / 1e3 if count else None


def device_busy(fn, kernel: str):
    """One profiled call of ``fn``: (ms of all kernels on the card, ms of
    the kernels named ``kernel``, host ms of the call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = named = 0.0
    for ev in prof.key_averages():
        t = ev.device_time_total / 1e3
        total += t
        if kernel in ev.key:
            named += t
    return total, named, wall


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median ms of ``fn()`` on the card, each call between CUDA events
    (host time spent inside the call counts)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host ms of ``fn()`` ending in a synchronise (one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def close(got, want, tol):
    atol, rtol = tol
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route the planner's kernel calls to the plain versions (on the card).
    planner_rollout imports the wrappers at every call, so it picks up the
    swapped module attributes; the launch counts are set to 0 here and must
    still be 0 on leaving, or the reference ran the kernels after all."""
    saved = {n: getattr(fk_step_cuda, n) for n in
             ("fk_step_zu", "fk_step_muq", "fk_step_pairmu")}
    saved_interp = interp_cuda.fk_interp
    for w in WRAPPERS.values():
        w.launches = 0
    try:
        for n, k in saved.items():
            setattr(fk_step_cuda, n, lambda *a, _f=k.fmt:
                    fk_step_cuda.fk_step_plain(_f, *a))
        interp_cuda.fk_interp = interp_cuda.fk_interp_plain
        yield
    finally:
        for n, k in saved.items():
            setattr(fk_step_cuda, n, k)
        interp_cuda.fk_interp = saved_interp
    launched = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    if launched:
        raise RuntimeError(f"the plain reference launched kernels: {launched}")


def random_states(rng, B, z_grid, cfg, dev):
    """(B, 18) states over the terrain: tilted, yawed, moving, with the
    body origin at the terrain height under it."""
    st = np.zeros((B, 18), np.float32)
    st[:, 0:2] = rng.uniform(-5.5, 5.5, (B, 2))
    ij = ((st[:, 0:2] + cfg.d_max) / cfg.grid_res).astype(int)
    st[:, 2] = z_grid[ij[:, 0], ij[:, 1]] + rng.uniform(-0.05, 0.1, B)
    st[:, 3:6] = rng.uniform(-1.0, 1.0, (B, 3))
    yaw = rng.uniform(-np.pi, np.pi, B)
    tilt = rng.uniform(-0.3, 0.3, (B, 2))
    for b in range(B):
        cy, sy = np.cos(yaw[b]), np.sin(yaw[b])
        cr, sr = np.cos(tilt[b, 0]), np.sin(tilt[b, 0])
        cp, sp = np.cos(tilt[b, 1]), np.sin(tilt[b, 1])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        st[b, 6:15] = (Rz @ Ry @ Rx).reshape(9)
    st[:, 15:18] = rng.uniform(-1.0, 1.0, (B, 3))
    return torch.from_numpy(st).to(dev)


def touched_words(wx, wy, sxy, d_max, res, taps, width, reciprocal):
    """Distinct window words that the lookups at (wx, wy) read: ``taps``
    lists (plane start, tap offset) pairs, ``width`` is the window's words
    per trajectory.  The cell index follows the plain versions (multiply by
    1/res in the step, divide in fk_interp)."""
    fxq = (wx + d_max) * (1.0 / res) if reciprocal else (wx + d_max) / res
    fyq = (wy + d_max) * (1.0 / res) if reciprocal else (wy + d_max) / res
    idx = (torch.clamp(fxq.to(torch.int32) - sxy[:, 0:1].to(torch.int32), 0, 14)
           * 16 + torch.clamp(fyq.to(torch.int32)
                              - sxy[:, 1:2].to(torch.int32), 0, 14)).long()
    seen = torch.zeros((wx.shape[0], width), dtype=torch.bool, device=wx.device)
    for base, off in taps:
        seen.scatter_(1, base + idx + off, True)
    return int(seen.sum())


def measure(name, kernel, launch, plain, nbytes, flops, tol, flush, P,
            results):
    """Hold ``launch()`` (the wrapper ``name`` on its inputs) against
    ``plain()``, time both, print one line and record it; returns ok.
    The kernel's time ``ms`` is taken with L2 flushed before every launch,
    so that it reads its inputs from device memory as the bound assumes;
    ``warm_ms`` (inputs left in L2 by the last launch) is printed only."""
    got = launch()
    torch.cuda.synchronize()
    want = plain()
    good, err = close(got, want, tol)
    warm_ms = kernel_ms(launch, kernel)
    ms = kernel_ms(launch, kernel, flush=flush)
    call_ms = time_ms(launch, reps=100)
    plain_ms = time_ms(plain, reps=20)
    b_ms, b_by = bound(nbytes, flops)
    _say(f"kernel {name} B={got.shape[0]} P={P}: max|k-p|={err:.3e} "
         f"(tol {tol[0]:g}+{tol[1]:g}|p|) {'ok' if good else 'MISMATCH'}; "
         f"kernel {ms} ms on the card with L2 flushed ({warm_ms} ms with its "
         f"inputs in L2), {call_ms:.4f} ms per wrapper call, plain "
         f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
         f"{flops} float ops)")
    results.setdefault(name, []).append(dict(
        P=P, max_abs_err=err, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        flops=flops))
    return good and ms is not None


def check_kernels(dev, results):
    """Phase 2: every kernel against its plain version at B=4096."""
    B = 4096
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    ok = True
    for voxel in (0.15, 0.1):
        cfg = PhysicsConfig(robot="tradr", mesh_voxel_size=voxel)
        robot = RobotModel.from_config(cfg, device=dev)
        P = robot.points.shape[0]
        z_np = rough_terrain(cfg, rng)
        z = torch.from_numpy(z_np).to(dev)
        fr = torch.from_numpy(bench_friction(cfg)).to(dev)
        state = random_states(rng, B, z_np, cfg, dev)
        c = fast._make_consts(robot)
        cst = fk_step_cuda.pack_consts(robot)
        pts = fk_step_cuda.pack_points(robot)
        tv = torch.from_numpy(rng.uniform(-1, 1, (B, robot.n_tracks)).astype(
            np.float32)).to(dev)
        wx, wy = fast._world_xy(c, state)
        dq = (state[:, 3:4] * 0.32, state[:, 4:5] * 0.32)
        d_max, res = robot.d_max, robot.grid_res
        for fmt in (("zu", "pairmu") if voxel == 0.15 else ("zu", "muq")):
            if fmt == "zu":
                sxy, patch = fast._extract_windows_zpair(z, wx, wy, d_max,
                                                         res, *dq)
            elif fmt == "muq":
                sxy, patch = fast._extract_windows_zmuq(
                    z, fast.quantize_mu_grid(fr), wx, wy, d_max, res, *dq)
            else:
                sxy, patch = fast._extract_windows_packed1(z, fr, wx, wy,
                                                           d_max, res, *dq)
            args = (cst, patch, state, tv, sxy, pts)
            # each input read once (of the window only the words under the
            # footprint's taps), the (B, 8) output written once
            taps = {"zu": [(0, 0), (0, 16)],
                    "muq": [(0, 0), (0, 16), (256, 0)],
                    "pairmu": [(0, o) for o in interp_cuda.TAP_OFFSETS]}[fmt]
            words = touched_words(wx, wy, sxy, d_max, res, taps,
                                  patch.shape[1], reciprocal=True)
            nbytes = 4 * (words + sum(a.numel() for a in args if a is not patch)
                          + B * 8)
            ok &= measure(
                f"fk_step_{fmt}", "fk_step_kernel",
                lambda a=args, k=WRAPPERS[f"fk_step_{fmt}"]: k(*a),
                lambda a=args, f=fmt: fk_step_cuda.fk_step_plain(f, *a),
                nbytes, B * P * STEP_FLOPS_PER_POINT[fmt], TOL["step"], flush,
                P, results)
        if voxel == 0.1:
            sxy0, patch0 = fast._extract_windows(z, fr, wx, wy, d_max, res)
            args = (patch0, wx.contiguous(), wy.contiguous(), sxy0, c.cst)
            words = touched_words(
                wx, wy, sxy0, d_max, res,
                [(b, o) for b in (0, 256) for o in interp_cuda.TAP_OFFSETS],
                512, reciprocal=False)
            nbytes = 4 * (words + sum(a.numel() for a in args[1:]) + 5 * B * P)
            ok &= measure(
                "fk_interp", "fk_interp_kernel",
                lambda: interp_cuda.fk_interp(*args),
                lambda: interp_cuda.fk_interp_plain(*args),
                nbytes, B * P * INTERP_FLOPS_PER_POINT, TOL["fk_interp"],
                flush, P, results)
    return ok


def positions(out):
    """(B, N, 3) positions of a PlanResult or a planner_rollout result."""
    return out.xs if isinstance(out, PlanResult) else out[0].x


def run_main_path(dev, launches):
    """Phase 3: the planner's serving path through its entry points."""
    ok = True
    gen = torch.Generator(device=dev)
    workloads = []
    # the online node: Planner.plan, 64 trajectories x 500 steps, friction
    for name, cfg, step in (
            ("plan_0.15m_pair", PhysicsConfig.for_planner("tradr"),
             "fk_step_pairmu"),
            ("plan_0.1m_pair3_muq",
             PhysicsConfig(robot="tradr", mesh_voxel_size=0.1), "fk_step_muq")):
        planner = Planner(cfg, device=dev)
        gen.manual_seed(1)
        controls, _ = planner.sample_controls(gen)
        # the smooth hill: on i.i.d. rough terrain 500-step positions move
        # by ~1 cm RMSE under a 1e-7 change of the controls alone, which
        # would drown the kernel-against-plain comparison
        z = torch.from_numpy(gaussian_hill(cfg)).to(dev)
        fr = torch.from_numpy(bench_friction(cfg)).to(dev)
        workloads.append((name, step, 5,
                          lambda p=planner, z=z, c=controls, f=fr:
                          p.plan(z, c, friction=f)))
    # bench.py's three workloads: 4096 x 100 on the gaussian hill
    for name, voxel, with_fr, step in (
            ("rollout_4096x100_0.1m_zu", 0.1, False, "fk_step_zu"),
            ("rollout_4096x100_0.1m_muq", 0.1, True, "fk_step_muq"),
            ("rollout_4096x100_0.15m_zu", 0.15, False, "fk_step_zu")):
        cfg = (PhysicsConfig.for_planner("tradr") if voxel == 0.15
               else PhysicsConfig(robot="tradr", mesh_voxel_size=voxel))
        robot = RobotModel.from_config(cfg, device=dev)
        z = torch.from_numpy(gaussian_hill(cfg)).to(dev)
        fr = torch.from_numpy(bench_friction(cfg)).to(dev) if with_fr else None
        gen.manual_seed(0)
        controls = torch.rand((4096, 100, 2), generator=gen, device=dev) * 2 - 1
        workloads.append((name, step, 10,
                          lambda r=robot, z=z, c=controls, f=fr:
                          fast.planner_rollout(r, z, c, friction=f)))

    for name, step, reps, run in workloads:
        for w in WRAPPERS.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in WRAPPERS.items()}
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v
        xs = positions(out)
        want = {n: 0 for n in WRAPPERS}
        want[step] = xs.shape[1]
        want["fk_interp"] = 1
        good = counts == want
        finite = bool(torch.isfinite(xs).all())
        with plain_kernels():
            ref = run()
            torch.cuda.synchronize()
            plain_ms = wall_ms(run, reps=2)
        rmse = float(((xs - positions(ref)) ** 2).mean().sqrt())
        ms = wall_ms(run, reps=reps)
        busy, in_step, prof_wall = device_busy(run, "fk_step_kernel")
        extra = ""
        if isinstance(out, PlanResult):
            rel = (out.costs - ref.costs).abs() / ref.costs.abs().clamp(min=1e-6)
            extra = (f", best {int(out.best)} (plain {int(ref.best)}), "
                     f"cost rel diff {float(rel.max()):.2e}")
        line_ok = good and finite and rmse < POS_RMSE_TOL_M
        _say(f"main {name}: {tuple(xs.shape)} launches {counts} "
             f"{'ok' if good else 'WRONG'}; finite {finite}; position RMSE vs "
             f"plain {rmse:.3e} m (tol {POS_RMSE_TOL_M:g}){extra}; "
             f"{ms:.3f} ms per batch (plain {plain_ms:.3f} ms); one profiled "
             f"call: card busy {busy:.3f} ms, {100 * busy / ms:.1f}% of the "
             f"unprofiled {ms:.3f} ms ({100 * busy / prof_wall:.1f}% of the "
             f"profiled call's {prof_wall:.3f} ms), step kernel "
             f"{in_step:.3f} ms")
        ok &= line_ok
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power_limit()

    t0 = time.perf_counter()
    built = _build.build_all()
    _say(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} s "
         f"per source, {time.perf_counter() - t0:.2f} s in all, flags "
         f"{' '.join(_build.NVCC_FLAGS)}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                _say(f"  ptxas {name}: {line.strip()}")
    _say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    results = {}
    ok = check_kernels(dev, results)
    launches = {}
    ok &= run_main_path(dev, launches)

    kernels = []
    for name, meta in KERNELS.items():
        rows = results.get(name, [])
        main_row = max(rows, key=lambda r: r["P"]) if rows else {}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=max((r["max_abs_err"] for r in rows), default=None),
            ms=main_row.get("ms"), plain_ms=main_row.get("plain_ms"),
            bound_ms=main_row.get("bound_ms"), bound_by=main_row.get("bound_by"),
            library_ms=None, shapes=rows))
        ok &= bool(rows) and launches.get(name, 0) > 0
    _say(json.dumps({"kernels": kernels}))
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    _say(card)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
