#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of the repository:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build  -- compile every CUDA kernel of ``monoforce_tpu_torch/ops/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once); print the card's
   name and power limit.
2. kernels -- call each kernel's wrapper at the main path's shapes (B=4096,
   and B=4094 for two; P=62, 148 and 202; the planner tick's B=64 for its
   two step formats, muq and pairmu; the terrain fit's B=16, P=97 for the
   two lookup kernels) on windows cut by the port's extractors from a
   seeded rough terrain, and hold it against its plain PyTorch version on
   the same inputs; print the largest difference, the tolerance, the
   kernel's mean device time from the profiler's trace with L2 flushed and
   with its inputs in L2, the median time of a wrapper call and of the
   plain version between CUDA events, and the bound; beside the lookup
   rows, the window words the taps touch and the 32-byte sectors that hold
   them; beside the B=64 and B=16 rows, one launch's floor (a one-element
   ``add_`` in the same kind of trace).  Then the JAX tests' accuracy
   oracles (tests/test_fast.py:304-443) on the kernels, at those tests'
   inputs: packed and pair3 against exact, muq against pair3.  That check
   is the path of the two kernels that serve only as oracles (fk_step,
   fk_step_pair3): their launches are counted there.
3. main path -- ``Planner.plan`` at the online node's shape (64 x 500 steps,
   friction grid) for the 0.15 m planner preset (mode pair) and the 0.1 m
   cloud (pair3_muq); ``planner_rollout`` on bench.py's three workloads at
   4096 x 100 on the 128 x 128 gaussian hill (pair3_zu, pair3_muq, pair_zu),
   on husky's 0.1 m cloud with friction (packed) and with rk4 (fallback:
   fast_rollout).  Each run starts with every launch count at 0 and must
   launch its step kernel once per step and fk_interp once (fallback:
   fk_interp once per step and once more); its outputs must be finite and
   its positions must agree with the same rollout through the plain
   versions on the card.  The packed and pair3_muq runs are also held
   against fast_rollout (tests/test_fast.py:253-266's gate: positions and
   the ranking of both costs).  Prints ms per batch (median, synchronised)
   and, from one profiled call, the card's busy time and the named
   kernel's device time per launch.
4. training -- ``fit_terrain`` at bench_all.py's shape (tradr, 16 x 100
   steps, 100 Adam iterations) on ground truth from fast_rollout over
   bench_all's hill.  The loss must drop 10x; each iteration must launch
   fk_interp and its backward kernel 101 times each; the first three
   losses must agree with the same fit through the plain versions.  Prints
   seconds per iteration and the card's busy share.
5. online tick -- ``MonoForce.run`` at full width: the default
   ``LSSConfig`` (four cameras at 256 x 416, EfficientNet-B0, 59 depth bins,
   camC 64, the 128 x 128 BEV grid at 0.1 m) in front of
   ``PhysicsConfig.for_planner("tradr")`` (P=62, 64 x 500, the friction
   head as the friction grid: mode pair), on a rig of four level cameras
   at yaw 0, 90, 180 and 270 degrees, 0.5 m up, focal 400 px, with seeded
   weights (``init_params``, perturbed by 0.05 noise) and seeded images;
   the float32 mode and ``half=True``.  Each tick must launch
   fk_step_pairmu 500 times and fk_interp once; the card's float32 heads
   must agree with the same weights' forward on the CPU, the half heads
   with the float32 ones at the JAX package's gate, the heads keep their
   ranges, and the plan's costs are finite.  Prints the share of frustum
   points the splat keeps, ms per tick (encoder and plan apart) and the
   card's busy share from one profiled tick.
6. one JSON line listing every kernel with its launches on the main path,
   its largest difference from the plain version, its time, the plain
   version's time and its bound on this card.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.models.terrain_encoder.geometry import get_geometry
from monoforce_tpu_torch.ops import _build, fk_step_cuda, interp_cuda
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import RobotModel
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.planner.shooting import (Planner, PlanResult,
                                                  _plan, force_variance_cost,
                                                  inclination_cost)
from monoforce_tpu_torch.training import fit_terrain

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# float operations per contact point of one step, counted from
# fk_step_plain (each exp, rsqrt, sqrt and divide counted as one): the
# rotation, world point and velocity (30), index and weights (12), taps to
# normals (18), contact and spring force (32), friction force (29 with two
# driving parts), torques and the eight sums (18), n_cp (1); friction adds
# 15 (muq: decode, bilinear, scale, 3 products), 3 (pairmu) or 10 (pair3,
# packed, exact: bilinear, 3 products); the two-pass std adds 3 (packed,
# exact)
STEP_FLOPS_PER_POINT = {"zu": 147, "muq": 162, "pairmu": 150, "pair3": 157,
                        "packed": 160, "exact": 160}
# fk_interp per point: index (8), weights (6), z and mu (14), normals (12)
INTERP_FLOPS_PER_POINT = 40
# its backward per point: index (8), weights (6), normals' cotangent (24),
# the eight tap cotangents and their sums (20), d wx and d wy (28)
INTERP_BWD_FLOPS_PER_POINT = 86

KERNELS = {
    "fk_interp": dict(source="monoforce_tpu_torch/ops/csrc/fk_interp.cu",
                      replaces="monoforce_tpu/ops/interp_pallas.py:140"),
    # one kernel (format zu) serves two TPU kernels: its entries part by
    # the cloud (P <= 64: pair_zu; 64 < P <= 192: pair3_zu)
    "fk_step_zu[pair_zu]": dict(
        source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
        replaces="monoforce_tpu/ops/fk_step_pallas.py:779"),
    "fk_step_zu[pair3_zu]": dict(
        source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
        replaces="monoforce_tpu/ops/fk_step_pallas.py:944"),
    "fk_step_muq": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                        replaces="monoforce_tpu/ops/fk_step_pallas.py:968"),
    "fk_step_pairmu": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                           replaces="monoforce_tpu/ops/fk_step_pallas.py:763"),
    "fk_step_packed": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                           replaces="monoforce_tpu/ops/fk_step_pallas.py:417"),
    "fk_step": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                    replaces="monoforce_tpu/ops/fk_step_pallas.py:323"),
    "fk_step_pair3": dict(source="monoforce_tpu_torch/ops/csrc/fk_step.cu",
                          replaces="monoforce_tpu/ops/fk_step_pallas.py:926"),
    "fk_interp_bwd": dict(
        source="monoforce_tpu_torch/ops/csrc/fk_interp_bwd.cu",
        replaces="monoforce_tpu/ops/interp_pallas.py:160 (custom VJP of "
                 "fk_interp, :139)"),
}
WRAPPERS = {"fk_interp": interp_cuda.fk_interp,
            "fk_step_zu": fk_step_cuda.fk_step_zu,
            "fk_step_muq": fk_step_cuda.fk_step_muq,
            "fk_step_pairmu": fk_step_cuda.fk_step_pairmu,
            "fk_step_packed": fk_step_cuda.fk_step_packed,
            "fk_step": fk_step_cuda.fk_step,
            "fk_step_pair3": fk_step_cuda.fk_step_pair3,
            "fk_interp_bwd": interp_cuda.fk_interp_bwd}


def entry(wrapper: str, P: int) -> str:
    """The kernels line's entry of a wrapper's launch on a P-point cloud."""
    if wrapper == "fk_step_zu":
        return f"fk_step_zu[{'pair_zu' if P <= 64 else 'pair3_zu'}]"
    return wrapper


# the step wrappers that the rollouts import from fk_step_cuda at each call
ROLLOUT_STEPS = ("fk_step_zu", "fk_step_muq", "fk_step_pairmu",
                 "fk_step_packed")

# kernel against plain version on the same inputs: |k - p| <= ATOL + RTOL |p|
# fk_interp: FMA contraction in the bilinear sums, rsqrtf and the normals'
# multiply by 1/res, O(1) outputs; its backward: the same, and each cell's
# cotangents added in another order than autograd's (entries up to ~1e2);
# steps: FMA contraction
# and the per-trajectory sums over up to 256 points in another order
# (forces of ~1e2 N, accelerations of ~1e1 m/s^2)
TOL = {"fk_interp": (1e-5, 1e-5), "fk_interp_bwd": (1e-4, 1e-5),
       "step": (1e-3, 1e-4)}
# the JAX tests' oracle tolerances (atol, rtol) on the accelerations and
# rtol on the contact counts (tests/test_fast.py:341-345, :440-443)
ORACLE_TOL = {"packed": ((0.3, 0.02), 0.02), "pair3": ((0.3, 0.02), 0.02),
              "muq": ((0.05, 0.01), 1e-6)}
# tests/test_fast.py:253-266's gate of a serving mode against fast_rollout
SPEARMAN_MIN = 0.99
# the fit: bench_all.py's convergence gate, and the plain versions' losses
FIT_DROP = 10.0
FIT_LOSS_RTOL = 1e-3
# positions of a whole rollout, kernels against plain versions: rounding
# differences grow over the steps; 1 mm RMSE is 1% of a 0.1 m grid cell
POS_RMSE_TOL_M = 1e-3
# the online tick: the card's float32 heads against the CPU's, largest
# difference (cuDNN's algorithms and the splat's atomics add in other
# orders than the CPU, over ~60 layers; heads O(0.1-1); 2-3e-5 measured on
# an H100); the half mode against float32, RMSE per head: the JAX
# package's gate (tests/test_encoder.py:178-181)
TICK_CPU_ATOL = 2e-4
TICK_HALF_GATE = {"terrain": 0.02, "geom": 0.02, "friction": 0.05}
TICK_SEED = 1        # init_params; with the noise seed below every head
TICK_NOISE_SEED = 3  # carries signal (a ReLU head can be zero everywhere)


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
    the kernels named ``kernel``, their number, host ms of the call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = named = 0.0
    count = 0
    for ev in prof.key_averages():
        t = ev.device_time_total / 1e3
        total += t
        if kernel in ev.key:
            named += t
            count += ev.count
    return total, named, count, wall


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


def flat(out):
    """A kernel's output, or its outputs in one flat tensor."""
    if isinstance(out, (tuple, list)):
        return torch.cat([t.flatten() for t in out])
    return out


def close(got, want, tol):
    atol, rtol = tol
    got, want = flat(got), flat(want)
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
    """Route the rollouts' kernel calls to the plain versions (on the card).
    planner_rollout and fast_rollout import the wrappers at every call, so
    they pick up the swapped module attributes, and autograd differentiates
    the plain fk_interp directly; the launch counts are set to 0 here and
    must still be 0 on leaving, or the reference ran the kernels after
    all."""
    saved = {n: getattr(fk_step_cuda, n) for n in ROLLOUT_STEPS}
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
    """Distinct window words that the lookups at (wx, wy) read, and the
    32-byte sectors (8 words, the card's unit of a gather) they lie in:
    ``taps`` lists (plane start, tap offset) pairs, ``width`` is the
    window's words per trajectory.  The cell index follows the plain
    versions (multiply by 1/res in the step, divide in fk_interp)."""
    fxq = (wx + d_max) * (1.0 / res) if reciprocal else (wx + d_max) / res
    fyq = (wy + d_max) * (1.0 / res) if reciprocal else (wy + d_max) / res
    idx = (torch.clamp(fxq.to(torch.int32) - sxy[:, 0:1].to(torch.int32), 0, 14)
           * 16 + torch.clamp(fyq.to(torch.int32)
                              - sxy[:, 1:2].to(torch.int32), 0, 14)).long()
    seen = torch.zeros((wx.shape[0], width), dtype=torch.bool, device=wx.device)
    for base, off in taps:
        seen.scatter_(1, base + idx + off, True)
    sectors = seen.view(wx.shape[0], width // 8, 8).any(dim=2)
    return int(seen.sum()), int(sectors.sum())


def launch_floor(flush):
    """Device ms of a one-element ``add_`` in the same kind of trace as
    :func:`kernel_ms`: (inputs in L2, L2 flushed before every launch)."""
    one = torch.zeros(1, device=flush.device)
    return (kernel_ms(lambda: one.add_(1.0), "add"),
            kernel_ms(lambda: one.add_(1.0), "add", flush=flush))


def measure(name, kernel, launch, plain, nbytes, flops, tol, flush, P,
            results, note="", **extra):
    """Hold ``launch()`` (the wrapper ``name`` on its inputs) against
    ``plain()``, time both, print one line (ending in ``note``) and record
    it with ``extra``; returns ok.  The kernel's time ``ms`` is taken with
    L2 flushed before every launch, so that it reads its inputs from device
    memory as the bound assumes; ``warm_ms`` is with its inputs left in L2
    by the last launch."""
    got = launch()
    torch.cuda.synchronize()
    want = plain()
    good, err = close(got, want, tol)
    B = (got[0] if isinstance(got, tuple) else got).shape[0]
    warm_ms = kernel_ms(launch, kernel)
    ms = kernel_ms(launch, kernel, flush=flush)
    call_ms = time_ms(launch, reps=100)
    plain_ms = time_ms(plain, reps=20)
    b_ms, b_by = bound(nbytes, flops)
    _say(f"kernel {name} B={B} P={P}: max|k-p|={err:.3e} "
         f"(tol {tol[0]:g}+{tol[1]:g}|p|) {'ok' if good else 'MISMATCH'}; "
         f"kernel {ms} ms on the card with L2 flushed ({warm_ms} ms with its "
         f"inputs in L2), {call_ms:.4f} ms per wrapper call, plain "
         f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
         f"{flops} float ops){note}")
    results.setdefault(name, []).append(dict(
        B=B, P=P, max_abs_err=err, ms=ms, warm_ms=warm_ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        flops=flops, **extra))
    return good and ms is not None


def step_windows(fmt, robot, z, fr, wx, wy, dq):
    """The window extractor of each step format, on the inputs at hand."""
    d_max, res = robot.d_max, robot.grid_res
    if fmt == "zu":
        return fast._extract_windows_zpair(z, wx, wy, d_max, res, *dq)
    if fmt == "muq":
        return fast._extract_windows_zmuq(z, fast.quantize_mu_grid(fr), wx,
                                          wy, d_max, res, *dq)
    if fmt == "exact":
        return fast._extract_windows(z, fr, wx, wy, d_max, res)
    return fast._extract_windows_packed1(z, fr, wx, wy, d_max, res, *dq)


# the words of a window that one lookup reads: (plane start, tap offset)
_ZMU_TAPS = [(0, o) for o in interp_cuda.TAP_OFFSETS]
STEP_TAPS = {"zu": [(0, 0), (0, 16)], "muq": [(0, 0), (0, 16), (256, 0)],
             "pairmu": _ZMU_TAPS, "pair3": _ZMU_TAPS, "packed": _ZMU_TAPS,
             "exact": [(b, o) for b in (0, 256)
                       for o in interp_cuda.TAP_OFFSETS]}


def check_kernels(dev, results, only=None):
    """Phase 2: every kernel against its plain version at B=4096 (and two
    at B=4094), on rough terrain, tilted moving bodies.  ``only``, a set
    of kernel names, restricts the checks to those (the inputs stay the
    same), to compare two trees' kernels quickly."""
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    ok = True
    # one launch's floor, printed beside the step kernel at the tick's batch
    # and the lookup kernels at the fit's
    floor = launch_floor(flush)
    floor_note = (f"; launch floor at this batch: one-element add_ {floor[1]} "
                 f"ms with L2 flushed ({floor[0]} ms with its input in L2)")
    # (robot, voxel, batch, step formats, lookup kernels); B=64 is the
    # planner tick's batch in its two step formats; the last case is the
    # terrain fit's shape (tradr's default 0.11 m cloud, B=16)
    both = ("fk_interp", "fk_interp_bwd")
    cases = (("tradr", 0.15, 4096, ("zu", "pairmu"), ()),
             ("tradr", 0.1, 4096, ("zu", "muq", "pair3", "packed", "exact"),
              both),
             ("husky", 0.1, 4096, ("packed",), ()),
             ("husky", 0.1, 4094, ("packed",), ("fk_interp_bwd",)),
             ("tradr", 0.1, 64, ("muq",), ()),
             ("tradr", 0.15, 64, ("pairmu",), ()),
             ("tradr", 0.11, 16, (), both))
    for robot_name, voxel, B, fmts, interp in cases:
        cfg = PhysicsConfig(robot=robot_name, mesh_voxel_size=voxel)
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
        for fmt in fmts:
            sxy, patch = step_windows(fmt, robot, z, fr, wx, wy, dq)
            name = "fk_step" if fmt == "exact" else f"fk_step_{fmt}"
            if only is not None and name not in only:
                continue
            args = (cst, patch, state, tv, sxy, pts)
            # each input read once (of the window only the words under the
            # footprint's taps), the (B, 8) output written once
            words, _ = touched_words(wx, wy, sxy, d_max, res,
                                     STEP_TAPS[fmt], patch.shape[1],
                                     reciprocal=fmt in ("zu", "muq", "pairmu",
                                                        "pair3"))
            nbytes = 4 * (words + sum(a.numel() for a in args if a is not patch)
                          + B * 8)
            ok &= measure(
                entry(name, P), "fk_step_kernel",
                lambda a=args, k=WRAPPERS[name]: k(*a),
                lambda a=args, f=fmt: fk_step_cuda.fk_step_plain(f, *a),
                nbytes, B * P * STEP_FLOPS_PER_POINT[fmt], TOL["step"], flush,
                P, results, note=floor_note if B == 64 else "")
        if not interp:
            continue
        sxy0, patch0 = fast._extract_windows(z, fr, wx, wy, d_max, res)
        args = (patch0, wx.contiguous(), wy.contiguous(), sxy0, c.cst)
        words, sectors = touched_words(
            wx, wy, sxy0, d_max, res, STEP_TAPS["exact"], 512,
            reciprocal=False)
        queries = sum(a.numel() for a in args[1:])
        # the gather's granularity: the bound counts the tapped words, the
        # card moves the 32-byte sectors that hold them; the fit's batch
        # (B=16) is one launch's latency, beside the floor
        note = (f"; window: {words} tapped words in {sectors} 32-byte "
                f"sectors ({32 * sectors} bytes, the bound counts "
                f"{4 * words})" + (floor_note if B == 16 else ""))
        if only is not None:
            interp = [k for k in interp if k in only]
        if "fk_interp" in interp:
            ok &= measure(
                "fk_interp", "fk_interp_kernel",
                lambda: interp_cuda.fk_interp(*args),
                lambda: interp_cuda.fk_interp_plain(*args),
                4 * (words + queries + 5 * B * P),
                B * P * INTERP_FLOPS_PER_POINT, TOL["fk_interp"], flush, P,
                results, note=note, words=words, sectors=sectors)
        g = torch.from_numpy(rng.normal(size=(B, 5 * P)).astype(
            np.float32)).to(dev)
        if "fk_interp_bwd" not in interp:
            continue
        # reads: the tapped words, the queries, the cotangent; writes: the
        # whole d patch row and d wx, d wy
        ok &= measure(
            "fk_interp_bwd", "fk_interp_bwd_kernel",
            lambda: interp_cuda.fk_interp_bwd(*args, g),
            lambda: interp_cuda.fk_interp_bwd_plain(*args, g),
            4 * (words + queries + g.numel() + 512 * B + 2 * B * P),
            B * P * INTERP_BWD_FLOPS_PER_POINT, TOL["fk_interp_bwd"], flush,
            P, results, note=note, words=words, sectors=sectors)
    return ok


def check_oracles(dev, launches):
    """The JAX tests' accuracy oracles on the kernels, at those tests'
    inputs (tests/test_fast.py:304-443: B=8, rough terrain, bodies at rest
    at x, y, z in [-1, 1], the 0.1 m and 0.11 m clouds): packed and pair3
    (bf16 taps) against exact, muq (u8 friction) against pair3.  Counts
    the launches of this path.  (At B=4096 some trajectories exceed these
    tolerances in the plain versions too: they bound the bf16 and u8
    trades at the tests' inputs, not every input.)"""
    for w in WRAPPERS.values():
        w.launches = 0
    ok = True
    for voxel in (0.1, 0.11):
        robot = RobotModel.from_config(
            PhysicsConfig(robot="tradr", mesh_voxel_size=voxel), device=dev)
        rng = np.random.default_rng(5)
        z = torch.from_numpy(rng.normal(scale=0.1, size=(128, 128)).astype(
            np.float32)).to(dev)
        fr = torch.from_numpy(rng.uniform(0.3, 1.0, (128, 128)).astype(
            np.float32)).to(dev)
        st = torch.zeros((8, 18), device=dev)
        st[:, 0:3] = torch.from_numpy(rng.uniform(-1, 1, (8, 3)).astype(
            np.float32))
        st[:, [6, 10, 14]] = 1.0
        tv = torch.tensor([[0.5, 0.4]], device=dev).expand(8, 2).contiguous()
        c = fast._make_consts(robot)
        wx, wy = fast._world_xy(c, st)
        acc = {}
        for fmt in ("exact", "packed", "pair3", "muq"):
            sxy, patch = step_windows(fmt, robot, z, fr, wx, wy, (None, None))
            name = "fk_step" if fmt == "exact" else f"fk_step_{fmt}"
            acc[fmt] = WRAPPERS[name](fk_step_cuda.pack_consts(robot), patch,
                                      st, tv, sxy,
                                      fk_step_cuda.pack_points(robot))
        for served, oracle in (("packed", "exact"), ("pair3", "exact"),
                               ("muq", "pair3")):
            tol_a, rtol_n = ORACLE_TOL[served]
            good_a, err_a = close(acc[served][:, :6], acc[oracle][:, :6],
                                  tol_a)
            good_n, err_n = close(acc[served][:, 7], acc[oracle][:, 7],
                                  (0.0, rtol_n))
            _say(f"oracle {served} vs {oracle} (P={c.px.shape[0]}, B=8): "
                 f"accelerations max diff {err_a:.3e} (tol {tol_a[0]:g}+"
                 f"{tol_a[1]:g}|o|), contacts max diff {err_n:.3e} (rtol "
                 f"{rtol_n:g}) {'ok' if good_a and good_n else 'MISMATCH'}")
            ok &= good_a and good_n
    torch.cuda.synchronize()
    for n in ("fk_step", "fk_step_pair3"):
        launches[n] = WRAPPERS[n].launches
    return ok


def positions(out):
    """(B, N, 3) positions of a PlanResult or a planner_rollout result."""
    return out.xs if isinstance(out, PlanResult) else out[0].x


def spearman(a, b) -> float:
    """Rank correlation of two (B,) tensors (no ties expected)."""
    ra, rb = (t.argsort().argsort().double() for t in (a, b))
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / (ra.norm() * rb.norm()))


def costs(stats):
    """The planner's two path costs of a rollout's StepStats."""
    return (force_variance_cost(stats.spring_std),
            inclination_cost(stats.abs_roll, stats.abs_pitch))


def against_fast_rollout(robot, z, controls, fr, out):
    """tests/test_fast.py:253-266's gate: a serving rollout against
    fast_rollout on the same inputs, positions within 1 mm RMSE and both
    costs ranked alike (Spearman > 0.99).  Returns (ok, text)."""
    ref, ref_stats = fast.fast_rollout(robot, z, controls, friction=fr)
    rmse = float(((out[0].x - ref.x) ** 2).mean().sqrt())
    rho = [spearman(a, b) for a, b in zip(costs(out[1]), costs(ref_stats))]
    ok = rmse < POS_RMSE_TOL_M and min(rho) > SPEARMAN_MIN
    return ok, (f"; against fast_rollout: position RMSE {rmse:.3e} m, "
                f"Spearman force variance {rho[0]:.5f}, inclination "
                f"{rho[1]:.5f} (min {SPEARMAN_MIN}) {'ok' if ok else 'FAILED'}")


def run_main_path(dev, launches):
    """Phase 3: the planner's serving path through its entry points."""
    ok = True
    gen = torch.Generator(device=dev)
    # (name, {wrapper: launches}, timed repetitions, the run, the kernel
    # whose device time is printed, the gate against fast_rollout or None,
    # the cloud's points)
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
        workloads.append((name, {step: 500, "fk_interp": 1}, 5,
                          lambda p=planner, z=z, c=controls, f=fr:
                          p.plan(z, c, friction=f), "fk_step_kernel", None,
                          planner.robot.points.shape[0]))
    # bench.py's three workloads, then the packed mode (husky's 0.1 m cloud,
    # P=202) and the fallback mode (rk4): 4096 x 100 on the gaussian hill
    for name, robot_name, kw, with_fr, step in (
            ("rollout_4096x100_0.1m_zu", "tradr", {"mesh_voxel_size": 0.1},
             False, "fk_step_zu"),
            ("rollout_4096x100_0.1m_muq", "tradr", {"mesh_voxel_size": 0.1},
             True, "fk_step_muq"),
            ("rollout_4096x100_0.15m_zu", "tradr", None, False, "fk_step_zu"),
            ("rollout_4096x100_husky_0.1m_packed", "husky",
             {"mesh_voxel_size": 0.1}, True, "fk_step_packed"),
            ("rollout_4096x100_0.1m_rk4_fallback", "tradr",
             {"mesh_voxel_size": 0.1, "integration_mode": "rk4"}, False,
             None)):
        cfg = (PhysicsConfig.for_planner(robot_name) if kw is None
               else PhysicsConfig(robot=robot_name, **kw))
        robot = RobotModel.from_config(cfg, device=dev)
        z = torch.from_numpy(gaussian_hill(cfg)).to(dev)
        fr = torch.from_numpy(bench_friction(cfg)).to(dev) if with_fr else None
        gen.manual_seed(0)
        controls = torch.rand((4096, 100, 2), generator=gen, device=dev) * 2 - 1
        want = {step: 100, "fk_interp": 1} if step else {"fk_interp": 101}
        gate = None
        if step in ("fk_step_muq", "fk_step_packed"):
            gate = functools.partial(against_fast_rollout, robot, z, controls,
                                     fr)
        workloads.append((name, want, 10,
                          lambda r=robot, z=z, c=controls, f=fr:
                          fast.planner_rollout(r, z, c, friction=f),
                          "fk_step_kernel" if step else "fk_interp_kernel",
                          gate, robot.points.shape[0]))

    for name, want_counts, reps, run, kernel, gate, P in workloads:
        for w in WRAPPERS.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in WRAPPERS.items()}
        for n, v in counts.items():
            launches[entry(n, P)] = launches.get(entry(n, P), 0) + v
        xs = positions(out)
        want = {n: want_counts.get(n, 0) for n in WRAPPERS}
        good = counts == want
        finite = bool(torch.isfinite(xs).all())
        with plain_kernels():
            ref = run()
            torch.cuda.synchronize()
            plain_ms = wall_ms(run, reps=2)
        rmse = float(((xs - positions(ref)) ** 2).mean().sqrt())
        ms = wall_ms(run, reps=reps)
        busy, in_kernel, n_kernel, prof_wall = device_busy(run, kernel)
        extra = ""
        if isinstance(out, PlanResult):
            rel = (out.costs - ref.costs).abs() / ref.costs.abs().clamp(min=1e-6)
            extra = (f", best {int(out.best)} (plain {int(ref.best)}), "
                     f"cost rel diff {float(rel.max()):.2e}")
        gate_ok = True
        if gate is not None:
            gate_ok, text = gate(out)
            extra += text
        line_ok = good and finite and rmse < POS_RMSE_TOL_M and gate_ok
        _say(f"main {name}: {tuple(xs.shape)} launches "
             f"{ {n: v for n, v in counts.items() if v} } "
             f"{'ok' if good else 'WRONG, want ' + str(want_counts)}; finite "
             f"{finite}; position RMSE vs plain {rmse:.3e} m (tol "
             f"{POS_RMSE_TOL_M:g}){extra}; {ms:.3f} ms per batch (plain "
             f"{plain_ms:.3f} ms); one profiled call: card busy {busy:.3f} ms, "
             f"{100 * busy / ms:.1f}% of the unprofiled {ms:.3f} ms "
             f"({100 * busy / prof_wall:.1f}% of the profiled call's "
             f"{prof_wall:.3f} ms), {kernel} {in_kernel:.3f} ms in "
             f"{n_kernel} launches, "
             f"{1e3 * in_kernel / max(n_kernel, 1):.2f} us per launch")
        ok &= line_ok
    return ok


def run_fit(dev, launches):
    """Phase 4: fit_terrain at bench_all.py's shape (bench_all.py:101-132):
    tradr (P=97), the 128 x 128 grid, 16 trajectories x 100 steps, 100
    iterations, ground truth from fast_rollout on bench_all's hill."""
    cfg = PhysicsConfig(robot="tradr")
    robot = RobotModel.from_config(cfg, device=dev)
    gx, gy = cfg.grid_coords()
    z_gt = torch.from_numpy((0.3 * np.exp(-((gx - 1.5) ** 2 + gy ** 2) / 2.0))
                            .astype(np.float32)).to(dev)
    B, N, iters = 16, 100, 100
    rng = np.random.default_rng(0)
    controls = torch.from_numpy(rng.uniform(-1, 1, (B, N, 2)).astype(
        np.float32)).to(dev)
    gt, _ = fast.fast_rollout(robot, z_gt, controls, with_stats=False)
    ts = (torch.arange(N, dtype=torch.float32, device=dev) * cfg.dt).expand(
        B, N).contiguous()

    def fit(n):
        return fit_terrain(cfg, controls, [gt.x], ts, ts, n_iters=n,
                           device=dev)[1]

    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    losses = fit(iters)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    for n, v in counts.items():
        launches[n] = launches.get(n, 0) + v
    want = {n: 0 for n in WRAPPERS}
    want["fk_interp"] = want["fk_interp_bwd"] = iters * (N + 1)
    good = counts == want
    drop = losses[0] / max(losses[-1], 1e-30)
    with plain_kernels():
        plain = fit(3)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], plain))
    busy, in_interp, _, prof_wall = device_busy(lambda: fit(1), "fk_interp")
    one_s = wall_ms(lambda: fit(1), reps=3) / 1e3
    ok = (good and drop >= FIT_DROP and rel <= FIT_LOSS_RTOL
          and all(np.isfinite(losses)))
    _say(f"fit fit_terrain tradr P={robot.points.shape[0]} B={B} N={N} x "
         f"{iters} iterations: launches {counts if not good else 'ok'} "
         f"(want fk_interp and fk_interp_bwd {iters * (N + 1)} each); loss "
         f"{losses[0]:.6g} -> {losses[-1]:.6g} ({drop:.1f}x, gate "
         f"{FIT_DROP:g}x); first 3 losses against the plain versions: rel "
         f"diff {rel:.2e} (tol {FIT_LOSS_RTOL:g}); {secs:.3f} s in all, "
         f"{secs / iters:.4f} s per iteration (a one-iteration fit "
         f"{one_s:.4f} s); one profiled one-iteration fit: card busy "
         f"{busy:.3f} ms, {100 * busy / (one_s * 1e3):.1f}% of the "
         f"unprofiled {one_s * 1e3:.3f} ms ({100 * busy / prof_wall:.1f}% of "
         f"the profiled {prof_wall:.3f} ms), fk_interp kernels "
         f"{in_interp:.3f} ms {'ok' if ok else 'FAILED'}")
    return ok


def camera_rig(n_cams, hw, focal, height, dev):
    """Calibrations (B=1) of ``n_cams`` level cameras at even yaws from 0,
    ``height`` up, principal point at the image centre, no augmentation:
    camera z (the optical axis) along the ego's horizontal, x right, y
    down."""
    H, W = hw
    to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    rots = []
    for k in range(n_cams):
        a = 2 * np.pi * k / n_cams
        yaw = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]])
        rots.append(yaw @ to_ego)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    calib = (np.stack(rots), np.tile([0.0, 0.0, height], (n_cams, 1)),
             np.tile(K, (n_cams, 1, 1)), np.tile(np.eye(3), (n_cams, 1, 1)),
             np.zeros((n_cams, 3)))
    return [torch.tensor(a[None], dtype=torch.float32, device=dev)
            for a in calib]


def kept_share(model, calib) -> float:
    """The share of frustum points that fall inside the BEV grid (the
    splat's test, ops/voxel_pool.py)."""
    geom = get_geometry(model.frustum, *calib)
    vox = ((geom - (model.bx - model.dx / 2.0)) / model.dx).to(torch.int32)
    nx = torch.as_tensor(model.nx, dtype=torch.int32, device=vox.device)
    return float(((vox >= 0) & (vox < nx)).all(dim=-1).float().mean())


def perturbed_state(mf, seed: int, scale: float = 0.05) -> dict:
    """``mf``'s state_dict with seeded noise added to every float tensor
    (tests/test_encoder.py:157-163), so that the heads carry signal."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in mf.model.state_dict().items():
        if v.is_floating_point():
            v = v.cpu() + scale * torch.randn(v.shape, generator=gen)
        out[k] = v.cpu()
    return out


def run_online_tick(dev, launches, card):
    """Phase 5: MonoForce.run at full width, float32 and half."""
    cfg = PhysicsConfig.for_planner("tradr")
    lss = LSSConfig()
    H, W = lss.data_aug_conf["final_dim"]
    ok = True
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(1, 4, 3, H, W)).astype(
        np.float32)).to(dev)
    calib = camera_rig(4, (H, W), 400.0, 0.5, dev)

    mfs = {"f32": MonoForce(cfg, lss, device=dev),
           "half": MonoForce(cfg, lss, half=True, device=dev)}
    mfs["f32"].init_params(TICK_SEED)
    sd = perturbed_state(mfs["f32"], TICK_NOISE_SEED)
    for mf in mfs.values():
        mf.load_state_dict(sd)
    share = kept_share(mfs["f32"].model, calib)
    _say(f"tick rig: 4 cameras {H}x{W}, focal 400 px, 0.5 m up, yaw 0/90/"
         f"180/270; D={mfs['f32'].model.D} depth bins; the splat keeps "
         f"{100 * share:.2f}% of the frustum points")

    gen = torch.Generator(device=dev)

    def controls():
        gen.manual_seed(7)
        return shooting_controls(gen, cfg.n_sim_trajs, cfg.vel_max,
                                 cfg.omega_max, cfg.traj_sim_time, cfg.dt)[0]

    heads, calls = {}, {}
    for name, mf in mfs.items():
        def tick(mf=mf):
            gen.manual_seed(7)
            return mf.run(imgs, *calib, generator=gen)

        for w in WRAPPERS.values():
            w.launches = 0
        terrain, plan = tick()
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in WRAPPERS.items()}
        for n, v in counts.items():
            launches[entry(n, 62)] = launches.get(entry(n, 62), 0) + v
        want = {n: 0 for n in WRAPPERS}
        want["fk_step_pairmu"], want["fk_interp"] = 500, 1
        good = counts == want
        heads[name] = {k: v.cpu() for k, v in terrain.items()}
        finite = (all(bool(torch.isfinite(v).all()) for v in terrain.values())
                  and bool(torch.isfinite(plan.costs).all())
                  and bool(torch.isfinite(plan.xs).all()))
        best = int(plan.best)
        ranges = (float(terrain["geom"].min()) >= -1.0
                  and float(terrain["geom"].max()) <= 1.0
                  and float(terrain["diff"].min()) >= 0.0
                  and float(terrain["friction"].min()) >= 0.0)
        signal = {k: round(float(v.abs().mean()), 5) for k, v in terrain.items()}
        z, fr = terrain["terrain"][0, 0], terrain["friction"][0, 0]
        calls[name] = {
            "tick": tick,
            "encoder": lambda mf=mf: mf.encode(imgs, *calib),
            # the plan alone, on this tick's terrain and controls
            "plan": lambda mf=mf, z=z, fr=fr, c=controls(): _plan(
                mf.robot, z, fr, c, None, mf.cost)}
        line_ok = good and finite and ranges and 0 <= best < cfg.n_sim_trajs
        _say(f"tick {name}: launches "
             f"{ {n: v for n, v in counts.items() if v} } "
             f"{'ok' if good else 'WRONG, want fk_step_pairmu 500, fk_interp 1'}"
             f"; heads mean |x| {signal}, ranges "
             f"{'ok' if ranges else 'VIOLATED'}; best path {best}, costs "
             f"finite {finite} {'ok' if line_ok else 'FAILED'}")
        ok &= line_ok

    # ms per call, medians of 10 synchronised calls, in the order f32,
    # half, half, f32 (the host's speed drifts within a run)
    ms = {name: {part: [] for part in calls[name]} for name in mfs}
    for name in ("f32", "half", "half", "f32"):
        for part, fn in calls[name].items():
            ms[name][part].append(wall_ms(fn, reps=10))
    for name in mfs:
        busy, in_step, n_step, prof_wall = device_busy(calls[name]["tick"],
                                                       "fk_step_kernel")
        enc_busy, _, _, enc_wall = device_busy(calls[name]["encoder"], "conv")
        tick_ms = statistics.mean(ms[name]["tick"])
        _say(f"tick {name} timing: "
             + "; ".join(f"{part} {' and '.join(f'{t:.3f}' for t in v)} ms"
                         for part, v in ms[name].items())
             + f" (each a median of 10 calls; two rounds); one profiled tick: "
             f"card busy {busy:.3f} ms, {100 * busy / tick_ms:.1f}% of the "
             f"unprofiled {tick_ms:.3f} ms ({100 * busy / prof_wall:.1f}% of "
             f"the profiled {prof_wall:.3f} ms), fk_step_kernel "
             f"{in_step:.3f} ms in {n_step} launches; one profiled encoder "
             f"call: card busy {enc_busy:.3f} ms of {enc_wall:.3f} ms "
             f"[{card}]")

    # the card's float32 encoder against the same weights on the CPU
    cpu = MonoForce(cfg, lss, device="cpu")
    cpu.load_state_dict(sd)
    want = cpu.encode(imgs.cpu(), *[c.cpu() for c in calib])
    errs = {k: float((heads["f32"][k] - want[k]).abs().max()) for k in want}
    good = all(e <= TICK_CPU_ATOL for e in errs.values())
    _say(f"tick f32 card against CPU: max |card - cpu| per head "
         f"{ {k: f'{e:.3e}' for k, e in errs.items()} } (tol "
         f"{TICK_CPU_ATOL:g}) {'ok' if good else 'MISMATCH'} [{card}]")
    ok &= good
    rmses = {k: float(((heads["half"][k] - heads["f32"][k]) ** 2).mean().sqrt())
             for k in heads["f32"]}
    good = all(rmses[k] < tol for k, tol in TICK_HALF_GATE.items())
    _say(f"tick half against f32: RMSE per head "
         f"{ {k: f'{e:.3e}' for k, e in rmses.items()} } (gate "
         f"{TICK_HALF_GATE}) {'ok' if good else 'FAILED'} [{card}]")
    return ok and good


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

    results, launches = {}, {}
    ok = True
    for phase, fn in (("kernels", lambda: check_kernels(dev, results)),
                      ("oracles", lambda: check_oracles(dev, launches)),
                      ("main path", lambda: run_main_path(dev, launches)),
                      ("training", lambda: run_fit(dev, launches)),
                      ("online tick",
                       lambda: run_online_tick(dev, launches, card))):
        t1 = time.perf_counter()
        good = fn()
        _say(f"phase {phase}: {'ok' if good else 'FAILED'} in "
             f"{time.perf_counter() - t1:.1f} s")
        ok &= good

    kernels = []
    for name, meta in KERNELS.items():
        rows = results.get(name, [])
        # the row at the main path's batch, the largest cloud first
        main_row = max(rows, key=lambda r: (r["B"] == 4096, r["P"]),
                       default={})
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            launched_on=("accuracy oracles" if name in ("fk_step",
                                                         "fk_step_pair3")
                         else "main path"),
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
