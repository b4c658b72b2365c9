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
   two lookup kernels; the navigation simulator's B=1, P=62 for fk_interp)
   on windows cut by the port's extractors from a
   seeded rough terrain, and hold it against its plain PyTorch version on
   the same inputs; print the largest difference, the tolerance, the
   kernel's mean device time from the profiler's trace with L2 flushed and
   with its inputs in L2, the median time of a wrapper call and of the
   plain version between CUDA events, and the bound; beside the lookup
   rows, the window words the taps touch and the 32-byte sectors that hold
   them; beside the B=64, B=16 and B=1 rows, one launch's floor (a one-element
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
   steps) on ground truth from fast_rollout over bench_all's hill, 50 Adam
   iterations (bench_all.py runs 100; cut to keep the script within half
   its time limit).  The loss must drop 10x; each iteration must launch
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
6. exact engine -- the reference engine's 13 golden cases
   (tests/golden/*.npz, each 4 x 500 steps on a 128 x 128 grid) through the
   port's exact engine on the card: the 9 semi-implicit ones through
   ``rollout``, the 4 odeint ones through ``rollout_odeint``, and the 9
   semi-implicit ones through ``fast_rollout`` (fk_interp 501 launches
   each), at tests/test_golden.py's gates.  Prints each case's RMSEs and
   the ms of its 4 x 500 rollout, and the card's busy share of one.
7. train step -- the ``Trainer`` at bench_all.py:193-243's full width: the
   default ``LSSConfig`` (4 x 256 x 416, B0, D=59, camC 64, 128 x 128 at
   0.1 m), tradr at 0.4 m (pool 4), B=24, 100 control steps (remat
   segments of 10), 50 ground-truth poses, lr 1e-3, seeded weights and
   bench_all's seeded batch.  One warm-up step and 5 timed steps: every
   loss and parameter finite, the parameters and BN statistics moved.
   Prints the median ms per step, the peak memory, and from profiled
   calls the card's busy time of a step, of its encoder part (a step
   without the physics term) and of its physics part (the rollout's
   forward and backward on the step's terrain).  Against the CPU: one
   step at B=2 from the same weights and batch slice (no drop-connect,
   TF32 off) on both, losses, gradients and parameters held; the
   ``Evaluator`` on a B=24 batch (finite) and at B=2 against the CPU; and
   ``fit_terrain``'s exact branch for marv at bench_all's fit shape
   (16 x 100, the 128 x 128 hill, 20 iterations): the loss falls and its
   first three losses agree with the same fit on the CPU.
8. navigation -- ``navigate`` at scripts/navigate.py's full width:
   ``PhysicsConfig.for_planner("tradr")`` on its hill (bench.py's gaussian
   hill) with waypoints (2, -1.5) and (4, 0.5), 64 trajectories x 2 s
   (200 steps, mode pair: navigate fills the friction grid) every 0.5 s,
   10 Hz follower ticks, each simulating 10 steps of ``fast_rollout`` on
   one trajectory, up to 40 s, force-variance cost, a generator seeded 0.
   The route must complete, every replan launch fk_step_pairmu 200 times
   and fk_interp once, every tick fk_interp 11 times, every output be
   finite, and the first replan's paths (1e-4 m, the same best) and first
   10 ticks' positions (1e-3 m) agree with the same loop through the plain
   versions.  Prints ms per replan and per tick (medians), the route's wall
   time, and from a profiled 5 s segment the card's busy share and both
   kernels' device time per launch.  Then tests/test_nav.py's obstruction
   scene at 64 trajectories (waiting, then forcing through, then reached,
   within the speed bounds), and ``local_heightmap`` on one lidar scan
   (131,072 seeded returns off the hill, 1% NaN) into tradr's 128 x 128
   grid at 0.1 m with 16 inpaint iterations at a yawed pose: max-z and
   mask equal to the CPU's cell for cell, the inpainted map within 1e-6;
   prints ms per call.  Phase 2 times fk_interp at the simulator's shape
   (B=1, P=62) beside the launch floor.
9. from disk -- the port started the way its users start it: a synthetic
   ROUGH sequence at the real sizes written to disk (26 frames; four
   1200 x 1920 camera PNGs of seeded photo-like texture a frame and their
   segmentation PNGs; one 131,072-point lidar scan a frame, phase 8's
   ``lidar_cloud``; 10 Hz poses and commands; a calibration with four
   yawed cameras), then ``scripts/train.py``'s ``main`` in-process at its
   defaults (marv, 0.4 m, 5 s: 500 steps of the exact engine) with the
   reference's production values (``--bsz 24 --terrain_weight 3.0
   --phys_weight 4.0``) for two epochs of one batch each (24 train, 2 val
   samples): the first cold (resize cache and labels written, by the
   native host ops), the second warm and profiled; one more warm step
   unprofiled; ``scripts/eval.py``'s ``main`` over the val split; and
   ``scripts/run.py``'s ``main`` from the trained checkpoint (loaded
   strictly) at full width, which must launch its mode's step kernel once
   per step and fk_interp once.  Prints the loader's seconds per batch
   cold and warm (timed alone), seconds per train step, the card's busy
   share over the warm epoch, the peak memory and the bytes per PNG; the
   losses must be finite.  The sequence is removed afterwards.
10. one JSON line listing every kernel with its launches on the main path,
   its largest difference from the plain version, its time, the plain
   version's time and its bound on this card.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from monoforce_tpu_torch import native
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.models.terrain_encoder.geometry import get_geometry
from monoforce_tpu_torch.ops import _build, fk_step_cuda, interp_cuda
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.losses import physics_loss
from monoforce_tpu_torch.physics.engine import (RobotModel, rollout,
                                                rollout_odeint)
from monoforce_tpu_torch.ops import heightmap
from monoforce_tpu_torch.ops.heightmap import (estimate_heightmap,
                                               local_heightmap)
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.planner import navigator
from monoforce_tpu_torch.scripts import eval as eval_script
from monoforce_tpu_torch.scripts import run as run_script
from monoforce_tpu_torch.scripts import train as train_script
from monoforce_tpu_torch.scripts._common import have_matplotlib
from monoforce_tpu_torch.planner.controller import FollowerController
from monoforce_tpu_torch.planner.follower import FollowerParams
from monoforce_tpu_torch.planner.navigator import navigate
from monoforce_tpu_torch.planner.shooting import (Planner, PlanResult,
                                                  _plan, force_variance_cost,
                                                  inclination_cost)
from monoforce_tpu_torch.training import Evaluator, Trainer, fit_terrain
from monoforce_tpu_torch.models.terrain_encoder.lss import float32_math
from monoforce_tpu_torch.utils import NumpyLoader
from monoforce_tpu_torch.training.trainer import (_physics_states,
                                                  compute_losses,
                                                  make_train_step)

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
REPO = os.path.dirname(os.path.abspath(__file__))
# the golden gates of tests/test_golden.py:32-36 (position, rotation
# entries, velocity RMSE; forces at the stride relative to the peak)
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
GOLDEN_GATES = {"x": 1e-3, "R": 5e-3, "xd": 2e-2, "F_spring": 0.05,
                "F_friction": 0.05}
# the train step against the CPU: losses; the encoder's
# clipped gradients, each tensor within TRAIN_GRAD_RTOL of its largest
# entry plus TRAIN_GRAD_FLOOR of the largest entry of all (float32
# gradients through the trunk's ~50 train-mode BNs: two CPU thread counts
# already part by up to 7e-4 of a tensor's largest entry at the card
# test's size; the trunk's BN biases have an exactly-zero gradient, whose
# rounding noise reaches 2e-7 of the largest entry); Adam's first step
# moves an entry by lr g / (|g| + eps): where |g| > 1e-5 and ten times the
# two devices' gradient difference (the sign sure) the steps agree within
# TRAIN_PARAM_ATOL, elsewhere they lie within 2 lr; the physics gradient in
# smooth maps within MAPS_GRAD_RTOL of its largest entry; the evaluator's
# metrics
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
TRAIN_GRAD_FLOOR = 1e-5
TRAIN_PARAM_ATOL = 1e-6
MAPS_GRAD_RTOL = 1e-3
EVAL_RTOL = 1e-4
# the exact-branch fit: its first three losses on the card against the CPU
# (as phase 4's kernels against the plain versions)
EXACT_FIT_RTOL = 1e-3
TRAIN_SEED = 0
# bench_all.py:193-243's batch and the timed steps after one warm-up; the
# exact-branch fit's trajectories, steps and iterations (bench_all.py:101-132)
TRAIN_B, TRAIN_STEPS = 24, 5
EXACT_FIT = (16, 100, 20)
# navigation: scripts/navigate.py's defaults (64 trajectories, 2 s plans,
# replans every 0.5 s, 10 Hz ticks, 40 s, force variance; its hill is
# gaussian_hill); each tick's simulator launches fk_interp for its settle
# and its 10 steps; the first replan's paths and the first 10 ticks against
# the plain versions (1e-4 m: 200 steps of float rounding on the smooth
# hill; 1 mm after ten follower ticks); the local heightmap's inpainting
# against the CPU; one lidar scan (128 beams x 1024 columns)
NAV = dict(n_trajs=64, plan_horizon=2.0, replan_every=0.5, control_dt=0.1,
           max_time=40.0, cost="force_variance")
NAV_WAYPOINTS = np.asarray([[2.0, -1.5, 0.0], [4.0, 0.5, 0.0]])
NAV_SIM_INTERP = 11
NAV_PATH_TOL_M = 1e-4
NAV_POS_TOL_M = 1e-3
NAV_HM_TOL = 1e-6
NAV_PROFILE_S = 5.0
LIDAR_POINTS = 128 * 1024
# from disk: a synthetic ROUGH sequence at the real sizes (26 frames, four
# cameras of DEFAULT_LSS_CONFIG's 1200 x 1920, one lidar scan a frame),
# split 24 train / 2 val by compile_data; scripts/train.py's defaults (marv,
# 0.4 m, 5 s) with the production values of the reference's train.sh
# (scripts/train.py:4-6) for two epochs, the first cold (the resize cache
# and the labels written), the second warm; frames at 5 Hz, poses and
# commands at 10 Hz for 12 s past the last frame (the labels look 10 s
# ahead); the lidar 0.6 m above base_link, the cameras 7 degrees off the
# ego axes (frustum points off the cell borders); extra arguments of every
# script (a CPU rehearsal passes a tiny LSS config and a short horizon)
DISK_FRAMES = 26
DISK_HW = (1200, 1920)
DISK_POINTS = LIDAR_POINTS
DISK_TRAIN_ARGS = ["--bsz", "24", "--terrain_weight", "3.0",
                   "--phys_weight", "4.0", "--nepochs", "2"]
DISK_ARGS: list = []
DISK_CAMS = {"camera_left": 97.0, "camera_front": 7.0,
             "camera_right": -83.0, "camera_rear": 187.0}
DISK_LIDAR_Z = 0.6
# scripts/run.py's tick at its defaults: tradr's 0.11 m cloud (P=97) with
# the friction head is mode pair3_muq, 500 step launches and one lookup
DISK_RUN_MODE = "pair3_muq"
DISK_RUN_LAUNCHES = {"fk_step_muq": 500, "fk_interp": 1}


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
    total, wall, named = profile_kernels(fn, (kernel,))
    return (total,) + named[kernel] + (wall,)


def profile_kernels(fn, names=()):
    """One profiled call of ``fn``: (ms of all the card's activity, host ms
    of the call, {name: (device ms, launches)} of the kernels whose names
    hold each of ``names``).  The total is summed over the profiler's raw
    events: a train epoch from disk launches ~1e6 kernels, which
    ``key_averages`` takes over a minute to convert, so it runs only when
    kernels are named."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda) / 1e6
    named = {n: (0.0, 0) for n in names}
    for ev in (prof.key_averages() if names else ()):
        for n in names:
            if n in ev.key:
                ms, k = named[n]
                named[n] = (ms + ev.device_time_total / 1e3, k + ev.count)
    return total, wall, named


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
    # planner tick's batch in its two step formats, and scripts/run.py's
    # tick at its defaults (tradr's 0.11 m cloud: muq and the lookup); then
    # the terrain fit's shape (the same cloud, B=16) and the navigation
    # simulator's (the planner preset's 0.15 m cloud, one trajectory)
    both = ("fk_interp", "fk_interp_bwd")
    cases = (("tradr", 0.15, 4096, ("zu", "pairmu"), ()),
             ("tradr", 0.1, 4096, ("zu", "muq", "pair3", "packed", "exact"),
              both),
             ("husky", 0.1, 4096, ("packed",), ()),
             ("husky", 0.1, 4094, ("packed",), ("fk_interp_bwd",)),
             ("tradr", 0.1, 64, ("muq",), ()),
             ("tradr", 0.15, 64, ("pairmu",), ()),
             ("tradr", 0.11, 64, ("muq",), ("fk_interp",)),
             ("tradr", 0.11, 16, (), both),
             ("tradr", 0.15, 1, (), ("fk_interp",)))
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
                f"{4 * words})" + (floor_note if B in (1, 16) else ""))
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
    tradr (P=97), the 128 x 128 grid, 16 trajectories x 100 steps, 50
    iterations (bench_all's 100, halved), ground truth from fast_rollout on
    bench_all's hill."""
    cfg = PhysicsConfig(robot="tradr")
    robot = RobotModel.from_config(cfg, device=dev)
    gx, gy = cfg.grid_coords()
    z_gt = torch.from_numpy((0.3 * np.exp(-((gx - 1.5) ** 2 + gy ** 2) / 2.0))
                            .astype(np.float32)).to(dev)
    B, N, iters = 16, 100, 50
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


def golden_case(name, dev):
    """(npz data, robot, (B, H, W) grid, controls, joint angles or None,
    friction or None) of a golden case on ``dev``, with the exact contact
    cloud the reference ran with."""
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    cfg = PhysicsConfig(robot=str(d["robot"]), robot_points=d["robot_points"])
    robot = RobotModel.from_config(cfg, device=dev)
    B = d["controls"].shape[0]

    def batch(a):
        return torch.from_numpy(np.broadcast_to(a, (B,) + a.shape).copy()).to(
            dev)

    return (d, robot, batch(d["z_grid"]),
            torch.from_numpy(d["controls"]).to(dev),
            torch.from_numpy(d["joint_angles"]).to(dev)
            if d["joint_angles"].size else None,
            batch(d["friction"]) if d["friction"].size else None)


def golden_errors(d, states, forces=None) -> dict:
    """A rollout's RMSEs against its golden case."""
    def rmse(a, b):
        return float(np.sqrt(np.mean((a.cpu().double().numpy() - b) ** 2)))

    err = {"x": rmse(states.x, d["Xs"]), "R": rmse(states.R, d["Rs"]),
           "xd": rmse(states.xd, d["Xds"])}
    if forces is not None:
        k = int(d["force_stride"])
        peak = float(np.abs(d["F_spring"]).max()) + 1e-6
        err["F_spring"] = rmse(forces[0][:, ::k], d["F_spring"]) / peak
        err["F_friction"] = rmse(forces[1][:, ::k], d["F_friction"]) / peak
    return err


def run_exact_engine(dev, launches, card):
    """Phase 6: the 13 golden cases through the exact engine on the card,
    and the 9 semi-implicit ones through fast_rollout."""
    ok = True
    names = sorted(os.path.basename(p)[:-4]
                   for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))
    ok &= len(names) == 13
    for name in names:
        d, robot, z, ctr, ja, fr = golden_case(name, dev)
        odeint = "odeint" in name
        dt = 5.0 / (ctr.shape[1] - 1)

        def run():
            if odeint:
                return rollout_odeint(robot, z, ctr, joint_angles=ja,
                                      friction=fr, dt=dt)
            return rollout(robot, z, ctr, joint_angles=ja, friction=fr)[:2]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, forces = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = golden_errors(d, states, forces)
        good = all(v < GOLDEN_GATES[k] for k, v in err.items())
        text = (f"golden {name} ({'rollout_odeint' if odeint else 'rollout'}, "
                f"{tuple(ctr.shape[:2])}): RMSE "
                + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                + f" {'ok' if good else 'FAILED'}; {ms:.1f} ms")
        if not odeint:
            for w in WRAPPERS.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fstates, _ = fast.fast_rollout(robot, z, ctr, joint_angles=ja,
                                           friction=fr)
            torch.cuda.synchronize()
            fms = (time.perf_counter() - t0) * 1e3
            counts = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
            for n, v in counts.items():
                launches[n] = launches.get(n, 0) + v
            ferr = golden_errors(d, fstates)
            fgood = (all(v < GOLDEN_GATES[k] for k, v in ferr.items())
                     and counts == {"fk_interp": ctr.shape[1] + 1})
            text += ("; fast_rollout RMSE "
                     + ", ".join(f"{k} {v:.3e}" for k, v in ferr.items())
                     + f", launches {counts} {'ok' if fgood else 'FAILED'}; "
                     f"{fms:.1f} ms")
            good &= fgood
        _say(text)
        ok &= good
    d, robot, z, ctr, ja, fr = golden_case("tradr_hill", dev)
    busy, _, _, prof_wall = device_busy(
        lambda: rollout(robot, z, ctr, friction=fr), "")
    one = wall_ms(lambda: rollout(robot, z, ctr, friction=fr), reps=3)
    _say(f"golden timing: rollout tradr_hill 4 x 500 {one:.1f} ms (median of "
         f"3); one profiled call: card busy {busy:.3f} ms, "
         f"{100 * busy / one:.1f}% of the unprofiled {one:.1f} ms "
         f"({100 * busy / prof_wall:.1f}% of the profiled {prof_wall:.1f} ms) "
         f"[{card}]")
    return ok


def bench_all_batch(B, lss, dphys, dev):
    """bench_all.py:135-156 and :210-225's seeded batch: four cameras with
    identity rotations at the origin, focal 400 px, seeded images; seeded
    (height, mask) labels on the 128 x 128 grid, 100 uniform controls over
    100 dt, identity initial poses, 50 seeded ground-truth positions."""
    h, w = lss.data_aug_conf["final_dim"]
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(B, 4, 3, h, w)).astype(np.float32)
    K = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1.0]])
    eye3 = np.broadcast_to(np.eye(3), (B, 4, 3, 3))
    rng = np.random.default_rng(1)
    G, n_ctrl, n_traj = 128, 100, 50
    t_sim = n_ctrl * float(dphys.dt)
    batch = (imgs, eye3, np.zeros((B, 4, 3)),
             np.broadcast_to(K, (B, 4, 3, 3)), eye3, np.zeros((B, 4, 3)),
             rng.normal(size=(B, 2, G, G)).astype(np.float32),
             rng.normal(size=(B, 2, G, G)).astype(np.float32),
             np.tile(np.linspace(0, t_sim, n_ctrl, dtype=np.float32)[None],
                     (B, 1)),
             rng.uniform(-1, 1, (B, n_ctrl, 2)).astype(np.float32),
             np.broadcast_to(np.eye(4), (B, 4, 4)),
             np.tile(np.linspace(0, t_sim, n_traj, dtype=np.float32)[None],
                     (B, 1)),
             rng.normal(size=(B, n_traj, 3)).astype(np.float32),
             np.zeros((B, n_traj, 3)), np.broadcast_to(np.eye(3),
                                                       (B, n_traj, 3, 3)),
             np.zeros((B, n_traj, 3)))
    return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                 dtype=torch.float32).to(dev) for a in batch)


def _finite_model(model) -> bool:
    return all(bool(torch.isfinite(v).all())
               for v in model.state_dict().values() if v.is_floating_point())


class FixedMaps(torch.nn.Module):
    """A stand-in for the encoder that returns given terrain maps, so that
    the losses and the evaluator's rollout run on another device's maps."""

    def __init__(self, maps):
        super().__init__()
        self.maps = maps

    def forward(self, *args, **kwargs):
        return self.maps


def rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)


def _grad_bounds(gb: dict) -> dict:
    """Each gradient tensor's tolerance: TRAIN_GRAD_RTOL of its largest
    entry plus TRAIN_GRAD_FLOOR of the largest entry of all."""
    top = max(float(g.abs().max()) for g in gb.values())
    return {k: TRAIN_GRAD_RTOL * float(g.abs().max()) + TRAIN_GRAD_FLOOR * top
            for k, g in gb.items()}


def _grad_diff(ga: dict, gb: dict, bounds: dict):
    """Largest difference of two gradient sets over its tensor's bound (the
    check passes at 1 or below), and that tensor's name."""
    return max((float((ga[k] - g).abs().max()) / bounds[k], k)
               for k, g in gb.items())


def _map_grad_diff(ga: dict, gb: dict) -> float:
    """Largest difference of two gradients in the maps over each map's
    largest entry."""
    return max(float((ga[k] - g).abs().max()) / max(float(g.abs().max()),
                                                    1e-30)
               for k, g in gb.items())


def _maps_losses(maps, robot, batch, pool_k):
    """The train step's three losses on given maps, and their gradient in
    the maps."""
    maps = {k: v.clone().requires_grad_() for k, v in maps.items()}
    with float32_math():
        total, aux = compute_losses(FixedMaps(maps), robot, batch, True,
                                    pool_k=pool_k)
        total.backward()
    return ({k: float(v.detach()) for k, v in aux.items()},
            {k: v.grad.cpu() for k, v in maps.items() if v.grad is not None})


def smooth_maps(B, lss, dev):
    """Smooth terrain maps at the encoder's grid: bench_all.py's fit hill
    as geom and terrain, bench.py's friction grid."""
    cfg = PhysicsConfig(grid_res=lss.grid_conf["xbound"][2])
    gx, gy = cfg.grid_coords()
    hill = 0.3 * np.exp(-((gx - 1.5) ** 2 + gy ** 2) / 2.0)
    fr = 0.7 + 0.25 * np.sin(1.3 * gx) * np.cos(0.9 * gy)
    return {k: torch.from_numpy(np.broadcast_to(
        a, (B, 1) + a.shape).astype(np.float32).copy()).to(dev)
        for k, a in (("geom", hill), ("terrain", hill), ("friction", fr))}


def compare_train_step(dev, lss, dphys, batch, log_dir):
    """The train step at B=2 from the same seeded weights and batch, no
    drop-connect, on the card and on the CPU.  Returns (ok, text).

    Its physics term is chaotic on the seeded encoder's rough maps: 100
    steps of contact dynamics turn the rounding by which the two devices
    differ into a different loss, even on identical maps, and into
    unrelated gradients.  So the physics is held where it is well
    conditioned: the step's physics path (pooling, the rollout with remat
    and the BPTT clip, the loss, its gradient in the maps) on smooth maps
    at the step's shapes; the numbers on the encoder's maps are printed
    beside the CPU's own change when its maps move by 1e-7, and not gated.
    Also checked: the encoder's two losses of the whole step; the
    encoder's step alone (no physics term): its losses, clipped gradients,
    updated parameters and BN statistics; on the seeded weights, the
    evaluator's heightmap metrics, and all four metrics on the smooth
    maps."""
    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        b = tuple(t.to(d) for t in batch)
        tr = Trainer(dphys, lss, lr=1e-3, log_dir=os.path.join(log_dir, str(i)),
                     device=d, drop_connect_rate=0.0)
        tr.init_state(seed=TRAIN_SEED)
        with torch.no_grad(), float32_math():
            maps = copy.deepcopy(tr.model).train()(*b[:6])
        aux = {k: float(v) for k, v in tr.train_step(b, tr.generator).items()}
        enc = Trainer(dphys, lss, lr=1e-3, log_dir=os.path.join(log_dir, str(i)),
                      device=d, drop_connect_rate=0.0)
        enc.init_state(seed=TRAIN_SEED)
        # the evaluator on the seeded weights (after a full step, the
        # physics gradient's amplified rounding parts the devices' weights)
        ev = Evaluator(enc.model, enc.robot, pool_k=enc.pool_k,
                       out_dir=os.path.join(log_dir, str(i)))
        metrics = ev._metrics(b)[0]
        smooth = smooth_maps(b[0].shape[0], lss, d)
        ev_smooth = Evaluator(FixedMaps(smooth), enc.robot, pool_k=enc.pool_k,
                              out_dir=os.path.join(log_dir, str(i)))
        enc_step, _ = make_train_step(enc.model, enc.robot, enc.optimizer,
                                      phys_weight=0.0, pool_k=enc.pool_k)
        enc_aux = {k: float(v) for k, v in enc_step(b, enc.generator).items()}
        maps = {k: maps[k] for k in ("geom", "terrain", "friction")}
        runs.append(dict(
            aux=aux, enc_aux=enc_aux,
            metrics={k: float(v) for k, v in metrics.items()},
            smooth=_maps_losses(smooth, tr.robot, b, tr.pool_k),
            smooth_metrics={k: float(v) for k, v in
                            ev_smooth._metrics(b)[0].items()},
            own=_maps_losses(maps, tr.robot, b, tr.pool_k),
            card_maps=(maps if i == 0 else None),
            cpu_args=(tr.robot, b, tr.pool_k, maps) if i else None,
            state={k: v.cpu() for k, v in enc.model.state_dict().items()},
            grads={k: p.grad.cpu() for k, p in enc.model.named_parameters()
                   if p.grad is not None}))
        del tr, enc, ev, ev_smooth
    card, cpu = runs
    robot, b, pool_k, cpu_maps = cpu["cpu_args"]
    # on the encoder's maps (not gated): the card's maps on the CPU, and
    # the CPU's own maps moved by 1e-7 of each entry
    on_card = _maps_losses({k: v.cpu() for k, v in card["card_maps"].items()},
                           robot, b, pool_k)
    gen = torch.Generator().manual_seed(0)
    moved = _maps_losses({k: v * (1 + 1e-7 * torch.randn(v.shape,
                                                          generator=gen))
                          for k, v in cpu_maps.items()}, robot, b, pool_k)
    chaos = {"card maps, card against CPU": (rel(card["own"][0], on_card[0]),
                                             _map_grad_diff(card["own"][1],
                                                            on_card[1])),
             "CPU maps moved by 1e-7, CPU against itself": (
                 rel(moved[0], cpu["own"][0]),
                 _map_grad_diff(moved[1], cpu["own"][1])),
             "each device's own maps": (rel(card["own"][0], cpu["own"][0]),
                                        _map_grad_diff(card["own"][1],
                                                       cpu["own"][1]))}
    enc_losses = {k: cpu["aux"][k] for k in ("geom", "terrain")}
    hm = {k: cpu["metrics"][k] for k in ("hm_geom", "hm_terrain")}
    stat_rel = max(float(((card["state"][k] - v).abs() / (1 + v.abs())).max())
                   for k, v in cpu["state"].items() if "running" in k)
    bounds = _grad_bounds(cpu["grads"])
    resolved = unresolved = 0.0
    n_resolved = n_all = 0
    for k, g in cpu["grads"].items():
        diff = (card["state"][k] - cpu["state"][k]).abs()
        sure = (g.abs() > 1e-5) & (g.abs() > 10 * (card["grads"][k] - g).abs())
        resolved = max(resolved, float(diff[sure].max()) if sure.any() else 0.0)
        unresolved = max(unresolved, float(diff.max()))
        n_resolved += int(sure.sum())
        n_all += g.numel()
    worst_ratio, worst = _grad_diff(card["grads"], cpu["grads"], bounds)
    checks = {
        "step's encoder losses": (rel(card["aux"], enc_losses),
                                  TRAIN_LOSS_RTOL),
        "physics losses on smooth maps": (rel(card["smooth"][0],
                                              cpu["smooth"][0]),
                                          TRAIN_LOSS_RTOL),
        "their gradient in the maps": (_map_grad_diff(card["smooth"][1],
                                                      cpu["smooth"][1]),
                                       MAPS_GRAD_RTOL),
        "encoder step's losses": (rel(card["enc_aux"], cpu["enc_aux"]),
                                  TRAIN_LOSS_RTOL),
        f"its clipped gradients over their bounds (worst {worst})": (
            worst_ratio, 1.0),
        "its BN statistics": (stat_rel, 1e-5),
        f"its parameters where the sign is sure ({n_resolved} of {n_all})": (
            resolved, TRAIN_PARAM_ATOL),
        "its parameters elsewhere": (unresolved, 2e-3 + TRAIN_PARAM_ATOL),
        "evaluator's heightmap metrics": (rel(card["metrics"], hm), EVAL_RTOL),
        "evaluator on smooth maps": (rel(card["smooth_metrics"],
                                         cpu["smooth_metrics"]), EVAL_RTOL),
    }
    ok = all(v <= tol for v, tol in checks.values())
    return ok, (f"step losses {card['aux']} (cpu {cpu['aux']}); the "
                "encoder's maps, losses' and gradient's rel diff (not gated): "
                + "; ".join(f"{n} {a:.2e} and {g:.2e}"
                            for n, (a, g) in chaos.items())
                + "; gated: "
                + "; ".join(f"{n} {v:.2e} (tol {t:g})"
                            for n, (v, t) in checks.items())
                + f" {'ok' if ok else 'MISMATCH'}")


def run_exact_fit(dev):
    """fit_terrain's exact branch: marv at bench_all.py:101-132's shape
    (16 x 100, the 128 x 128 hill), ground truth from the port's exact
    rollout, 20 iterations on the card, 3 on the CPU."""
    B, N, iters = EXACT_FIT
    cfg = PhysicsConfig(robot="marv")
    robot = RobotModel.from_config(cfg, device=dev)
    gx, gy = cfg.grid_coords()
    z_gt = (0.3 * np.exp(-((gx - 1.5) ** 2 + gy ** 2) / 2.0)).astype(np.float32)
    controls = np.random.default_rng(0).uniform(-1, 1, (B, N, 2)).astype(
        np.float32)
    gt, _, _ = rollout(robot, torch.from_numpy(z_gt).to(dev).expand(B, -1, -1),
                       torch.from_numpy(controls).to(dev), return_forces=False)
    gt = gt.x.cpu().numpy()
    ts = np.tile(np.arange(N, dtype=np.float32) * cfg.dt, (B, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = fit_terrain(cfg, controls, [gt], ts, ts, n_iters=iters,
                            device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _, cpu = fit_terrain(cfg, controls, [gt], ts, ts, n_iters=3, device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], cpu))
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and rel <= EXACT_FIT_RTOL)
    return ok, (f"exact fit marv P={robot.points.shape[0]} B={B} N={N} x "
                f"{iters} iterations: loss {losses[0]:.6g} -> {losses[-1]:.6g} "
                f"({losses[0] / max(losses[-1], 1e-30):.2f}x); first 3 "
                f"against the CPU: rel diff {rel:.2e} (tol {EXACT_FIT_RTOL:g}); "
                f"{secs:.2f} s, {secs / iters:.3f} s per iteration "
                f"{'ok' if ok else 'FAILED'}")


def run_train_step(dev, launches, card):
    """Phase 7: the Trainer's full-width step (bench_all.py:193-243), the
    card against the CPU, the Evaluator and the exact-branch fit."""
    lss = LSSConfig()
    dphys = PhysicsConfig(robot="tradr", grid_res=0.4)
    B, steps = TRAIN_B, TRAIN_STEPS
    ok = True
    # the trainers' log directories, inside the checkout, removed on leaving
    os.makedirs(os.path.join(REPO, "runs"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "runs")) as tmp:
        tr = Trainer(dphys, lss, lr=1e-3, log_dir=os.path.join(tmp, "train"),
                     device=dev)
        tr.init_state(seed=TRAIN_SEED)
        batch = bench_all_batch(B, lss, dphys, dev)
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        for w in WRAPPERS.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        aux = [tr.train_step(batch, tr.generator)]      # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            aux.append(tr.train_step(batch, tr.generator))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        counts = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        losses = [{k: float(v) for k, v in a.items()} for a in aux]
        after = tr.model.state_dict()
        finite = (all(np.isfinite(list(a.values())).all() for a in losses)
                  and _finite_model(tr.model))
        moved_p = sum(not torch.equal(before[n], p.detach())
                      for n, p in tr.model.named_parameters())
        moved_bn = sum(not torch.equal(before[k], v) for k, v in after.items()
                       if "running" in k)
        n_p = len(list(tr.model.parameters()))
        n_bn = sum("running" in k for k in after)
        good = (finite and moved_p > 0.9 * n_p and moved_bn == n_bn
                and not counts)
        ms = statistics.median(times)
        _say(f"train step B={B} (4 x {lss.data_aug_conf['final_dim']}, "
             f"tradr 0.4 m, 100 steps): losses "
             + " -> ".join(f"{a['total']:.5g}" for a in losses)
             + f" (geom {losses[-1]['geom']:.5g}, terrain "
             f"{losses[-1]['terrain']:.5g}, phys {losses[-1]['phys']:.5g}); "
             f"finite {finite}; {moved_p} of {n_p} parameters and {moved_bn} "
             f"of {n_bn} BN statistics moved; kernels launched {counts}; "
             f"{ms:.1f} ms per step (median of {steps}: "
             + ", ".join(f"{t:.1f}" for t in times)
             + f"); peak memory {peak:.2f} GiB {'ok' if good else 'FAILED'}")
        ok &= good

        # one profiled step, and its two parts apart: the encoder (a step
        # without the physics term) and the physics (the rollout's forward
        # and backward on this step's terrain)
        enc_step, _ = make_train_step(tr.model, tr.robot, tr.optimizer,
                                      phys_weight=0.0, pool_k=tr.pool_k)
        with torch.no_grad():
            tr.model.eval()
            terrain = {k: v.detach() for k, v in tr.model(*batch[:6]).items()}

        def physics():
            t = {k: v.clone().requires_grad_() for k, v in terrain.items()
                 if k in ("terrain", "friction")}
            st = _physics_states(tr.robot, t, batch[10], batch[9], tr.pool_k)
            physics_loss([st.x], [batch[12]], batch[8], batch[11]).backward()

        parts = {"step": lambda: tr.train_step(batch, tr.generator),
                 "encoder": lambda: enc_step(batch, tr.generator),
                 "physics": physics}
        prof = {}
        for name, fn in parts.items():
            wall = wall_ms(fn, reps=3)
            busy, _, _, prof_wall = device_busy(fn, "")
            prof[name] = (wall, busy, prof_wall)
        _say("train step parts (median of 3 synchronised calls; card busy in "
             "one profiled call): "
             + "; ".join(f"{n} {w:.1f} ms, card busy {b:.1f} ms "
                         f"({100 * b / w:.1f}% of it, {100 * b / pw:.1f}% of "
                         f"the profiled {pw:.1f} ms)"
                         for n, (w, b, pw) in prof.items())
             + f" [{card}]")

        # the evaluator at B=24 on the trained weights
        ev = Evaluator(tr.model, tr.robot, pool_k=tr.pool_k,
                       out_dir=os.path.join(tmp, "eval"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in ev._metrics(batch)[0].items()}
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        good = all(np.isfinite(v) for v in metrics.values())
        _say(f"evaluator B={B}: {metrics} finite {good}; {eval_ms:.1f} ms")
        ok &= good
        del tr, ev, enc_step, terrain, batch
        torch.cuda.empty_cache()

        good, text = compare_train_step(
            dev, lss, dphys, bench_all_batch(2, lss, dphys, "cpu"), tmp)
        _say(f"train step B=2 card against CPU: {text} [{card}]")
        ok &= good
    good, text = run_exact_fit(dev)
    _say(f"fit {text} [{card}]")
    return ok & good


class _TimedController(FollowerController):
    """The supervisor, logging when each replan hands it a path and when
    each control tick starts (host clock; both follow a read-back, so the
    card's work before them is done)."""

    def __init__(self, *a, log, **kw):
        super().__init__(*a, **kw)
        self.log = log

    def set_path(self, path):
        super().set_path(path)
        self.log.append(("replan_end", time.perf_counter()))

    def tick(self, pose, t, cloud=None):
        self.log.append(("tick", time.perf_counter()))
        return super().tick(pose, t, cloud=cloud)


@contextlib.contextmanager
def _logged_replans(log):
    """Log the start of each replan: navigate draws its controls first."""
    draw = navigator.shooting_controls

    def shooting_controls(*a, **kw):
        log.append(("replan_start", time.perf_counter()))
        return draw(*a, **kw)

    navigator.shooting_controls = shooting_controls
    try:
        yield
    finally:
        navigator.shooting_controls = draw


def loop_times(log):
    """(ms per replan, ms per control tick) from a route's log: a replan
    from drawing its controls to the path handed over; a control tick from
    its start to the next replan's or tick's (the follower, the simulator's
    10 steps and the position read back)."""
    replans, ticks = [], []
    start = None
    for (kind, t), nxt in zip(log, log[1:] + [None]):
        if kind == "replan_start":
            start = t
        elif kind == "replan_end":
            replans.append((t - start) * 1e3)
        elif nxt is not None:
            ticks.append((nxt[1] - t) * 1e3)
    return replans, ticks


def nav_launches(res, counts, steps):
    """The route's launches against its replans and ticks: the step kernel
    once a planning step and fk_interp once a replan (the settle), and
    fk_interp NAV_SIM_INTERP times a control tick (the simulator's settle
    and 10 steps)."""
    want = {n: 0 for n in WRAPPERS}
    want["fk_step_pairmu"] = steps * len(res.plans)
    want["fk_interp"] = len(res.plans) + NAV_SIM_INTERP * len(res.times)
    return counts == want, {n: v for n, v in want.items() if v}


def lidar_cloud(cfg, rng, n):
    """A seeded scan of ``n`` returns off the navigation hill: x, y uniform
    over the grid and a little past it, z the hill plus 0.01 m noise, 1% of
    the returns NaN."""
    xy = rng.uniform(-1.1 * cfg.d_max, 1.1 * cfg.d_max, (n, 2))
    z = 0.4 * np.exp(-((xy[:, 0] - 2.0) ** 2 / 4.0 + xy[:, 1] ** 2 / 8.0))
    cloud = np.concatenate([xy, (z + rng.normal(scale=0.01, size=n))[:, None]],
                           axis=1).astype(np.float32)
    cloud[rng.choice(n, n // 100, replace=False), rng.integers(0, 3, n // 100)] \
        = np.nan
    return cloud


def run_local_heightmap(dev, card):
    """Phase 8(c): local_heightmap on one lidar scan at tradr's grid, the
    card against the CPU."""
    cfg = PhysicsConfig.for_planner("tradr")
    cloud = torch.from_numpy(lidar_cloud(cfg, np.random.default_rng(8),
                                         LIDAR_POINTS))
    yaw = 0.6
    pose = torch.eye(4)
    pose[:2, :2] = torch.tensor([[np.cos(yaw), -np.sin(yaw)],
                                 [np.sin(yaw), np.cos(yaw)]])
    pose[:3, 3] = torch.tensor([1.0, -0.5, 0.1])
    args = (cfg.grid_res, cfg.d_max, cfg.h_max)
    cloud_d, pose_d = cloud.to(dev), pose.to(dev)
    raw = [estimate_heightmap(heightmap._robot_frame(c, p), *args)
           for c, p in ((cloud_d, pose_d), (cloud, pose))]
    maps = [local_heightmap(c, p, *args, inpaint_iters=16)
            for c, p in ((cloud_d, pose_d), (cloud, pose))]
    same = torch.equal(raw[0].cpu(), raw[1])
    err = float((maps[0].cpu() - maps[1]).abs().max())
    finite = bool(torch.isfinite(maps[0]).all())
    ms = time_ms(lambda: local_heightmap(cloud_d, pose_d, *args), reps=20)
    cpu_ms = wall_ms(lambda: local_heightmap(cloud, pose, *args), reps=5)
    ok = same and err <= NAV_HM_TOL and finite and maps[0].shape == (128, 128)
    _say(f"local_heightmap {LIDAR_POINTS} points -> {tuple(maps[0].shape)} "
         f"at {cfg.grid_res} m, 16 inpaint iterations, yaw {yaw}: measured "
         f"cells {int(raw[1][1].sum())}; max-z and mask equal to the CPU's "
         f"{same}; inpainted max diff {err:.3e} (tol {NAV_HM_TOL:g}); "
         f"{ms:.3f} ms per call on the card (CUDA events), {cpu_ms:.3f} ms "
         f"on the host's CPU {'ok' if ok else 'FAILED'} [{card}]")
    return ok


def run_navigation(dev, launches, card):
    """Phase 8: navigate at scripts/navigate.py's full width on the card,
    the obstruction route, and local_heightmap on one lidar scan."""
    cfg = PhysicsConfig.for_planner("tradr")
    z = torch.from_numpy(gaussian_hill(cfg)).to(dev)
    steps = int(NAV["plan_horizon"] / cfg.dt)
    ok = True

    # (a) the full-width route, timed replan by replan and tick by tick
    log = []
    ctl = _TimedController(log=log, device=dev)
    for w in WRAPPERS.values():
        w.launches = 0
    with _logged_replans(log):
        t0 = time.perf_counter()
        res = navigate(cfg, z, NAV_WAYPOINTS, controller=ctl,
                       generator=torch.Generator(dev).manual_seed(0), device=dev,
                       **NAV)
        route_s = time.perf_counter() - t0
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    for n, v in counts.items():
        launches[n] = launches.get(n, 0) + v
    good_counts, want = nav_launches(res, counts, steps)
    finite = all(np.isfinite(a).all() for a in
                 (res.positions, res.commands,
                  *(p[1] for p in res.plans), *(p[2] for p in res.plans)))
    replan_ms, tick_ms = loop_times(log)

    # the same loop through the plain versions: the first replan and the
    # first 10 ticks
    with plain_kernels():
        ref = navigate(cfg, z, NAV_WAYPOINTS,
                       generator=torch.Generator(dev).manual_seed(0),
                       device=dev, **dict(NAV, max_time=1.0))
    path_err = float(np.abs(res.plans[0][1] - ref.plans[0][1]).max())
    same_best = res.plans[0][3] == ref.plans[0][3]
    pos_err = float(np.abs(res.positions[:10] - ref.positions[:10]).max())
    good = (res.reached and good_counts and finite and same_best
            and path_err <= NAV_PATH_TOL_M and pos_err <= NAV_POS_TOL_M)
    _say(f"navigate route (tradr planner preset, {NAV['n_trajs']} x {steps} "
         f"a replan, ticks of {NAV['control_dt']} s, the hill, waypoints "
         f"{NAV_WAYPOINTS.tolist()}): reached {res.reached} at t="
         f"{res.times[-1]:.1f} s, {len(res.times)} ticks, {len(res.plans)} "
         f"replans; launches { {n: v for n, v in counts.items() if v} } "
         f"{'ok' if good_counts else 'WRONG, want ' + str(want)}; finite "
         f"{finite}; against the plain versions: first replan's paths max "
         f"diff {path_err:.3e} m (tol {NAV_PATH_TOL_M:g}), best "
         f"{res.plans[0][3]} (plain {ref.plans[0][3]}), first 10 ticks' "
         f"positions max diff {pos_err:.3e} m (tol {NAV_POS_TOL_M:g}); "
         f"{statistics.median(replan_ms):.3f} ms per replan (median of "
         f"{len(replan_ms)}, {min(replan_ms):.3f}-{max(replan_ms):.3f}), "
         f"{statistics.median(tick_ms):.3f} ms per control tick (median of "
         f"{len(tick_ms)}, {min(tick_ms):.3f}-{max(tick_ms):.3f}); route "
         f"wall time {route_s:.3f} s {'ok' if good else 'FAILED'} [{card}]")
    ok &= good

    # a profiled 5 s segment of the route: the card's busy share and the
    # two kernels' device time per launch
    seg = dict(NAV, max_time=NAV_PROFILE_S)
    busy, wall, named = profile_kernels(
        lambda: navigate(cfg, z, NAV_WAYPOINTS,
                         generator=torch.Generator(dev).manual_seed(0),
                         device=dev, **seg),
        ("fk_step_kernel", "fk_interp_kernel"))
    _say(f"navigate, one profiled {NAV_PROFILE_S:g} s segment: card busy "
         f"{busy:.3f} ms of {wall:.3f} ms ({100 * busy / wall:.1f}%); "
         + "; ".join(f"{n} {ms:.3f} ms in {k} launches, "
                     f"{1e3 * ms / max(k, 1):.2f} us per launch"
                     for n, (ms, k) in named.items()) + f" [{card}]")

    # (b) tests/test_nav.py's obstruction scene at full width
    rng = np.random.default_rng(3)
    obstacles = (np.array([[1.1, 0.0, 0.1]], np.float32)
                 + rng.normal(scale=0.05, size=(30, 3)).astype(np.float32))
    ctl = FollowerController(FollowerParams(), force_through_after=0.5,
                             device=dev)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = navigate(cfg, torch.zeros(cfg.grid_shape, device=dev),
                   np.asarray([[2.8, 0.0, 0.0]]), n_trajs=NAV["n_trajs"],
                   plan_horizon=1.5, max_time=30.0, obstacles=obstacles,
                   controller=ctl, generator=torch.Generator(dev).manual_seed(0),
                   device=dev)
    obs_s = time.perf_counter() - t0
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    for n, v in counts.items():
        launches[n] = launches.get(n, 0) + v
    good_counts, want = nav_launches(res, counts, int(1.5 / cfg.dt))
    st = list(res.statuses)
    order = ("waiting" in st and "force_through" in st
             and st.index("waiting") < st.index("force_through"))
    bounds = all(abs(res.commands[i][0]) < 1e-6 for i, s in enumerate(st)
                 if s == "waiting") and all(
        abs(res.commands[i][0]) <= ctl.max_force_through_speed + 1e-6
        for i, s in enumerate(st) if s == "force_through")
    good = res.reached and order and bounds and good_counts
    _say(f"navigate obstruction route ({NAV['n_trajs']} x 150, flat, 30 "
         f"obstacle points at (1.1, 0, 0.1), force through after 0.5 s): "
         f"reached {res.reached} at t={res.times[-1]:.1f} s, {len(st)} ticks "
         f"({st.count('waiting')} waiting, {st.count('force_through')} "
         f"forcing through), {len(res.plans)} replans; waiting then forcing "
         f"through {order}; speed bounds {bounds}; launches "
         f"{'ok' if good_counts else 'WRONG, want ' + str(want)}; "
         f"{obs_s:.3f} s {'ok' if good else 'FAILED'}")
    ok &= good

    # (c) local_heightmap at a lidar scan's size
    return ok & run_local_heightmap(dev, card)


def _png(arr, path):
    from PIL import Image
    Image.fromarray(arr).save(path)
    return os.path.getsize(path)


def _texture(seed, hw):
    """A seeded photo-like RGB frame: colour fields at three scales (bicubic
    upsamples of coarse noise) and per-pixel sensor grain."""
    from PIL import Image
    H, W = hw
    rng = np.random.default_rng(seed)
    img = np.full((H, W, 3), 110.0, np.float32)
    for (h, w), amp in (((6, 10), 70.0), ((30, 48), 30.0), ((150, 240), 12.0)):
        coarse = rng.normal(size=(h, w, 3)).astype(np.float32)
        for c in range(3):
            img[..., c] += amp * np.asarray(Image.fromarray(
                coarse[..., c]).resize((W, H), Image.BICUBIC))
    img += rng.normal(scale=3.0, size=(H, W, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _segmentation(seed, hw):
    """Seeded WildScenes labels in bands: sky above, trees, bush, rock and
    logs in the middle, ground classes below, blocks of 50 x 48 px."""
    H, W = hw
    rng = np.random.default_rng(seed)
    rows, cols = 24, 40
    bands = ((0.3, [10]), (0.55, [12, 13, 0, 9, 5]), (1.0, [1, 3, 4, 6, 9]))
    grid = np.empty((rows, cols), np.uint8)
    top = 0
    for frac, classes in bands:
        bottom = int(round(frac * rows))
        grid[top:bottom] = rng.choice(classes, (bottom - top, cols))
        top = bottom
    return np.repeat(np.repeat(grid, -(-H // rows), 0), -(-W // cols), 1)[:H, :W]


def _pose(t):
    """base_link's pose at t s: a 0.5 m/s arc turning at 0.1 rad/s,
    climbing 2 cm/s, rolling and pitching a little."""
    from scipy.spatial.transform import Rotation
    v, w = 0.5, 0.1
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler(
        "xyz", [0.03 * np.sin(0.7 * t), 0.04 * np.sin(0.5 * t), w * t]
    ).as_matrix()
    T[:3, 3] = [v / w * np.sin(w * t), v / w * (1 - np.cos(w * t)), 0.02 * t]
    return T


def _yaml(obj, path):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def _mat(T):
    T = np.asarray(T, np.float64)
    return {"rows": T.shape[0], "cols": T.shape[1],
            "data": [float(v) for v in T.reshape(-1)]}


def write_rough_sequence(root, n_frames, hw, n_points, seed=9):
    """A synthetic ROUGH sequence under ``root/ROUGH`` in the reference's
    layout (its docs/DATA.md; tests/fixtures.py at the real sizes): for each
    of ``n_frames`` frames at 5 Hz one lidar scan (phase 8's
    ``lidar_cloud``, x/y/z/intensity, in the lidar frame), four camera PNGs
    and their segmentation PNGs; 10 Hz lidar poses and commands; the
    calibration.  Written by 8 threads (PNG encoding releases the GIL).
    Returns (the sequence's path, {kind: mean bytes per PNG})."""
    H, W = hw
    seq = os.path.join(root, "ROUGH", "synthetic_2026-01-01-00-00-00")
    for sub in ("clouds", "poses", "controls", "images",
                "images/wildscenes_seg/seg", "calibration/cameras"):
        os.makedirs(os.path.join(seq, sub))
    t0 = 1000.0
    stamps = t0 + 0.2 * np.arange(n_frames)
    ids = [f"{int(s)}_{int(round((s - int(s)) * 1e9)):09d}" for s in stamps]
    T_lidar = np.eye(4)
    T_lidar[2, 3] = DISK_LIDAR_Z

    pose_ts = t0 + 0.1 * np.arange(int(10 * (0.2 * n_frames + 12.0)))
    rows = [[t] + (_pose(t - t0) @ T_lidar)[:3, :4].reshape(-1).tolist()
            for t in pose_ts]
    np.savetxt(os.path.join(seq, "poses", "lidar_poses.csv"), np.asarray(rows),
               delimiter=",", header="stamp," + ",".join(
                   f"T{i}{j}" for i in range(3) for j in range(4)),
               comments="")
    rng = np.random.default_rng(seed)
    cmd = [[t, 0.5 + 0.05 * rng.normal(), 0.1 + 0.02 * rng.normal()]
           for t in pose_ts]
    np.savetxt(os.path.join(seq, "controls", "cmd_vel.csv"), np.asarray(cmd),
               delimiter=",", header="stamp,v,w", comments="")

    cfg = PhysicsConfig()
    for sid in ids:
        xyz = lidar_cloud(cfg, rng, n_points)
        cloud = np.zeros(n_points, dtype=[("x", "f4"), ("y", "f4"),
                                          ("z", "f4"), ("intensity", "f4")])
        cloud["x"], cloud["y"] = xyz[:, 0], xyz[:, 1]
        cloud["z"] = xyz[:, 2] - DISK_LIDAR_Z
        cloud["intensity"] = rng.uniform(0, 255, n_points)
        np.savez(os.path.join(seq, "clouds", f"{sid}.npz"), cloud=cloud)

    K = np.array([[1100.0, 0, W / 2], [0, 1100.0, H / 2], [0, 0, 1]])
    to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    pitch = np.deg2rad(-8.0)       # the optical axis 8 degrees down
    tilt = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                     [0, np.sin(pitch), np.cos(pitch)]])
    footprint = np.eye(4)
    footprint[2, 3] = -0.15
    trans = {"T_base_link__os_sensor": _mat(T_lidar),
             "T_base_link__base_footprint": _mat(footprint)}
    for cam, yaw_deg in DISK_CAMS.items():
        a = np.deg2rad(yaw_deg)
        E = np.eye(4)
        E[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0],
                              [np.sin(a), np.cos(a), 0],
                              [0, 0, 1]]) @ to_ego @ tilt
        E[:3, 3] = [0.3 * np.cos(a) + 0.02, 0.3 * np.sin(a) - 0.03, 0.5]
        trans[f"T_base_link__{cam}"] = _mat(E)
        _yaml({"camera_name": cam, "image_width": W, "image_height": H,
               "camera_matrix": _mat(K)},
              os.path.join(seq, "calibration", "cameras", f"{cam}.yaml"))
    _yaml(trans, os.path.join(seq, "calibration", "transformations.yaml"))

    jobs = []
    for f, sid in enumerate(ids):
        for c, cam in enumerate(DISK_CAMS):
            k = seed * 100003 + 4 * f + c
            jobs.append(("rgb", lambda k=k: _texture(k, hw), os.path.join(
                seq, "images", f"{sid}_{cam}.png")))
            jobs.append(("seg", lambda k=k: _segmentation(k, hw), os.path.join(
                seq, "images", "wildscenes_seg", "seg", f"{sid}_{cam}.png")))
    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(lambda j: (j[0], _png(j[1](), j[2])), jobs))
    return seq, {kind: statistics.mean(n for k, n in sizes if k == kind)
                 for kind in ("rgb", "seg")}


class _TimedLoader(NumpyLoader):
    """scripts/train.py's NumpyLoader, timed alone: the seconds each batch
    took to load, by split and pass."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.passes = []

    def __iter__(self):
        times = []
        self.passes.append(times)
        it = super().__iter__()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            times.append(time.perf_counter() - t0)
            yield batch


class _TimedTrainer(Trainer):
    """scripts/train.py's Trainer, its steps timed (synchronised) and its
    second train epoch (the warm one) profiled: the card's kernel time and
    the epoch's wall time."""

    def init_state(self, *args, **kwargs):
        out = super().init_state(*args, **kwargs)
        step = self.train_step
        self.step_s, self.epoch_s, self.train_epochs = [], [], 0
        self.warm = None

        def timed(batch, generator=None):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            aux = step(batch, generator)
            torch.cuda.synchronize(self.device)
            self.step_s.append(time.perf_counter() - t0)
            return aux

        self.train_step = timed
        return out

    def epoch(self, loader, train=True, generator=None, step0=0):
        warm = train and self.train_epochs == 1
        self.train_epochs += bool(train)
        t0 = time.perf_counter()
        if warm:
            out = []
            self.warm = profile_kernels(lambda: out.append(
                super(_TimedTrainer, self).epoch(loader, train, generator,
                                                 step0)))[:2]
            out = out[0]
        else:
            out = super().epoch(loader, train, generator, step0)
        self.epoch_s.append(("train" if train else "val",
                             round(time.perf_counter() - t0, 3)))
        return out


def run_from_disk(dev, launches, card):
    """Phase 9: train, eval and run from a ROUGH sequence on disk, through
    the entry points' main(argv)."""
    ok = True
    H, W = DISK_HW
    os.makedirs(os.path.join(REPO, "runs"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "runs")) as root:
        t0 = time.perf_counter()
        seq, png = write_rough_sequence(os.path.join(root, "data"),
                                        DISK_FRAMES, DISK_HW, DISK_POINTS)
        _say(f"from disk: wrote a synthetic ROUGH sequence of {DISK_FRAMES} "
             f"frames ({len(DISK_CAMS)} cameras {H}x{W}, {DISK_POINTS} lidar "
             f"points a frame) in {time.perf_counter() - t0:.1f} s; bytes per "
             f"PNG: RGB {png['rgb']:.0f}, segmentation {png['seg']:.0f}")
        labels_native = native.available()
        dev_arg = ["--device", str(dev)]
        log_dir = os.path.join(root, "train")

        # (a) scripts/train.py's main, the loader and the steps timed
        loaders = []       # the train loader (shuffled), then the val loader

        def loader(*args, **kwargs):
            loaders.append(_TimedLoader(*args, **kwargs))
            return loaders[-1]

        torch.zeros(1, device=dev)     # the allocator's stats exist from here
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with mock.patch.object(train_script, "NumpyLoader", loader), \
                mock.patch.object(train_script, "Trainer", _TimedTrainer):
            tr = train_script.main(["--data_dir", os.path.join(root, "data"),
                                    "--log_dir", log_dir, *DISK_TRAIN_ARGS,
                                    *DISK_ARGS, *dev_arg])
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        recs = [json.loads(line)
                for line in open(os.path.join(log_dir, "metrics.jsonl"))]
        losses = [r[k] for r in recs for k in r if k.startswith("iter_loss")]
        finite = bool(losses) and all(np.isfinite(losses))
        resized = glob.glob(os.path.join(seq, "images", "resized", "*.png"))
        n_labels = [len(glob.glob(os.path.join(seq, "terrain", k, "*.npy")))
                    for k in ("geom", "rigid")]
        loader_s = {name: [sum(p) / max(len(p), 1) for p in ld.passes]
                    for name, ld in zip(("train", "val"), loaders)}
        busy, wall = tr.warm or (0.0, 1.0)
        n_batches = [len(p) for p in loaders[0].passes]
        good = (finite and len(tr.step_s) == 2 and n_batches == [1, 1]
                and n_labels == [DISK_FRAMES, DISK_FRAMES] and labels_native
                and len(resized) == len(DISK_CAMS) * DISK_FRAMES)
        epochs = [(r["split"], round(r["epoch_loss_total"], 6)) for r in recs
                  if "epoch_loss_total" in r]
        _say(f"from disk train (scripts/train.py main: marv, 0.4 m, "
             f"{tr.dphys_cfg.traj_sim_time} s = {tr.dphys_cfg.n_sim_steps} "
             f"steps, {' '.join(DISK_TRAIN_ARGS)}): {len(tr.step_s)} steps in "
             f"{train_s:.1f} s; loader alone, s per batch of 24 train "
             f"samples: cold {loader_s['train'][0]:.3f}, warm "
             + (f"{loader_s['train'][1]:.3f}" if len(loader_s['train']) > 1
                else "-")
             + "; val batch of 2: "
             + ", ".join(f"{t:.3f}" for t in loader_s["val"])
             + "; s per train step (synchronised): "
             + ", ".join(f"{t:.3f}" for t in tr.step_s)
             + f" (the second under the profiler); s per epoch "
             f"{tr.epoch_s}; warm train epoch: card "
             f"busy {busy / 1e3:.3f} s of {wall / 1e3:.3f} s "
             f"({100 * busy / wall:.1f}%); peak memory {peak:.2f} GiB; "
             f"labels {n_labels} written by the "
             f"{'native host ops' if labels_native else 'NUMPY FALLBACK'}; "
             f"{len(resized)} resized images cached; prediction figures "
             f"{'drawn' if have_matplotlib() else 'skipped (no matplotlib)'}; "
             f"losses finite {finite}, epoch totals {epochs} "
             f"{'ok' if good else 'FAILED'} [{card}]")
        ok &= good

        # one more warm train step, outside the profiler
        batch = next(iter(loaders[0]))
        tr.train_step(tr._batch(batch), tr.generator)
        _say(f"from disk: one more warm train step, not profiled: "
             f"{tr.step_s[-1]:.3f} s; its batch loaded in "
             f"{loaders[0].passes[-1][0]:.3f} s [{card}]")
        del tr, batch
        gc.collect()        # the timed step's closure holds the trainer
        torch.cuda.empty_cache()

        # (b) scripts/eval.py's main over the val split
        t0 = time.perf_counter()
        means = eval_script.main(["--data_dir", os.path.join(root, "data"),
                                  "--checkpoint",
                                  os.path.join(log_dir, "val_best.pth"),
                                  "--out_dir", os.path.join(root, "eval"),
                                  *DISK_ARGS, *dev_arg])
        eval_s = time.perf_counter() - t0
        rows = open(os.path.join(root, "eval", "losses.csv")).read().split()
        good = (len(rows) == 3 and bool(means)
                and all(np.isfinite(list(means.values()))))
        _say(f"from disk eval (scripts/eval.py main, bsz 1, the 2 val "
             f"samples): {means} in {eval_s:.1f} s, {len(rows) - 1} rows "
             f"{'ok' if good else 'FAILED'}")
        ok &= good

        # (c) scripts/run.py's main from the trained checkpoint: the
        # checkpoint loads strictly into MonoForce, one tick at full width
        ckpt = os.path.join(log_dir, "train_best.pth")
        cfg = PhysicsConfig(robot="tradr")     # scripts/run.py's default
        robot = RobotModel.from_config(cfg, device=dev)
        mode = fast.planner_kernel_mode(robot, cfg.n_sim_trajs,
                                        uniform_friction=False)
        P = robot.points.shape[0]
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        terrain, plan = run_script.main(
            ["--seq_dir", seq, "--checkpoint", ckpt, "--out",
             os.path.join(root, "run.png"), *DISK_ARGS, *dev_arg])
        run_s = time.perf_counter() - t0
        counts = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
        for n, v in counts.items():
            launches[entry(n, P)] = launches.get(entry(n, P), 0) + v
        want = DISK_RUN_LAUNCHES
        finite = (all(bool(torch.isfinite(v).all()) for v in terrain.values())
                  and bool(torch.isfinite(plan.costs).all()))
        # the card's machine may lack matplotlib: then no figure is drawn
        drawn = os.path.exists(os.path.join(root, "run.png"))
        good = (mode == DISK_RUN_MODE and counts == want and finite
                and drawn == have_matplotlib())
        _say(f"from disk run (scripts/run.py main --seq_dir --checkpoint "
             f"train_best.pth: 4 x {LSSConfig().data_aug_conf['final_dim']}, "
             f"tradr P={P}, {cfg.n_sim_trajs} x {cfg.n_sim_steps}, mode "
             f"{mode}"
             + ("" if mode == DISK_RUN_MODE else f" WRONG, want {DISK_RUN_MODE}")
             + f"): launches {counts} "
             f"{'ok' if counts == want else 'WRONG, want ' + str(want)}; best "
             f"path {int(plan.best)}, costs finite {finite}; figure drawn "
             f"{drawn}; {run_s:.1f} s with the reader and the load "
             f"{'ok' if good else 'FAILED'} [{card}]")
        ok &= good
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

    results, launches = {}, {}
    ok = True
    for phase, fn in (("kernels", lambda: check_kernels(dev, results)),
                      ("oracles", lambda: check_oracles(dev, launches)),
                      ("main path", lambda: run_main_path(dev, launches)),
                      ("training", lambda: run_fit(dev, launches)),
                      ("online tick",
                       lambda: run_online_tick(dev, launches, card)),
                      ("exact engine",
                       lambda: run_exact_engine(dev, launches, card)),
                      ("train step",
                       lambda: run_train_step(dev, launches, card)),
                      ("navigation",
                       lambda: run_navigation(dev, launches, card)),
                      ("from disk",
                       lambda: run_from_disk(dev, launches, card))):
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
