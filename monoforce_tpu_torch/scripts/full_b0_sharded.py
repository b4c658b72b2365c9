"""The full EfficientNet-B0 train step under data parallelism.

Port of ``scripts/full_b0_sharded.py``: the production encoder (the whole
B0 trunk, the default Up fusion and /16 reduction) at the JAX script's tiny
image and grid geometry (``__graft_entry__._tiny_cfgs``: two 32 x 64
cameras, a 3.2 m BEV grid at 0.1 m, tradr at 0.4 m over 0.3 s), a seeded
synthetic batch of 2 samples per rank, and the production optimizer chain
(``make_optimizer(1e-4)``: zero non-finite, clip 1.0, weight decay, Adam),
for two data-parallel steps.  ``--world`` ranks are spawned over a
``FileStore`` in a temporary directory (``parallel.run_ranks``), each with
its slice of the global batch and ``parallel.make_dp_train_step``.

Checks: the losses are finite, the parameters moved and are finite, every
rank holds the same parameters and BN statistics, and the chain opens with
``zero_non_finite`` (on a random initialisation the 30-step stiff-contact
BPTT can emit a non-finite gradient entry, which plain Adam would write
into the parameters).  Prints timed phase lines.

    python -m monoforce_tpu_torch.scripts.full_b0_sharded --world 8 \\
        --device cpu
    python -m monoforce_tpu_torch.scripts.full_b0_sharded --world 2

Ranks on one card share it over gloo; ``--backend nccl --device cuda``
runs rank r on card r and needs a card per rank:

    python -m monoforce_tpu_torch.scripts.full_b0_sharded --world 4 \\
        --backend nccl --device cuda

The module also holds the tiny configuration, the synthetic batch and the
per-rank function, :func:`train_rank`, that the data-parallel
equivalence check runs with SGD.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.parallel.data_parallel import (make_dp_train_step,
                                                        run_ranks)
from monoforce_tpu_torch.parallel.sharding import make_mesh, shard_batch
from monoforce_tpu_torch.physics.engine import RobotModel, resolve_device
from monoforce_tpu_torch.scripts._common import add_device_arg
from monoforce_tpu_torch.training.trainer import (make_optimizer,
                                                  make_train_step)

__all__ = ["tiny_configs", "synthetic_batch", "train_rank", "main"]

SAMPLES_PER_RANK = 2
STEPS = 2
SEED = 0
LR = 1e-4
DROP_CONNECT_RATE = 0.2
# the equivalence check: one SGD step, so that the parameters' change is
# the gradient (Adam's first step, ~lr * sign(g), turns rounding noise on
# near-zero gradients into 2 lr sign flips: tests/test_parallel.py:93-97),
# drop-connect off (the ranks draw their masks each from its own seed)
CHECK_LR = 1e-2


def tiny_configs():
    """(LSSConfig, PhysicsConfig) of ``__graft_entry__._tiny_cfgs``."""
    lss = LSSConfig(
        data_aug_conf={"H": 64, "W": 128, "final_dim": (32, 64),
                       "resize_lim": (0.5, 0.55), "bot_pct_lim": (0.0, 0.0),
                       "rot_lim": (-3.0, 3.0), "rand_flip": False},
        grid_conf={"xbound": (-1.6, 1.6, 0.1), "ybound": (-1.6, 1.6, 0.1),
                   "zbound": (-3.2, 3.2, 6.4), "dbound": (0.6, 2.2, 0.4)})
    dphys = PhysicsConfig(robot="tradr", grid_res=0.4, traj_sim_time=0.3)
    dphys.d_max = 1.6
    return lss, dphys


def synthetic_batch(dphys: PhysicsConfig, B: int, seed: int = 0,
                    n_cams: int = 2, hw=(32, 64), nan_fracs=None):
    """The ROUGH loader's 16-tuple of numpy arrays drawn as the JAX
    script's batch (``_fake_inputs`` and its labels, controls and poses):
    images, identity camera rotations at the origin with a 60 px focal
    length, (height, weight) labels on the 32 x 32 BEV grid, controls over
    the simulated time, identity initial poses and ground-truth positions
    at 0.1 s.  ``nan_fracs[b]``, where given, is the share of sample b's
    label cells (both maps) that are NaN."""
    rng = np.random.default_rng(seed)
    h, w = hw
    G = int(round(2 * dphys.d_max / 0.1))
    t_sim = dphys.traj_sim_time
    n_ctrl = dphys.n_sim_steps
    n_traj = int(np.ceil(t_sim / 0.1))
    f32 = np.float32
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1.0]], f32)
    eye3 = np.broadcast_to(np.eye(3, dtype=f32), (B, n_cams, 3, 3))
    batch = [rng.normal(size=(B, n_cams, 3, h, w)).astype(f32),
             eye3.copy(), np.zeros((B, n_cams, 3), f32),
             np.broadcast_to(K, (B, n_cams, 3, 3)).copy(), eye3.copy(),
             np.zeros((B, n_cams, 3), f32),
             rng.normal(size=(B, 2, G, G)).astype(f32),
             rng.normal(size=(B, 2, G, G)).astype(f32),
             np.tile(np.linspace(0, t_sim, n_ctrl, dtype=f32), (B, 1)),
             rng.uniform(-1, 1, (B, n_ctrl, 2)).astype(f32),
             np.tile(np.eye(4, dtype=f32), (B, 1, 1)),
             np.tile(np.linspace(0, t_sim, n_traj, dtype=f32), (B, 1)),
             rng.normal(size=(B, n_traj, 3)).astype(f32),
             np.zeros((B, n_traj, 3), f32),
             np.tile(np.eye(3, dtype=f32), (B, n_traj, 1, 1)),
             np.zeros((B, n_traj, 3), f32)]
    if nan_fracs is not None:
        for b, frac in enumerate(nan_fracs):
            for hm in (batch[6], batch[7]):
                cells = rng.uniform(size=(G, G)) < frac
                hm[b, 0][cells] = np.nan
    return tuple(batch)


def _rank_device(device: str, rank: int) -> torch.device:
    """A device type spreads the ranks over the cards; a specific device
    (``cuda:0``, ``cpu``) holds them all."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_rank(rank: int, world: int, device: str, batch: int,
               check: bool = False, nan_fracs=None,
               dtype: str = "float32") -> dict:
    """Train steps of the tiny-geometry B0 model on this rank's slice of
    the seeded global batch of ``batch`` samples: the data-parallel step
    when ``world > 1`` (inside a process group), else the single-process
    ``make_train_step`` on the whole batch.  The script's run: ``STEPS``
    steps with ``make_optimizer(LR)`` and drop-connect; with ``check``, the
    equivalence check's: one SGD step at ``CHECK_LR`` with drop-connect
    off, the model's state_dict returned on the CPU.  ``nan_fracs``: see
    :func:`synthetic_batch`.  ``dtype`` (``"float32"`` or ``"float64"``)
    is the model's, the robot's and the batch's.  Returns the losses of
    each step, its seconds, whether the parameters moved and are finite, a
    digest of the parameters and buffers, and the names of the optimizer's
    stages."""
    dev = _rank_device(device, rank)
    dt = getattr(torch, dtype)
    lss, dphys = tiny_configs()
    model = LiftSplatShoot(
        lss.grid_conf, lss.data_aug_conf,
        drop_connect_rate=0.0 if check else DROP_CONNECT_RATE)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to(dev, dt)
    robot = RobotModel.from_config(dphys, device=dev, dtype=dt)
    if check:
        optimizer = torch.optim.SGD(model.parameters(), lr=CHECK_LR)
        stages = ["sgd"]
    else:
        optimizer = make_optimizer(LR)(model.parameters())
        stages = [name for name, _ in optimizer.stages()]
    parts = shard_batch(tuple(torch.as_tensor(a, dtype=dt) for a in
                              synthetic_batch(dphys, batch, SEED,
                                              nan_fracs=nan_fracs)),
                        make_mesh(world, device=dev))
    local = tuple(p.shards[rank] for p in parts)
    make = make_dp_train_step if world > 1 else make_train_step
    train_step, _ = make(model, robot, optimizer, pool_k=4)
    before = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    losses, seconds = [], []
    for _ in range(1 if check else STEPS):
        t0 = time.perf_counter()
        aux = train_step(local, gen)
        losses.append({k: float(v) for k, v in aux.items()})
        seconds.append(time.perf_counter() - t0)
    params = list(model.parameters())
    out = dict(
        losses=losses, seconds=seconds, stages=stages, device=str(dev),
        n_params=sum(p.numel() for p in params),
        moved=any(not torch.equal(a, b) for a, b in zip(before, params)),
        finite=all(bool(torch.isfinite(p).all()) for p in params),
        digest=_digest(model.state_dict()))
    if check:
        out["state"] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=8,
                   help="data-parallel ranks (the JAX script's N_DEVICES)")
    p.add_argument("--backend", type=str, default="gloo",
                   help="torch.distributed backend: gloo, or nccl with "
                        "--device cuda (rank r on card r; needs a card "
                        "per rank)")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds before the ranks are ended and the run "
                        "fails")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run and check the data-parallel full-B0 steps; returns rank 0's
    result with the seconds of the whole run and every rank's device.
    Raises AssertionError when a check fails."""
    args = parse_args(argv)
    resolve_device(args.device)
    t0 = time.time()

    def _log(msg: str) -> None:
        print(f"[full_b0 +{time.time() - t0:7.1f}s] {msg}", flush=True)

    batch = SAMPLES_PER_RANK * args.world
    _log(f"spawning {args.world} ranks ({args.backend}, {args.device}): the "
         f"full-B0 train step at the tiny geometry, global batch {batch}, "
         f"make_optimizer({LR:g}), {STEPS} steps")
    results = run_ranks(train_rank, args.world, (args.device, batch),
                        backend=args.backend, timeout=args.timeout)
    res = results[0]
    _log(f"ranks done on {sorted({r['device'] for r in results})}: "
         f"{res['n_params']:,} params (full B0 trunk)")
    for i, (aux, s) in enumerate(zip(res["losses"], res["seconds"])):
        _log(f"step {i + 1}: {s:.2f} s on rank 0, loss={aux['total']:.6f} ("
             + ", ".join(f"{k}={v:.4f}" for k, v in sorted(aux.items()))
             + ")")
    assert all(np.isfinite(a["total"]) for a in res["losses"]), res["losses"]
    assert res["moved"], "the train steps left every parameter unchanged"
    assert res["finite"], "an update wrote non-finite parameters"
    assert res["stages"][0] == "zero_non_finite", (
        f"the chain's stages are {res['stages']}")
    digests = {r["digest"] for r in results}
    assert len(digests) == 1, "the ranks hold different parameters"
    _log("FULL-B0 data-parallel train step: losses finite, params moved and "
         "finite, the same on every rank, the chain opens with "
         "zero_non_finite -- all assertions passed")
    res["run_seconds"] = time.time() - t0
    res["devices"] = [r["device"] for r in results]
    return res


if __name__ == "__main__":
    main()
