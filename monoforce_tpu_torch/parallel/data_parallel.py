"""The data-parallel train step over a ``torch.distributed`` process group.

The counterpart of the JAX package's ``make_train_step`` jitted over a
batch sharded with ``shard_batch`` and a replicated state
(``monoforce_tpu/training/trainer.py:104-``, ``parallel/sharding.py``,
``__graft_entry__.py:107-236``).  There SPMD keeps the global-batch
semantics for free; here each rank holds a replica of the model and its
slice of the batch, and the step writes them out:

- **Global BatchNorm.**  :func:`global_batch_norm` turns the encoder's BN
  layers into :class:`GlobalBatchNorm2d`, whose train-mode mean and biased
  variance are taken over the global batch: the sum and the count, then
  the sum of squared deviations, are all-reduced with a differentiable
  all-reduce, whose backward all-reduces the cotangent, as the global
  statistics need.  The running statistics follow (flax's rule, as
  ``layers.BatchNorm2d``), so every rank keeps the same ones.
  ``nn.SyncBatchNorm`` refuses CPU tensors.
- **Ratio losses over the global batch.**  ``hm_loss`` divides by the count
  of NaN-free cells and ``physics_loss`` is a mean, so averaging the
  ranks' own means equals the global loss only when every rank counts the
  same.  Each rank's loss is its *share*: its own sum over the all-reduced
  global count (taken without gradient).  The shares sum to the global
  loss, so the gradients are summed over the ranks, not averaged: each
  rank's contribution counts once.  The losses returned are the global
  ones (the shares all-reduced).
- **The optimizer.**  The trainer's chain (``make_optimizer``: zero
  non-finite, clip by the global norm, weight decay, Adam), or any
  optimizer with ``zero_grad``/``step``, runs unchanged on the summed
  gradients, so every rank takes the same update.
- **Drop-connect masks.**  Each rank draws the masks of its own samples
  from the generator it passes: seed it per rank (``seed + rank``) for
  independent masks.  They are not the masks one process draws over the
  global batch, so a data-parallel step equals the single-process one at
  ``drop_connect_rate=0``.

The process group is the caller's: gloo on the CPU, and gloo also for
ranks that share one card (NCCL refuses two ranks on one GPU); NCCL with
one rank a card.  Gloo runs the all-reduce on CUDA tensors, the only
collective the step uses.  :func:`run_ranks` starts such a group of
processes on one host; with NCCL, rank r runs on card r.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from monoforce_tpu_torch.models.terrain_encoder.layers import BatchNorm2d
from monoforce_tpu_torch.models.terrain_encoder.lss import float32_math
from monoforce_tpu_torch.training.trainer import compute_losses

__all__ = ["GlobalBatchNorm2d", "global_batch_norm", "global_share",
           "global_losses", "make_dp_train_step", "run_ranks"]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangent over the group
    (``torch.distributed.nn.functional.all_reduce``'s rule, which torch
    2.13 deprecates with a warning at every call)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class GlobalBatchNorm2d(BatchNorm2d):
    """``layers.BatchNorm2d`` whose train-mode statistics are the global
    batch's over ``self.group`` (two all-reduces forward, two backward);
    eval mode is BatchNorm2d's."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # the statistics accumulate in float64, as torch's CPU batch norm
        # does, so that the shards' sums add up to the global batch's
        # statistics as closely as one process takes them
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        f64 = torch.float64
        stats = _AllReduceSum.apply(
            torch.cat([x.sum(dim=dims, dtype=f64),
                       x.new_tensor([float(n)], dtype=f64)]), self.group)
        count = stats[-1]
        mean = (stats[:-1] / count).to(x.dtype)
        d = x - mean[None, :, None, None]
        var = _AllReduceSum.apply((d * d).sum(dim=dims, dtype=f64),
                                  self.group) / count
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var.to(x.dtype),
                                             alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        # x * alpha + beta, torch's own form of the normalisation
        alpha = torch.rsqrt(var + self.eps).to(x.dtype) * self.weight
        beta = self.bias - mean * alpha
        return x * alpha[None, :, None, None] + beta[None, :, None, None]


def global_batch_norm(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """Turn every ``layers.BatchNorm2d`` of ``model`` into a
    :class:`GlobalBatchNorm2d` over ``group`` (the default group if None),
    in place: the parameters and buffers stay the same objects, so an
    optimizer built before keeps them.  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.group = group
    return model


def global_share(group=None):
    """``compute_losses``' ``mean`` for one rank: its own sum over the
    count all-reduced over ``group`` (taken without gradient), so that the
    ranks' shares sum to the global batch's loss."""
    def share(total, count):
        n = count.detach().to(total.device, torch.float64)
        dist.all_reduce(n, group=group)
        return total / torch.clamp(n, min=1).to(total.dtype)
    return share


def global_losses(aux: dict, group=None) -> dict:
    """The ranks' loss shares summed over ``group``: the global losses."""
    vals = torch.stack([v.detach() for v in aux.values()])
    dist.all_reduce(vals, group=group)
    return dict(zip(aux, vals.unbind()))


def make_dp_train_step(model, robot, optimizer, group=None,
                       geom_weight: float = 1.0, terrain_weight: float = 2.0,
                       phys_weight: float = 1.0, pool_k: int = 4):
    """``trainer.make_train_step`` for one rank of a data-parallel group.

    Converts ``model``'s BN layers with :func:`global_batch_norm`.  Every
    rank calls ``train_step(local_batch, generator)`` with its slice of the
    global batch (``shard_batch``'s parts, in rank order); each returns the
    global losses as 0-d tensors and leaves the same parameters and BN
    statistics on every rank.  ``eval_step(local_batch)`` returns the
    global eval-mode losses."""
    global_batch_norm(model, group)
    weights = dict(geom_weight=geom_weight, terrain_weight=terrain_weight,
                   phys_weight=phys_weight, pool_k=pool_k)
    share = global_share(group)

    def train_step(batch, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        # TF32 stays off over the backward too
        with float32_math():
            total, aux = compute_losses(model, robot, batch, True, generator,
                                        mean=share, **weights)
            total.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for g, s in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(s.view_as(g))
        optimizer.step()
        return global_losses(aux, group)

    def eval_step(batch):
        with torch.no_grad(), float32_math():
            _, aux = compute_losses(model, robot, batch, False, mean=share,
                                    **weights)
        return global_losses(aux, group)

    return train_step, eval_step


def _join(backend, rank, world, root, timeout):
    """Join the default group as ``rank`` over a ``FileStore`` under
    ``root``.  An NCCL rank selects its card first: NCCL builds its
    communicator on the current device, so without it every rank's would
    land on cuda:0.  Returns the rank's card: card ``rank`` under NCCL,
    None under gloo (the rank's function places its tensors)."""
    card = torch.device("cuda", rank) if backend == "nccl" else None
    kw = {}
    if card is not None:
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    return card


def _rank_main(fn, rank, world, backend, root, timeout, args):
    """One rank: join the group, run ``fn(rank, world, *args)``, and save
    its result (or its traceback)."""
    torch.set_num_threads(1)
    try:
        _join(backend, rank, world, root, timeout)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, args=(), backend: str = "gloo",
              timeout: float = 600.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form the default process group (``backend``, a ``FileStore`` in a
    temporary directory under ``workdir``); returns their results in rank
    order.  ``fn`` must be importable (a module's top-level function) and
    its results picklable by ``torch.save``.  Each rank uses one thread.
    Under ``"nccl"`` rank r runs on card r, and fewer
    cards than ranks raise here, before any rank starts.  The first rank
    to fail, or ``timeout`` seconds passing, ends every rank and raises."""
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f"NCCL runs one rank a card: {world} ranks asked for, {have} "
                f"cards available (use backend='gloo' for ranks that share a "
                f"card or run on the CPU)")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as root:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, root, timeout,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(pending)} of {world} ranks "
                                       f"still running after {timeout} s")
                multiprocessing.connection.wait([p.sentinel for p in pending],
                                                timeout=left)
                for p in [p for p in pending if not p.is_alive()]:
                    pending.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        err = os.path.join(root, f"rank{r}.err")
                        text = (open(err).read() if os.path.exists(err)
                                else "no traceback written")
                        raise RuntimeError(f"rank {r} of {world} exited with "
                                           f"code {p.exitcode}:\n{text}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           map_location="cpu") for r in range(world)]
