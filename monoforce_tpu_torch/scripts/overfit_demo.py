"""Training convergence: overfit one batch from a fresh initialisation.

Port of ``scripts/overfit_demo.py``.  The trainer's purpose is that the
loss falls and the terrain predictions approach the labels (reference:
monoforce/scripts/train.py:187-226).  This script overfits the first batch
of a ROUGH sequence for ``--steps`` train steps and writes the per-step
losses to ``<out>/losses.jsonl`` (and, where matplotlib is present, the
curve to ``<out>/loss_curve.png``) with a ``summary.json``.

With ``--staged WARM_STEPS`` it follows the reference's staged production
recipe (train.sh:8-17): WARM_STEPS heightmap-only steps at ``--lr`` (the
role of the pretrained ``val.pth`` the reference starts from), then
``--steps`` steps with the physics term from that initialisation at
``--lr2`` (the production lr 1e-4, train.sh:11).  :func:`staged_gates`
holds such a run to the JAX test's gates
(tests/test_trainer.py::test_overfit_converges): the warm total falls 5x
and its terrain and geom losses fall; the physics stage has no 3x spike,
and its physics and total losses fall 2x.

The data is a ROUGH sequence, ``--sequence DIR`` with ``--lss_cfg_path``
(the JAX script's synthetic mode draws it from the tests' fixtures; its
``--real ROBOT`` mode reads the reference's data sample: here that is a
``--sequence`` with ``--robot``, ``--traj_sim_time 5.0``, ``--bsz 1``).

    python -m monoforce_tpu_torch.scripts.overfit_demo --sequence SEQ \\
        --lss_cfg_path cfg.yaml --staged 30 --steps 30 --out runs/overfit
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)
from monoforce_tpu_torch.training import Trainer
from monoforce_tpu_torch.utils import NumpyLoader

__all__ = ["main", "staged_gates"]

KEYS = ("total", "geom", "terrain", "phys")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sequence", type=str, required=True,
                   help="ROUGH sequence directory")
    p.add_argument("--lss_cfg_path", type=str, default=None)
    p.add_argument("--robot", type=str, default="tradr")
    p.add_argument("--traj_sim_time", type=float, default=1.0)
    p.add_argument("--bsz", type=int, default=2)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr2", type=float, default=1e-4,
                   help="the physics stage's lr with --staged "
                        "(reference train.sh:11)")
    p.add_argument("--staged", type=int, default=0, metavar="WARM_STEPS",
                   help="heightmap-only warm-up steps at --lr before --steps "
                        "steps with the physics term at --lr2")
    p.add_argument("--phys-weight", type=float, default=1.0)
    p.add_argument("--terrain-weight", type=float, default=2.0,
                   help="train.py:35 default 2.0; train.sh:13 uses 3.0")
    p.add_argument("--dphys_grid_res", type=float, default=0.4,
                   help="the physics runs on the heightmap pooled to this "
                        "resolution (train.py:38,96-99)")
    p.add_argument("--save-ckpt", type=str, default=None, metavar="PATH",
                   help="write the final model's state_dict there (a "
                        ".pth that scripts/eval.py --checkpoint reads)")
    p.add_argument("--out", type=str, default="runs/overfit")
    add_device_arg(p)
    return p.parse_args(argv)


def staged_gates(rows, warm_steps: int) -> dict:
    """The JAX test's gates on a staged run's rows: {gate: passed}.  Each
    stage's first row holds the losses before its first update."""
    warm, phys = rows[:warm_steps], rows[warm_steps:]
    w0, p0 = warm[0], phys[0]

    def last_min(stage, k):
        return min(r[k] for r in stage[-5:])

    return {
        "warm total falls 5x": last_min(warm, "total") < w0["total"] / 5.0,
        "warm terrain falls": last_min(warm, "terrain") < w0["terrain"],
        "warm geom falls": last_min(warm, "geom") < w0["geom"],
        "phys stage finite": all(np.isfinite(r["total"]) for r in phys),
        "phys stage no 3x spike": max(r["total"] for r in phys)
        < 3.0 * p0["total"],
        "phys falls 2x": last_min(phys, "phys") < p0["phys"] / 2.0,
        "phys stage total falls 2x": last_min(phys, "total")
        < p0["total"] / 2.0,
    }


def _plot(rows, args, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.2))
    steps = [r["step"] for r in rows]
    for k in KEYS:
        ax.plot(steps, [max(r[k], 1e-8) for r in rows], label=k)
    if args.staged:
        ax.axvline(args.staged - 0.5, color="k", ls="--", alpha=0.5)
    ax.set_yscale("log")
    ax.set_xlabel("train step")
    ax.set_ylabel("loss")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    """Overfit as the command line says; returns the summary, with every
    row and each stage's first and median seconds per step."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    lss_cfg = (LSSConfig.from_yaml(args.lss_cfg_path)
               if args.lss_cfg_path else LSSConfig())
    dphys = PhysicsConfig(robot=args.robot, grid_res=args.dphys_grid_res,
                          traj_sim_time=args.traj_sim_time)
    ds = ROUGH(args.sequence, lss_cfg=lss_dict(lss_cfg), dphys_cfg=dphys)
    loader = NumpyLoader(ds, batch_size=args.bsz, drop_last=True)
    os.makedirs(args.out, exist_ok=True)
    rows, seconds = [], {}

    def trainer(lr, phys_weight, name):
        t = Trainer(dphys_cfg=dphys, lss_cfg=lss_cfg, lr=lr,
                    terrain_weight=args.terrain_weight,
                    phys_weight=phys_weight,
                    log_dir=os.path.join(args.out, name), device=device)
        t.init_state(seed=0)
        return t

    def run_stage(t, batch, steps, stage):
        for i in range(steps):
            t0 = time.perf_counter()
            aux = t.train_step(batch, t.generator)
            # reading the losses waits for the step's work on the device
            vals = dict(zip(aux, torch.stack(list(aux.values())).tolist()))
            rows.append({"step": len(rows), "stage": stage,
                         **{k: vals[k] for k in KEYS},
                         "seconds": time.perf_counter() - t0})
            if i % 25 == 0 or i == steps - 1:
                print(f"{stage} {i:4d}  " + "  ".join(
                    f"{k}={rows[-1][k]:.4f}" for k in KEYS))
        times = sorted(r["seconds"] for r in rows if r["stage"] == stage)
        seconds[stage] = {"first": rows[-steps]["seconds"],
                          "median": times[len(times) // 2]}

    if args.staged:
        # stage 1: heightmap-only warm-up (the pretrained-encoder surrogate,
        # reference train.sh:13-17)
        warm = trainer(args.lr, 0.0, "warm")
        batch = warm._batch(next(iter(loader)))
        run_stage(warm, batch, args.staged, "warm")
        # stage 2: the physics term from the warm weights at the
        # production lr (reference train.sh:11), a fresh optimizer
        t = trainer(args.lr2, args.phys_weight, "run")
        t.model.load_state_dict(warm.model.state_dict())
        run_stage(t, batch, args.steps, "phys")
    else:
        t = trainer(args.lr, args.phys_weight, "run")
        batch = t._batch(next(iter(loader)))
        run_stage(t, batch, args.steps, "train")

    with open(os.path.join(args.out, "losses.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    if have_matplotlib():
        _plot(rows, args, os.path.join(args.out, "loss_curve.png"))
    first, last = rows[0], rows[-1]
    print(f"total: {first['total']:.4f} -> {last['total']:.4f} "
          f"({first['total'] / max(last['total'], 1e-9):.1f}x)")
    summary = {"steps": args.steps, "lr": args.lr,
               "phys_weight": args.phys_weight, "data": args.sequence,
               "device": str(device),
               "first": {k: first[k] for k in KEYS},
               "final": {k: last[k] for k in KEYS},
               "improvement_x": first["total"] / max(last["total"], 1e-9),
               "seconds_per_step": seconds}
    if args.staged:
        phys = rows[args.staged:]
        summary["staged"] = {
            "warm_steps": args.staged, "warm_lr": args.lr,
            "phys_steps": args.steps, "phys_lr": args.lr2,
            "phys_first": {k: phys[0][k] for k in KEYS},
            "phys_final": {k: phys[-1][k] for k in KEYS},
            "phys_term_improvement_x": phys[0]["phys"]
            / max(phys[-1]["phys"], 1e-9),
            "phys_stage_max_total": max(r["total"] for r in phys),
            "gates": staged_gates(rows, args.staged)}
        print(f"phys term: {phys[0]['phys']:.4f} -> {phys[-1]['phys']:.4f} "
              f"({summary['staged']['phys_term_improvement_x']:.1f}x), max "
              f"total in phys stage "
              f"{summary['staged']['phys_stage_max_total']:.4f}")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if args.save_ckpt:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_ckpt)),
                    exist_ok=True)
        torch.save(t.model.state_dict(), args.save_ckpt)
        print(f"saved checkpoint -> {args.save_ckpt}")
    summary["rows"] = rows
    return summary


if __name__ == "__main__":
    main()
