"""Train the terrain encoder end-to-end with the differentiable-physics loss.

Port of ``scripts/train.py``; reference parity: monoforce/scripts/train.py
CLI (defaults at train.py:23-40; production hyperparameters in
scripts/train.sh: bsz 24, terrain weight 3.0, phys weight 4.0).  The ROUGH
sequences under ``--data_dir`` go through ``compile_data``'s seeded split
and ``NumpyLoader``, which loads each batch between steps, into the
``Trainer``.  Unlike the JAX script, no batch is drawn before training:
the port's ``Trainer.init_state`` needs no example batch.

    python -m monoforce_tpu_torch.scripts.train --data_dir DATA --bsz 24 \\
        --terrain_weight 3.0 --phys_weight 4.0
"""

from __future__ import annotations

import argparse
import os

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH, rough_seq_dirs
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)
from monoforce_tpu_torch.training import Trainer
from monoforce_tpu_torch.utils import NumpyLoader, compile_data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the MonoForce LSS model")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory containing ROUGH/<sequence> dirs")
    p.add_argument("--bsz", type=int, default=4)
    p.add_argument("--nepochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--robot", type=str, default="marv")
    p.add_argument("--lss_cfg_path", type=str, default=None)
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--debug", action="store_true", help="small datasets")
    p.add_argument("--geom_weight", type=float, default=1.0)
    p.add_argument("--terrain_weight", type=float, default=2.0)
    p.add_argument("--phys_weight", type=float, default=1.0)
    p.add_argument("--traj_sim_time", type=float, default=5.0)
    p.add_argument("--dphys_grid_res", type=float, default=0.4)
    p.add_argument("--log_dir", type=str, default="runs/lss")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    """Train as the command line says; returns the trained ``Trainer``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dphys_cfg = PhysicsConfig(robot=args.robot, grid_res=args.dphys_grid_res,
                              traj_sim_time=args.traj_sim_time)
    lss_cfg = (LSSConfig.from_yaml(args.lss_cfg_path)
               if args.lss_cfg_path else LSSConfig())

    seqs = rough_seq_dirs(args.data_dir)
    if not seqs:
        raise SystemExit(f"no ROUGH sequences under {args.data_dir}")

    def Data(path, is_train=False):
        return ROUGH(path, lss_cfg=lss_dict(lss_cfg), dphys_cfg=dphys_cfg,
                     is_train=is_train)

    train_ds, val_ds = compile_data(seqs, Data, small_data=args.debug)
    train_loader = NumpyLoader(train_ds, batch_size=args.bsz, shuffle=True)
    val_loader = NumpyLoader(val_ds, batch_size=args.bsz)

    trainer = Trainer(dphys_cfg=dphys_cfg, lss_cfg=lss_cfg, lr=args.lr,
                      geom_weight=args.geom_weight,
                      terrain_weight=args.terrain_weight,
                      phys_weight=args.phys_weight, log_dir=args.log_dir,
                      pretrained=args.pretrained_model_path, device=device)
    # config snapshots (train.py:188-190)
    dphys_cfg.to_yaml(os.path.join(args.log_dir, "dphys_cfg.yaml"))
    lss_cfg.to_yaml(os.path.join(args.log_dir, "lss_cfg.yaml"))

    trainer.init_state()
    # the per-epoch prediction figure needs matplotlib
    trainer.train(train_loader, val_loader, n_epochs=args.nepochs,
                  save_figures=have_matplotlib())
    return trainer


if __name__ == "__main__":
    main()
