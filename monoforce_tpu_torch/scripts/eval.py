"""Evaluate a trained terrain encoder (reference: monoforce/scripts/eval.py).

Port of ``scripts/eval.py``: runs the ``Evaluator`` over the validation
split of the ROUGH sequences under ``--data_dir``, writes per-batch
heightmap and trajectory losses to ``<out_dir>/losses.csv`` and prints the
means.  ``--checkpoint`` takes a ``Trainer`` checkpoint (``.pth``, or a
full ``.pt``) or a reference ``.pth``, loaded strictly; without one the
encoder keeps its seeded weights.

    python -m monoforce_tpu_torch.scripts.eval --data_dir DATA \\
        --checkpoint runs/lss/val_best.pth
"""

from __future__ import annotations

import argparse

import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH, rough_seq_dirs
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.physics.engine import RobotModel, resolve_device
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)
from monoforce_tpu_torch.training.evaluator import Evaluator
from monoforce_tpu_torch.training.trainer import read_state_dict
from monoforce_tpu_torch.utils import NumpyLoader, compile_data


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--robot", type=str, default="marv")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--lss_cfg_path", type=str, default=None)
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--dphys_grid_res", type=float, default=0.4)
    p.add_argument("--traj_sim_time", type=float, default=5.0)
    p.add_argument("--out_dir", type=str, default="runs/eval")
    p.add_argument("--save_figures", action="store_true",
                   help="write the 3x4 per-batch diagnostic panels "
                        "(reference eval.py:159-265)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate as the command line says; returns the mean metrics."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.save_figures and not have_matplotlib():
        raise SystemExit("--save_figures needs matplotlib")
    dphys_cfg = PhysicsConfig(robot=args.robot, grid_res=args.dphys_grid_res,
                              traj_sim_time=args.traj_sim_time)
    lss_cfg = (LSSConfig.from_yaml(args.lss_cfg_path)
               if args.lss_cfg_path else LSSConfig())

    seqs = rough_seq_dirs(args.data_dir)

    def Data(path, is_train=False):
        return ROUGH(path, lss_cfg=lss_dict(lss_cfg), dphys_cfg=dphys_cfg,
                     is_train=is_train)

    _, val_ds = compile_data(seqs, Data)
    loader = NumpyLoader(val_ds, batch_size=args.bsz)

    model = LiftSplatShoot(lss_cfg.grid_conf, lss_cfg.data_aug_conf,
                           outC=lss_cfg.outC, camC=lss_cfg.camC,
                           downsample=lss_cfg.downsample).to(device)
    if args.checkpoint:
        model.load_state_dict(read_state_dict(args.checkpoint), strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(0))

    pool_k = int(round(dphys_cfg.grid_res / lss_cfg.grid_conf["xbound"][2]))
    ev = Evaluator(model, RobotModel.from_config(dphys_cfg, device=device),
                   pool_k, out_dir=args.out_dir)
    means = ev.run(loader, save_figures=args.save_figures,
                   d_max=float(dphys_cfg.d_max))
    print(means)
    return means


if __name__ == "__main__":
    main()
