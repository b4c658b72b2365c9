"""Visual dataset explorer (reference: utils.py:191-297 explore_data):
render camera images, heightmap labels and the GT trajectory of a sample
to a PNG for inspection.

Port of ``scripts/explore_data.py``.  The sample is host data (numpy), so
no device work runs; ``--device`` is checked like every entry point's.

    python -m monoforce_tpu_torch.scripts.explore_data --seq_dir DATA/ROUGH/SEQ
"""

from __future__ import annotations

import argparse

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)
from monoforce_tpu_torch.vis import explore_sample


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_dir", type=str, required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--robot", type=str, default="tradr")
    p.add_argument("--out", type=str, default="sample.png")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Draw the sample as the command line says; returns the figure's path."""
    args = parse_args(argv)
    resolve_device(args.device)
    if not have_matplotlib():
        raise SystemExit("explore_data draws its figure with matplotlib, "
                         "which is not installed")
    dphys_cfg = PhysicsConfig(robot=args.robot)
    ds = ROUGH(args.seq_dir, lss_cfg=lss_dict(LSSConfig()),
               dphys_cfg=dphys_cfg)
    print(f"sequence {ds.name}: {len(ds)} samples, cameras {ds.camera_names}")
    out = explore_sample(ds[args.index], d_max=dphys_cfg.d_max, path=args.out)
    print("saved", out)
    return out


if __name__ == "__main__":
    main()
