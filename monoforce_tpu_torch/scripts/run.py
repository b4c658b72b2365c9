"""Single-shot end-to-end inference (reference: monoforce/scripts/run.py):
images + calibration -> LSS terrain -> shoot sampled controls -> visualize
the paths and the selected one.

Port of ``scripts/run.py``.  The frame comes from a ROUGH sequence
(``--seq_dir``, ``--index``) or from image files with a calibration
directory (``--img-paths``, ``--calibration-path``, ``--cameras``).
``--checkpoint`` takes a ``Trainer`` checkpoint (``.pth``, or a full
``.pt``) or a reference ``.pth`` state_dict, loaded strictly into
``MonoForce``; without one the encoder gets seeded weights.

    python -m monoforce_tpu_torch.scripts.run --seq_dir DATA/ROUGH/SEQ \\
        --checkpoint runs/lss/train_best.pth
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH
from monoforce_tpu_torch.datasets.augment import (img_transform,
                                                  normalize_img,
                                                  sample_augmentation)
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)
from monoforce_tpu_torch.training.trainer import read_state_dict
from monoforce_tpu_torch.utils.io import load_calib
from monoforce_tpu_torch.vis import plot_terrain_with_trajs


def _inputs_from_images(img_paths, calib_path, cameras, lss_cfg):
    """Build the six LSS input arrays straight from image files +
    a calibration directory -- the reference run.py CLI contract
    (reference scripts/run.py:91-131: val augmentation on the RAW image,
    per-camera K, extrinsics ``T_base_link__<cam>`` with NO gravity
    alignment)."""
    calib = load_calib(calib_path)
    if calib is None:
        raise SystemExit(f"no camera calibration found under {calib_path}")
    if cameras is None:
        cameras = sorted(k for k in calib if k.startswith("camera_")
                         and k != "camera_up")
    if len(cameras) != len(img_paths):
        raise SystemExit(f"{len(img_paths)} images for {len(cameras)} "
                         f"cameras ({cameras})")

    aug_cfg = {"data_aug_conf": lss_cfg.data_aug_conf,
               "grid_conf": lss_cfg.grid_conf}
    imgs, rots, trans, intrins, post_rots, post_trans = [], [], [], [], [], []
    for cam, img_path in zip(cameras, img_paths):
        K = np.asarray(calib[cam]["camera_matrix"]["data"],
                       dtype=np.float32).reshape(3, 3)
        aug = sample_augmentation(aug_cfg, is_train=False)
        with Image.open(img_path) as img:
            img, post_rot2, post_tran2 = img_transform(
                img, np.eye(2, dtype=np.float32),
                np.zeros(2, dtype=np.float32), *aug)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, dtype=np.float32)
        post_rot[:2, :2] = post_rot2
        post_tran[:2] = post_tran2
        E = np.asarray(calib["transformations"][f"T_base_link__{cam}"]["data"],
                       dtype=np.float32).reshape(4, 4)
        imgs.append(normalize_img(img))
        rots.append(E[:3, :3])
        trans.append(E[:3, 3])
        intrins.append(K)
        post_rots.append(post_rot)
        post_trans.append(post_tran)
    return [np.stack(a).astype(np.float32) for a in
            (imgs, rots, trans, intrins, post_rots, post_trans)]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_dir", type=str, default=None,
                   help="one ROUGH sequence directory")
    p.add_argument("--img-paths", type=str, nargs="+", default=None,
                   help="input RGB image paths (reference run.py CLI mode; "
                        "use with --calibration-path)")
    p.add_argument("--calibration-path", type=str, default=None,
                   help="calibration dir with cameras/*.yaml + "
                        "transformations.yaml")
    p.add_argument("--cameras", type=str, nargs="+", default=None,
                   help="camera names matching --img-paths order")
    p.add_argument("--lss_cfg_path", type=str, default=None,
                   help="LSS config YAML (defaults to built-in config)")
    p.add_argument("--lss_preset", type=str, default="default",
                   choices=("default", "resize"),
                   help="named encoder geometry: 'default' (lss_cfg.yaml) "
                        "or 'resize' (the online 480x300 "
                        "lss_cfg_resize.yaml / img_preproc.launch pipeline)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--robot", type=str, default="tradr")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--n_trajs", type=int, default=64)
    p.add_argument("--half", action="store_true",
                   help="serving precision: bf16 camera encoder (the BEV "
                        "encoder and the heads stay float32)")
    p.add_argument("--out", type=str, default="run_result.png")
    add_device_arg(p)
    args = p.parse_args(argv)
    if (args.seq_dir is None) == (args.img_paths is None):
        p.error("exactly one of --seq_dir or --img-paths is required")
    if args.img_paths is not None and args.calibration_path is None:
        p.error("--img-paths needs --calibration-path")
    return args


def main(argv=None):
    """One tick as the command line says; returns (terrain, plan)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dphys_cfg = PhysicsConfig(robot=args.robot)
    dphys_cfg.n_sim_trajs = args.n_trajs
    lss_cfg = (LSSConfig.from_yaml(args.lss_cfg_path)
               if args.lss_cfg_path else LSSConfig.preset(args.lss_preset))
    if args.img_paths is not None:
        data = _inputs_from_images(args.img_paths, args.calibration_path,
                                   args.cameras, lss_cfg)
    else:
        ds = ROUGH(args.seq_dir, lss_cfg=lss_dict(lss_cfg),
                   dphys_cfg=dphys_cfg)
        data = ds.get_images_data(args.index)

    mf = MonoForce(dphys_cfg=dphys_cfg, lss_cfg=lss_cfg, half=args.half,
                   device=device)
    if args.checkpoint:
        mf.load_state_dict(read_state_dict(args.checkpoint))
    else:
        mf.init_params()

    terrain, plan = mf.run(*(a[None] for a in data))
    best = int(plan.best)
    print(f"best path: {best}  cost: {float(plan.costs[best]):.4f}")
    if have_matplotlib():
        out = plot_terrain_with_trajs(terrain["terrain"][0, 0], plan.xs,
                                      plan.costs, dphys_cfg.d_max, best=best,
                                      path=args.out)
        print("saved", out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return terrain, plan


if __name__ == "__main__":
    main()
