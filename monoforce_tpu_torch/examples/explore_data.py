"""ROUGH data exploration example
(reference: examples/explore_data_rgb_rigid_terrain.ipynb).

Port of ``examples/explore_data.py``: loads one sample of a ROUGH sequence
and renders what the notebook shows: the RGB camera images, the
rigid-terrain heightmap label, the labeled-area mask, and the robot
trajectory overlaid on the grid (notebook cells 6-10; the ``%matplotlib``
viewer replaced by a saved headless figure).  ``--sequence`` is required;
the encoder's settings are the port's ``LSSConfig()`` defaults, or
``--lss_cfg_path``.  Host work only (numpy and PIL), so it takes no
``--device``.

    python -m monoforce_tpu_torch.examples.explore_data --sequence PATH \\
        [--robot marv] [--index 0] [--out explore_data.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH
from monoforce_tpu_torch.datasets.augment import denormalize_img
from monoforce_tpu_torch.scripts._common import have_matplotlib, lss_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence", default=None, help="ROUGH sequence dir")
    p.add_argument("--lss_cfg_path", default=None,
                   help="LSS config YAML (defaults to the built-in config)")
    p.add_argument("--robot", default="marv", choices=["marv", "tradr"])
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="explore_data.png")
    args = p.parse_args(argv)
    if args.sequence is None:
        raise SystemExit("no --sequence given: name a ROUGH sequence "
                         "directory")
    return args


def load(sequence, robot: str, index: int, lss_cfg: LSSConfig):
    """(the dataset, the sample's index, its 16-tuple, the trajectory's
    grid rows and columns)."""
    lss = lss_dict(lss_cfg)
    ds = ROUGH(sequence, lss_cfg=lss, dphys_cfg=PhysicsConfig(robot=robot))
    i = index % len(ds)
    sample = ds[i]
    grid_res = lss["grid_conf"]["xbound"][2]
    H, W = sample[7].shape[1:]
    poses = ds.get_traj(i)["poses"]
    return (ds, i, sample, poses[:, 0, 3] / grid_res + H // 2,
            poses[:, 1, 3] / grid_res + W // 2)


def _figure(ds, sample, x_grid, y_grid, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs, hm_geom, hm_terrain = sample[0], sample[6], sample[7]
    n_cams = imgs.shape[0]
    cols = max(n_cams, 3)
    fig, axes = plt.subplots(2, cols, figsize=(4.2 * cols, 8))
    for c in range(n_cams):
        axes[0, c].imshow(denormalize_img(imgs[c]))
        axes[0, c].set_title(ds.camera_names[c])
        axes[0, c].axis("off")
    for c in range(n_cams, cols):
        axes[0, c].axis("off")
    im = axes[1, 0].imshow(hm_terrain[0], cmap="terrain", origin="lower")
    axes[1, 0].plot(y_grid, x_grid, "r-", lw=1.5, label="trajectory")
    axes[1, 0].set_title("terrain heightmap label")
    axes[1, 0].legend(loc="upper right")
    fig.colorbar(im, ax=axes[1, 0], shrink=0.8, label="z [m]")
    axes[1, 1].imshow(hm_terrain[1], cmap="gray", origin="lower")
    axes[1, 1].plot(y_grid, x_grid, "r-", lw=1.5)
    axes[1, 1].set_title("labeled-area mask (traj footprint)")
    im = axes[1, 2].imshow(hm_geom[0], cmap="terrain", origin="lower")
    axes[1, 2].set_title("geom heightmap (lidar max-z)")
    fig.colorbar(im, ax=axes[1, 2], shrink=0.8, label="z [m]")
    for c in range(3, cols):
        axes[1, c].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """Load and describe the sample; returns it (the 16-tuple)."""
    args = parse_args(argv)
    lss_cfg = (LSSConfig.from_yaml(args.lss_cfg_path) if args.lss_cfg_path
               else LSSConfig())
    ds, i, sample, x_grid, y_grid = load(args.sequence, args.robot,
                                         args.index, lss_cfg)
    print(f"sequence: {args.sequence}  ({len(ds)} samples; showing {i})")
    imgs, hm_terrain = sample[0], sample[7]
    print(f"RGB images: {imgs.shape}  (N cams, C, H, W)")
    print(f"terrain heightmap + mask: {hm_terrain.shape}")
    print(f"grid: {hm_terrain.shape[1]}x{hm_terrain.shape[2]} at "
          f"{ds.grid_res} m; trajectory: {len(x_grid)} poses, "
          f"{int(np.asarray(hm_terrain[1]).sum())} labeled cells")
    if have_matplotlib():
        _figure(ds, sample, x_grid, y_grid, args.out)
        print(args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return sample


if __name__ == "__main__":
    main()
