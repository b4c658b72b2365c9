"""Robot contact-geometry explorer (reference: explore_robot_meshes.ipynb).

Port of ``examples/explore_robot_contacts.py``.  The reference views the
raw OBJ meshes in open3d; this framework models robots as
voxel-downsampled contact-point clouds with geometric driving-part masks
(``robots.py``).  This example describes all three presets (or one OBJ
mesh) and renders them side by side with their driving parts coloured,
headless.  Host work only (numpy), so it takes no ``--device``.

    python -m monoforce_tpu_torch.examples.explore_robot_contacts \\
        [--voxel 0.11] [--out robots.png] [--mesh path/to/robot.obj]
"""

from __future__ import annotations

import argparse

import numpy as np

from monoforce_tpu_torch.robots import (driving_part_masks, load_obj_vertices,
                                        robot_point_cloud, voxel_downsample)
from monoforce_tpu_torch.scripts._common import have_matplotlib


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--voxel", type=float, default=0.11)
    p.add_argument("--mesh", default=None, help="optional OBJ to inspect")
    p.add_argument("--out", default="robots.png")
    return p.parse_args(argv)


def robot_clouds(voxel: float, mesh=None):
    """[(name, points (P, 3), part masks (K, P), (size x, size y))] for the
    three presets, or for the OBJ ``mesh`` (no masks: its parts are not
    known)."""
    if mesh:
        robots = [("mesh", voxel_downsample(load_obj_vertices(mesh), voxel))]
    else:
        robots = [(name, robot_point_cloud(name, voxel))
                  for name in ("tradr", "marv", "husky")]
    out = []
    for name, pts in robots:
        try:
            masks, size = driving_part_masks(name, pts)
        except ValueError:
            masks, size = np.zeros((0, len(pts)), bool), (0, 0)
        out.append((name, pts, masks, size))
    return out


def _figure(clouds, voxel, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6 * len(clouds), 5.5))
    colors = ["tab:red", "tab:blue", "tab:green", "tab:orange"]
    for i, (name, pts, masks, size) in enumerate(clouds):
        ax = fig.add_subplot(1, len(clouds), i + 1, projection="3d")
        body = ~masks.any(axis=0) if masks.size else np.ones(len(pts), bool)
        ax.scatter(pts[body, 0], pts[body, 1], pts[body, 2], s=12, c="gray",
                   label="body")
        for k in range(masks.shape[0]):
            m = masks[k]
            ax.scatter(pts[m, 0], pts[m, 1], pts[m, 2], s=16,
                       c=colors[k % 4], label=f"part {k}")
        ax.set_title(f"{name}: {len(pts)} pts @ {voxel} m voxel\n"
                     f"size {size[0]:.2f} x {size[1]:.2f} m")
        ax.legend(loc="upper left", fontsize=7)
        ax.set_box_aspect((1, 1, 0.5))
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """Describe the clouds; returns :func:`robot_clouds`' list."""
    args = parse_args(argv)
    clouds = robot_clouds(args.voxel, args.mesh)
    for name, pts, masks, size in clouds:
        print(f"{name}: {len(pts)} points at {args.voxel} m, size "
              f"{size[0]:.2f} x {size[1]:.2f} m, driving parts "
              f"{masks.sum(axis=1).tolist()} points")
    if have_matplotlib():
        _figure(clouds, args.voxel, args.out)
        print(args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return clouds


if __name__ == "__main__":
    main()
