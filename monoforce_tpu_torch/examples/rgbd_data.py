"""RGBD exploration example (reference: examples/rgbd_data.ipynb).

Port of ``examples/rgbd_data.py``: loads an RGB + depth frame pair from a
ROUGH sequence's ``luxonis`` folder (or synthesizes one), back-projects the
depth image to a camera-frame point cloud with the camera intrinsics
(``datasets.camera.depth_to_cloud``), and draws a summary figure, headless
(the notebook's open3d viewer replaced).  Host work only (numpy and PIL),
so it takes no ``--device``.

    python -m monoforce_tpu_torch.examples.rgbd_data [--sequence PATH] \\
        [--out rgbd.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from monoforce_tpu_torch.datasets.camera import depth_to_cloud
from monoforce_tpu_torch.scripts._common import have_matplotlib


def load_or_synthesize(sequence):
    """(rgb (H, W, 3) uint8, depth (H, W) in mm, K (3, 3)): the middle frame
    of ``sequence``'s luxonis folder, else a synthetic frame: a ground
    plane receding with the image row and a box."""
    if sequence:
        import yaml
        from PIL import Image

        rgb_dir = os.path.join(sequence, "luxonis", "rgb")
        depth_dir = os.path.join(sequence, "luxonis", "depth")
        rgb_files = sorted(os.listdir(rgb_dir))
        depth_files = sorted(os.listdir(depth_dir))
        i = len(rgb_files) // 2
        rgb = np.asarray(Image.open(os.path.join(rgb_dir, rgb_files[i])))
        depth = np.asarray(Image.open(os.path.join(depth_dir, depth_files[i])))
        with open(os.path.join(sequence, "luxonis", "calibration",
                               "cameras", "camera_front.yaml")) as f:
            K = np.asarray(yaml.safe_load(f)["camera_matrix"]["data"],
                           np.float64).reshape(3, 3)
        return rgb, depth, K
    H, W = 240, 320
    K = np.asarray([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1.0]])
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = 2000.0 + 6.0 * (H - yy)           # ground receding with height
    depth[80:140, 140:200] = 1500.0           # box
    rgb = np.stack([xx * 255 // W, yy * 255 // H, np.full_like(xx, 120)],
                   axis=-1).astype(np.uint8)
    return rgb, depth.astype(np.float32), K


def cloud_of(depth, K) -> np.ndarray:
    """The back-projected points deeper than 0.1 m, (M, 3) in metres."""
    cloud = depth_to_cloud(depth, K)
    return cloud[cloud[:, 2] > 0.1]


def _figure(rgb, depth, cloud, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    axes[0].imshow(rgb)
    axes[0].set_title("RGB")
    im = axes[1].imshow(depth, cmap="turbo")
    axes[1].set_title("depth")
    fig.colorbar(im, ax=axes[1], shrink=0.8)
    # top-down scatter coloured by height (camera frame: x right, y down,
    # z forward -> plot (x, z) with -y as height)
    sub = cloud[:: max(1, cloud.shape[0] // 20000)]
    sc = axes[2].scatter(sub[:, 0], sub[:, 2], c=-sub[:, 1], s=1,
                         cmap="terrain")
    axes[2].set_xlabel("x [m]")
    axes[2].set_ylabel("z forward [m]")
    axes[2].set_title("back-projected cloud (top-down)")
    fig.colorbar(sc, ax=axes[2], shrink=0.8, label="height [m]")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence", default=None,
                   help="ROUGH sequence dir with a luxonis/ RGBD folder")
    p.add_argument("--out", default="rgbd.png")
    return p.parse_args(argv)


def main(argv=None):
    """Back-project the frame; returns the cloud."""
    args = parse_args(argv)
    rgb, depth, K = load_or_synthesize(args.sequence)
    cloud = cloud_of(depth, K)
    print(f"frame {depth.shape[0]}x{depth.shape[1]}; cloud: "
          f"{cloud.shape[0]} points, z range [{cloud[:, 2].min():.2f}, "
          f"{cloud[:, 2].max():.2f}] m")
    if have_matplotlib():
        _figure(rgb, depth, cloud, args.out)
        print(args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return cloud


if __name__ == "__main__":
    main()
