"""Matplotlib figures of training and evaluation (headless-friendly).

Port of ``monoforce_tpu/vis.py``'s ``plot_terrain_with_trajs`` (:25-57),
``plot_rollout_3d`` (:60-79), ``save_prediction_figure`` (:82-108),
``save_eval_figure`` (:148-210) and ``animate_rollout`` (:212-272; the
reference's mayavi animation, dphysics.py:607-669), with an own copy of
``monoforce_tpu/datasets/augment.py::denormalize_img``; reference: the
trainer's prediction figure (train.py:248-357) and the evaluator's panel
(eval.py:159-265).  matplotlib is imported when a figure is drawn, never
when the module is.  Tensors on any device are accepted.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_terrain_with_trajs", "plot_rollout_3d",
           "save_prediction_figure", "save_eval_figure", "animate_rollout",
           "denormalize_img", "IMG_MEAN", "IMG_STD"]

IMG_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def denormalize_img(chw) -> np.ndarray:
    """(3, H, W) normalized -> (H, W, 3) uint8."""
    arr = _np(chw)[:3].transpose(1, 2, 0) * IMG_STD + IMG_MEAN
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def plot_terrain_with_trajs(z_grid, trajs, costs=None, d_max: float = 6.4,
                            best: int | None = None, path: str | None = None):
    """Top-down heightmap with sampled trajectories colored by cost.

    z_grid: (H, W); trajs: (B, N, 3); costs: (B,).
    """
    plt = _mpl()
    z = _np(z_grid)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(z.T, origin="lower", extent=(-d_max, d_max, -d_max, d_max),
                   cmap="terrain")
    fig.colorbar(im, ax=ax, label="elevation [m]")
    trajs = _np(trajs)
    if costs is not None:
        costs = _np(costs)
        order = np.argsort(costs)[::-1]
        cmin, cmax = costs.min(), costs.max() + 1e-9
        for i in order:
            c = plt.cm.RdYlGn(1.0 - (costs[i] - cmin) / (cmax - cmin))
            ax.plot(trajs[i, :, 0], trajs[i, :, 1], color=c, lw=0.8, alpha=0.7)
    else:
        for t in trajs:
            ax.plot(t[:, 0], t[:, 1], "b-", lw=0.8, alpha=0.5)
    if best is not None:
        ax.plot(trajs[best, :, 0], trajs[best, :, 1], "k-", lw=2.5,
                label="selected")
        ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_rollout_3d(z_grid, xs, d_max: float = 6.4, stride: int = 4,
                    path: str | None = None):
    """3D surface + trajectory line (the mayavi animation's static stand-in)."""
    plt = _mpl()
    z = _np(z_grid)
    H, W = z.shape
    gx, gy = np.meshgrid(np.linspace(-d_max, d_max, H),
                         np.linspace(-d_max, d_max, W), indexing="ij")
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(gx[::stride, ::stride], gy[::stride, ::stride],
                    z[::stride, ::stride], cmap="terrain", alpha=0.6)
    xs = _np(xs)
    ax.plot(xs[:, 0], xs[:, 1], xs[:, 2], "g-", lw=2)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def save_prediction_figure(terrain: dict, hm_geom, hm_terrain, xs_pred, xs_gt,
                           d_max: float = 6.4, path: str = "prediction.png"):
    """2x3 panel: predicted/label heightmaps, friction, trajectories
    (compact version of the trainer figure, train.py:248-357)."""
    plt = _mpl()
    fig, axes = plt.subplots(2, 3, figsize=(15, 9))
    panels = [
        ("pred terrain", _np(terrain["terrain"])[0, 0]),
        ("label terrain", _np(hm_terrain)[0]),
        ("pred friction", _np(terrain["friction"])[0, 0]),
        ("pred geom", _np(terrain["geom"])[0, 0]),
        ("label geom", _np(hm_geom)[0]),
    ]
    for ax, (title, img) in zip(axes.flat, panels):
        im = ax.imshow(img.T, origin="lower", cmap="jet",
                       extent=(-d_max, d_max, -d_max, d_max))
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.7)
    ax = axes.flat[5]
    xs_pred, xs_gt = _np(xs_pred), _np(xs_gt)
    ax.plot(xs_gt[:, 0], xs_gt[:, 1], "k-", label="GT")
    ax.plot(xs_pred[:, 0], xs_pred[:, 1], "r-", label="pred")
    ax.set_title("trajectories")
    ax.legend()
    ax.grid()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def save_eval_figure(batch, terrain: dict, xs_pred, d_max: float = 6.4,
                     path: str = "eval_batch.png"):
    """3x4 per-batch eval diagnostic (reference: eval.py:159-265): camera
    images, predicted geom/terrain/friction + labels, and predicted-vs-GT
    trajectories over the terrain estimate.  ``batch`` is the 16-tuple
    (the first sample of the batch is shown)."""
    plt = _mpl()
    (imgs, rots, trans, intrins, post_rots, post_trans,
     hm_geom, hm_terrain, control_ts, controls, pose0,
     traj_ts, Xs, Xds, Rs, Omegas) = batch

    fig, axes = plt.subplots(3, 4, figsize=(18, 12))
    imgs0 = _np(imgs[0])
    for i in range(4):
        ax = axes[0, i]
        if i < imgs0.shape[0]:
            ax.imshow(denormalize_img(imgs0[i]))
            ax.set_title(f"camera {i}")
        ax.axis("off")

    hm_panels = [
        ("pred geom", _np(terrain["geom"])[0, 0]),
        ("label geom", _np(hm_geom)[0, 0]),
        ("pred terrain", _np(terrain["terrain"])[0, 0]),
        ("label terrain", _np(hm_terrain)[0, 0]),
    ]
    for ax, (title, img) in zip(axes[1], hm_panels):
        im = ax.imshow(img.T, origin="lower", cmap="jet",
                       extent=(-d_max, d_max, -d_max, d_max))
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.7)

    ax = axes[2, 0]
    im = ax.imshow(_np(terrain["friction"])[0, 0].T, origin="lower",
                   cmap="viridis", extent=(-d_max, d_max, -d_max, d_max))
    ax.set_title("pred friction")
    fig.colorbar(im, ax=ax, shrink=0.7)

    xs_pred = _np(xs_pred)[0]
    xs_gt = _np(Xs)[0]
    ax = axes[2, 1]
    im = ax.imshow(_np(terrain["terrain"])[0, 0].T, origin="lower",
                   cmap="terrain", extent=(-d_max, d_max, -d_max, d_max))
    ax.plot(xs_gt[:, 0], xs_gt[:, 1], "k-", lw=2, label="GT")
    ax.plot(xs_pred[:, 0], xs_pred[:, 1], "r-", lw=2, label="pred")
    ax.set_title("trajectory (top-down)")
    ax.legend()
    ax = axes[2, 2]
    ts = _np(traj_ts)[0]
    ax.plot(ts, xs_gt[:, 2], "k-", label="GT z")
    ax.plot(ts, xs_pred[:, 2], "r-", label="pred z")
    ax.set_title("trajectory z(t)")
    ax.legend()
    ax.grid()
    ax = axes[2, 3]
    err = np.linalg.norm(xs_pred - xs_gt, axis=-1)
    ax.plot(ts, err, "b-")
    ax.set_title("position error [m]")
    ax.grid()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def animate_rollout(z_grid, states, robot_points=None, forces=None,
                    d_max: float = 6.4, stride: int = 10,
                    surf_stride: int = 4, path: str = "rollout.gif",
                    fps: int = 8):
    """Rollout animation (reference: DPhysics.visualize, dphysics.py:607-669,
    mayavi): terrain surface, the robot's contact points at each pose, the
    trajectory so far, and optional spring-force quivers -- rendered headless
    per frame and assembled into a GIF with PIL.

    z_grid: (H, W); states: RigidState with (N, ...) leaves (one trajectory);
    robot_points: (P, 3) body-frame contact points; forces: (N, P, 3)
    per-step spring forces (downsampled to every ``stride`` steps).
    Returns the GIF path.
    """
    import io

    from PIL import Image

    plt = _mpl()
    z = _np(z_grid)
    H, W = z.shape
    gx, gy = np.meshgrid(np.linspace(-d_max, d_max, H),
                         np.linspace(-d_max, d_max, W), indexing="ij")
    xs = _np(states.x)
    Rs = _np(states.R)
    n_steps = xs.shape[0]
    pts = None if robot_points is None else _np(robot_points)
    f = None if forces is None else _np(forces)

    frames = []
    zmin, zmax = float(z.min()), float(z.max())
    for t in range(0, n_steps, max(stride, 1)):
        fig = plt.figure(figsize=(7, 5.5))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_surface(gx[::surf_stride, ::surf_stride],
                        gy[::surf_stride, ::surf_stride],
                        z[::surf_stride, ::surf_stride],
                        cmap="terrain", alpha=0.5, linewidth=0)
        ax.plot(xs[:t + 1, 0], xs[:t + 1, 1], xs[:t + 1, 2], "g-", lw=2)
        if pts is not None:
            world = pts @ Rs[t].T + xs[t]
            ax.scatter(world[:, 0], world[:, 1], world[:, 2], s=4, c="k")
            if f is not None and t < f.shape[0]:
                ft = f[t]
                scale = 0.5 / (np.abs(ft).max() + 1e-6)
                ax.quiver(world[:, 0], world[:, 1], world[:, 2],
                          ft[:, 0] * scale, ft[:, 1] * scale,
                          ft[:, 2] * scale, color="r", lw=0.5,
                          arrow_length_ratio=0.1)
        ax.set_xlim(-d_max, d_max)
        ax.set_ylim(-d_max, d_max)
        ax.set_zlim(zmin - 0.5, zmax + 1.0)
        ax.set_title(f"step {t}/{n_steps}")
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return path
