"""Matplotlib figures of training and evaluation (headless-friendly).

Port of ``monoforce_tpu/vis.py``'s ``save_prediction_figure`` (:82-108) and
``save_eval_figure`` (:148-210), with an own copy of
``monoforce_tpu/datasets/augment.py::denormalize_img``; reference: the
trainer's prediction figure (train.py:248-357) and the evaluator's panel
(eval.py:159-265).  matplotlib is imported when a figure is drawn, never
when the module is.  Tensors on any device are accepted.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_prediction_figure", "save_eval_figure", "denormalize_img",
           "IMG_MEAN", "IMG_STD"]

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
