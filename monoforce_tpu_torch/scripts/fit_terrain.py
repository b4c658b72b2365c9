"""Inverse-physics demo: recover elevation + friction from a trajectory
(reference: monoforce/scripts/fit_terrain.py).

Port of ``scripts/fit_terrain.py``.  Simulates ground-truth rollouts with
the exact engine on a synthetic gaussian hill, then fits a flat terrain
estimate by gradient descent through the rollout (``fit_terrain``).

Which rollout the fit differentiates depends on the horizon, by the JAX
package's rule: at the default 3 s (300 steps, remat segments of 15) it is
the exact engine, which runs no kernel of ours; at 2 s or less (under 256
steps) it is ``fast_rollout``, whose every terrain lookup is the
``fk_interp`` kernel and its backward kernel on the card.

    python -m monoforce_tpu_torch.scripts.fit_terrain --traj_sim_time 2.0
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.controls import generate_controls
from monoforce_tpu_torch.physics.engine import (RobotModel, on_device,
                                                resolve_device, rollout)
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib)
from monoforce_tpu_torch.training import fit_terrain


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--n_trajs", type=int, default=8)
    p.add_argument("--lr_z", type=float, default=0.02)
    p.add_argument("--lr_friction", type=float, default=0.01)
    p.add_argument("--tv_weight", type=float, default=0.0)
    p.add_argument("--traj_sim_time", type=float, default=3.0)
    p.add_argument("--out", default="fit_terrain.png")
    add_device_arg(p)
    return p.parse_args(argv)


def config(traj_sim_time: float) -> PhysicsConfig:
    """tradr on the 32 x 32 grid at 0.4 m."""
    return PhysicsConfig(robot="tradr", grid_res=0.4,
                         traj_sim_time=traj_sim_time)


def hill(cfg) -> np.ndarray:
    """The true terrain: 0.5 exp(-(x - 1.5)^2 / 2 - y^2 / 3), float32."""
    gx, gy = cfg.grid_coords()
    return (0.5 * np.exp(-((gx - 1.5) ** 2) / 2 - gy ** 2 / 3)).astype(
        np.float32)


def sample_controls(cfg, n_trajs: int, device):
    """Constant (v, w) per trajectory from a generator seeded 0 (the JAX
    script's ``PRNGKey(0)``; the numbers differ)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return generate_controls(gen, n_trajs, cfg.traj_sim_time, cfg.dt,
                             v_range=(0.3, 1.0), w_range=(-0.5, 0.5))


def fit(cfg, controls, ts, n_iters: int, lr_z: float, lr_friction: float,
        tv_weight: float, device):
    """Ground truth from the exact rollout on :func:`hill`, then
    ``fit_terrain`` from a flat start, printing every tenth loss.
    ``controls`` (B, N, 2) and the stamps ``ts`` (N,) may be arrays.
    Returns (the true terrain, the ground-truth states, the fitted
    TerrainParams, the losses)."""
    robot = RobotModel.from_config(cfg, device=device)
    dev = robot.device
    z_true = hill(cfg)
    controls = on_device(controls, dev, "controls")
    B = controls.shape[0]
    zb = torch.from_numpy(z_true).to(dev).expand((B,) + z_true.shape)
    states_gt, _, _ = rollout(robot, zb, controls, return_forces=False)
    tsb = on_device(ts, dev, "ts")[None].expand(B, -1)
    params, losses = fit_terrain(cfg, controls, [states_gt.x], tsb, tsb,
                                 n_iters=n_iters, lr_z=lr_z,
                                 lr_friction=lr_friction,
                                 tv_weight=tv_weight, verbose=True,
                                 device=dev)
    return z_true, states_gt, params, losses


def _figure(z_true, params, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (title, img) in zip(axes, [
            ("true terrain", z_true),
            ("fitted terrain", params.z_grid.cpu().numpy()),
            ("fitted friction", params.friction.cpu().numpy())]):
        im = ax.imshow(img.T, origin="lower", cmap="terrain")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """The fit as the command line says; returns (params, losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config(args.traj_sim_time)
    controls, ts = sample_controls(cfg, args.n_trajs, device)
    z_true, _, params, losses = fit(cfg, controls, ts, args.n_iters,
                                    args.lr_z, args.lr_friction,
                                    args.tv_weight, device)
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
    if have_matplotlib():
        _figure(z_true, params, args.out)
        print("saved", args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return params, losses


if __name__ == "__main__":
    main()
