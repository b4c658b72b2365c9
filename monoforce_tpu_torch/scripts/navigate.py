"""Closed-loop navigation demo: plan -> select -> follow -> simulate ->
replan on the differentiable engine (the reference's
husky_gazebo_monoforce.launch integration without Gazebo/ROS).

Port of ``scripts/navigate.py``: tradr at the planner preset on a hill, a
ridge or flat ground, through two waypoints.  Every replan runs the
``pair`` serving mode (``fk_step_pairmu`` once a step, ``fk_interp`` once);
every 10 Hz tick simulates 10 steps of ``fast_rollout`` (``fk_interp`` 11
times).

    python -m monoforce_tpu_torch.scripts.navigate --terrain ridge
"""

from __future__ import annotations

import argparse

import numpy as np

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.planner.navigator import navigate
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib)

WAYPOINTS = np.asarray([[2.0, -1.5, 0.0], [4.0, 0.5, 0.0]])


def make_terrain(cfg, kind: str = "hill") -> np.ndarray:
    gx, gy = cfg.grid_coords()
    if kind == "hill":
        z = 0.4 * np.exp(-((gx - 2.0) ** 2 / 4.0 + gy ** 2 / 8.0))
    elif kind == "ridge":
        z = 0.35 * np.exp(-(gy ** 2) / 0.8) * (np.abs(gx - 2.0) < 2.0)
    else:
        z = np.zeros_like(gx)
    return z.astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--terrain", default="hill", choices=["hill", "flat", "ridge"])
    p.add_argument("--n_trajs", type=int, default=64)
    p.add_argument("--max_time", type=float, default=40.0)
    p.add_argument("--out", default="navigate.png")
    add_device_arg(p)
    return p.parse_args(argv)


def _figure(cfg, z, res, terrain, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 7))
    d = float(cfg.d_max)
    im = ax.imshow(z.T, origin="lower", cmap="terrain", extent=(-d, d, -d, d))
    fig.colorbar(im, ax=ax, label="elevation [m]")
    for t, paths, costs, best in res.plans:
        ax.plot(paths[best, :, 0], paths[best, :, 1], "b-", lw=0.7, alpha=0.4)
    ax.plot(res.positions[:, 0], res.positions[:, 1], "k-", lw=2.5,
            label="driven")
    ax.plot(WAYPOINTS[:, 0], WAYPOINTS[:, 1], "r*", ms=16, label="waypoints")
    ax.legend()
    ax.set_title(f"closed-loop navigation ({terrain})")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """The route as the command line says; returns its NavigationResult."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = PhysicsConfig.for_planner("tradr")
    z = make_terrain(cfg, args.terrain)
    res = navigate(cfg, z, WAYPOINTS, n_trajs=args.n_trajs,
                   max_time=args.max_time, verbose=True, device=device)
    print(f"route {'completed' if res.reached else 'TIMED OUT'} after "
          f"{res.times[-1]:.1f} s, {len(res.plans)} replans")
    if have_matplotlib():
        _figure(cfg, z, res, args.terrain, args.out)
        print(args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return res


if __name__ == "__main__":
    main()
