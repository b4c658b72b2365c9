"""Differentiable-physics walkthrough (the reference's diff_physics.ipynb as
an executable script): build a terrain, sample controls, roll out a batch of
trajectories, cost them, and differentiate through the rollout.

Port of ``examples/diff_physics.py``: tradr (the 0.11 m cloud, P=97) on
the 128 x 128 grid at 0.1 m, 64 constant (v, w) sequences over 5 s through
the exact engine (``DPhysics``) and through ``fast_rollout`` with its
force-variance cost, then the gradient of the mean final height of 8
trajectories with respect to the terrain: ``fk_interp`` and its backward
kernel 501 times each on the card.

    python -m monoforce_tpu_torch.examples.diff_physics
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.controls import generate_controls
from monoforce_tpu_torch.physics.engine import (DPhysics, on_device,
                                                resolve_device)
from monoforce_tpu_torch.physics.fast import fast_rollout
from monoforce_tpu_torch.planner.shooting import force_variance_cost
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib)
from monoforce_tpu_torch.utils.timing import synchronize


def hill(cfg) -> np.ndarray:
    """A gaussian hill ahead of the robot, float32."""
    gx, gy = cfg.grid_coords()
    return (0.5 * np.exp(-((gx - 2.0) ** 2) / 2 - gy ** 2 / 4)).astype(
        np.float32)


def terrain_gradient(robot, z, controls) -> torch.Tensor:
    """d mean(final height) / d terrain through ``fast_rollout``."""
    zg = z.detach().clone().requires_grad_(True)
    s, _ = fast_rollout(robot, zg, controls)
    (g,) = torch.autograd.grad(s.x[:, -1, 2].mean(), zg)
    return g


def walkthrough(cfg, z, controls, device, n_grad: int = 8):
    """The example's computation on the terrain ``z`` (H, W) and the
    controls (B, N, 2): the exact engine's states and spring forces, the
    fast path's states and costs, and the terrain gradient over the first
    ``n_grad`` trajectories.  Returns a dict of tensors, with the fast
    path's seconds."""
    engine = DPhysics(cfg, device=device)
    robot = engine.robot
    z = on_device(z, robot.device, "z")
    controls = on_device(controls, robot.device, "controls")
    B = controls.shape[0]
    states, (f_spring, _) = engine(z.expand((B,) + z.shape), controls)
    t0 = time.perf_counter()
    with torch.no_grad():
        fstates, stats = fast_rollout(robot, z, controls)
        costs = force_variance_cost(stats.spring_std)
    synchronize(costs)
    fast_s = time.perf_counter() - t0
    grad = terrain_gradient(robot, z, controls[:n_grad])
    return dict(states=states, f_spring=f_spring, fstates=fstates,
                costs=costs, grad=grad, fast_s=fast_s)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """The walkthrough at the notebook's sizes; returns its dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    # 1. configuration: tracked robot, 12.8 m x 12.8 m grid at 0.1 m
    cfg = PhysicsConfig(robot="tradr")
    print(f"robot={cfg.robot}  mass={cfg.robot_mass} kg  "
          f"contact points={len(cfg.robot_points)}  grid={cfg.grid_shape}")
    # 2.-3. terrain and 64 constant (v, w) sequences over 5 s
    z = torch.from_numpy(hill(cfg)).to(device)
    controls, _ = generate_controls(
        torch.Generator(device=device).manual_seed(0), n_trajs=64,
        time_horizon=5.0, dt=cfg.dt)
    # 4.-6. exact engine, fast path with its cost, gradient through it
    out = walkthrough(cfg, z, controls, device)
    costs = out["costs"]
    best = int(torch.argmin(costs))
    print("states:", tuple(out["states"].x.shape), " spring forces:",
          tuple(out["f_spring"].shape))
    print(f"fast path: {out['fast_s']:.2f} s; best path {best} cost "
          f"{float(costs[best]):.4f}")
    g = out["grad"]
    print(f"terrain gradient: shape {tuple(g.shape)}, "
          f"nonzero cells {int((g.abs() > 0).sum())}")
    # 7. plot
    if have_matplotlib():
        from monoforce_tpu_torch.vis import plot_terrain_with_trajs
        print("saved", plot_terrain_with_trajs(
            z, out["fstates"].x, costs, cfg.d_max, best=best,
            path="diff_physics_example.png"))
    else:
        print("matplotlib is not installed: diff_physics_example.png not "
              "written")
    return out


if __name__ == "__main__":
    main()
