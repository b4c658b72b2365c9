"""Physics-engine demos without any dataset or weights
(reference: monoforce/scripts/robot_control.py):

- ``motion``: one rollout of marv with time-varying flipper angles through
  the exact engine (``DPhysics``),
- ``shoot``: batched shooting of sampled control sequences through
  ``fast_rollout`` with wall-time reporting (the reference's
  shoot_multiple, robot_control.py:79-151).

Port of ``scripts/robot_control.py``.  ``shoot`` times a call from its
launch to the card's last kernel: the clock stops after a synchronise.

    python -m monoforce_tpu_torch.scripts.robot_control shoot --terrain hill
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import (DPhysics, RigidState,
                                                RobotModel, on_device,
                                                resolve_device)
from monoforce_tpu_torch.physics.fast import fast_rollout
from monoforce_tpu_torch.planner.shooting import force_variance_cost
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib)
from monoforce_tpu_torch.utils.timing import Timer, synchronize


def make_terrain(cfg, kind: str = "hill") -> np.ndarray:
    gx, gy = cfg.grid_coords()
    if kind == "hill":
        return (0.5 * np.exp(-((gx - 2.0) ** 2) / 2 - gy ** 2 / 4)).astype(
            np.float32)
    if kind == "step":
        return (0.2 * (gx > 1.5)).astype(np.float32)
    return np.zeros_like(gx, dtype=np.float32)


def flipper_angles(cfg) -> np.ndarray:
    """(1, N, 4) angles: 0.4 sin t on the front pair, -0.3 cos t on the
    rear, on a float32 numpy time grid (``torch.linspace`` can differ from
    it in the last bit)."""
    t = np.linspace(0, cfg.traj_sim_time, cfg.n_sim_steps, dtype=np.float32)
    return np.stack([0.4 * np.sin(t)] * 2 + [-0.3 * np.cos(t)] * 2,
                    axis=1)[None]


def motion_rollout(cfg, terrain: str, device):
    """One straight 0.6 m/s rollout with moving flippers through
    ``DPhysics``.  Returns (engine, z (1, H, W), states, forces)."""
    engine = DPhysics(cfg, device=device)
    dev = engine.robot.device
    n = cfg.n_sim_steps
    z = torch.from_numpy(make_terrain(cfg, terrain)).to(dev)[None]
    controls = torch.tensor([[0.6, 0.0]], device=dev).expand(1, n, 2)
    ja = on_device(flipper_angles(cfg), dev, "joint_angles")
    states, forces = engine(z, controls, joint_angles=ja)
    return engine, z, states, forces


def shoot_rollout(robot, z, controls):
    """The shooting batch forward: (positions (B, N, 3), force-variance
    costs (B,))."""
    with torch.no_grad():
        states, stats = fast_rollout(robot, z, controls)
        return states.x, force_variance_cost(stats.spring_std)


def motion(args, device):
    from monoforce_tpu_torch.vis import animate_rollout, plot_rollout_3d

    cfg = PhysicsConfig(robot="marv")
    engine, z, states, forces = motion_rollout(cfg, args.terrain, device)
    print("final position:", states.x[0, -1].cpu().numpy())
    if not have_matplotlib():
        print(f"matplotlib is not installed: {args.out} not written")
        return states
    print(plot_rollout_3d(z[0], states.x[0], cfg.d_max, path=args.out))
    if args.animate:
        one = RigidState(*(a[0] for a in states))
        gif = args.out.rsplit(".", 1)[0] + ".gif"
        print(animate_rollout(z[0], one, robot_points=engine.robot.points,
                              forces=forces[0][0], d_max=float(cfg.d_max),
                              path=gif))
    return states


def shoot(args, device):
    from monoforce_tpu_torch.vis import plot_terrain_with_trajs

    cfg = PhysicsConfig(robot="tradr")
    robot = RobotModel.from_config(cfg, device=device)
    z = torch.from_numpy(make_terrain(cfg, args.terrain)).to(robot.device)
    controls, _ = shooting_controls(
        torch.Generator(device=robot.device).manual_seed(0), args.n_trajs,
        cfg.vel_max, cfg.omega_max, cfg.traj_sim_time, cfg.dt)
    # a warm-up call outside the clock, then the best of the repeats
    synchronize(shoot_rollout(robot, z, controls))
    times = []
    for _ in range(args.repeats):
        with Timer() as t:
            xs, costs = t.block_on(shoot_rollout(robot, z, controls))
        times.append(t.dt)
    n_steps = controls.shape[1]
    print(f"{args.n_trajs} trajs x {n_steps} steps: "
          f"{min(times) * 1e3:.1f} ms (best of {args.repeats})")
    best = int(torch.argmin(costs))
    print("lowest-cost path:", best, float(costs[best]))
    if have_matplotlib():
        print(plot_terrain_with_trajs(z, xs, costs, cfg.d_max, best=best,
                                      path=args.out))
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return xs, costs, min(times)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("demo", choices=["motion", "shoot"])
    p.add_argument("--terrain", default="hill", choices=["hill", "step", "flat"])
    p.add_argument("--n_trajs", type=int, default=64)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--out", default="robot_control.png")
    p.add_argument("--animate", action="store_true",
                   help="also save a rollout GIF (the mayavi "
                        "animation's stand-in, dphysics.py:607-669)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """The demo the command line names; ``motion`` returns its states,
    ``shoot`` (positions, costs, best seconds)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    return (motion if args.demo == "motion" else shoot)(args, device)


if __name__ == "__main__":
    main()
