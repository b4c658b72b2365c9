"""Closed-loop navigation: plan -> select -> follow -> simulate -> replan.

Port of ``monoforce_tpu/planner/navigator.py`` (whole module).  This is the
integration the reference only exercises through Gazebo
(`monoforce_demos/launch/husky_gazebo_monoforce.launch`: the fused
terrain+physics node publishing sampled paths, `path_selector` arbitrating
against a waypoint route, `path_follower` emitting `cmd_vel`, and the
simulator closing the loop).  Here the differentiable engine IS the
simulator and the ROS topic graph becomes a host-side loop over device
programs:

    every ``replan_every`` seconds:
        sample shooting controls from the CURRENT state
        planner_rollout on the terrain estimate -> paths + costs
        WaypointRoute.select (waypoint distance + path cost arbitration)
    every ``control_dt`` seconds:
        FollowerController.tick(pose, selected path) -> (v, w, status)
            [the supervisor wraps the pure control law with the reference
             path_follower's 10 Hz loop logic (:475-626): clearance-box
             obstacle check at the carrot, stop -> force-through on
             timeout, idle backtracking]
        advance the simulator (fast_rollout, one trajectory) by control_dt

Every tensor of the loop lives on one device, ``cuda`` unless the caller
passes ``device="cpu"``; the host reads back the robot's position once a
tick (the waypoint route), the follower's command and flags, and the
chosen path's index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import (RigidState, RobotModel,
                                                on_device)
from monoforce_tpu_torch.physics.fast import fast_rollout, planner_rollout
from monoforce_tpu_torch.planner.controller import FollowerController
from monoforce_tpu_torch.planner.follower import FollowerParams
from monoforce_tpu_torch.planner.selector import WaypointRoute
from monoforce_tpu_torch.planner.shooting import (force_variance_cost,
                                                  inclination_cost)

__all__ = ["NavigationResult", "navigate"]


class NavigationResult(NamedTuple):
    reached: bool            # route completed before the timeout
    positions: np.ndarray    # (T, 3) simulated robot positions
    commands: np.ndarray     # (T, 2) follower (v, w) commands
    times: np.ndarray        # (T,)
    plans: list              # [(t, paths (B, N, 3), costs (B,), best)], host
    # supervisor status per tick ('follow', 'waiting', 'force_through',
    # 'backtrack', 'idle', 'done').  Default is an (immutable) empty tuple --
    # a `[]` default on a NamedTuple is CLASS-level shared state.
    statuses: Sequence[str] = ()


def _pose_from_state(state: RigidState) -> torch.Tensor:
    T = torch.eye(4, device=state.x.device)
    T[:3, :3] = state.R[0]
    T[:3, 3] = state.x[0]
    return T


def navigate(cfg, z_grid, waypoints, state0: Optional[RigidState] = None,
             friction=None, z_true=None, friction_true=None,
             n_trajs: int = 32, plan_horizon: float = 2.0,
             replan_every: float = 0.5, control_dt: float = 0.1,
             max_time: float = 40.0, cost: str = "force_variance",
             follower_params: FollowerParams = FollowerParams(),
             waypoint_weight: float = 1.0, path_weight: float = 1.0,
             obstacles=None, controller: Optional[FollowerController] = None,
             generator: Optional[torch.Generator] = None,
             verbose: bool = False, device="cuda") -> NavigationResult:
    """Drive the robot along ``waypoints`` over ``z_grid``.

    Args:
      cfg: PhysicsConfig (``PhysicsConfig.for_planner`` recommended -- the
        planning batch then runs the pair-packed serving kernel).
      z_grid / friction: the terrain ESTIMATE the planner sees (H, W).
        A missing friction grid is filled with ``cfg.friction_coef``, so
        the planner always runs with friction (mode ``pair`` at the
        planner preset, never the friction-free ``pair_zu``).
      z_true / friction_true: the simulator's ground-truth terrain;
        defaults to the estimate (perfect-perception setting).
      waypoints: (K, 3) route in the terrain frame.
      state0: initial RigidState with (1, ...) leaves; origin default.
      n_trajs / plan_horizon: shooting batch per replan.
      replan_every / control_dt: planner and follower tick periods.
      cost: 'force_variance' (monoforce_node.py:91) or 'inclination'
        (diff_physics.py:262-266).
      obstacles: optional (M, 3) obstacle cloud in the terrain frame.  When
        given, every tick runs the supervisor's clearance-box check at the
        carrot pose (reference path_follower:282-302 inside its 10 Hz loop
        :475-626): an obstructed carrot stops the robot ('waiting'), and
        after ``controller.force_through_after`` seconds it proceeds at the
        reduced force-through speed cap (:532-547).
      controller: optional pre-configured FollowerController (timeouts,
        backtracking parameters) on this run's device; a default one
        wrapping ``follower_params`` is created if None.
      generator: the ``torch.Generator`` every replan draws its controls
        from (the JAX function's ``key``); None: one on the run's device
        seeded with 0.
      device: where the loop runs, ``cuda`` unless the caller passes
        another device (the JAX function has no such argument); tensors
        given on another device raise.

    Returns a NavigationResult (positions at every control tick, plus the
    supervisor status per tick).
    """
    robot = RobotModel.from_config(cfg, device=device)
    dev = robot.device
    z_grid = on_device(z_grid, dev, "z_grid")
    z_true = z_grid if z_true is None else on_device(z_true, dev, "z_true")
    if friction is None:
        friction = torch.full(z_grid.shape, cfg.friction_coef,
                              dtype=torch.float32, device=dev)
    else:
        friction = on_device(friction, dev, "friction")
    friction_true = (friction if friction_true is None else
                     on_device(friction_true, dev, "friction_true"))
    route = WaypointRoute(waypoints)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the run on "
                         f"{dev}")

    if state0 is None:
        state0 = RigidState(torch.zeros((1, 3), device=dev),
                            torch.zeros((1, 3), device=dev),
                            torch.eye(3, device=dev)[None],
                            torch.zeros((1, 3), device=dev))
    state = RigidState(*(on_device(v, dev, f"state0.{k}")
                         for k, v in state0._asdict().items()))

    if controller is None:
        controller = FollowerController(follower_params, device=dev)
    elif controller.device != dev:
        raise ValueError(f"controller is on {controller.device}, the run on "
                         f"{dev}")
    obstacles = (on_device(obstacles, dev, "obstacles")
                 if obstacles is not None else None)

    n_sim = max(1, int(round(control_dt / cfg.dt)))
    replan_ticks = max(1, int(round(replan_every / control_dt)))
    positions, commands, times, plans, statuses = [], [], [], [], []
    t = 0.0
    reached = False
    while t < max_time:
        robot_xyz = state.x[0].cpu().numpy()
        if route.update(robot_xyz) is None:
            reached = True
            break

        if controller.path is None or len(times) % replan_ticks == 0:
            controls, _ = shooting_controls(
                generator, n_trajs, cfg.vel_max, cfg.omega_max, plan_horizon,
                cfg.dt)
            plan_state = RigidState(*(a.expand((n_trajs,) + a.shape[1:])
                                      for a in state))
            states, stats = planner_rollout(robot, z_grid, controls,
                                            state0=plan_state,
                                            friction=friction)
            if cost == "force_variance":
                costs = force_variance_cost(stats.spring_std)
            else:
                costs = inclination_cost(stats.abs_roll, stats.abs_pitch)
            best, trunc = route.select(states.x, costs, robot_xyz,
                                       waypoint_weight, path_weight)
            path = states.x[best]
            if trunc is not None:
                # lookahead truncation keeps a fixed shape by repeating the
                # truncation point (path_selector:255-258 semantics)
                M = path.shape[0]
                idx = torch.clamp(torch.arange(M, device=dev), max=trunc)
                path = path[idx]
            plans.append((t, states.x.cpu().numpy(), costs.cpu().numpy(),
                          best))
            controller.set_path(path)

        v, w, status = controller.tick(_pose_from_state(state), t,
                                       cloud=obstacles)
        statuses.append(status)
        sim_controls = torch.tensor([v, w], device=dev).expand(1, n_sim, 2)
        sim_states, _ = fast_rollout(robot, z_true[None], sim_controls,
                                     state0=state,
                                     friction=friction_true[None],
                                     with_stats=False)
        state = RigidState(*(a[:, -1] for a in sim_states))

        positions.append(state.x[0].cpu().numpy())
        commands.append((v, w))
        times.append(t)
        t += control_dt
        if verbose and len(times) % 10 == 0:
            print(f"t={t:5.1f}s  pos={positions[-1][:2].round(2)}  "
                  f"wp={route.wp_i}/{len(route.waypoints)}")

    return NavigationResult(reached, np.asarray(positions),
                            np.asarray(commands), np.asarray(times), plans,
                            statuses)
