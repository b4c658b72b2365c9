"""Shooting call: offline batch shooting through ``planner_rollout``.

Each call rolls a batch of seeded constant-command trajectories over one
seeded smooth hill with a friction grid, both held on the card, and
costs them; a call ends when its costs are ready.  The encoder is
bypassed.  The check rolls the reference out on the same terrain and
controls for the calls drawn from the seed and compares positions and
costs.
"""

from __future__ import annotations

import time

import torch

from portbench.compare import rel_max_gap
from portbench.counts.physics import (STEP_FLOPS_PER_POINT,
                                      serving_rollout_flops,
                                      step_kernel_bytes)
from portbench.drivers import free, physics_config, sample_units, sync
from portbench.traffic import hill_terrain, shooting_controls, sub_seed


def tapped_words(xs, Rs, points, delta_h, d_max, res, chunk=10):
    """Mean count, per trajectory and step, of the distinct window cells
    the step kernel's four taps read (cell (i, j) and its +x, +y and +xy
    neighbours of every contact point), from a rollout's states (the
    reference's, which the program's follow to ~1e-4 m): the points at
    the state each step starts from."""
    B, N = xs.shape[:2]
    total = 0.0
    for a in range(0, N, chunk):
        k = torch.clamp(torch.arange(a, min(a + chunk, N),
                                     device=xs.device) - 1, min=0)
        R = Rs[:, k]
        x = xs[:, k] - R[..., :, 2] * delta_h
        w = torch.einsum("bnij,pj->bnpi", R.double(), points.double()) \
            + x.double()[:, :, None]
        ix = ((w[..., 0] + d_max) / res).to(torch.int64)
        iy = ((w[..., 1] + d_max) / res).to(torch.int64)
        cell = ix * 4096 + iy
        taps = torch.cat([cell, cell + 4096, cell + 1, cell + 4097], dim=-1)
        taps, _ = torch.sort(taps, dim=-1)
        distinct = 1 + (taps[..., 1:] != taps[..., :-1]).sum(dim=-1)
        total += float(distinct.double().sum())
    return total / (B * N)


class Driver:
    def __init__(self, config, traffic, limits, seed, device,
                 trace_on=False, system="program"):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.trace_on, self.system = trace_on, system
        self.failed = 0
        self.kept = {}
        self.keep = sample_units(seed, limits)
        self.last = None
        self.words = None

    def setup(self):
        from portbench.reference.config import PhysicsConfig
        from portbench.reference.engine import RobotModel
        c, t, dev = self.config, self.traffic, self.device
        self.ref_phys = physics_config(PhysicsConfig, c)
        self.z, self.mu = hill_terrain(self.seed, t, self.ref_phys.grid_shape,
                                       c["grid_res"], c["d_max"], dev)
        self.ref_robot = RobotModel.from_config(self.ref_phys, device=dev)
        self.gen = torch.Generator(device=dev)
        if self.system == "program":
            from monoforce_tpu_torch.config import PhysicsConfig as P
            from monoforce_tpu_torch.physics.engine import RobotModel as R
            from monoforce_tpu_torch.physics.fast import planner_rollout
            from monoforce_tpu_torch.planner.shooting import \
                force_variance_cost
            robot = R.from_config(physics_config(P, c), device=dev)

            def call(controls):
                states, stats = planner_rollout(robot, self.z, controls,
                                                friction=self.mu)
                return states.x, states.R, force_variance_cost(
                    stats.spring_std)
        elif self.system == "control":
            from portbench.reference.fast import planner_rollout
            from portbench.reference.plan import force_variance_cost

            @torch.no_grad()
            def call(controls):
                states, stats = planner_rollout(
                    self.ref_robot, self.z, controls, friction=self.mu,
                    state_round=torch.bfloat16)
                return states.x, states.R, force_variance_cost(
                    stats.spring_std)
        else:
            raise ValueError(f"no system {self.system!r} in the shoot driver")
        self._call = call
        t0 = time.perf_counter()
        for w in range(t["warmup"]):
            self.unit(-1 - w, None)
        self.warmup_s = time.perf_counter() - t0

    def _controls(self, i):
        t = self.traffic
        self.gen.manual_seed(sub_seed(self.seed, "controls", i))
        return shooting_controls(self.gen, t["batch"], t["steps"],
                                 t["vel_max"], t["omega_max"])

    def unit(self, i, spans):
        xs, Rs, costs = self._call(self._controls(i))
        sync(self.device)
        if i in self.keep:
            self.kept[i] = (xs, Rs, costs)
        self.last = (i, (xs, Rs, costs))
        return self.traffic["batch"]

    def finish(self):
        self._call = None
        free(self.device)

    @torch.no_grad()
    def readings(self):
        from portbench.reference.fast import planner_rollout
        from portbench.reference.plan import force_variance_cost
        if self.last is not None and self.last[0] >= 0:
            # the window's last unit is compared too
            self.kept[self.last[0]] = self.last[1]
        self.last = None
        if not self.kept:
            return {}
        robot = self.ref_robot
        out = {"pos_gap_m": 0.0, "cost_gap": 0.0}
        words = []
        for i, (xs, Rs, costs) in sorted(self.kept.items()):
            states, stats = planner_rollout(robot, self.z, self._controls(i),
                                            friction=self.mu)
            gap = float((xs.double() - states.x.double()).abs().max())
            out["pos_gap_m"] = max(out["pos_gap_m"],
                                   gap if gap == gap else float("inf"))
            out["cost_gap"] = max(out["cost_gap"], rel_max_gap(
                costs, force_variance_cost(stats.spring_std)))
            delta_h = float(robot.mass * robot.gravity
                            / (robot.stiffness + 1e-6))
            words.append(tapped_words(states.x, states.R, robot.points,
                                      delta_h, self.config["d_max"],
                                      self.config["grid_res"]))
        self.words = sum(words) / len(words)
        out["calls_compared"] = len(self.kept)
        return out

    def counts(self):
        c, t = self.config, self.traffic
        B, P, N = t["batch"], c["contact_points"], t["steps"]
        out = {"flops_per_unit": serving_rollout_flops(B, P, N,
                                                       c["step_format"])}
        if self.words is not None:
            out["step_kernel"] = {
                "flops": B * P * STEP_FLOPS_PER_POINT[c["step_format"]],
                "bytes": step_kernel_bytes(
                    B, P, int(self.ref_robot.driving_masks.shape[0]),
                    B * self.words)}
        return out
