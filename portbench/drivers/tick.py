"""Closed-loop tick: one robot's online loop through ``MonoForce.run``.

Each tick copies one seeded camera frame from a host pool to the card,
runs the encoder and the shooting plan with fresh seeded controls, and
reads the chosen index back to the host; the next tick starts when that
read returns.  The check runs the reference encoder on the same frames
and weights, and the reference plan on the program's own terrain and
friction heads with the same controls (following the program's state
there, since 500 steps of contact dynamics part on the last bits of the
maps), for the ticks drawn from the seed.
"""

from __future__ import annotations

import time

import torch

from portbench.compare import choice_gap, reference_in_tf32, rel_max_gap
from portbench.counts.encoder import encoder_flops
from portbench.counts.physics import serving_rollout_flops
from portbench.drivers import (free, lss_config, physics_config,
                               sample_units, sync)
from portbench.traffic import (camera_rig, frames, shooting_controls,
                               sub_seed)
from portbench.weights import seeded_state

HEADS = ("geom", "terrain", "diff", "friction")
# a head whose largest entry is under 1 cm (a friction under 0.01) is all
# but dead: its gaps are measured against this, not against its own scale
HEAD_FLOOR = 0.01


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
        self._enc = (0.0, 0.0)

    # ------------------------------------------------------------- set-up
    def _reference_model(self):
        from portbench.reference.lss import LiftSplatShoot
        c, lss = self.config, self.ref_lss
        model = LiftSplatShoot(lss.grid_conf, lss.data_aug_conf,
                               outC=c["outC"], camC=c["camC"],
                               downsample=c["downsample"])
        model.load_state_dict(self.sd)
        return model.to(self.device).eval()

    def _reference_robot(self):
        from portbench.reference.engine import RobotModel
        return RobotModel.from_config(self.ref_phys, device=self.device)

    def setup(self):
        from portbench.reference.config import LSSConfig, PhysicsConfig
        from portbench.reference.lss import LiftSplatShoot
        c, t, dev = self.config, self.traffic, self.device
        self.ref_lss = lss_config(LSSConfig, c)
        self.ref_phys = physics_config(PhysicsConfig, c)
        hw = tuple(c["final_dim"])
        self.calib = camera_rig(c["cameras"], hw, t["focal"],
                                t["camera_height"], t["yaw0_deg"], dev)
        self.frames = frames(self.seed, t["frames"], c["cameras"], hw, dev)
        with torch.device("meta"):
            template = LiftSplatShoot(
                self.ref_lss.grid_conf, self.ref_lss.data_aug_conf,
                outC=c["outC"], camC=c["camC"],
                downsample=c["downsample"]).state_dict()
        self.sd = seeded_state(template, self.seed, c["weights"], dev)
        self.gen = torch.Generator(device=dev)
        if self.system in ("program", "altered_answer"):
            self._tick = self._program()
        elif self.system == "control":
            self._tick = self._control()
        else:
            raise ValueError(f"no system {self.system!r} in the tick driver")
        t0 = time.perf_counter()
        for w in range(t["warmup"]):
            self.unit(-1 - w, None)
        self.warmup_s = time.perf_counter() - t0

    def _program(self):
        from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
        from monoforce_tpu_torch.pipeline import MonoForce
        c = self.config
        mf = MonoForce(physics_config(PhysicsConfig, c),
                       lss_config(LSSConfig, c), cost=c["cost"],
                       device=self.device)
        mf.load_state_dict(self.sd)
        if self.trace_on:
            encode = mf.encode

            def spanned(*args, **kwargs):
                sync(self.device)
                a = time.perf_counter()
                out = encode(*args, **kwargs)
                sync(self.device)
                self._enc = (a, time.perf_counter())
                return out
            mf.encode = spanned
        self._mf = mf

        def tick(imgs, controls):
            terrain, plan = mf.run(imgs, *self.calib, controls=controls)
            return terrain, plan.xs, plan.costs, plan.best

        if self.system == "altered_answer":
            n = self.config["n_sim_trajs"]

            def altered(imgs, controls):
                """The program with its chosen index moved by half the
                batch: a planted fault, to read the choice's gap on."""
                heads, xs, costs, best = tick(imgs, controls)
                return heads, xs, costs, (int(best) + n // 2) % n
            return altered
        return tick

    def _control(self):
        """The reference in the program's place, one precision lower: the
        encoder in TF32, the rollout's state rounded to bf16 each step."""
        from portbench.reference.plan import plan
        model, robot = self._reference_model(), self._reference_robot()

        @torch.no_grad()
        def tick(imgs, controls):
            with reference_in_tf32():
                heads = model(imgs, *self.calib)
            xs, costs, best = plan(robot, heads["terrain"][0, 0],
                                   heads["friction"][0, 0], controls,
                                   state_round=torch.bfloat16)
            return heads, xs, costs, best
        return tick

    # --------------------------------------------------------------- units
    def _controls(self, i):
        c = self.config
        self.gen.manual_seed(sub_seed(self.seed, "controls", i))
        return shooting_controls(self.gen, c["n_sim_trajs"],
                                 int(round(c["traj_sim_time"] / c["dt"])),
                                 self.traffic["vel_max"],
                                 self.traffic["omega_max"])

    def unit(self, i, spans):
        imgs = self.frames[i % len(self.frames)].to(self.device)
        heads, xs, costs, best = self._tick(imgs, self._controls(i))
        best = int(best)
        if spans is not None:
            a, b = self._enc
            spans["encoder_ms"] = (b - a) * 1e3
            spans["plan_ms"] = (time.perf_counter() - b) * 1e3
        if not 0 <= best < self.config["n_sim_trajs"]:
            self.failed += 1
        if i in self.keep:
            self.kept[i] = (heads, xs, costs, best)
        self.last = (i, (heads, xs, costs, best))
        return 1

    # -------------------------------------------------------------- check
    def finish(self):
        self._tick = self._mf = None
        free(self.device)

    @torch.no_grad()
    def readings(self):
        from portbench.reference.plan import plan
        if self.last is not None and self.last[0] >= 0:
            # the window's last unit is compared too
            self.kept[self.last[0]] = self.last[1]
        self.last = None
        if not self.kept:
            return {}
        model, robot = self._reference_model(), self._reference_robot()
        out = {"head_gap": 0.0, "pos_gap_m": 0.0, "cost_gap": 0.0,
               "choice_gap": 0.0}
        live = []
        for i, (heads, xs, costs, best) in sorted(self.kept.items()):
            imgs = self.frames[i % len(self.frames)].to(self.device)
            ref = model(imgs, *self.calib)
            out["head_gap"] = max([out["head_gap"]] + [
                rel_max_gap(heads[k], ref[k], HEAD_FLOOR) for k in HEADS])
            live.append(min(float(ref[k].abs().mean()) for k in HEADS))
            rxs, rcosts, _ = plan(robot, heads["terrain"][0, 0],
                                  heads["friction"][0, 0], self._controls(i))
            # not compared: the plan on the reference's own heads, which
            # parts from the program's by chaos over 500 contact steps
            oxs, _, _ = plan(robot, ref["terrain"][0, 0],
                             ref["friction"][0, 0], self._controls(i))
            own = float((xs.double() - oxs.double()).abs().max())
            out["pos_gap_m.own_heads"] = max(
                out.get("pos_gap_m.own_heads", 0.0),
                own if own == own else float("inf"))
            gap = float((xs.double() - rxs.double()).abs().max())
            out["pos_gap_m"] = max(out["pos_gap_m"],
                                   gap if gap == gap else float("inf"))
            out["cost_gap"] = max(out["cost_gap"], rel_max_gap(costs, rcosts))
            out["choice_gap"] = max(out["choice_gap"],
                                    choice_gap(best, rcosts))
        out["ticks_compared"] = len(self.kept)
        out["least_head_mean_abs"] = min(live)
        return out

    def counts(self):
        c, lss = self.config, self.ref_lss
        n_steps = int(round(c["traj_sim_time"] / c["dt"]))
        enc = encoder_flops(lss.grid_conf, lss.data_aug_conf, c["camC"],
                            c["downsample"], 1, c["cameras"], train=False)
        return {"flops_per_unit": enc + serving_rollout_flops(
            c["n_sim_trajs"], c["contact_points"], n_steps, c["step_format"])}
