"""Train step: ``Trainer.train_step`` back to back on a pool of seeded
full-width batches, built on the card in set-up and cycled; a step ends
when its loss is on the host.

Set-up builds one trainer, loads the seeded weights and drives it through
its first three steps on three batches whose rows all differ, through the
window's own call and feed; those steps warm it up, and what they leave is
what the check reads: each step's losses, the first gradient as Adam got
it (its first moment after one step, over 1 - beta1), and each parameter's
change after the three steps.  The window goes on with the same trainer.
Once it has closed the reference runs the same three steps from the same
weights, batches and drop-connect draws.

One step inside the window, drawn from the seed among its first
``check_within``, is checked as well: the parameters, buffers, Adam state
and drop-connect generator are copied on the card before it, and its
losses, gradient (from Adam's first moment before and after) and change
are kept.  After the window the reference runs that one step from the
copy, on the same batch and draw: it follows the program from the
program's own state there, since the steps between part by chaos.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
import time
from contextlib import nullcontext

import torch

from portbench.compare import leaf_norm_gaps, reference_in_tf32
from portbench.counts.encoder import encoder_flops
from portbench.counts.physics import exact_rollout_flops
from portbench.drivers import free, lss_config, physics_config
from portbench.traffic import camera_rig, generator, train_batches
from portbench.weights import seeded_state

FIRST_STEPS = 3
PARTS = ("geom", "terrain", "phys", "total")


class Driver:
    def __init__(self, config, traffic, limits, seed, device,
                 trace_on=False, system="program"):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.trace_on, self.system = trace_on, system
        self.failed = 0
        g = generator("cpu", seed, "sample")
        self.check_step = int(torch.randint(limits["check_within"], (),
                                            generator=g))
        self.window_step = None

    def _weights(self):
        c = self.config
        return dict(geom_weight=c["geom_weight"],
                    terrain_weight=c["terrain_weight"],
                    phys_weight=c["phys_weight"])

    def _reference(self):
        """(model, robot, optimizer) of the reference, from the seeded
        weights."""
        from portbench.reference.engine import RobotModel
        from portbench.reference.lss import LiftSplatShoot
        from portbench.reference.train import GradientChain
        c, lss = self.config, self.ref_lss
        model = LiftSplatShoot(lss.grid_conf, lss.data_aug_conf,
                               outC=c["outC"], camC=c["camC"],
                               downsample=c["downsample"],
                               drop_connect_rate=c["drop_connect_rate"])
        model.load_state_dict(self.sd)
        model = model.to(self.device)
        robot = RobotModel.from_config(self.ref_phys, device=self.device)
        opt = GradientChain(model.parameters(), c["lr"], c["weight_decay"],
                            c["max_grad_norm"])
        return model, robot, opt

    def setup(self):
        from portbench.reference.config import LSSConfig, PhysicsConfig
        from portbench.reference.lss import LiftSplatShoot
        c, t, dev = self.config, self.traffic, self.device
        self.ref_lss = lss_config(LSSConfig, c)
        self.ref_phys = physics_config(PhysicsConfig, c)
        self.n_steps = int(round(c["traj_sim_time"] / c["dt"]))
        calib = camera_rig(t["cameras"], tuple(c["final_dim"]), t["focal"],
                           t["camera_height"], t["yaw0_deg"], dev)
        self.pool = train_batches(self.seed, t, self.ref_lss, calib, c["dt"],
                                  self.n_steps, dev)
        with torch.device("meta"):
            template = LiftSplatShoot(
                self.ref_lss.grid_conf, self.ref_lss.data_aug_conf,
                outC=c["outC"], camC=c["camC"],
                downsample=c["downsample"]).state_dict()
        self.sd = seeded_state(template, self.seed, c["weights"], dev)
        self.masks = generator(dev, self.seed, "masks")
        if self.system == "program":
            self._program()
        elif self.system in ("control", "half_batch"):
            self._stand_in()
        else:
            raise ValueError(f"no system {self.system!r} in the train driver")
        t0 = time.perf_counter()
        self.first = self._first_steps(self._step, self._named, self._adam)
        self.warmup_s = time.perf_counter() - t0

    def _program(self):
        from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
        from monoforce_tpu_torch.training import Trainer
        c = self.config
        log_dir = os.path.join(tempfile.gettempdir(), "portbench-trainer")
        tr = Trainer(dphys_cfg=physics_config(PhysicsConfig, c),
                     lss_cfg=lss_config(LSSConfig, c), lr=c["lr"],
                     log_dir=log_dir, device=self.device,
                     drop_connect_rate=c["drop_connect_rate"],
                     **self._weights())
        # the seeded weights replace whatever init_state draws, so its own
        # draw (leaf by leaf on the host) is skipped
        tr.model.init_weights = lambda generator: None
        tr.init_state()
        tr.model.load_state_dict(self.sd)
        self._trainer = tr
        self._step = lambda batch: tr.train_step(batch, self.masks)
        self._model = tr.model
        self._named = lambda: tr.model.named_parameters()
        self._adam = lambda: tr.optimizer.state_dict()["state"]

    def _stand_in(self):
        """The reference in the program's place: in TF32 (``control``), or
        with half of each batch left out (``half_batch``)."""
        from portbench.reference.train import train_step
        model, robot, opt = self._reference()
        half = self.system == "half_batch"

        def step(batch):
            if half:
                batch = tuple(b[:b.shape[0] // 2] for b in batch)
            with nullcontext() if half else reference_in_tf32():
                return train_step(model, robot, opt, batch, self.masks,
                                  pool_k=self._pool_k(), **self._weights())
        self._trainer = (model, opt)
        self._step = step
        self._model = model
        self._named = model.named_parameters
        self._adam = lambda: opt.state_dict()["state"]

    def _pool_k(self):
        return int(round(self.config["grid_res"]
                         / self.config["xbound"][2]))

    def _first_steps(self, step, named, adam_state):
        """Losses of the first steps, the first gradient's norm per leaf
        as Adam got it, and each leaf's change after the steps.  Kept on
        the card besides, for the look at the leaves: the sign of each
        step's gradient as Adam got it, and each element's change."""
        beta1 = self.config["adam_betas"][0]
        losses, grads, signs = [], None, []
        m_prev = {n: torch.zeros_like(p) for n, p in named()}
        for s in range(FIRST_STEPS):
            aux = step(self.pool[s % len(self.pool)])
            losses.append({k: float(aux[k]) for k in PARTS})
            m = _moments(named, adam_state(), "exp_avg")
            g = {n: (m[n] - beta1 * m_prev[n]) / (1 - beta1) if n in m
                 else torch.zeros_like(m_prev[n]) for n in m_prev}
            signs.append({n: torch.sign(v).to(torch.int8)
                          for n, v in g.items()})
            if s == 0:
                # a leaf that Adam holds no state for got no gradient
                grads = {n: float(v.norm()) for n, v in g.items()}
            m_prev = {n: m.get(n, m_prev[n]).clone() for n in m_prev}
        delta = {n: p.detach() - self.sd[n] for n, p in named()}
        change = {n: float(d.norm()) for n, d in delta.items()}
        return {"losses": losses, "grads": grads, "change": change,
                "signs": signs, "delta": delta}

    def _snapshot(self):
        """The trainer's whole state before a step, copied on the card:
        parameters and buffers, Adam's state by leaf name, and the
        drop-connect generator."""
        state = {k: v.detach().clone()
                 for k, v in self._model.state_dict().items()}
        adam = {n: {k: v.clone() for k, v in st.items()}
                for n, st in _by_name(self._named, self._adam()).items()}
        return {"state": state, "adam": adam,
                "masks": self.masks.get_state()}

    def _kept(self, named, adam_state, aux):
        """What a step leaves, copied on the card: its losses, each
        leaf's value and Adam's first moment."""
        return {"losses": {k: aux[k].detach().clone() if torch.is_tensor(
                    aux[k]) else float(aux[k]) for k in PARTS},
                "params": {n: p.detach().clone() for n, p in named()},
                "m": {n: v.clone() for n, v in
                      _moments(named, adam_state, "exp_avg").items()}}

    def _after(self, before, kept):
        """One step's losses, and per leaf the norms of its gradient as
        Adam got it (from the first moment before and after) and of its
        change, from the copy made before it."""
        beta1 = self.config["adam_betas"][0]
        grads, change = {}, {}
        for n, p in kept["params"].items():
            old = before["adam"].get(n)
            m0 = old["exp_avg"] if old else torch.zeros_like(p)
            m1 = kept["m"].get(n)
            grads[n] = (float(((m1 - beta1 * m0) / (1 - beta1)).norm())
                        if m1 is not None else 0.0)
            change[n] = float((p - before["state"][n]).norm())
        return {"losses": {k: float(v) for k, v in kept["losses"].items()},
                "grads": grads, "change": change}

    def unit(self, i, spans):
        before = self._snapshot() if i == self.check_step else None
        aux = self._step(self.pool[(FIRST_STEPS + i) % len(self.pool)])
        if not math.isfinite(float(aux["total"])):
            self.failed += 1
        if before is not None:
            self.window_step = (before, self._kept(self._named, self._adam(),
                                                   aux))
        return self.traffic["batch"]

    def finish(self):
        self._trainer = self._step = self._named = self._adam = None
        self._model = None
        free(self.device)

    def readings(self):
        from portbench.reference.train import train_step
        model, robot, opt = self._reference()
        self.masks = generator(self.device, self.seed, "masks")

        def step(batch):
            return train_step(model, robot, opt, batch, self.masks,
                              pool_k=self._pool_k(), **self._weights())
        ref = self._first_steps(step, model.named_parameters,
                                lambda: opt.state_dict()["state"])
        got = self.first
        out = {}
        for k in PARTS:
            out[f"loss_gap.{k}"] = max(
                abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
                for g, r in zip(got["losses"], ref["losses"]))
        step1 = _loss_gaps(got["losses"][0], ref["losses"][0])
        out["loss1_gap.hm"] = max(step1["geom"], step1["terrain"])
        out["loss1_gap.phys"] = step1["phys"]
        out["loss1_gap.total"] = step1["total"]
        grads = leaf_norm_gaps(got["grads"], ref["grads"])
        out["grad_gap"] = max(grads.values())
        out["grad_gap.median"] = statistics.median(grads.values())
        moved = _moved(ref["grads"])
        change = leaf_norm_gaps(got["change"], ref["change"], keep=moved)
        worst = max(change, key=change.get)
        out["change_gap"] = statistics.median(change.values())
        out["change_gap.worst"] = change[worst]
        out["change_gap.worst_leaf"] = f"{worst} ({self.sd[worst].numel()})"
        out["leaves_left_out"] = len(ref["grads"]) - len(moved)
        out.update(_sign_look(got, ref, moved, worst))
        self.first = None
        del got, ref, model, opt
        free(self.device)
        out.update(self._window_readings())
        return out

    def _window_readings(self):
        """The window's checked step, run again by the reference from the
        copy of the program's state made before it."""
        from portbench.reference.train import train_step
        if self.window_step is None:
            return {}
        before, kept = self.window_step
        self.window_step = None
        got = self._after(before, kept)
        del kept
        model, robot, opt = self._reference()
        model.load_state_dict(before["state"])
        order = [n for n, _ in model.named_parameters()]
        # copies: Adam takes the tensors it is given as its own state
        state = {j: {k: v.clone() for k, v in before["adam"][n].items()}
                 for j, n in enumerate(order) if n in before["adam"]}
        opt.load_state_dict({"state": state,
                             "param_groups": opt.state_dict()["param_groups"]})
        masks = generator(self.device, self.seed, "masks")
        masks.set_state(before["masks"])
        k = self.check_step
        aux = train_step(model, robot, opt,
                         self.pool[(FIRST_STEPS + k) % len(self.pool)],
                         masks, pool_k=self._pool_k(), **self._weights())
        ref = self._after(before, self._kept(
            model.named_parameters, opt.state_dict()["state"], aux))
        gaps = _loss_gaps(got["losses"], ref["losses"])
        grads = leaf_norm_gaps(got["grads"], ref["grads"])
        change = leaf_norm_gaps(got["change"], ref["change"],
                                keep=_moved(ref["grads"]))
        worst = max(change, key=change.get)
        return {"win_step": k,
                "win_loss_gap.hm": max(gaps["geom"], gaps["terrain"]),
                "win_loss_gap.phys": gaps["phys"],
                "win_grad_gap": max(grads.values()),
                "win_grad_gap.median": statistics.median(grads.values()),
                "win_change_gap": change[worst],
                "win_change_gap.worst_leaf": worst,
                "win_change_gap.median": statistics.median(change.values())}

    def counts(self):
        c, t, lss = self.config, self.traffic, self.ref_lss
        enc = encoder_flops(lss.grid_conf, lss.data_aug_conf, c["camC"],
                            c["downsample"], t["batch"], t["cameras"],
                            train=True)
        return {"flops_per_unit": enc + exact_rollout_flops(
            t["batch"], c["contact_points"], self.n_steps,
            flippers=c["robot"] == "marv", backward=True)}


def _by_name(named, adam_state) -> dict:
    """Adam's per-parameter state keyed by the leaf's name (Adam keys it
    by the parameter's place in ``named()``'s order)."""
    return {n: adam_state[j] for j, (n, _) in enumerate(named())
            if j in adam_state}


def _moments(named, adam_state, key) -> dict:
    return {n: st[key] for n, st in _by_name(named, adam_state).items()}


def _loss_gaps(got: dict, ref: dict) -> dict:
    return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in PARTS}


def _moved(grads: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grads.values())
    return {n for n, g in grads.items() if g >= 1e-3 * median}


def _sign_look(got, ref, moved, worst) -> dict:
    """Where the change's worst leaf parts: an element whose gradient has
    another sign on the two sides at some first step ("unsure") moves
    under Adam's first steps by about lr the other way.  Reads the share
    of such elements in the worst leaf and in all moved leaves, and the
    worst leaf's gap again with the unsure elements' change taken from
    the reference (all of the gap left there comes from sure ones)."""
    unsure = {n: torch.zeros_like(got["signs"][0][n], dtype=torch.bool)
              for n in moved}
    for gs, rs in zip(got["signs"], ref["signs"]):
        for n in moved:
            unsure[n] |= gs[n] != rs[n]
    sure_norm = {}
    for n in moved:
        d = torch.where(unsure[n], ref["delta"][n], got["delta"][n])
        sure_norm[n] = float(d.norm())
    ref_norm = {n: float(ref["delta"][n].norm()) for n in moved}
    sure = leaf_norm_gaps(sure_norm, ref_norm)
    n_all = sum(unsure[n].numel() for n in moved)
    return {"change_gap.worst_unsure_share":
            float(unsure[worst].float().mean()),
            "change_gap.unsure_share": sum(
                int(unsure[n].sum()) for n in moved) / max(n_all, 1),
            "change_gap.worst_sure": sure[worst],
            "change_gap.sure_worst": max(sure.values())}
