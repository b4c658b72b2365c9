"""Where the staged overfit's physics-stage spike comes from (CPU study).

``tests/test_torch_overfit.py`` holds ``overfit_demo``'s staged run to the
JAX test's gate "no 3x spike": the physics stage's largest total under 3
times its first.  This script measures what that gate depends on:

1. the port's warm stage, as ``overfit_demo --staged 30`` runs it (30
   heightmap-only steps at lr 1e-3, seed 0, one thread) on the tests'
   synthetic sequence (``fixtures.make_sequence``, ``tiny_lss_cfg``,
   tradr at 0.4 m over 1 s, batch 2); its weights start 2-4;
2. the first physics-stage step from those weights in train mode with
   drop-connect off: the port's losses and gradient against the JAX
   package's (the weights carried by ``torch_port.state_dict_to_variables``),
   the global norms and the largest difference over the largest entry,
   beside each side's own spread (the port at 1 and 4 threads, JAX
   jitted and op by op), and the heads' change from 1 to n threads in
   train and in eval mode;
3. the physics stage (30 steps at lr 1e-4, physics weight 1, drop-connect
   0.2 from seed 0) at each thread count, with a fresh Adam state (the
   recipe, as in JAX) and with the warm stage's Adam state carried over
   (its moments, the lr set back to 1e-4); then the warm stage at each
   thread count and the physics stage from it at one thread; per run the
   largest total over the first, the step that holds it, and the losses
   there;
4. the JAX package's physics stage from each of those warm weights (its
   own drop-connect keys, the JAX test's key sequence after 30 warm
   splits).

    python tests/overfit_spike_study.py --threads 1 2 4 6 8 \\
        --out runs/overfit_spike.json

It imports both packages, as the tests do; it is not collected by pytest.
"""

import argparse
import functools
import json
import os
import sys
import tempfile
import time
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fixtures import make_sequence, tiny_lss_cfg  # noqa: E402
from monoforce_tpu import losses as jlosses  # noqa: E402
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig  # noqa: E402
from monoforce_tpu.models import LiftSplatShoot as JaxLSS  # noqa: E402
from monoforce_tpu.models.terrain_encoder import lss as jlss  # noqa: E402
from monoforce_tpu.models.terrain_encoder.efficientnet import (  # noqa: E402
    EfficientNetB0 as JaxB0)
from monoforce_tpu.models.terrain_encoder.torch_port import (  # noqa: E402
    state_dict_to_variables)
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel  # noqa: E402
from monoforce_tpu.training import trainer as jtrainer  # noqa: E402
from monoforce_tpu_torch import convert  # noqa: E402
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig  # noqa: E402
from monoforce_tpu_torch.datasets import ROUGH  # noqa: E402
from monoforce_tpu_torch.scripts._common import lss_dict  # noqa: E402
from monoforce_tpu_torch.training import Trainer  # noqa: E402
from monoforce_tpu_torch.training.trainer import compute_losses  # noqa: E402
from monoforce_tpu_torch.utils import NumpyLoader  # noqa: E402

WARM, STEPS, LR, LR2 = 30, 30, 1e-3, 1e-4
KEYS = ("total", "geom", "terrain", "phys")


def port_trainer(lss, dphys, lr, phys_weight, root, name, **kw):
    t = Trainer(dphys_cfg=dphys, lss_cfg=lss, lr=lr, terrain_weight=2.0,
                phys_weight=phys_weight, log_dir=os.path.join(root, name),
                device="cpu", **kw)
    t.init_state(seed=0)
    return t


def run_port_stage(t, batch, steps):
    """Totals before each update, and the first update's largest entry."""
    rows, first_move = [], None
    for i in range(steps):
        before = [p.detach().clone() for p in t.model.parameters()]
        aux = t.train_step(batch, t.generator)
        rows.append({k: float(aux[k]) for k in KEYS})
        if i == 0:
            first_move = max(float((p.detach() - b).abs().max())
                             for p, b in zip(t.model.parameters(), before))
    return rows, first_move


def summary(rows, first_move=None):
    totals = [r["total"] for r in rows]
    out = {"first": totals[0], "max_over_first": max(totals) / totals[0],
           "argmax_step": int(np.argmax(totals)),
           "last5_min_over_first": min(totals[-5:]) / totals[0],
           "rows": rows}
    if first_move is not None:
        out["first_update_max_abs"] = first_move
    return out


def port_first_step(warm_sd, lss, dphys, batch, pool_k, threads):
    """The port's train-mode losses and gradient, drop-connect off."""
    torch.set_num_threads(threads)
    t = Trainer(dphys_cfg=dphys, lss_cfg=lss, lr=LR2, terrain_weight=2.0,
                phys_weight=1.0, device="cpu", drop_connect_rate=0.0,
                log_dir=tempfile.mkdtemp())
    t.init_state(seed=0)
    t.model.load_state_dict(warm_sd)
    total, aux = compute_losses(t.model, t.robot, batch, True,
                                pool_k=pool_k, terrain_weight=2.0)
    total.backward()
    torch.set_num_threads(1)
    return ({k: float(aux[k].detach()) for k in KEYS},
            {n: p.grad.detach().numpy().copy()
             for n, p in t.model.named_parameters()})


def jax_first_step(warm_sd, lss, batch, pool_k, jr, jit):
    """The JAX package's train-mode losses and gradient on the same
    weights and batch, drop-connect off; ``jit`` or op by op."""
    still = functools.partial(JaxB0, drop_connect_rate=0.0)
    with mock.patch.object(jlss, "EfficientNetB0", still):
        jm = JaxLSS(lss.grid_conf, lss.data_aug_conf)
        variables = state_dict_to_variables(warm_sd)
        jb = [jnp.asarray(b.numpy()) for b in batch]

        def loss(params):
            terrain, _ = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                *jb[:6], train=True, mutable=["batch_stats"])
            lg = jlosses.hm_loss(terrain["geom"], jb[6][:, 0:1],
                                 jb[6][:, 1:2])
            lt = jlosses.hm_loss(terrain["terrain"], jb[7][:, 0:1],
                                 jb[7][:, 1:2])
            states = jtrainer._physics_states(jr, terrain, jb[10], jb[9],
                                              pool_k)
            lp = jlosses.physics_loss([states.x], [jb[12]], jb[8], jb[11])
            return lg + 2.0 * lt + lp, (lg, lt, lp)

        fn = jax.value_and_grad(loss, has_aux=True)
        if jit:
            fn = jax.jit(fn)
        else:
            fn = jax.disable_jit()(fn)
        (jt, parts), grads = fn(variables["params"])
    grads = convert.variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, grads),
         "batch_stats": variables["batch_stats"]})
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    return (dict(zip(KEYS, [float(jt)] + [float(p) for p in parts])),
            {n: g.numpy() for n, g in grads.items()
             if not n.endswith(buffers)})


def compare(a, b):
    """Loss rel diffs; the gradients' global norms, and their largest
    difference over b's largest entry."""
    (la, ga), (lb, gb) = a, b

    def norm(gs):
        return float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in gs.values())))

    top = max(float(np.abs(g).max()) for g in gb.values())
    diff = max(float(np.abs(g - gb[n]).max()) for n, g in ga.items())
    return {"loss_rel_diff": {k: abs(la[k] - lb[k]) / abs(lb[k])
                              for k in KEYS if lb[k]},
            "grad_norms": [norm(ga), norm(gb)],
            "grad_max_diff_over_max": diff / top}


def first_step_against_jax(warm_sd, lss, dphys, batch, pool_k, jr):
    """The port against JAX beside each side's own spread: the port at 1
    and 4 threads, JAX jitted and op by op."""
    p1 = port_first_step(warm_sd, lss, dphys, batch, pool_k, 1)
    p4 = port_first_step(warm_sd, lss, dphys, batch, pool_k, 4)
    jj = jax_first_step(warm_sd, lss, batch, pool_k, jr, jit=True)
    je = jax_first_step(warm_sd, lss, batch, pool_k, jr, jit=False)
    return {"losses": {"port 1 thread": p1[0], "port 4 threads": p4[0],
                       "jax jit": jj[0], "jax op by op": je[0]},
            "port 4 threads vs port 1 thread": compare(p4, p1),
            "jax op by op vs jax jit": compare(je, jj),
            "port 1 thread vs jax op by op": compare(p1, je),
            "port 1 thread vs jax jit": compare(p1, jj)}


def heads_thread_spread(warm_sd, lss, dphys, batch, threads):
    """The heads' largest change from 1 to ``threads`` threads over the
    largest entry, in train mode (drop-connect off) and in eval mode."""
    out = {}
    for train in (True, False):
        heads = []
        for n in (1, threads):
            torch.set_num_threads(n)
            t = Trainer(dphys_cfg=dphys, lss_cfg=lss, device="cpu",
                        drop_connect_rate=0.0, log_dir=tempfile.mkdtemp())
            t.init_state(seed=0)
            t.model.load_state_dict(warm_sd)
            t.model.train(train)
            with torch.no_grad():
                heads.append(t.model(*batch[:6]))
        torch.set_num_threads(1)
        out["train" if train else "eval"] = {
            k: float((heads[1][k] - v).abs().max() / v.abs().max())
            for k, v in heads[0].items() if float(v.abs().max()) > 0}
    return out


def jax_phys_stage(warm_sd, lss, batch, pool_k, jr):
    """The JAX package's physics stage from the port's warm weights."""
    jm = JaxLSS(lss.grid_conf, lss.data_aug_conf)
    variables = state_dict_to_variables(warm_sd)
    tx = jtrainer.make_optimizer(lr=LR2)
    state = jtrainer.TrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])
    train_step, _ = jtrainer.make_train_step(jm, jr, tx, 1.0, 2.0, 1.0,
                                             pool_k)
    jb = tuple(jnp.asarray(b.numpy()) for b in batch)
    rng = jax.random.PRNGKey(0)
    for _ in range(WARM):
        rng, _ = jax.random.split(rng)
    rows = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        state, aux = train_step(state, jb, sub)
        rows.append({k: float(aux[k]) for k in KEYS})
    return summary(rows)


def warm_stage(lss, dphys, batch, root, threads):
    """overfit_demo's warm stage at ``threads`` threads: (the weights, the
    Adam state, the rows)."""
    torch.set_num_threads(threads)
    warm = port_trainer(lss, dphys, LR, 0.0, root, f"warm_{threads}")
    rows, _ = run_port_stage(warm, batch, WARM)
    torch.set_num_threads(1)
    return ({k: v.clone() for k, v in warm.model.state_dict().items()},
            warm.optimizer.state_dict(), rows)


def phys_stage(lss, dphys, batch, root, warm_sd, threads, adam_state=None):
    """overfit_demo's physics stage from ``warm_sd`` at ``threads``
    threads, with a fresh Adam or ``adam_state`` carried over."""
    torch.set_num_threads(threads)
    t = port_trainer(lss, dphys, LR2, 1.0, root, "phys")
    t.model.load_state_dict(warm_sd)
    if adam_state is not None:
        t.optimizer.load_state_dict(adam_state)
        for g in t.optimizer.adam.param_groups:
            g["lr"] = LR2
    t0 = time.time()
    rows, move = run_port_stage(t, batch, STEPS)
    torch.set_num_threads(1)
    s = summary(rows, move)
    s["seconds"] = time.time() - t0
    return s


def _say(name, s):
    r0, rm = s["rows"][0], s["rows"][s["argmax_step"]]
    print(f"{name}: max/first {s['max_over_first']:.3f} at step "
          f"{s['argmax_step']} (" + ", ".join(
              f"{k} {r0[k]:.5f} -> {rm[k]:.5f}" for k in KEYS)
          + f"), last-5 min/first {s['last5_min_over_first']:.3f}"
          + (f", first update {s['first_update_max_abs']:.3e}"
             if "first_update_max_abs" in s else ""), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 6, 8])
    ap.add_argument("--out", default="runs/overfit_spike.json")
    args = ap.parse_args(argv)
    t_start = time.time()
    root = tempfile.mkdtemp(prefix="overfit_spike_")
    seq = make_sequence(root, n_frames=4)
    cfg = tiny_lss_cfg()
    lss = LSSConfig(data_aug_conf=cfg["data_aug_conf"],
                    grid_conf=cfg["grid_conf"],
                    soft_classes=cfg["soft_classes"])
    dphys = PhysicsConfig(robot="tradr", grid_res=0.4, traj_sim_time=1.0)
    loader = NumpyLoader(ROUGH(seq, lss_cfg=lss_dict(lss), dphys_cfg=dphys),
                         batch_size=2, drop_last=True)
    probe = port_trainer(lss, dphys, LR, 0.0, root, "probe")
    batch, pool_k = probe._batch(next(iter(loader))), probe.pool_k
    result = {"threads": args.threads}

    warm_sd, warm_opt, warm_rows = warm_stage(lss, dphys, batch, root, 1)
    result["warm"] = summary(warm_rows)
    _say("warm stage, 1 thread", result["warm"])

    jr = JaxRobotModel.from_config(JaxPhysicsConfig(
        robot="tradr", grid_res=0.4, traj_sim_time=1.0))
    result["first_step"] = first_step_against_jax(warm_sd, lss, dphys, batch,
                                                  pool_k, jr)
    print("first physics step:", json.dumps(result["first_step"]),
          flush=True)
    result["heads_thread_spread"] = {
        n: heads_thread_spread(warm_sd, lss, dphys, batch, n)
        for n in args.threads if n > 1}
    print("heads, 1 thread against n:",
          json.dumps(result["heads_thread_spread"]), flush=True)

    name = "warm 1 thread, JAX phys"
    jax_runs = {name: jax_phys_stage(warm_sd, lss, batch, pool_k, jr)}
    _say(name, jax_runs[name])
    # one set of warm weights, the physics stage at each thread count
    runs = {}
    for n in args.threads:
        for adam in ("fresh", "carried"):
            name = f"warm 1 thread, phys {n} threads, {adam} Adam"
            runs[name] = phys_stage(lss, dphys, batch, root, warm_sd, n,
                                    warm_opt if adam == "carried" else None)
            _say(name, runs[name])
    # the warm stage at each thread count, the physics stage at one
    for n in args.threads:
        if n == 1:
            continue
        sd_n, _, rows_n = warm_stage(lss, dphys, batch, root, n)
        name = f"warm {n} threads, phys 1 thread, fresh Adam"
        runs[name] = phys_stage(lss, dphys, batch, root, sd_n, 1)
        runs[name]["warm_last"] = rows_n[-1]
        _say(name, runs[name])
        name = f"warm {n} threads, JAX phys"
        jax_runs[name] = jax_phys_stage(sd_n, lss, batch, pool_k, jr)
        _say(name, jax_runs[name])
    result["port_phys_stage"] = runs
    result["jax_phys_stage"] = jax_runs
    result["seconds"] = time.time() - t_start
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out} ({result['seconds']:.0f} s)")


if __name__ == "__main__":
    main()
