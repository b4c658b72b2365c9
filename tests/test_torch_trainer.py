"""The port's trainer and evaluator against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  The encoder is
``tests/fixtures.py::tiny_lss_cfg`` (two 32 x 64 cameras, D=12, the
128 x 128 BEV grid at 0.1 m) with the JAX model's variables filled from a
seed and perturbed (``test_torch_encoder.seeded_variables``), carried to
the port by ``convert.variables_to_state_dict``; the physics is tradr at
0.4 m (pool 4), B=2 x 64 control steps (remat segments of 8).  The JAX
references run jitted (~15 s for the loss and its gradient, ~5 s for the
evaluator's metrics).

Bounds, float32 rounding in another order:
- the optimizer chain against ``trainer.make_optimizer``: params within
  1e-6 (Adam's update in another order of operations);
- ``avg_pool_grid``: within 1e-6;
- BN's train-mode forward and its running statistics against flax: within
  1e-5 relative (and 1e-5 of each tensor's largest entry: flax's variance
  is E[x^2] - E[x]^2, torch's a two-pass one);
- the eval-mode losses within 1e-4 relative, their gradient in every
  parameter within 1e-4 of that tensor's largest entry (64 steps of
  contact dynamics behind the physics term; measured 9e-6);
- the evaluator's metrics within 1e-4 relative.
The JAX ``train_step`` draws dropout masks from its key, so the losses and
gradients are compared in eval mode, against ``jax.value_and_grad`` built
from ``trainer._physics_states`` and the losses.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import tiny_lss_cfg
from test_torch_encoder import rig, seeded_variables
from monoforce_tpu import losses as jlosses
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.models import LiftSplatShoot as JaxLSS
from monoforce_tpu.models.terrain_encoder.bev import BevEncode as JaxBevEncode
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu.training import trainer as jtrainer
from monoforce_tpu.training.evaluator import Evaluator as JaxEvaluator
from monoforce_tpu_torch import convert
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.models.terrain_encoder.bev import BevEncode
from monoforce_tpu_torch.models.terrain_encoder.efficientnet import EfficientNetB0
from monoforce_tpu_torch.training import Evaluator, Trainer, avg_pool_grid
from monoforce_tpu_torch.training.trainer import (clip_by_global_norm_,
                                                  compute_losses,
                                                  make_optimizer)

B, NCAM, N, T = 2, 2, 64, 16


def make_batch(seed=0, b=B):
    """The ROUGH loader's 16-tuple at the tiny shape: images, a rig of two
    level cameras yawed off the axes, (height, mask) labels, turning
    controls at 0.01 s, gravity-aligned initial poses, and a ground-truth
    path at T stamps."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(b, NCAM, 3, 32, 64)).astype(np.float32)
    calib = [np.repeat(a, b, 0) for a in rig(NCAM, (32, 64), 41.3, 0.53, 0.3)]
    hm = []
    for _ in range(2):
        h = rng.normal(scale=0.1, size=(b, 2, 128, 128)).astype(np.float32)
        h[:, 1] = rng.uniform(size=(b, 128, 128)) < 0.5
        hm.append(h)
    control_ts = np.tile(np.arange(N, dtype=np.float32) * 0.01, (b, 1))
    controls = np.stack([rng.uniform(0.2, 1.0, (b, N)),
                         rng.uniform(0.2, 0.8, (b, N))], -1).astype(np.float32)
    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose0[:, :2, 3] = rng.uniform(-1.0, 1.0, (b, 2))
    traj_ts = np.tile(np.linspace(0, (N - 1) * 0.01, T, dtype=np.float32),
                      (b, 1))
    Xs = np.zeros((b, T, 3), np.float32)
    Xs[..., :2] = pose0[:, None, :2, 3]
    Xs[..., 0] += 0.5 * traj_ts
    return (imgs, *calib, *hm, control_ts, controls, pose0, traj_ts, Xs,
            np.zeros((b, T, 3), np.float32),
            np.tile(np.eye(3, dtype=np.float32), (b, T, 1, 1)),
            np.zeros((b, T, 3), np.float32))


def lss_config():
    cfg = tiny_lss_cfg()
    return LSSConfig(data_aug_conf=cfg["data_aug_conf"],
                     grid_conf=cfg["grid_conf"],
                     soft_classes=cfg["soft_classes"])


def robots():
    jr = JaxRobotModel.from_config(JaxPhysicsConfig(robot="tradr",
                                                    grid_res=0.4))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX model, its variables, the port's state_dict, batch)."""
    cfg = tiny_lss_cfg()
    batch = make_batch()
    jm = JaxLSS(cfg["grid_conf"], cfg["data_aug_conf"])
    variables = seeded_variables(jm, batch[:6], seed=3)
    return jm, variables, convert.variables_to_state_dict(variables), batch


def port_model(sd, **kw):
    cfg = tiny_lss_cfg()
    tm = LiftSplatShoot(cfg["grid_conf"], cfg["data_aug_conf"], **kw)
    tm.load_state_dict(sd, strict=True)
    return tm


def tensors(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("grads", ["non_finite", "random"])
def test_optimizer_chain_matches_jax(grads):
    """zero non-finite -> clip 1.0 -> L2 -> Adam -> -lr against
    ``trainer.make_optimizer``: a NaN/+-inf gradient is a skipped
    contribution, never a NaN parameter; three random steps, global norms
    above and below the clip."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5,), "b": (3, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    if grads == "non_finite":
        seq = [{"a": np.array([np.nan, np.inf, -np.inf, 1.0, 0.5], np.float32),
                "b": rng.normal(size=(3, 4)).astype(np.float32)}]
    else:
        seq = [{k: (scale * rng.normal(size=s)).astype(np.float32)
                for k, s in shapes.items()} for scale in (3.0, 0.05, 1.0)]
    tx = jtrainer.make_optimizer(lr=1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    chain = make_optimizer(lr=1e-2)(list(tp.values()))
    for g in seq:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        chain.step()
        for k in shapes:
            got = tp[k].detach().numpy()
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    moved = np.abs(tp["b"].detach().numpy() - p0["b"]).max()
    assert moved > 1e-3


def test_clip_is_optax_formula():
    """(g / norm) * max_norm at or past the norm, untouched below it."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    clip_by_global_norm_(g, 1.0)
    np.testing.assert_array_equal(g[0].numpy(), np.float32([3.0, 4.0]) / 13.0)
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm_(small, 1.0)
    np.testing.assert_array_equal(small[0].numpy(), np.float32([0.3, 0.4]))


def test_avg_pool_grid_matches_jax():
    x = np.random.default_rng(8).normal(size=(2, 3, 8, 12)).astype(np.float32)
    want = jtrainer.avg_pool_grid(jnp.asarray(x), 4)
    got = avg_pool_grid(torch.from_numpy(x), 4)
    assert got.shape == (2, 3, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# ----------------------------------------------------- the model in train


def _bev_state_dict(variables):
    """A flax ``BevEncode``'s variables under the port's BevEncode names
    (the ``bevencode.`` layers of ``convert``'s table)."""
    sd = {}
    for tname, path, kind in convert._lss_layers():
        if not tname.startswith("bevencode."):
            continue
        name, p, s = tname[len("bevencode."):], variables["params"], None
        for k in path[1:]:
            p = p[k]
        if kind == "conv":
            sd[name + ".weight"] = torch.from_numpy(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy())
            if "bias" in p:
                sd[name + ".bias"] = torch.from_numpy(np.asarray(p["bias"]))
            continue
        s = variables["batch_stats"]
        for k in path[1:]:
            s = s[k]
        for tkey, node, key in (("weight", p, "scale"), ("bias", p, "bias"),
                                ("running_mean", s, "mean"),
                                ("running_var", s, "var")):
            sd[f"{name}.{tkey}"] = torch.from_numpy(np.array(node[key]))
        sd[name + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def test_batchnorm_train_mode_matches_flax():
    """One train-mode forward of ``BevEncode`` (no dropout in it) against
    flax's ``apply(..., train=True, mutable=["batch_stats"])`` on the same
    variables: the heads, and every updated running mean and variance
    (momentum 0.99, the biased batch variance).  torch's own update
    (unbiased variance) would miss the variances by n/(n-1)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 32, 32)).astype(np.float32)
    jbev = JaxBevEncode(1)
    variables = seeded_variables(jbev, (x.transpose(0, 2, 3, 1),), seed=3)
    out, mutated = jbev.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                              train=True, mutable=["batch_stats"])
    tb = BevEncode(16, 1)
    tb.load_state_dict(_bev_state_dict(variables), strict=True)
    tb.train()
    got = tb(torch.from_numpy(x))
    for k, v in out.items():
        want = np.asarray(v).transpose(0, 3, 1, 2)
        assert np.abs(want).mean() > 1e-3, k
        np.testing.assert_allclose(got[k].detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    after = _bev_state_dict({"params": variables["params"],
                             "batch_stats": mutated["batch_stats"]})
    state = tb.state_dict()
    n_stats = 0
    for k, v in after.items():
        if k.endswith(("running_mean", "running_var")):
            want = v.numpy()
            np.testing.assert_allclose(state[k].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
            n_stats += 1
    assert n_stats == 2 * 20
    # the first BN's batch of 2 x 16 x 16: torch's stock update differs
    stock = torch.nn.BatchNorm2d(64, momentum=0.01)
    stock.load_state_dict({k[4:]: v for k, v in
                           _bev_state_dict(variables).items()
                           if k.startswith("bn1.")})
    stock.train()
    stock(tb.conv1(torch.from_numpy(x)).detach())
    assert not torch.allclose(stock.running_var, state["bn1.running_var"],
                              rtol=1e-6, atol=0)


def test_stochastic_depth_draws_from_the_given_generator():
    """A train-mode B0 forward draws its drop-connect masks from the
    generator it is given: the same seed gives the same output, another
    seed another; none given raises; ``drop_connect_rate=0`` needs none."""
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(8, 3, 32, 32)).astype(np.float32))
    trunk = EfficientNetB0()
    trunk.train()

    def run(seed):
        return trunk(x, torch.Generator().manual_seed(seed))["reduction_5"]

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="Generator"):
        trunk(x)
    still = EfficientNetB0(drop_connect_rate=0.0)
    still.load_state_dict(trunk.state_dict())
    still.train()
    assert still(x)["reduction_5"].shape == run(0).shape


# --------------------------------------------------------- losses, grads


@functools.lru_cache(maxsize=None)
def _jax_losses_and_grads():
    jm, variables, _, batch = _setup()
    jr, _ = robots()
    jb = [jnp.asarray(a) for a in batch]

    def loss(params):
        terrain = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, *jb[:6])
        lg = jlosses.hm_loss(terrain["geom"], jb[6][:, 0:1], jb[6][:, 1:2])
        lt = jlosses.hm_loss(terrain["terrain"], jb[7][:, 0:1], jb[7][:, 1:2])
        states = jtrainer._physics_states(jr, terrain, jb[10], jb[9], 4)
        lp = jlosses.physics_loss([states.x], [jb[12]], jb[8], jb[11])
        return lg + 2.0 * lt + lp, (lg, lt, lp)

    (total, parts), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    sd_grads = convert.variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, grads),
         "batch_stats": variables["batch_stats"]})
    return [float(total)] + [float(p) for p in parts], sd_grads


def test_compute_losses_and_gradient_match_jax():
    """Eval mode: the geom, terrain and physics losses (weights 1, 2, 1;
    the physics from the gravity-aligned pose through 64 steps with remat
    segments and the BPTT clip) and the gradient of the total in every
    parameter of the encoder."""
    want, want_grads = _jax_losses_and_grads()
    _, _, sd, batch = _setup()
    _, tr = robots()
    tm = port_model(sd)
    total, aux = compute_losses(tm, tr, tensors(batch), train=False)
    total.backward()
    got = [float(aux[k].detach()) for k in ("total", "geom", "terrain", "phys")]
    assert min(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    n = 0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(scale, 1e-12),
                                   err_msg=name)
        n += scale > 0
    assert n > 0.9 * len(list(tm.parameters()))


def test_evaluator_metrics_match_jax(tmp_path):
    """``Evaluator._metrics`` (heightmap losses, the rollout from the GT
    state, nearest-stamp alignment, traj_xyz and traj_rot) against the JAX
    evaluator's; ``run`` writes losses.csv in the same format."""
    jm, variables, sd, batch = _setup()
    jr, tr = robots()
    jev = JaxEvaluator(jm, jr, pool_k=4, out_dir=str(tmp_path / "jax"))
    want, _, want_x = jev._step(variables, tuple(jnp.asarray(a) for a in batch))
    ev = Evaluator(port_model(sd), tr, pool_k=4, out_dir=str(tmp_path / "port"))
    got, terrain, x_pred = ev._metrics(tensors(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert x_pred.shape == (B, T, 3)
    np.testing.assert_allclose(x_pred.numpy(), want_x, atol=1e-4, rtol=0)
    means = ev.run([batch, batch])
    lines = (tmp_path / "port" / "losses.csv").read_text().splitlines()
    assert lines[0] == "batch,hm_geom,hm_terrain,traj_xyz,traj_rot"
    assert len(lines) == 3 and lines[1].startswith("0,")
    assert all(len(v.split(".")[1]) == 6 for v in lines[2].split(",")[1:])
    np.testing.assert_allclose(means["traj_xyz"], float(got["traj_xyz"]),
                               rtol=1e-6)


# ---------------------------------------------------------------- Trainer


def make_trainer(log_dir, **kw):
    return Trainer(dphys_cfg=PhysicsConfig(robot="tradr", grid_res=0.4),
                   lss_cfg=lss_config(), lr=1e-3, log_dir=str(log_dir),
                   device="cpu", **kw)


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A full checkpoint restores weights, BN statistics, Adam's moments,
    the step and the drop-connect generator: the step after ``resume``
    repeats the step after saving, bit for bit.  The plain checkpoint is
    a state_dict under the reference's names."""
    batch = make_batch(seed=1)
    tr = make_trainer(tmp_path)
    tr.init_state(seed=0)
    fresh = _params(tr)
    tr.epoch([batch])
    assert tr.step == 1
    assert any(not torch.equal(fresh[k], v) for k, v in
               tr.model.state_dict().items() if "running_var" in k)
    saved = _params(tr)
    path = tr.save_checkpoint("ck", full=True)
    assert os.path.basename(path) == "ck.pt"
    tr.epoch([batch])
    after_one = _params(tr)
    tr.resume("ck")
    assert tr.step == 1
    for k, v in saved.items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    tr.epoch([batch])
    for k, v in after_one.items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    plain = torch.load(tr.save_checkpoint("plain"))
    assert set(plain) == set(tr.model.state_dict())


def test_partial_load_pretrained(tmp_path):
    """``pretrained`` overlays the stored entries onto the fresh seeded
    weights for the keys the model has; keys it lacks are ignored."""
    ref = make_trainer(tmp_path / "ref")
    fresh = ref.init_state(seed=1)
    part = {k: v + 1.0 for k, v in fresh.items()
            if k.startswith("bevencode.up_friction")}
    part["not.a.layer"] = torch.zeros(3)
    path = str(tmp_path / "part.pth")
    torch.save(part, path)
    tr = make_trainer(tmp_path / "run", pretrained=path)
    loaded = tr.init_state(seed=1)
    for k, v in loaded.items():
        want = part[k] if k in part else fresh[k]
        assert torch.equal(v, want), k
    assert "not.a.layer" not in loaded


def test_nan_loss_saves_an_emergency_checkpoint_and_raises(tmp_path):
    tr = make_trainer(tmp_path)
    tr.init_state(seed=0)
    batch = list(make_batch(seed=2))
    batch[0] = np.full_like(batch[0], np.nan)
    with pytest.raises(ValueError, match="Loss is NaN"):
        tr.epoch([tuple(batch)], train=False)
    assert (tmp_path / "nan_emergency.pth").exists()


def test_train_logs_metrics_and_best_checkpoints(tmp_path):
    """One epoch on an in-memory loader: per-iteration and per-epoch
    records in metrics.jsonl, the best-train and best-val checkpoints,
    the prediction figure; the same seed gives the same trained weights."""
    tr = make_trainer(tmp_path / "a")
    tr.init_state(seed=0)
    loader = [make_batch(seed=3)]
    hist = tr.train(loader, [make_batch(seed=4)], n_epochs=1, seed=5)
    assert all(np.isfinite(v) for v in hist[0]["train"].values())
    recs = [json.loads(line) for line in
            (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["split"] for r in recs] == ["train", "train", "val", "val"]
    assert {"iter_loss_total", "iter_loss_phys", "step", "time"} <= set(recs[0])
    assert "epoch_loss_total" in recs[1]
    for name in ("train_best.pth", "val_best.pth",
                 "figures/prediction_epoch_0.png"):
        assert (tmp_path / "a" / name).exists(), name
    again = make_trainer(tmp_path / "b")
    again.init_state(seed=0)
    again.train(loader, [make_batch(seed=4)], n_epochs=1, seed=5,
                save_figures=False)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_new_entry_points_default_to_cuda(tmp_path):
    """DPhysics, the Trainer and fit_terrain (its exact branch too) run on
    cuda unless told otherwise: with no card they raise instead of using
    the CPU."""
    from monoforce_tpu_torch.physics import DPhysics
    from monoforce_tpu_torch.training import fit_terrain

    cfg = PhysicsConfig(robot="marv", grid_res=0.4)
    ctr = np.zeros((1, 8, 2), np.float32)
    ts = np.zeros((1, 8), np.float32)
    if torch.cuda.is_available():
        assert DPhysics(cfg).robot.device.type == "cuda"
        return
    for make in (lambda: DPhysics(cfg),
                 lambda: Trainer(cfg, log_dir=str(tmp_path)),
                 lambda: fit_terrain(cfg, ctr, [np.zeros((1, 8, 3))], ts, ts,
                                     n_iters=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert DPhysics(cfg, device="cpu").robot.device.type == "cpu"
