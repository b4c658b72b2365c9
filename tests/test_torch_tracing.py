"""The spans and counters of ``monoforce_tpu_torch.utils.profiling``: off
by default and free there, and inside ``recording()`` the tick's and the
train step's span trees, their counters, and outputs bit for bit as with
recording off.  Tiny shapes on the CPU (the kernels' plain versions)."""

import tracemalloc

import numpy as np
import pytest
import torch

from fixtures import tiny_lss_cfg
from monoforce_tpu_torch import ops
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.training import Trainer
from monoforce_tpu_torch.utils import profiling
from monoforce_tpu_torch.utils.profiling import (count, host_ms, recording,
                                                 span, trace)
from test_torch_encoder import rig

N_TRAJ, N_STEPS = 16, 40       # two blocks of 32 steps and one of 8
TICK_TREE = {"tick": None, "encode": "tick", "encode.cam": "encode",
             "encode.splat": "encode", "encode.bev": "encode",
             "plan": "tick", "rollout": "plan", "rollout.settle": "rollout",
             "rollout.extract": "rollout", "rollout.steps": "rollout",
             "rollout.stats": "rollout", "plan.cost": "plan"}
TRAIN_TREE = {"train_step": None, "encoder.forward": "train_step",
              "encode.cam": "encoder.forward",
              "encode.splat": "encoder.forward",
              "encode.bev": "encoder.forward",
              "physics.forward": "train_step", "backward": "train_step",
              "physics.backward": "backward",
              "encoder.backward": "backward", "optimizer": "train_step"}


def _lss():
    cfg = tiny_lss_cfg()
    return LSSConfig(data_aug_conf=cfg["data_aug_conf"],
                     grid_conf=cfg["grid_conf"])


@pytest.fixture(scope="module")
def tick():
    """A seeded MonoForce at the tiny shape, a frame and its controls."""
    dcfg = PhysicsConfig.for_planner("tradr", traj_sim_time=N_STEPS * 0.01)
    dcfg.n_sim_trajs = N_TRAJ
    mf = MonoForce(dcfg, _lss(), device="cpu")
    mf.init_params(seed=3)
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(1, 2, 3, 32, 64)).astype(np.float32)
    inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                   (imgs,) + rig(2, (32, 64), focal=41.3, height=0.53,
                                 yaw0=0.3))
    controls, _ = shooting_controls(torch.Generator().manual_seed(1), N_TRAJ,
                                    dcfg.vel_max, dcfg.omega_max,
                                    dcfg.traj_sim_time, dcfg.dt)
    assert controls.shape[1] == N_STEPS
    return mf, inputs, controls


def _tree(taken):
    """{name: parent's name} of the spans, and the request ids."""
    by_id = {s.id: s for s in taken["spans"]}
    tree = {}
    for s in taken["spans"]:
        tree.setdefault(s.name, set()).add(
            by_id[s.parent].name if s.parent is not None else None)
    return ({k: v.pop() for k, v in tree.items() if len(v) == 1},
            {s.request for s in taken["spans"]})


def test_off_records_nothing_and_allocates_nothing(tick):
    mf, inputs, controls = tick
    assert span("tick") is span("rollout") is profiling._NOOP
    mf.run(*inputs, controls=controls)
    count("rollout.steps", 5)
    with recording() as rec:
        assert rec.take() == {"spans": [], "counters": {}}
    assert span("tick") is profiling._NOOP

    def shared():
        with profiling._NOOP:
            pass

    def spanned():
        with span("rollout.steps"):
            count("rollout.steps", 32)

    # the traced memory each call holds at its peak, over what it leaves
    # (the ``with`` statement's own): a span or counter that allocated
    # would lift the second above the first
    peaks = []
    tracemalloc.start()
    try:
        for f in (shared, spanned, shared, spanned):
            f()
            tracemalloc.reset_peak()
            f()
            current, peak = tracemalloc.get_traced_memory()
            peaks.append(peak - current)
    finally:
        tracemalloc.stop()
    assert peaks[1] == peaks[0] and peaks[3] == peaks[2]


def test_tick_span_tree_and_counters(tick):
    mf, inputs, controls = tick
    with recording() as rec:
        mf.run(*inputs, controls=controls)
        taken = rec.take()
    tree, requests = _tree(taken)
    assert tree == TICK_TREE
    assert len(requests) == 1
    (request,) = requests
    names = [s.name for s in taken["spans"]]
    assert names.count("rollout.extract") == names.count("rollout.steps") == 2
    assert names.count("tick") == 1 and "plan.controls" not in names
    for s in taken["spans"]:
        assert s.end_ns >= s.start_ns
    counters = taken["counters"]
    assert set(counters) == {request}
    # the kernels' plain versions launch nothing on the CPU; every step of
    # the serving mode is a fused step
    assert counters[request] == {"rollout.steps": N_STEPS,
                                 "rollout.fused_steps": N_STEPS}
    ms = host_ms(taken)
    assert ms["tick"] >= ms["encode"] + ms["plan"]
    assert ms["plan"] >= ms["rollout"] + ms["plan.cost"]

    # controls drawn by the tick: their span lies in the plan
    with recording() as rec:
        mf.run(*inputs, generator=torch.Generator().manual_seed(2))
        tree, _ = _tree(rec.take())
    assert tree["plan.controls"] == "plan"


def test_tick_outputs_equal_with_recording_on(tick):
    mf, inputs, controls = tick
    heads0, plan0 = mf.run(*inputs, controls=controls)
    with recording():
        heads1, plan1 = mf.run(*inputs, controls=controls)
    for k in heads0:
        assert torch.equal(heads0[k], heads1[k]), k
    for a, b in zip(plan0, plan1):
        assert torch.equal(a, b)
    assert int(plan0.best) == int(plan1.best)


def _batch(b=2, n=32, t=8, seed=0):
    """The ROUGH loader's 16-tuple at the tiny shape (two cameras)."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(b, 2, 3, 32, 64)).astype(np.float32)
    calib = [np.repeat(a, b, 0) for a in rig(2, (32, 64), 41.3, 0.53, 0.3)]
    hm = []
    for _ in range(2):
        h = rng.normal(scale=0.1, size=(b, 2, 128, 128)).astype(np.float32)
        h[:, 1] = rng.uniform(size=(b, 128, 128)) < 0.5
        hm.append(h)
    control_ts = np.tile(np.arange(n, dtype=np.float32) * 0.01, (b, 1))
    controls = np.stack([rng.uniform(0.2, 1.0, (b, n)),
                         rng.uniform(0.2, 0.8, (b, n))], -1)
    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose0[:, :2, 3] = rng.uniform(-1.0, 1.0, (b, 2))
    traj_ts = np.tile(np.linspace(0, (n - 1) * 0.01, t, dtype=np.float32),
                      (b, 1))
    Xs = np.zeros((b, t, 3), np.float32)
    Xs[..., :2] = pose0[:, None, :2, 3]
    Xs[..., 0] += 0.5 * traj_ts
    batch = (imgs, *calib, *hm, control_ts, controls.astype(np.float32),
             pose0, traj_ts, Xs, np.zeros((b, t, 3), np.float32),
             np.tile(np.eye(3, dtype=np.float32), (b, t, 1, 1)),
             np.zeros((b, t, 3), np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


def _trainer(log_dir):
    tr = Trainer(dphys_cfg=PhysicsConfig(robot="tradr", grid_res=0.4),
                 lss_cfg=_lss(), lr=1e-3, log_dir=str(log_dir), device="cpu")
    tr.init_state(seed=0)
    return tr


def test_train_step_span_tree_and_outputs(tmp_path):
    batch = _batch()
    params = []
    for on in (False, True):
        tr = _trainer(tmp_path / str(on))
        gen = torch.Generator().manual_seed(5)
        if on:
            with recording() as rec:
                aux = tr.train_step(batch, gen)
                taken = rec.take()
        else:
            aux = tr.train_step(batch, gen)
        assert np.isfinite(float(aux["total"]))
        params.append({k: v.clone() for k, v in
                       tr.model.state_dict().items()})
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k

    tree, requests = _tree(taken)
    assert tree == TRAIN_TREE
    assert len(requests) == 1
    (request,) = requests
    # nothing counted: the kernels' plain versions launch nothing
    assert taken["counters"] == {}
    first = {s.name: s for s in reversed(taken["spans"])}
    assert first["physics.backward"].end_ns <= \
        first["encoder.backward"].start_ns
    assert first["physics.forward"].end_ns <= first["backward"].start_ns
    ms = host_ms(taken)
    assert ms["backward"] >= ms["physics.backward"] + ms["encoder.backward"]


def test_launch_counters_registered_and_reported():
    wrappers = {"fk_step_zu", "fk_step_muq", "fk_step_pairmu",
                "fk_step_pair3", "fk_step_packed", "fk_step", "fk_interp",
                "fk_interp_bwd"}
    names = [n for n, _ in profiling._counted]
    assert sorted(names) == sorted(wrappers)
    for n, w in profiling._counted:
        assert getattr(ops, n) is w
    # a request reports each wrapper's change of ``.launches``, and only
    # the wrappers that moved
    with recording() as rec:
        with span("rollout") as top:
            ops.fk_step_pairmu.launches += 3
            ops.fk_interp.launches += 1
        taken = rec.take()
    ops.fk_step_pairmu.launches -= 3
    ops.fk_interp.launches -= 1
    assert taken["counters"] == {top.id: {"launches.fk_step_pairmu": 3,
                                          "launches.fk_interp": 1}}


def test_trace_shows_the_spans(tick, tmp_path):
    mf, inputs, controls = tick
    with trace(str(tmp_path)) as prof:
        mf.run(*inputs, controls=controls)
    names = {e.name for e in prof.events()}
    assert {"mf.tick", "mf.encode", "mf.rollout", "mf.rollout.steps"} <= names
    assert (tmp_path / "trace.json").exists()
    # recording ends with the trace
    assert span("tick") is profiling._NOOP
