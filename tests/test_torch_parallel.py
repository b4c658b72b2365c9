"""The port's ``parallel`` package against the JAX package's, on the CPU.

- Meshes and sharding: 8 shards on the CPU, the specs, the shapes, the
  inverse, a raise when the batch does not divide.
- ``sharded_shoot`` at tests/test_parallel.py's shape (tradr's 0.11 m
  cloud, P=97, 128 x 128 at 0.1 m, 128 x 50 over 8 shards of 16), inputs
  drawn with numpy from a seed: against the port's unsharded
  ``planner_rollout`` at test_parallel.py's gates (positions RMSE < 5e-5 m,
  costs within rtol 2e-2), each shard's mode that of its local batch
  (``pair3_muq``: ``friction=None`` is a grid of ones, as in JAX); and
  against the JAX ``sharded_shoot`` on the 8-device CPU mesh
  (tests/conftest.py) at tests/test_torch_planner.py's bounds for the
  serving modes (positions RMSE < 1e-4 m, costs within rtol 1e-4: float32
  sums in another order over 50 steps).
- The data-parallel train step: two gloo ranks against the port's
  single-process step on the same global batch of 8 (the tiny-geometry
  B0 of ``__graft_entry__._tiny_cfgs``, SGD 1e-2 as in
  test_parallel.py::test_train_step_dp_equivalence, drop-connect 0).  In
  float32 the total loss within that test's rtol 1e-5.  The parameters
  and BN statistics are held in float64 (model, robot, batch, BN
  statistics and losses): there the two differ by ~1e-14, and the bound,
  atol 1e-11 and rtol 1e-10, is 1e6 times tighter than the JAX test's
  atol 1e-5 and rtol 1e-4.  In float32 the step's rounding (BN's batch
  statistics through the backward) moved a few stem entries by up to
  1.8e-5 on some hosts, so a float32 bound there decided the host, not
  the data-parallel semantics; the card holds the float32 step at the
  JAX bound (chip_smoke.py phase 11).  One case places NaN label cells
  unevenly (the ranks count different valid cells, where averaging the
  ranks' own means is not the global mean); the other has none.
- ``run_ranks`` with NCCL on a machine without enough cards raises at
  once, and ranks map to cards in rank order.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.parallel import make_mesh as jax_make_mesh
from monoforce_tpu.parallel import sharded_shoot as jax_sharded_shoot
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.losses import hm_loss
from monoforce_tpu_torch.parallel import (data_parallel, data_sharding,
                                          gather_batch, make_mesh, replicated,
                                          run_ranks, shard_batch,
                                          sharded_shoot)
from monoforce_tpu_torch.physics import fast
from monoforce_tpu_torch.physics.engine import RigidState
from monoforce_tpu_torch.physics.fast import planner_rollout
from monoforce_tpu_torch.planner.shooting import (force_variance_cost,
                                                  inclination_cost)
from monoforce_tpu_torch.scripts import full_b0_sharded

B, N, SHARDS = 128, 50, 8
# the float64 data-parallel step against one process: parameters and BN
# statistics (the gap is ~1e-14)
DP_F64_TOL = dict(atol=1e-11, rtol=1e-10)


def test_make_mesh_and_sharding_helpers():
    mesh = make_mesh(SHARDS, device="cpu")
    assert mesh.size == SHARDS and mesh.shape == {"data": SHARDS}
    assert mesh.devices == (torch.device("cpu"),) * SHARDS
    batch = {"a": torch.arange(64.0).reshape(16, 4), "b": np.arange(16)}
    sharded = shard_batch(batch, mesh)
    assert sharded["a"].sharding.spec[0] == "data"
    assert sharded["a"].sharding.spec == ("data", None)
    assert [tuple(s.shape) for s in sharded["b"].shards] == [(2,)] * SHARDS
    back = gather_batch(sharded)
    assert torch.equal(back["a"], batch["a"])
    assert np.array_equal(back["b"].numpy(), batch["b"])
    assert data_sharding(mesh, 3).spec == ("data", None, None)
    assert replicated(mesh).spec == ()
    state = RigidState(*(torch.zeros(16, 3) for _ in range(4)))
    assert isinstance(shard_batch(state, mesh), RigidState)
    with pytest.raises(ValueError):
        shard_batch({"a": torch.zeros(12, 4)}, mesh)


def test_make_mesh_device_rules():
    """A device type takes that many cards and raises when fewer exist; a
    named device holds every shard."""
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        for kw in ({}, {"n_devices": 2}):
            with pytest.raises(RuntimeError):
                make_mesh(device="cuda", **kw)
        with pytest.raises(RuntimeError):
            make_mesh(2, device="cuda:0")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    z = (0.1 * rng.normal(size=(128, 128))).astype(np.float32)
    ctr = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    return z, ctr


def _robots():
    jr = JaxRobotModel.from_config(JaxPhysicsConfig(robot="tradr"))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


@pytest.fixture(scope="module")
def shot():
    """The port's sharded shoot at test_parallel.py's shape, with the modes
    its shards ran, and the JAX one on the same inputs (one jitted
    call)."""
    z, ctr = _inputs()
    jr, tr = _robots()
    modes = []
    mode = fast.planner_kernel_mode

    def spy(robot, batch_size, uniform_friction=True):
        modes.append((batch_size, uniform_friction,
                      mode(robot, batch_size, uniform_friction)))
        return modes[-1][2]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fast, "planner_kernel_mode", spy)
        xs, costs = sharded_shoot(make_mesh(SHARDS, device="cpu"), tr, z,
                                  ctr)
    jxs, jcosts = jax_sharded_shoot(jax_make_mesh(SHARDS), jr,
                                    jnp.asarray(z), jnp.asarray(ctr))
    return dict(z=z, ctr=ctr, robot=tr, xs=xs, costs=costs, modes=modes,
                jxs=np.asarray(jxs), jcosts=np.asarray(jcosts))


def test_sharded_shoot_matches_unsharded(shot):
    """Sharding is a no-op on the semantics: the same serving rollout
    unsharded (test_parallel.py's reference, friction None), each shard in
    the mode of its local batch of 16."""
    assert shot["xs"].shape == (B, N, 3) and shot["costs"].shape == (B,)
    assert shot["modes"] == [(B // SHARDS, False, "pair3_muq")] * SHARDS
    s, st = planner_rollout(shot["robot"], shot["z"], shot["ctr"])
    rmse = float(torch.sqrt(torch.mean((shot["xs"] - s.x) ** 2)))
    assert rmse < 5e-5, rmse
    np.testing.assert_allclose(shot["costs"].numpy(),
                               force_variance_cost(st.spring_std).numpy(),
                               rtol=2e-2)


def test_sharded_shoot_matches_jax(shot):
    rmse = float(np.sqrt(np.mean((shot["xs"].numpy() - shot["jxs"]) ** 2)))
    assert rmse < 1e-4, rmse
    np.testing.assert_allclose(shot["costs"].numpy(), shot["jcosts"],
                               rtol=1e-4)
    assert int(torch.argmin(shot["costs"])) == int(np.argmin(shot["jcosts"]))


def test_sharded_shoot_with_state0_and_inclination():
    """test_parallel.py:61-73's case (shards of 2: the packed mode), finite
    and equal to the unsharded path (B=16: pair3_muq) on the flat grid,
    where both tap formats hold the terrain exactly."""
    _, tr = _robots()
    z = np.zeros((128, 128), np.float32)
    b = 16
    ctr = np.tile(np.float32([[0.5, 0.2]]), (b, 40, 1))
    s0 = RigidState(torch.zeros(b, 3), torch.zeros(b, 3),
                    torch.eye(3).expand(b, 3, 3), torch.zeros(b, 3))
    xs, costs = sharded_shoot(make_mesh(SHARDS, device="cpu"), tr, z, ctr,
                              state0=s0, cost="inclination")
    assert costs.shape == (b,) and bool(torch.isfinite(costs).all())
    s, st = planner_rollout(tr, z, ctr, state0=s0,
                            friction=np.ones_like(z))
    np.testing.assert_allclose(xs.numpy(), s.x.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        costs.numpy(), inclination_cost(st.abs_roll, st.abs_pitch).numpy(),
        rtol=1e-4, atol=1e-7)


# the first half of the batch loses most of its label cells, the second
# half a few: the ranks count different valid cells
UNEVEN = (0.6,) * 4 + (0.02,) * 4


@pytest.mark.parametrize("nans", ["uneven", "none"])
def test_dp_step_matches_single_process(nans, tmp_path):
    nan_fracs = UNEVEN if nans == "uneven" else None
    args = ("cpu", 8, True, nan_fracs)
    _, dphys = full_b0_sharded.tiny_configs()
    labels = torch.from_numpy(full_b0_sharded.synthetic_batch(
        dphys, 8, 0, nan_fracs=nan_fracs)[6][:, 0:1])
    counts = [int((~torch.isnan(h)).sum()) for h in labels.split(4)]
    zero = torch.zeros_like(labels)
    halves = [float(hm_loss(zero[s], labels[s]))
              for s in (slice(0, 4), slice(4, 8))]
    whole = float(hm_loss(zero, labels))
    if nans == "uneven":
        # averaging the ranks' own means is not the global mean here
        assert counts[0] < counts[1]
        assert abs(np.mean(halves) - whole) > 1e-3 * whole
    else:
        assert counts[0] == counts[1]

    one = full_b0_sharded.train_rank(0, 1, *args)
    ranks = run_ranks(full_b0_sharded.train_rank, 2, args, timeout=300,
                      workdir=str(tmp_path))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"][0]["total"],
                               one["losses"][0]["total"], rtol=1e-5)

    args64 = args + ("float64",)
    one = full_b0_sharded.train_rank(0, 1, *args64)
    ranks = run_ranks(full_b0_sharded.train_rank, 2, args64, timeout=300,
                      workdir=str(tmp_path))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    np.testing.assert_allclose(ranks[0]["losses"][0]["total"],
                               one["losses"][0]["total"], rtol=1e-12)
    n_running = 0
    for k, want in one["state"].items():
        got = ranks[0]["state"][k]
        if not want.dtype.is_floating_point:
            assert torch.equal(got, want), k
            continue
        assert want.dtype == torch.float64, k
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=k,
                                   **DP_F64_TOL)
        n_running += "running" in k
    assert n_running > 0   # the BN statistics are among the checked tensors


def test_run_ranks_nccl_without_enough_cards_raises(monkeypatch, tmp_path):
    """NCCL runs one rank a card: with fewer cards than ranks run_ranks
    raises before any rank starts (no gloo fallback, no wait for the
    timeout)."""
    args = ("cuda", 4, True, None)
    for have in ((0, 2) if not torch.cuda.is_available() else ()) + (1,):
        monkeypatch.setattr(torch.cuda, "is_available", lambda h=have: h > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda h=have: h)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="NCCL runs one rank a card"):
            run_ranks(full_b0_sharded.train_rank, have + 1, args,
                      backend="nccl", timeout=600, workdir=str(tmp_path))
        assert time.perf_counter() - t0 < 5.0
    assert not list(tmp_path.iterdir())     # no rank's store was made


def test_nccl_ranks_map_to_their_cards(monkeypatch, tmp_path):
    """Rank r of four runs on card r: the script's device rule, and the
    group's setup, which selects the card before joining the group and
    hands it to NCCL; gloo ranks select none."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", r) for r in range(4)]
    assert [full_b0_sharded._rank_device("cuda", r)
            for r in range(4)] == cards
    assert {full_b0_sharded._rank_device("cuda:0", r)
            for r in range(4)} == {torch.device("cuda", 0)}
    assert full_b0_sharded._rank_device("cpu", 3) == torch.device("cpu")
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(data_parallel.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            (backend, kw["rank"], kw["world_size"],
                             kw.get("device_id"))))
    for r in range(4):
        assert data_parallel._join("nccl", r, 4, str(tmp_path), 60) == \
            cards[r]
    assert calls == [c for r in range(4) for c in
                     (("set_device", cards[r]), ("nccl", r, 4, cards[r]))]
    calls.clear()
    assert data_parallel._join("gloo", 1, 2, str(tmp_path), 60) is None
    assert calls == [("gloo", 1, 2, None)]
