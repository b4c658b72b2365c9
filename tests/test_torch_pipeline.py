"""The port's MonoForce (images -> terrain -> best path) against the JAX
package's, on the CPU.

Both packages get the same weights (the JAX variables, seeded and
perturbed as in tests/test_torch_encoder.py, carried across by
``variables_to_state_dict``), the same seeded images on a two-camera rig,
the same numpy-made shooting controls, and the geometry of
``fixtures.tiny_lss_cfg()`` (32 x 64 images, the 128 x 128 grid at 0.1 m)
in front of ``PhysicsConfig.for_planner("tradr", traj_sim_time=1.0)`` with
16 trajectories: the tick's ``pair`` mode (P=62, friction from the
encoder's head), 100 steps.

The JAX side runs the two stages of ``MonoForce._predict``
(monoforce_tpu/pipeline.py:63-75) as two jitted programs, ``model.apply``
and ``planner.shooting._plan``, with the initial state that ``run`` and
``planner_rollout`` build (``_default_state0`` when none is given, a
single state broadcast over the batch otherwise), so that one compile of
the 100-step planner (~30 s here) serves every plan below.

Tolerances: terrain heads as in tests/test_torch_encoder.py (float32
within 1e-5; half mode within RMSE 0.005 of the JAX half mode).  Plans as
tests/test_torch_planner.py holds them (positions RMSE < 1e-4 m, costs
within rtol 1e-4, the same best path) from one shared terrain, and from
each package's own float32 terrain (they differ by ~3e-7; measured:
positions 4e-8 m, costs 2e-6).  The half modes' terrains differ by RMSE
~1e-4 (bf16 rounding in each backend's kernels), and the planner reads
the terrain as bf16 window words, where such a difference moves taps by a
bf16 step (4 mm at 0.8 m): their plans are held to positions RMSE
< 0.02 m, costs within rtol 0.3 and a best path costing at most 10% above
the lowest (measured: 6 mm, 0.13, the same path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import tiny_lss_cfg
from monoforce_tpu.config import LSSConfig as JaxLSSConfig
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.models.terrain_encoder.lss import half_inference_variables
from monoforce_tpu.physics.engine import RigidState as JaxRigidState
from monoforce_tpu.physics.engine import _default_state0 as jax_state0
from monoforce_tpu.pipeline import MonoForce as JaxMonoForce
from monoforce_tpu.planner.shooting import _plan as jax_plan
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.convert import variables_to_state_dict
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import RigidState
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.planner.shooting import _plan
from test_torch_encoder import HEADS, rig, rmse, seeded_variables

B_TRAJ = 16


def _configs(jax_side):
    ld = tiny_lss_cfg()
    lss_cls, phys_cls = ((JaxLSSConfig, JaxPhysicsConfig) if jax_side
                         else (LSSConfig, PhysicsConfig))
    lss = lss_cls(data_aug_conf=ld["data_aug_conf"], grid_conf=ld["grid_conf"])
    dcfg = phys_cls.for_planner("tradr", traj_sim_time=1.0)
    dcfg.n_sim_trajs = B_TRAJ
    return dcfg, lss


def _controls(rng, n):
    """Front/back shooting controls as the online node samples them."""
    v = np.concatenate([rng.uniform(0.5, 1.0, B_TRAJ // 2),
                        rng.uniform(-1.0, -0.5, B_TRAJ - B_TRAJ // 2)])
    w = rng.uniform(-2.0, 2.0, B_TRAJ)
    return np.ascontiguousarray(np.broadcast_to(
        np.stack([v, w], -1)[:, None], (B_TRAJ, n, 2)).astype(np.float32))


class _Jax:
    """The JAX MonoForce's weights and its two jitted stages."""

    def __init__(self, inputs):
        dcfg, lss = _configs(jax_side=True)
        self.mf = JaxMonoForce(dphys_cfg=dcfg, lss_cfg=lss)
        self.variables = seeded_variables(self.mf.model, inputs, seed=3)
        self.apply = jax.jit(self.mf.model.apply)
        self.inputs = [jnp.asarray(a) for a in inputs]

    def encode(self, half):
        v = half_inference_variables(self.variables) if half else self.variables
        imgs = self.inputs[0].astype(jnp.bfloat16 if half else jnp.float32)
        out = self.apply(v, imgs, *self.inputs[1:])
        return {k: np.array(a) for k, a in out.items()}

    def plan(self, terrain, controls, state0=None):
        """_plan on terrain[0, 0] and friction[0, 0], as ``run`` does."""
        ctr = jnp.asarray(controls)
        if state0 is None:
            s0 = jax_state0(ctr)
        else:
            s0 = JaxRigidState(*[jnp.broadcast_to(jnp.asarray(a),
                                                  (B_TRAJ,) + np.shape(a))
                                 for a in state0])
        out = jax_plan(self.mf.robot, jnp.asarray(terrain["terrain"][0, 0]),
                       jnp.asarray(terrain["friction"][0, 0]), ctr, s0,
                       self.mf.cost)
        return {k: np.asarray(a) for k, a in out._asdict().items()}


@pytest.fixture(scope="module")
def tick(tmp_path_factory):
    """(JAX side, the port's float32 and half MonoForce with the JAX
    weights, inputs, controls)."""
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(1, 2, 3, 32, 64)).astype(np.float32)
    inputs = (imgs,) + rig(2, (32, 64), focal=41.3, height=0.53, yaw0=0.3)
    jx = _Jax(inputs)
    path = tmp_path_factory.mktemp("ckpt") / "lss.pth"
    torch.save(variables_to_state_dict(jx.variables), path)
    dcfg, lss = _configs(jax_side=False)
    ports = {}
    for half in (False, True):
        ports[half] = MonoForce(dcfg, lss, half=half, device="cpu")
        ports[half].load_torch_checkpoint(str(path))
    return jx, ports, inputs, _controls(rng, dcfg.n_sim_steps)


def _np(plan):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in plan._asdict().items()}


# (position RMSE m, costs rtol, best path's cost above the lowest, relative;
# None: the same best index)
TIGHT = (1e-4, 1e-4, None)
HALF_OWN_TERRAIN = (0.02, 0.3, 0.1)


def _plans_agree(got, want, tol):
    pos_tol, cost_rtol, best_rtol = tol
    assert got["xs"].shape == want["xs"].shape == (B_TRAJ, 100, 3)
    assert np.isfinite(got["xs"]).all() and np.isfinite(got["costs"]).all()
    assert rmse(got["xs"], want["xs"]) < pos_tol, rmse(got["xs"], want["xs"])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=cost_rtol)
    if best_rtol is None:
        assert int(got["best"]) == int(want["best"])
    else:
        c = want["costs"]
        assert c[int(got["best"])] - c.min() <= best_rtol * abs(c.min())


@pytest.mark.parametrize("half", [False, True], ids=["f32", "half"])
def test_tick_matches_jax(tick, half):
    """run(): the terrain heads, then the plan on each package's own
    terrain, then the plan on the JAX terrain given to both planners."""
    jx, ports, inputs, controls = tick
    mf = ports[half]
    terrain, plan = mf.run(*[torch.from_numpy(a) for a in inputs],
                           controls=torch.from_numpy(controls))
    got_t = {k: v.numpy() for k, v in terrain.items()}
    want_t = jx.encode(half)
    for k in HEADS:
        assert got_t[k].dtype == np.float32 and got_t[k].shape == (1, 1, 128, 128)
        assert np.abs(want_t[k]).mean() > 0.01, f"{k} carries no signal"
        if half:
            assert rmse(got_t[k], want_t[k]) < 0.005, (k, rmse(got_t[k], want_t[k]))
        else:
            np.testing.assert_allclose(got_t[k], want_t[k], atol=1e-5, rtol=0,
                                       err_msg=k)
    _plans_agree(_np(plan), jx.plan(want_t, controls),
                 HALF_OWN_TERRAIN if half else TIGHT)
    shared = _plan(mf.robot, torch.from_numpy(want_t["terrain"][0, 0]),
                   torch.from_numpy(want_t["friction"][0, 0]),
                   torch.from_numpy(controls), None, mf.cost)
    _plans_agree(_np(shared), jx.plan(want_t, controls), TIGHT)


def test_unbatched_state0_and_sampled_controls(tick):
    """A single robot state is repeated over the batch, as the JAX run
    does; without controls, run draws them from the generator."""
    jx, ports, inputs, controls = tick
    mf = ports[False]
    args = [torch.from_numpy(a) for a in inputs]
    c, s = np.cos(0.4), np.sin(0.4)
    s0 = ([0.2, -0.3, 0.0], [0.4, 0.1, 0.0],
          [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], [0.0, 0.0, 0.3])
    state0 = RigidState(*(torch.tensor(a, dtype=torch.float32) for a in s0))
    terrain, plan = mf.run(*args, controls=torch.from_numpy(controls),
                           state0=state0)
    want = jx.plan({k: v.numpy() for k, v in terrain.items()}, controls,
                   [np.asarray(a, np.float32) for a in s0])
    _plans_agree(_np(plan), want, TIGHT)
    assert np.abs(plan.xs[:, 0, :2].numpy() - [0.2, -0.3]).max() < 0.05

    gen = torch.Generator().manual_seed(5)
    _, sampled = mf.run(*args, generator=gen)
    cfg = mf.dphys_cfg
    want_ctr, _ = shooting_controls(torch.Generator().manual_seed(5), B_TRAJ,
                                    cfg.vel_max, cfg.omega_max,
                                    cfg.traj_sim_time, cfg.dt)
    again = _plan(mf.robot, terrain["terrain"][0, 0], terrain["friction"][0, 0],
                  want_ctr, None, mf.cost)
    assert torch.equal(sampled.xs, again.xs) and torch.equal(sampled.best,
                                                             again.best)


def test_load_torch_checkpoint(tick, tmp_path):
    """A converted checkpoint saved with torch.save loads strictly (the
    fixture's models came through it) and encodes as the weights it came
    from; a checkpoint short of a key is refused."""
    jx, ports, inputs, _ = tick
    sd = variables_to_state_dict(jx.variables)
    path = tmp_path / "lss.pth"
    torch.save(sd, path)
    dcfg, lss = _configs(jax_side=False)
    mf = MonoForce(dcfg, lss, device="cpu")
    with pytest.raises(RuntimeError):
        mf.encode(*[torch.from_numpy(a) for a in inputs])
    loaded = mf.load_torch_checkpoint(str(path))
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    got = mf.encode(*[torch.from_numpy(a) for a in inputs])
    want = ports[False].encode(*[torch.from_numpy(a) for a in inputs])
    for k in HEADS:
        assert torch.equal(got[k], want[k]), k
    del sd["bevencode.up_friction.4.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        mf.load_torch_checkpoint(str(path))


def test_default_device_is_the_card():
    dcfg, lss = _configs(jax_side=False)
    if torch.cuda.is_available():
        assert MonoForce(dcfg, lss).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MonoForce(dcfg, lss)
