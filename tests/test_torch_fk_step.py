"""The port's window extractors and step kernels (plain versions) against
the JAX package's serving extractors and step entry points.

Each case is one TPU entry point and the port's format that replaces it:

- ``fk_step_pair_zu``   (P=62)  -> ``zu``     on z-pair words
- ``fk_step_pair3_zu``  (P=148) -> ``zu``     on z-pair words
- ``fk_step_pair3_muq`` (P=148) -> ``muq``    on [z-pair | u8 quad] words,
  friction up to 3.9 so that quad words carry the sign bit
- ``fk_step_pair``      (P=62)  -> ``pairmu`` on [z | mu] words

Inputs come from numpy with a seed; the JAX functions run on the CPU
(their plain ``_xla`` twins) through the pair layout's reshape adapters.
Windows: the decoded bf16 taps and the corners must be bit-equal.  Steps:
rtol 1e-5, atol 1e-4, because the float32 sums over points run in another
order (and the TPU layout's ghost points add 1e-15 N each to the spring
sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.ops import fk_step_pallas as jops
from monoforce_tpu.physics import fast as jfast
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.ops import fk_step_cuda as tops
from monoforce_tpu_torch.physics import fast as tfast

B = 32


def _robots(voxel):
    jr = JaxRobotModel.from_config(
        JaxPhysicsConfig(robot="tradr", mesh_voxel_size=voxel))
    tr = robot_model_from_arrays(
        {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}, jr.n_tracks,
        jr.has_flippers, jr.integration_mode, device="cpu")
    return jr, tr


def _rotations(rng, n, max_angle):
    """Rodrigues rotations about random axes (numpy, float32)."""
    k = rng.normal(size=(n, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    a = rng.uniform(-max_angle, max_angle, (n, 1, 1))
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K -= K.transpose(0, 2, 1)
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(
        np.float32)


def _case(voxel, mu_max, seed):
    """Robots, grids and an (B, 18) state whose footprints lie on the
    terrain, with velocities, yaw/tilt and angular rates."""
    jr, tr = _robots(voxel)
    rng = np.random.default_rng(seed)
    z = rng.normal(scale=0.1, size=(128, 128)).astype(np.float32)
    fr = rng.uniform(0.3, mu_max, (128, 128)).astype(np.float32)
    st = np.zeros((B, 18), np.float32)
    st[:, 0:2] = rng.uniform(-5.5, 5.5, (B, 2))
    st[:, 2] = rng.uniform(-0.15, 0.15, B)
    st[:, 3:6] = rng.uniform(-1.0, 1.0, (B, 3))
    st[:, 6:15] = _rotations(rng, B, 0.6).reshape(B, 9)
    st[:, 15:18] = rng.uniform(-1.0, 1.0, (B, 3))
    tv = np.zeros((B, 8), np.float32)
    tv[:, :2] = rng.uniform(-1.0, 1.0, (B, 2))
    return jr, tr, z, fr, st, tv


def _jax_world_xy(jr, st):
    c = jfast._make_consts(jr)
    return jfast._world_xy(c, tuple(jnp.asarray(st).T), c.px, c.py, c.pz)


def _torch_world_xy(tr, st):
    return tfast._world_xy(tfast._make_consts(tr), torch.from_numpy(st))


def _hi(w):
    return (np.asarray(w).view(np.uint32) & 0xFFFF0000).view(np.float32)


def _lo(w):
    return (np.asarray(w).view(np.uint32) << 16).view(np.float32)


def _next_col(p):
    p = p.reshape(-1, 16, 16)
    return np.concatenate([p[:, :, 1:], p[:, :, 15:]], axis=2).reshape(-1, 256)


CASES = {
    "pair_zu": (0.15, 1.0, "zu"),
    "pair3_zu": (0.1, 1.0, "zu"),
    "pair3_muq": (0.1, 3.9, "muq"),
    "pair": (0.15, 1.0, "pairmu"),
}


def _windows(mode, predicted, seed=0):
    """Both packages' windows for one case: JAX words (as the TPU kernel
    takes them) and the port's, plus everything the steps need."""
    voxel, mu_max, fmt = CASES[mode]
    jr, tr, z, fr, st, tv = _case(voxel, mu_max, seed)
    jwx, jwy = _jax_world_xy(jr, st)
    twx, twy = _torch_world_xy(tr, st)
    dq = (st[:, 3:4] * 0.32, st[:, 4:5] * 0.32) if predicted else (None, None)
    jdq = [None if d is None else jnp.asarray(d) for d in dq]
    tdq = [None if d is None else torch.from_numpy(d) for d in dq]
    zj, frj, zt, frt = (jnp.asarray(z), jnp.asarray(fr), torch.from_numpy(z),
                        torch.from_numpy(fr))
    args_j = (jr.d_max, jr.grid_res, *jdq)
    args_t = (tr.d_max, tr.grid_res, *tdq)
    if mode == "pair_zu":
        jsxy, jw = jfast._extract_windows_packed(zj, None, jwx, jwy, *args_j)
        tsxy, tw = tfast._extract_windows_zpair(zt, twx, twy, *args_t)
    elif mode == "pair3_zu":
        jsxy, jw = jfast._extract_windows_zpair(zj, jwx, jwy, *args_j)
        tsxy, tw = tfast._extract_windows_zpair(zt, twx, twy, *args_t)
    elif mode == "pair3_muq":
        jsxy, jw = jfast._extract_windows_zmuq(
            zj, jfast.quantize_mu_grid(frj), jwx, jwy, *args_j)
        tsxy, tw = tfast._extract_windows_zmuq(
            zt, tfast.quantize_mu_grid(frt), twx, twy, *args_t)
    else:
        jsxy, jw = jfast._extract_windows_packed(zj, frj, jwx, jwy, *args_j)
        tsxy, tw = tfast._extract_windows_packed1(zt, frt, twx, twy, *args_t)
    return dict(jr=jr, tr=tr, st=st, tv=tv, fmt=fmt, jsxy=np.asarray(jsxy),
                jw=np.asarray(jw), tsxy=tsxy, tw=tw)


@pytest.mark.parametrize("predicted", [False, True])
@pytest.mark.parametrize("mode", list(CASES))
def test_window_taps_bit_equal(mode, predicted):
    w = _windows(mode, predicted)
    tw = w["tw"].numpy()
    assert tw.dtype == np.int32
    assert np.array_equal(w["tsxy"].numpy(), w["jsxy"])
    if mode in ("pair_zu", "pair"):
        # TPU pair words: trajectory 2i in the high halves, 2i+1 in the low
        jz = w["jw"][:, :256]
        z_plane = np.stack([_hi(jz), _lo(jz)], axis=1).reshape(B, 256)
        if mode == "pair":
            jm = w["jw"][:, 256:]
            mu_plane = np.stack([_hi(jm), _lo(jm)], axis=1).reshape(B, 256)
            assert np.array_equal(_lo(tw), mu_plane)
            assert np.array_equal(_hi(tw), z_plane)
        else:
            assert np.array_equal(_hi(tw), z_plane)
            assert np.array_equal(_lo(tw), _next_col(z_plane))
    else:
        # the same per-trajectory word layout: the words themselves agree
        assert np.array_equal(tw, w["jw"].view(np.int32))
    if mode == "pair3_muq":
        assert (tw[:, 256:] < 0).any()  # quads with mu >= 2 set the sign bit


@pytest.mark.parametrize("mode", list(CASES))
def test_step_matches_jax_entry_point(mode):
    w = _windows(mode, predicted=True, seed=1)
    jr, tr, st, tv = w["jr"], w["tr"], w["st"], w["tv"]
    jstep = {"pair_zu": jops.fk_step_pair_zu,
             "pair3_zu": jops.fk_step_pair3_zu,
             "pair3_muq": jops.fk_step_pair3_muq,
             "pair": jops.fk_step_pair}[mode]
    jpts = (jops.pack_points_pair if mode in ("pair_zu", "pair")
            else jops.pack_points_pair3)(jr)
    want = np.asarray(jstep(
        jops.pack_consts(jr), jnp.asarray(w["jw"]).reshape(B // 2, -1),
        jnp.asarray(st).reshape(-1, 36), jnp.asarray(tv).reshape(-1, 16),
        jnp.asarray(w["jsxy"]).reshape(-1, 4), jpts,
        n_k=jr.n_tracks)).reshape(-1, 8)
    kernel = {"zu": tops.fk_step_zu, "muq": tops.fk_step_muq,
              "pairmu": tops.fk_step_pairmu}[w["fmt"]]
    got = kernel(tops.pack_consts(tr), w["tw"], torch.from_numpy(st),
                 torch.from_numpy(tv[:, :tr.n_tracks].copy()), w["tsxy"],
                 tops.pack_points(tr)).numpy()
    assert (want[:, 7] > 1.0).all()  # every footprint is in contact
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_step_wrappers_check_inputs():
    w = _windows("pair3_zu", predicted=False)
    tr = w["tr"]
    args = [tops.pack_consts(tr), w["tw"], torch.from_numpy(w["st"]),
            torch.from_numpy(w["tv"][:, :2].copy()), w["tsxy"],
            tops.pack_points(tr)]
    tops.fk_step_zu.launches = 0
    assert tops.fk_step_zu(*args).shape == (B, 8)
    assert tops.fk_step_zu.launches == 0  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        tops.fk_step_muq(*args)  # muq wants 512 words per trajectory
    bad = list(args)
    bad[1] = w["tw"].float()
    with pytest.raises(TypeError):
        tops.fk_step_zu(*bad)
