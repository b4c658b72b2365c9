"""The port's window extractors and step kernels (plain versions) against
the JAX package's extractors and step entry points.

Each case is one TPU entry point and the port's format that replaces it:

- ``fk_step_pair_zu``   (P=62)  -> ``zu``     on z-pair words
- ``fk_step_pair3_zu``  (P=148) -> ``zu``     on z-pair words
- ``fk_step_pair3_muq`` (P=148) -> ``muq``    on [z-pair | u8 quad] words,
  friction up to 3.9 so that quad words carry the sign bit
- ``fk_step_pair``      (P=62)  -> ``pairmu`` on [z | mu] words
- ``fk_step_pair3``     (P=148) -> ``pair3``  on [z | mu] words
- ``fk_step_packed``    (P=202, husky) -> ``packed`` on [z | mu] words
- ``fk_step``           (P=148) -> ``exact``  on f32 [z | mu] windows

Inputs come from numpy with a seed; the JAX functions run on the CPU
(their plain ``_xla`` twins), the pair entry points through the pair
layout's reshape adapters.  Windows: the decoded bf16 taps and the corners
must be bit-equal.  Steps: rtol 1e-5, atol 1e-4, because the float32 sums
over points run in another order (and the TPU layout's ghost points add
1e-15 N each to the spring sums).  Gradients of the exact step: within
1e-4 of the largest entry, for the same reasons.  The JAX tests' oracle
pairs (tests/test_fast.py:304-443) hold for the port's plain versions at
their tolerances.
"""

import jax
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


def _robots(voxel, robot="tradr"):
    jr = JaxRobotModel.from_config(
        JaxPhysicsConfig(robot=robot, mesh_voxel_size=voxel))
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


def _case(voxel, mu_max, seed, robot="tradr"):
    """Robots, grids and an (B, 18) state whose footprints lie on the
    terrain, with velocities, yaw/tilt and angular rates."""
    jr, tr = _robots(voxel, robot)
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
# entry points on the windows of _extract_windows_packed1 (as "pair") and
# _extract_windows (the exact f32 windows, no motion prediction)
STEP_CASES = {**CASES, "pair3": (0.1, 2.0, "pair3"),
              "packed": (0.1, 2.0, "packed"), "exact": (0.1, 2.0, "exact")}


def _windows(mode, predicted, seed=0):
    """Both packages' windows for one case: JAX words (as the TPU kernel
    takes them) and the port's, plus everything the steps need."""
    voxel, mu_max, fmt = STEP_CASES[mode]
    robot = "husky" if mode == "packed" else "tradr"
    jr, tr, z, fr, st, tv = _case(voxel, mu_max, seed, robot)
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
    elif mode == "pair":
        jsxy, jw = jfast._extract_windows_packed(zj, frj, jwx, jwy, *args_j)
        tsxy, tw = tfast._extract_windows_packed1(zt, frt, twx, twy, *args_t)
    elif mode == "exact":
        jsxy, jw = jfast._extract_windows(zj, frj, jwx, jwy, *args_j[:2])
        tsxy, tw = tfast._extract_windows(zt, frt, twx, twy, *args_t[:2])
    else:
        jsxy, jw = jfast._extract_windows_packed1(zj, frj, jwx, jwy, *args_j)
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


def _jax_step(mode, w):
    """The JAX entry point of ``mode`` on its windows, as (B, 8)."""
    jr, st, tv = w["jr"], jnp.asarray(w["st"]), jnp.asarray(w["tv"])
    cst, jw, jsxy = jops.pack_consts(jr), jnp.asarray(w["jw"]), w["jsxy"]
    if mode in ("packed", "exact"):
        step = jops.fk_step_packed if mode == "packed" else jops.fk_step
        return np.asarray(step(cst, jw, st, tv, jnp.asarray(jsxy),
                               jops.pack_points(jr)))
    jstep = {"pair_zu": jops.fk_step_pair_zu,
             "pair3_zu": jops.fk_step_pair3_zu,
             "pair3_muq": jops.fk_step_pair3_muq,
             "pair": jops.fk_step_pair,
             "pair3": jops.fk_step_pair3}[mode]
    jpts = (jops.pack_points_pair if mode in ("pair_zu", "pair")
            else jops.pack_points_pair3)(jr)
    return np.asarray(jstep(
        cst, jw.reshape(B // 2, -1), st.reshape(-1, 36), tv.reshape(-1, 16),
        jnp.asarray(jsxy).reshape(-1, 4), jpts,
        n_k=jr.n_tracks)).reshape(-1, 8)


def _port_args(w):
    tr = w["tr"]
    return (tops.pack_consts(tr), w["tw"], torch.from_numpy(w["st"]),
            torch.from_numpy(w["tv"][:, :tr.n_tracks].copy()), w["tsxy"],
            tops.pack_points(tr))


PORT_STEP = {"zu": tops.fk_step_zu, "muq": tops.fk_step_muq,
             "pairmu": tops.fk_step_pairmu, "pair3": tops.fk_step_pair3,
             "packed": tops.fk_step_packed, "exact": tops.fk_step}


@pytest.mark.parametrize("mode", list(STEP_CASES))
def test_step_matches_jax_entry_point(mode):
    w = _windows(mode, predicted=mode != "exact", seed=1)
    want = _jax_step(mode, w)
    got = PORT_STEP[w["fmt"]](*_port_args(w)).numpy()
    assert (want[:, 7] > 1.0).all()  # every footprint is in contact
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_exact_step_gradient_matches_jax():
    """d patch, d state and d tv of fk_step against jax.vjp through the
    JAX fk_step's custom VJP, for one random cotangent."""
    w = _windows("exact", predicted=False, seed=2)
    jr, K = w["jr"], w["tr"].n_tracks
    g = np.random.default_rng(3).normal(size=(B, 8)).astype(np.float32)
    cst, sxy, pts = (jops.pack_consts(jr), jnp.asarray(w["jsxy"]),
                     jops.pack_points(jr))
    _, vjp = jax.vjp(lambda p, s, t: jops.fk_step(cst, p, s, t, sxy, pts),
                     jnp.asarray(w["jw"]), jnp.asarray(w["st"]),
                     jnp.asarray(w["tv"]))
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    want[2] = want[2][:, :K]
    cst_t, patch, state, tv, sxy_t, pts_t = _port_args(w)
    leaves = [t.requires_grad_() for t in (patch, state, tv)]
    out = tops.fk_step(cst_t, *leaves, sxy_t, pts_t)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, gt, wt in zip(("patch", "state", "tv"), got, want):
        scale = np.abs(wt).max()
        assert scale > 0, name
        np.testing.assert_allclose(gt.numpy(), wt, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def _oracle_inputs(voxel):
    """tests/test_fast.py's oracle inputs: rough terrain, bodies at rest
    with identity rotation at x, y, z in [-1, 1], two driving parts."""
    _, tr = _robots(voxel)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.normal(scale=0.1, size=(128, 128)).astype(
        np.float32))
    fr = torch.from_numpy(rng.uniform(0.3, 1.0, (128, 128)).astype(np.float32))
    st = torch.zeros((8, 18))
    st[:, 0:3] = torch.from_numpy(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
    st[:, [6, 10, 14]] = 1.0
    tv = torch.tensor([[0.5, 0.4]]).expand(8, 2).contiguous()
    return tr, z, fr, st, tv


@pytest.mark.parametrize("oracle,served", [("exact", "packed"),
                                           ("exact", "pair3"),
                                           ("pair3", "muq")])
def test_oracle_pairs_hold(oracle, served):
    """The JAX tests' accuracy oracles (tests/test_fast.py:304-443) on the
    port's plain versions: packed and pair3 (bf16 taps) against exact, at
    atol 0.3, rtol 0.02 on the accelerations and rtol 0.02 on the contact
    counts; muq (u8 friction) against pair3, at rtol 1e-6 on the counts and
    atol 0.05, rtol 0.01 on the accelerations."""
    for voxel in (0.1, 0.11):
        tr, z, fr, st, tv = _oracle_inputs(voxel)
        c = tfast._make_consts(tr)
        wx, wy = tfast._world_xy(c, st)
        d_max, res = tr.d_max, tr.grid_res
        windows = {
            "exact": tfast._extract_windows(z, fr, wx, wy, d_max, res),
            "packed": tfast._extract_windows_packed1(z, fr, wx, wy, d_max,
                                                     res),
            "muq": tfast._extract_windows_zmuq(
                z, tfast.quantize_mu_grid(fr), wx, wy, d_max, res)}
        windows["pair3"] = windows["packed"]
        acc = {}
        for fmt in (oracle, served):
            sxy, patch = windows[fmt]
            acc[fmt] = PORT_STEP[fmt](tops.pack_consts(tr), patch, st, tv,
                                      sxy, tops.pack_points(tr)).numpy()
        want, got = acc[oracle], acc[served]
        if oracle == "exact":
            np.testing.assert_allclose(got[:, :6], want[:, :6], atol=0.3,
                                       rtol=0.02)
            np.testing.assert_allclose(got[:, 7], want[:, 7], rtol=0.02)
        else:
            np.testing.assert_allclose(got[:, 7], want[:, 7], rtol=1e-6)
            np.testing.assert_allclose(got[:, :6], want[:, :6], atol=0.05,
                                       rtol=0.01)


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
    with pytest.raises(TypeError):
        # the exact step takes float32 windows, not int32 words
        tops.fk_step(args[0], w["tw"].repeat(1, 2), *args[2:])


# the serving formats of the fused steps: voxel, friction's upper end, robot
FUSED_CASES = {"zu": (0.15, 1.0, "tradr"), "muq": (0.1, 3.9, "tradr"),
               "pairmu": (0.15, 1.0, "tradr"), "packed": (0.1, 2.0, "husky")}


@pytest.mark.parametrize("fmt", list(FUSED_CASES))
def test_fused_steps_are_the_step_then_integrate(fmt):
    """The fused steps' plain version (``physics.fast.PlainStep``), the
    serving rollout's steps on the CPU: step k is ``fk_step_plain`` on the
    state before it followed by ``physics.fast._integrate``, bit for bit,
    reading that state from the sequence it writes, over two window
    refreshes; it launches nothing."""
    voxel, mu_max, robot = FUSED_CASES[fmt]
    _, tr, z, fr, st, _ = _case(voxel, mu_max, seed=5, robot=robot)
    N, refresh = 7, 3
    K = tr.n_tracks
    rng = np.random.default_rng(6)
    tv_t = torch.from_numpy(rng.uniform(-1.0, 1.0, (N, B, K)).astype(
        np.float32))
    zt, mu = torch.from_numpy(z), torch.from_numpy(fr)
    c = tfast._make_consts(tr)

    def windows(state):
        wx, wy = tfast._world_xy(c, state)
        args = (wx, wy, tr.d_max, tr.grid_res)
        if fmt == "zu":
            return tfast._extract_windows_zpair(zt, *args)
        if fmt == "muq":
            return tfast._extract_windows_zmuq(
                zt, tfast.quantize_mu_grid(mu), *args)
        return tfast._extract_windows_packed1(zt, mu, *args)

    cst, pts = tops.pack_consts(tr), tops.pack_points(tr)
    state0 = torch.from_numpy(st)
    seq = torch.full((B, N, 18), float("nan"))
    spring = torch.full((B, N), float("nan"))
    kernel = PORT_STEP[fmt]
    kernel.launches = 0
    with tfast.PlainStep(kernel).into(cst, tv_t, state0, seq, spring,
                                      pts) as steps:
        for k in range(N):
            if k % refresh == 0:
                sxy, patch = windows(state0 if k == 0 else seq[:, k - 1])
                steps.window(patch, sxy)
            steps.step(k)
    assert kernel.launches == 0

    state = state0
    for k in range(N):
        if k % refresh == 0:
            sxy, patch = windows(state)
        acc8 = tops.fk_step_plain(fmt, cst, patch, state, tv_t[k], sxy, pts)
        state = tfast._integrate(state, acc8, tr.dt)
        assert torch.equal(seq[:, k], state), k
        assert torch.equal(spring[:, k], acc8[:, 6]), k


def test_fused_steps_check_buffers():
    """``into`` checks the rollout's buffers once and ``window`` each
    refresh's windows: shapes, dtypes, contiguity; ``step`` its index, on
    the card as in the plain version; the fused launch runs on the card
    only."""
    w = _windows("pair", predicted=False)
    tr = w["tr"]
    cst, pts = tops.pack_consts(tr), tops.pack_points(tr)
    state0 = torch.from_numpy(w["st"])
    N, K = 4, tr.n_tracks
    tv_t = torch.zeros((N, B, K))
    seq, spring = torch.empty((B, N, 18)), torch.empty((B, N))
    step = tops.fk_step_pairmu
    launches = step.launches
    with pytest.raises(ValueError):
        step.into(cst, tv_t, state0, torch.empty((B, N + 1, 18)), spring, pts)
    with pytest.raises(ValueError):
        step.into(cst, tv_t[:, :, :0], state0, seq, spring, pts)
    with pytest.raises(ValueError):
        step.into(cst, tv_t.transpose(0, 1).contiguous().transpose(0, 1),
                  state0, seq, spring, pts)
    with pytest.raises(TypeError):
        step.into(cst, tv_t, state0, seq, spring.double(), pts)
    steps = step.into(cst, tv_t, state0, seq, spring, pts)
    with pytest.raises(TypeError):
        steps.window(w["tw"].float(), w["tsxy"])
    with pytest.raises(ValueError):
        steps.window(w["tw"][:, :128], w["tsxy"])
    steps.window(w["tw"], w["tsxy"])
    for k in (-1, N):
        with pytest.raises(IndexError):
            steps.step(k)
    with pytest.raises(NotImplementedError):
        with steps:
            pass
    with tfast.PlainStep(step).into(cst, tv_t, state0, seq, spring,
                                    pts) as steps:
        steps.window(w["tw"], w["tsxy"])
        steps.step(0)
        for k in (-1, N):
            with pytest.raises(IndexError):
                steps.step(k)
    assert torch.isfinite(seq[:, 0]).all()
    assert step.launches == launches
