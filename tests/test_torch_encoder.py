"""The port's terrain encoder against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  The camera rig is yawed 0.3 rad
off the ego axes: a camera along an axis puts every frustum point exactly
on a cell border (depth bins on the grid's 0.1 m lattice), where the last
bit of any rounding picks the cell (XLA's jitted and op-by-op forwards
already disagree on 8 of 64 such points).  The JAX models run jitted on the
CPU at "highest" matmul precision (tests/conftest.py); one module-scoped
model serves the forward, half-mode and state_dict tests.  Its variables
are the JAX model's own tree (``jax.eval_shape`` of ``init``) filled from
a seed like the JAX initializers (kernels N(0, 1/fan_in), BN scale and
variance one, but each BasicBlock's last BN scale zero, the rest zero) and
perturbed by 0.05 noise, as
tests/test_encoder.py:157-163 perturbs them, so that every head carries
signal.

Tolerances: geometry within 1e-5 m (float32 einsums in another order);
the splat within 1e-5 (sums of a few float32 terms in another order); the
align-corners upsample within 5e-6 (interpolation weights from float32
against float64 positions); whole float32 forwards within 1e-5 per head
(about 60 layers of float32 rounding; measured 1.3e-6 on head outputs of
mean 0.04-0.6); the half mode against the port's float32 at the JAX
package's gate (RMSE: terrain and geom 0.02, friction 0.05;
tests/test_encoder.py:178-181), and against the JAX half mode at RMSE
0.005 per head (bf16 rounding in another backend's kernels on both sides;
measured 3e-4 to 5e-4, as far as either half mode is from float32).
Variable seed 3 leaves every head alive (with other seeds a ReLU head can
be zero everywhere, which would compare nothing).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.config import LSSConfig as JaxLSSConfig
from monoforce_tpu.models import LiftSplatShoot as JaxLSS
from monoforce_tpu.models.terrain_encoder import geometry as jgeom
from monoforce_tpu.models.terrain_encoder.layers import (
    upsample_align_corners as jax_upsample)
from monoforce_tpu.models.terrain_encoder.lss import half_inference_variables
from monoforce_tpu.models.terrain_encoder.torch_port import (
    expected_torch_keys, state_dict_to_variables)
from monoforce_tpu.ops.voxel_pool import voxel_pool as jax_voxel_pool
from monoforce_tpu_torch.config import LSSConfig
from monoforce_tpu_torch.convert import variables_to_state_dict
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.models.terrain_encoder import geometry
from monoforce_tpu_torch.models.terrain_encoder.bev import BasicBlock
from monoforce_tpu_torch.models.terrain_encoder.layers import (
    upsample_align_corners)
from monoforce_tpu_torch.models.terrain_encoder.lss import half_inference_model
from monoforce_tpu_torch.ops.voxel_pool import voxel_pool

GRID = {"xbound": (-1.6, 1.6, 0.1), "ybound": (-1.6, 1.6, 0.1),
        "zbound": (-3.2, 3.2, 6.4), "dbound": (0.6, 2.2, 0.4)}
AUG = {"final_dim": (32, 64)}
HEADS = ("geom", "terrain", "diff", "friction")
HALF_GATE = {"terrain": 0.02, "geom": 0.02, "friction": 0.05}


def rig(n_cams, hw, focal, height, yaw0):
    """Calibrations (B=1) of level cameras at yaws ``yaw0`` + 2 pi k /
    n_cams, ``height`` up: camera z (the optical axis) along the ego's
    horizontal, x right, y down; principal point at the image centre, no
    augmentation."""
    H, W = hw
    to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rots = []
    for k in range(n_cams):
        a = yaw0 + 2 * np.pi * k / n_cams
        yaw = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        rots.append(yaw @ to_ego)
    rots = np.stack(rots)[None].astype(np.float32)
    trans = np.tile(np.array([0, 0, height], np.float32), (1, n_cams, 1))
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    intrins = np.tile(K, (1, n_cams, 1, 1))
    eye = np.tile(np.eye(3, dtype=np.float32), (1, n_cams, 1, 1))
    return rots, trans, intrins, eye, np.zeros((1, n_cams, 3), np.float32)


def seeded_variables(model, inputs, seed):
    """The JAX model's variable tree filled from ``seed`` like its
    initializers, then perturbed by 0.05 noise (all float32)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in inputs])
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            base = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "var" or (name == "scale" and not (
                "BasicBlock" in path[-3].key and path[-2].key == "BatchNorm_1")):
            base = np.ones(s.shape)
        else:
            base = np.zeros(s.shape)
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


@pytest.fixture(scope="module")
def lss():
    """(JAX model, its variables, the port's model carrying them, inputs)."""
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(1, 2, 3, 32, 64)).astype(np.float32)
    inputs = (imgs,) + rig(2, (32, 64), focal=41.3, height=0.53, yaw0=0.3)
    jm = JaxLSS(GRID, AUG)
    variables = seeded_variables(jm, inputs, seed=3)
    tm = LiftSplatShoot(GRID, AUG).eval()
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jm, variables, tm, inputs


def _port(tm, inputs, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        out = tm(t[0].to(dtype), *t[1:])
    return {k: v.numpy() for k, v in out.items()}


def _jax(jm, variables, inputs, dtype=jnp.float32):
    out = jax.jit(jm.apply)(variables, jnp.asarray(inputs[0], dtype),
                            *[jnp.asarray(a) for a in inputs[1:]])
    return {k: np.asarray(v) for k, v in out.items()}


def _random_calib(rng, B, N):
    """Random rotations and translations, intrinsics with focal 30-60 px,
    and post-augmentation rotations (resize, in-plane rotation, crop)."""
    rots = np.linalg.qr(rng.normal(size=(B, N, 3, 3)))[0].astype(np.float32)
    trans = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    intrins = np.zeros((B, N, 3, 3), np.float32)
    intrins[..., 0, 0] = rng.uniform(30, 60, (B, N))
    intrins[..., 1, 1] = rng.uniform(30, 60, (B, N))
    intrins[..., 0, 2] = rng.uniform(28, 36, (B, N))
    intrins[..., 1, 2] = rng.uniform(12, 20, (B, N))
    intrins[..., 2, 2] = 1.0
    a = rng.uniform(-0.1, 0.1, (B, N))
    s = rng.uniform(0.8, 1.2, (B, N))
    post_rots = np.zeros((B, N, 3, 3), np.float32)
    post_rots[..., 0, 0] = s * np.cos(a)
    post_rots[..., 0, 1] = -s * np.sin(a)
    post_rots[..., 1, 0] = s * np.sin(a)
    post_rots[..., 1, 1] = s * np.cos(a)
    post_rots[..., 2, 2] = 1.0
    post_trans = np.zeros((B, N, 3), np.float32)
    post_trans[..., :2] = rng.uniform(-8, 8, (B, N, 2))
    return rots, trans, intrins, post_rots, post_trans


@pytest.mark.parametrize("preset", ["default", "tiny"])
def test_frustum_and_grid_bit_equal(preset):
    grid, aug = ((JaxLSSConfig().grid_conf, JaxLSSConfig().data_aug_conf)
                 if preset == "default" else (GRID, AUG))
    want = np.asarray(jgeom.create_frustum(aug["final_dim"], grid["dbound"]))
    got = geometry.create_frustum(aug["final_dim"], grid["dbound"]).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if preset == "default":
        # float32 np.arange(0.6, 6.4, 0.1) ends at 6.3999996: 59 depth bins
        assert got.shape == (59, 16, 26, 3)
    bounds = (grid["xbound"], grid["ybound"], grid["zbound"])
    for a, b in zip(geometry.gen_dx_bx(*bounds), jgeom.gen_dx_bx(*bounds)):
        assert np.array_equal(a, b)


def test_geometry_matches_jax():
    rng = np.random.default_rng(2)
    calib = _random_calib(rng, 2, 3)
    frustum = geometry.create_frustum(AUG["final_dim"], GRID["dbound"])
    want = np.asarray(jgeom.get_geometry(
        jnp.asarray(frustum.numpy()), *[jnp.asarray(a) for a in calib]))
    got = geometry.get_geometry(frustum, *[torch.from_numpy(a) for a in calib])
    assert got.shape == (2, 3, 4, 2, 4, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_voxel_pool_matches_jax():
    """B=2, a Z=2 grid, ~30% of the points out of bounds, a tenth exactly
    on cell borders and a tenth just below a lower bound (truncation
    toward zero puts them in the first cell)."""
    rng = np.random.default_rng(3)
    grid = ((-1.0, 1.0, 0.25), (-1.5, 1.5, 0.25), (-1.0, 1.0, 1.0))
    dx, bx, nx = geometry.gen_dx_bx(*grid)
    assert tuple(nx) == (8, 12, 2)
    shape = (2, 2, 3, 4, 5)
    lo = np.array([g[0] for g in grid], np.float32)
    hi = np.array([g[1] for g in grid], np.float32)
    span = hi - lo
    geom = rng.uniform(lo - 0.1 * span, hi + 0.1 * span,
                       shape + (3,)).astype(np.float32)
    flat = geom.reshape(-1, 3)
    n = flat.shape[0]
    border = rng.choice(n, n // 10, replace=False)
    flat[border] = lo + rng.integers(0, 9, (n // 10, 1)) * dx
    below = rng.choice(n, n // 10, replace=False)
    flat[below, rng.integers(0, 3, n // 10)] = (lo - 0.4 * dx)[
        rng.integers(0, 3, n // 10)]
    feats = rng.normal(size=shape + (3,)).astype(np.float32)
    vox = np.trunc((geom - (bx - dx / 2)) / dx)
    out = ((vox < 0) | (vox >= nx)).any(-1).mean()
    assert 0.2 < out < 0.4, out

    want = np.asarray(jax_voxel_pool(jnp.asarray(geom), jnp.asarray(feats),
                                     jnp.asarray(dx), jnp.asarray(bx), nx))
    got = voxel_pool(torch.from_numpy(geom), torch.from_numpy(feats),
                     torch.from_numpy(dx), torch.from_numpy(bx), nx)
    assert got.shape == (2, 6, 8, 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale,hw", [(2, (5, 7)), (4, (3, 8)), (2, (1, 4))])
def test_upsample_align_corners_matches_jax(scale, hw):
    x = np.random.default_rng(4).normal(size=(2, 3) + hw).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   scale)).transpose(0, 3, 1, 2)
    got = upsample_align_corners(torch.from_numpy(x), scale).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_lss_forward_matches_jax(lss):
    jm, variables, tm, inputs = lss
    want = _jax(jm, variables, inputs)
    got = _port(tm, inputs)
    for k in HEADS:
        assert np.abs(want[k]).mean() > 0.01, f"{k} carries no signal"
        assert got[k].shape == want[k].shape == (1, 1, 32, 32), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_state_dict_names_and_round_trip(lss):
    _, variables, tm, _ = lss
    keys = [k for k in tm.state_dict() if not k.endswith("num_batches_tracked")]
    assert sorted(keys) == sorted(expected_torch_keys())
    sd = variables_to_state_dict(variables)
    assert set(sd) == set(tm.state_dict())
    back = state_dict_to_variables(sd)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        got = back
        for k in path:
            got = got[k.key]
        assert np.array_equal(got, np.asarray(leaf)), jax.tree_util.keystr(path)
    # a leaf no layer takes, and a leaf of another dtype, are refused
    extra = {"params": {**variables["params"], "x": {"kernel": np.zeros(1)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        variables_to_state_dict(extra)
    bf = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), variables)
    with pytest.raises(TypeError):
        variables_to_state_dict(bf)


def test_half_mode(lss):
    """bf16 camera encoder: float32 heads in range, against the port's
    float32 at the JAX gate and against the JAX half mode."""
    jm, variables, tm, inputs = lss
    half = half_inference_model(tm)
    assert all(p.dtype == torch.bfloat16 for p in half.camencode.parameters())
    assert all(b.dtype == torch.bfloat16 for n, b in
               half.camencode.named_buffers() if "num_batches" not in n)
    assert all(p.dtype == torch.float32 for p in half.bevencode.parameters())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got = _port(half, inputs, torch.bfloat16)
    f32 = _port(tm, inputs)
    want = _jax(jm, half_inference_variables(variables), inputs, jnp.bfloat16)
    for k in HEADS:
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all(), k
        assert rmse(got[k], want[k]) < 0.005, (k, rmse(got[k], want[k]))
    for k, tol in HALF_GATE.items():
        assert rmse(got[k], f32[k]) < tol, (k, rmse(got[k], f32[k]))
    assert got["geom"].min() >= -1.0 and got["geom"].max() <= 1.0
    assert got["diff"].min() >= 0.0 and got["friction"].min() >= 0.0


def test_init_weights_like_the_jax_initializers():
    """Seeded: the same seed gives the same weights, another seed others;
    conv weights truncated normal with variance 1/fan_in, BN as flax's
    (each BasicBlock's bn2 scale zero)."""
    a, b, c = (LiftSplatShoot(GRID, AUG) for _ in range(3))
    for m, seed in ((a, 0), (b, 0), (c, 1)):
        m.init_weights(torch.Generator().manual_seed(seed))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["camencode.trunk._blocks.15._project_conv.weight"]
    assert not torch.equal(w, sc["camencode.trunk._blocks.15._project_conv.weight"])
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert float(sa["camencode.depthnet.bias"].abs().max()) == 0.0
    for name, m in a.named_modules():
        if isinstance(m, BasicBlock):
            assert float(m.bn2.weight.detach().abs().max()) == 0.0, name
            assert float(m.bn1.weight.detach().min()) == 1.0, name
    assert float(sa["bevencode.bn1.running_var"].min()) == 1.0


def test_lss_config_matches_jax(tmp_path):
    for name in ("default", "resize"):
        assert (dataclasses.asdict(LSSConfig.preset(name))
                == dataclasses.asdict(JaxLSSConfig.preset(name)))
    cfg = LSSConfig.preset("resize")
    cfg.to_yaml(str(tmp_path / "lss.yaml"))
    back = LSSConfig.from_yaml(str(tmp_path / "lss.yaml"))
    assert back == cfg
    assert dataclasses.asdict(back) == dataclasses.asdict(
        JaxLSSConfig.from_yaml(str(tmp_path / "lss.yaml")))
    with pytest.raises(ValueError):
        LSSConfig.preset("other")
