"""The port's fk_interp and settle-window extractor against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX function runs on the CPU (its plain twin ``_fk_xla``), the port's on
the CPU (its plain version).  Tolerance: atol 1e-6 on every output plane,
values of order 1; both sides do the same float32 operations in the same
order, so only the reciprocal square root may differ by an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoforce_tpu.ops.interp_pallas import fk_interp as jax_fk_interp
from monoforce_tpu.physics import fast as jfast
from monoforce_tpu_torch.ops.interp_cuda import fk_interp, fk_interp_plain
from monoforce_tpu_torch.physics import fast as tfast


def _inputs(d_max, res, B=16, P=150, seed=0):
    rng = np.random.default_rng(seed)
    patch = np.concatenate([rng.normal(scale=0.2, size=(B, 256)),
                            rng.uniform(0.2, 1.5, (B, 256))], axis=1)
    n = int(round(2 * d_max / res))
    sxy = rng.integers(0, n - 16, (B, 2)).astype(np.float32)
    # queries inside each window: continuous ones, then some exactly on
    # cell boundaries (integer cell coordinates) and on the window edges
    cells = sxy[:, None, :] + rng.uniform(0.0, 15.0, (B, P, 2))
    cells[:, :40] = np.floor(cells[:, :40])
    cells[:, 40:44, 0] = sxy[:, None, 0] + np.array([0, 15, 16, 14.999])
    q = (cells * np.float32(res) - np.float32(d_max)).astype(np.float32)
    cst = np.array([d_max, res], np.float32)
    return (patch.astype(np.float32), np.ascontiguousarray(q[..., 0]),
            np.ascontiguousarray(q[..., 1]), sxy, cst)


@pytest.mark.parametrize("d_max,res", [(6.4, 0.1), (8.0, 0.125)])
def test_fk_interp_matches_jax(d_max, res):
    args = _inputs(d_max, res)
    want = np.asarray(jax_fk_interp(*map(jnp.asarray, args)))
    got = fk_interp(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (16, 5 * 150)
    # a query put into another cell would differ by far more than atol
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fk_interp_plain_is_what_cpu_tensors_get():
    args = [torch.from_numpy(a) for a in _inputs(6.4, 0.1, seed=3)]
    assert torch.equal(fk_interp(*args), fk_interp_plain(*args))
    fk_interp.launches = 0
    fk_interp(*args)
    assert fk_interp.launches == 0  # the plain version is no launch


def test_fk_interp_rejects_bad_inputs():
    patch, wx, wy, sxy, cst = (torch.from_numpy(a) for a in _inputs(6.4, 0.1))
    with pytest.raises(TypeError):
        fk_interp(patch.double(), wx, wy, sxy, cst)
    with pytest.raises(ValueError):
        fk_interp(patch[:, :256].contiguous(), wx, wy, sxy, cst)
    with pytest.raises(ValueError):
        fk_interp(patch, wx.T, wy, sxy, cst)


@pytest.mark.parametrize("batched", [False, True])
def test_settle_windows_bit_equal(batched):
    """_extract_windows (f32 [z | mu] windows of the settle step): corners
    and every window value bit-equal to the JAX one-hot extractor."""
    rng = np.random.default_rng(4)
    B, P = 8, 62
    shape = (B, 128, 128) if batched else (128, 128)
    z = rng.normal(scale=0.3, size=shape).astype(np.float32)
    fr = rng.uniform(0.2, 1.2, shape).astype(np.float32)
    qx = rng.uniform(-7.0, 7.0, (B, 1)) + rng.uniform(-0.4, 0.4, (B, P))
    qy = rng.uniform(-7.0, 7.0, (B, 1)) + rng.uniform(-0.4, 0.4, (B, P))
    qx, qy = qx.astype(np.float32), qy.astype(np.float32)
    d_max, res = np.float32(6.4), np.float32(0.1)
    j_sxy, j_patch = jfast._extract_windows(
        jnp.asarray(z), jnp.asarray(fr), jnp.asarray(qx), jnp.asarray(qy),
        d_max, res)
    t_sxy, t_patch = tfast._extract_windows(
        torch.from_numpy(z), torch.from_numpy(fr), torch.from_numpy(qx),
        torch.from_numpy(qy), torch.tensor(d_max), torch.tensor(res))
    assert np.array_equal(t_sxy.numpy(), np.asarray(j_sxy))
    assert np.array_equal(t_patch.numpy().view(np.int32),
                          np.asarray(j_patch).view(np.int32))
