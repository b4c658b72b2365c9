"""Fused terrain lookup out of cached 16x16 windows: CUDA kernel and plain
version.

Port of ``monoforce_tpu/ops/interp_pallas.py:52-153`` (``fk_interp``, its
math ``_fk_math`` and its plain twin ``_fk_xla``), forward only; the custom
VJP (``:156-167``) comes with the differentiable rollout.  The planner runs
it once per rollout, in the settle step.

The kernel is ``csrc/fk_interp.cu`` (one thread per trajectory and point;
its note says what bounds it on the H100).  :func:`fk_interp` takes the
plain version for tensors on the CPU only; for CUDA tensors it launches the
kernel or raises.  ``fk_interp.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from monoforce_tpu_torch.ops import _build

__all__ = ["TAP_OFFSETS", "fk_interp", "fk_interp_plain"]

TAP_OFFSETS = (0, 16, 1, 17)  # c, x+1 (front), y+1 (left), x+1 & y+1

# fk_interp_launch(patch, wx, wy, sxy, cst, B, P, out, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]


def fk_interp_plain(patch, wx, wy, sxy, cst):
    """Plain PyTorch version of :func:`fk_interp` (same arguments)."""
    d_max, res = cst[0], cst[1]
    fxq = (wx + d_max) / res
    fyq = (wy + d_max) / res
    xi = fxq.to(torch.int32)  # truncation toward zero (reference .long())
    yi = fyq.to(torch.int32)
    xf = fxq - xi.to(torch.float32)
    yf = fyq - yi.to(torch.float32)
    sx = sxy[:, 0:1].to(torch.int32)
    sy = sxy[:, 1:2].to(torch.int32)
    idx = (torch.clamp(xi - sx, 0, 14) * 16
           + torch.clamp(yi - sy, 0, 14)).long()
    tz = [torch.gather(patch[:, :256], 1, idx + off) for off in TAP_OFFSETS]
    tf = [torch.gather(patch[:, 256:], 1, idx + off) for off in TAP_OFFSETS]
    w_cc = (1 - xf) * (1 - yf)
    w_cf = (1 - xf) * yf
    w_lc = xf * (1 - yf)
    w_fl = xf * yf
    # the reference's weight/tap pairing (dphysics.py:442-445), kept as is
    z = w_cc * tz[0] + w_cf * tz[1] + w_lc * tz[2] + w_fl * tz[3]
    mu = w_cc * tf[0] + w_cf * tf[1] + w_lc * tf[2] + w_fl * tf[3]
    dz_dx = (tz[1] - tz[0]) / res
    dz_dy = (tz[2] - tz[0]) / res
    inv = torch.rsqrt(dz_dx * dz_dx + dz_dy * dz_dy + 1.0)
    return torch.cat([z, -dz_dx * inv, -dz_dy * inv, inv, mu], dim=1)


def _check(patch, wx, wy, sxy, cst):
    B, P = wx.shape
    expect = {"patch": (patch, (B, 512)), "wx": (wx, (B, P)),
              "wy": (wy, (B, P)), "sxy": (sxy, (B, 2)), "cst": (cst, (2,))}
    for name, (t, shape) in expect.items():
        if t.device != patch.device:
            raise ValueError(f"{name} is on {t.device}, patch on {patch.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fk_interp(patch, wx, wy, sxy, cst):
    """Terrain lookup at world-frame queries out of cached windows.

    patch: (B, 512) f32 [z(256) | friction(256)] row-major 16x16 windows;
    wx, wy: (B, P) f32 world-frame queries; sxy: (B, 2) f32 window corners;
    cst: (2,) f32 [d_max, grid_res].  Returns (B, 5P) f32
    [z | n_x | n_y | n_z | mu].
    """
    _check(patch, wx, wy, sxy, cst)
    if patch.device.type == "cpu":
        return fk_interp_plain(patch, wx, wy, sxy, cst)
    if patch.device.type != "cuda":
        raise NotImplementedError(f"fk_interp runs on cuda or cpu, not "
                                  f"{patch.device.type}")
    launch = _build.load("fk_interp", "fk_interp_launch", _ARGTYPES)
    B, P = wx.shape
    out = torch.empty((B, 5 * P), dtype=torch.float32, device=patch.device)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(patch.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                    sxy.data_ptr(), cst.data_ptr(), B, P, out.data_ptr(),
                    stream)
    if rc != 0:
        raise RuntimeError(f"fk_interp kernel launch failed: CUDA error {rc}")
    fk_interp.launches += 1
    return out


fk_interp.launches = 0
