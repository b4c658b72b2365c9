"""Fused terrain lookup out of cached 16x16 windows: CUDA kernel and plain
version.

Port of ``monoforce_tpu/ops/interp_pallas.py:52-167``: ``fk_interp``, its
math ``_fk_math``, its plain twin ``_fk_xla`` and its custom VJP
(``_fk_fwd``/``_fk_bwd``).  The planner runs it once per rollout, in the
settle step; ``physics.fast.fast_rollout`` once per step as well, and
terrain fitting differentiates through it.

Two kernels, each with one slot of threads per trajectory and one thread
per point (several small trajectories a block): ``csrc/fk_interp.cu``
(forward) and ``csrc/fk_interp_bwd.cu`` (backward, cell sums in shared
memory in an order fixed by the inputs); their notes say what bounds them
on the H100.  For CUDA tensors
:func:`fk_interp` is a ``torch.autograd.Function`` whose forward launches
the first and whose backward launches the second through
:func:`fk_interp_bwd`.  Both wrappers take the plain versions for tensors
on the CPU only (where autograd differentiates ``fk_interp_plain``
directly); for CUDA tensors they launch their kernel or raise.
``fk_interp.launches`` and ``fk_interp_bwd.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from monoforce_tpu_torch.ops import _build
from monoforce_tpu_torch.utils.profiling import register_launches

__all__ = ["TAP_OFFSETS", "fk_interp", "fk_interp_plain", "fk_interp_bwd",
           "fk_interp_bwd_plain"]

TAP_OFFSETS = (0, 16, 1, 17)  # c, x+1 (front), y+1 (left), x+1 & y+1

# fk_interp_launch(patch, wx, wy, sxy, cst, B, P, out, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
# fk_interp_bwd_launch(patch, wx, wy, sxy, cst, g, B, P, dpatch, dwx, dwy,
#                      stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_void_p] * 4)


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


def fk_interp_bwd_plain(patch, wx, wy, sxy, cst, g):
    """Plain PyTorch version of :func:`fk_interp_bwd`: autograd through
    :func:`fk_interp_plain` (``_fk_bwd``'s contract)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (patch, wx, wy)]
        out = fk_interp_plain(leaves[0], leaves[1], leaves[2], sxy, cst)
        return torch.autograd.grad(out, leaves, g)


def _check(patch, wx, wy, sxy, cst, g=None):
    B, P = wx.shape
    expect = {"patch": (patch, (B, 512)), "wx": (wx, (B, P)),
              "wy": (wy, (B, P)), "sxy": (sxy, (B, 2)), "cst": (cst, (2,))}
    if g is not None:
        expect["g"] = (g, (B, 5 * P))
    for name, (t, shape) in expect.items():
        if t.device != patch.device:
            raise ValueError(f"{name} is on {t.device}, patch on {patch.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if patch.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"fk_interp runs on cuda or cpu, not "
                                  f"{patch.device.type}")


def _launch(patch, wx, wy, sxy, cst):
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


class _FkInterp(torch.autograd.Function):
    """fk_interp on the card: the forward kernel, and the backward kernel
    for d patch, d wx and d wy (``_fk_fwd``/``_fk_bwd``)."""

    @staticmethod
    def forward(ctx, patch, wx, wy, sxy, cst):
        ctx.save_for_backward(patch, wx, wy, sxy, cst)
        return _launch(patch, wx, wy, sxy, cst)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dp, dwx, dwy = fk_interp_bwd(*ctx.saved_tensors, g.contiguous())
        return dp, dwx, dwy, None, None


def fk_interp(patch, wx, wy, sxy, cst):
    """Terrain lookup at world-frame queries out of cached windows.

    patch: (B, 512) f32 [z(256) | friction(256)] row-major 16x16 windows;
    wx, wy: (B, P) f32 world-frame queries; sxy: (B, 2) f32 window corners;
    cst: (2,) f32 [d_max, grid_res].  Returns (B, 5P) f32
    [z | n_x | n_y | n_z | mu], differentiable in patch, wx and wy.
    """
    _check(patch, wx, wy, sxy, cst)
    if patch.device.type == "cpu":
        return fk_interp_plain(patch, wx, wy, sxy, cst)
    return _FkInterp.apply(patch, wx, wy, sxy, cst)


fk_interp.launches = 0
register_launches("fk_interp", fk_interp)


def fk_interp_bwd(patch, wx, wy, sxy, cst, g):
    """Cotangents (d patch (B, 512), d wx (B, P), d wy (B, P)) of
    :func:`fk_interp` at these inputs, given the cotangent ``g`` (B, 5P)
    of its output.  sxy and cst get none: the corners and the constants
    are not differentiated."""
    _check(patch, wx, wy, sxy, cst, g)
    if patch.device.type == "cpu":
        return fk_interp_bwd_plain(patch, wx, wy, sxy, cst, g)
    launch = _build.load("fk_interp_bwd", "fk_interp_bwd_launch",
                         _BWD_ARGTYPES)
    B, P = wx.shape
    dpatch = torch.empty_like(patch)
    dwx = torch.empty_like(wx)
    dwy = torch.empty_like(wy)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(patch.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                    sxy.data_ptr(), cst.data_ptr(), g.data_ptr(), B, P,
                    dpatch.data_ptr(), dwx.data_ptr(), dwy.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fk_interp_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    fk_interp_bwd.launches += 1
    return dpatch, dwx, dwy


fk_interp_bwd.launches = 0
register_launches("fk_interp_bwd", fk_interp_bwd)
