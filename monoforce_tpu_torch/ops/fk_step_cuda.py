"""The per-point physics of one rollout step: CUDA kernel and plain version.

Port of the step kernels of ``monoforce_tpu/ops/fk_step_pallas.py``:
``pack_consts`` (``:68-84``), ``_step_math`` (``:128-274``) and
``_step_math_pair`` (``:474-682``) as every entry point computes them.  The
TPU packs two trajectories per register row; that is layout, so the port
works per trajectory on the P real points, and the JAX pair layout maps
onto it by plain views (``state.reshape(-1, 36)``, ``out.reshape(-1, 8)``).
One kernel, ``csrc/fk_step.cu``, serves six window formats, each a tensor of
32-bit words per trajectory:

- ``zu`` (``fk_step_zu``): 256 bf16 z-pair words ``[z(i,j) | z(i,j+1)]``
  (``physics.fast._extract_windows_zpair``); friction is exactly 1.  Serves
  ``fk_step_pair_zu`` and ``fk_step_pair3_zu``: the z taps are the same bf16
  values as the TPU's pair words.
- ``muq`` (``fk_step_muq``): 512 words, the z-pair plane and a plane of u8
  friction quads at scale 1/64 (``_extract_windows_zmuq``); exact bilinear
  weights on the quantized friction.  Serves ``fk_step_pair3_muq``.
- ``pairmu`` (``fk_step_pairmu``): 256 bf16 ``[z | mu]`` words
  (``_extract_windows_packed1``): z from the high halves of the four taps,
  friction from the low half of the tap-0 cell (the TPU ``pair`` mode's
  nearest-cell friction, the same bf16 values).  Serves ``fk_step_pair``.
- ``pair3`` (``fk_step_pair3``): the same ``[z | mu]`` words with exact
  bilinear friction over the four taps' low halves.  The JAX entry point
  takes two trajectories' windows per row, ``words.reshape(-1, 512)``.
- ``packed`` (``fk_step_packed``): ``[z | mu]`` words as ``pair3``, with
  ``_step_math``'s IEEE divide in the index path and two-pass spring std.
- ``exact`` (``fk_step``): float32 ``[z(256) | mu(256)]`` windows
  (``_extract_windows``), divide and two-pass std; differentiable, its
  backward is autograd through the plain version, as ``_fks_bwd`` is
  ``jax.vjp`` of ``_fk_step_xla``.

The first four formats take the spring statistic from the pair kernels'
sum and sum of squares, ``max(sumsq/n - mean^2, 0)``; the last two from the
mean and then the sum of squared deviations.  The TPU's ghost points each
added 1e-15 N to the spring sum, which the port, having none, leaves out.

Each wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from monoforce_tpu_torch.ops import _build
from monoforce_tpu_torch.ops.interp_cuda import TAP_OFFSETS

__all__ = ["FORMATS", "pack_consts", "pack_points", "fk_step_plain",
           "fk_step_zu", "fk_step_muq", "fk_step_pairmu", "fk_step_pair3",
           "fk_step_packed", "fk_step"]

# window words per trajectory, and the format codes of fk_step_launch
FORMATS = {"zu": 256, "muq": 512, "pairmu": 256, "packed": 256, "exact": 512,
           "pair3": 256}
_FMT_CODE = {"zu": 0, "muq": 1, "pairmu": 2, "packed": 3, "exact": 4,
             "pair3": 5}
# _step_math's formats: IEEE divide in the index path, two-pass spring std
_DIVIDE = ("packed", "exact")

# cst layout (fk_step_pallas.py:68-71)
_C_DMAX, _C_RES, _C_STIFF, _C_DAMP, _C_MASS, _C_G = range(6)
_C_GD0, _C_GD1, _C_GD2, _C_OMAX, _C_NREAL = range(6, 11)
_C_I00, _C_I01, _C_I02, _C_I11, _C_I12, _C_I22, _C_DT = range(11, 18)

# fk_step_launch(fmt, cst, patch, state, tv, sxy, pts, B, P, n_k, out, stream)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def pack_consts(robot) -> torch.Tensor:
    """(18,) float32 scalar constants of a RobotModel, on its device."""
    ii = robot.inertia_inv
    gd = robot.gravity_direction
    n_real = torch.tensor(float(robot.points.shape[0]), device=robot.device)
    return torch.stack([
        robot.d_max, robot.grid_res, robot.stiffness, robot.damping,
        robot.mass, robot.gravity, gd[0], gd[1], gd[2], robot.omega_max,
        n_real, ii[0, 0], ii[0, 1], ii[0, 2], ii[1, 1], ii[1, 2], ii[2, 2],
        robot.dt,
    ]).to(torch.float32)


def pack_points(robot) -> torch.Tensor:
    """(7, P) float32 point planes: px, py, pz, four driving masks (rows
    past the robot's K parts are zero)."""
    P = robot.points.shape[0]
    masks = torch.zeros((4, P), dtype=torch.float32, device=robot.device)
    masks[:robot.driving_masks.shape[0]] = robot.driving_masks
    return torch.cat([robot.points.T, masks]).contiguous()


def _f32_bits(u: torch.Tensor) -> torch.Tensor:
    """float32 whose bit pattern is the low 32 bits of int64 ``u``."""
    u = u & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(
        torch.float32)


def _hi(w):
    """The high bf16 half of int32 words, as float32."""
    return _f32_bits(w.long() & 0xFFFF0000)


def _lo(w):
    """The low bf16 half of int32 words, as float32."""
    return _f32_bits((w.long() & 0xFFFF) << 16)


def fk_step_plain(fmt, cst, patch, state, tv, sxy, pts):
    """Plain PyTorch version of the step kernel in window format ``fmt``
    (arguments as the wrappers')."""
    d_max, res = cst[_C_DMAX], cst[_C_RES]
    stiff, damp = cst[_C_STIFF], cst[_C_DAMP]
    m, g, n_real = cst[_C_MASS], cst[_C_G], cst[_C_NREAL]
    px, py, pz = pts[0:1], pts[1:2], pts[2:3]
    (x0, x1, x2, v0, v1, v2, r00, r01, r02, r10, r11, r12, r20, r21, r22,
     w0, w1, w2) = state.split(1, dim=1)

    rx = r00 * px + r01 * py + r02 * pz
    ry = r10 * px + r11 * py + r12 * pz
    rz = r20 * px + r21 * py + r22 * pz
    wx = rx + x0
    wy = ry + x1
    wz = rz + x2
    vx = v0 + w1 * rz - w2 * ry
    vy = v1 + w2 * rx - w0 * rz
    vz = v2 + w0 * ry - w1 * rx

    if fmt in _DIVIDE:  # fk_step_pallas.py:182-186
        fxq = (wx + d_max) / res
        fyq = (wy + d_max) / res
    else:  # the pair kernels multiply by the reciprocal (:527-535)
        inv_res = 1.0 / res
        fxq = (wx + d_max) * inv_res
        fyq = (wy + d_max) * inv_res
    xi = fxq.to(torch.int32)
    yi = fyq.to(torch.int32)
    xf = fxq - xi.to(torch.float32)
    yf = fyq - yi.to(torch.float32)
    sx = sxy[:, 0:1].to(torch.int32)
    sy = sxy[:, 1:2].to(torch.int32)
    idx = (torch.clamp(xi - sx, 0, 14) * 16
           + torch.clamp(yi - sy, 0, 14)).long()
    w_cc = (1 - xf) * (1 - yf)
    w_cf = (1 - xf) * yf
    w_lc = xf * (1 - yf)
    w_fl = xf * yf

    def gather(base, off):
        return torch.gather(patch[:, base:base + 256], 1, idx + off)

    def bilinear(t):
        return w_cc * t[0] + w_cf * t[1] + w_lc * t[2] + w_fl * t[3]

    if fmt == "exact":
        tz = [gather(0, off) for off in TAP_OFFSETS]
        mu = bilinear([gather(256, off) for off in TAP_OFFSETS])
    elif fmt in ("pairmu", "pair3", "packed"):
        words = [gather(0, off) for off in TAP_OFFSETS]
        tz = [_hi(w) for w in words]
        mu = _lo(words[0]) if fmt == "pairmu" else bilinear(
            [_lo(w) for w in words])
    else:
        a, c = gather(0, 0), gather(0, 16)
        tz = [_hi(a), _hi(c), _lo(a), _lo(c)]
        mu = None
        if fmt == "muq":
            mq = gather(256, 0)
            mt = [((mq >> s) & 255).to(torch.float32) for s in (24, 16, 8, 0)]
            mu = bilinear(mt) * (1.0 / 64.0)
    z = bilinear(tz)
    dz_dx = (tz[1] - tz[0]) / res
    dz_dy = (tz[2] - tz[0]) / res
    ninv = torch.rsqrt(dz_dx * dz_dx + dz_dy * dz_dy + 1.0)
    nx = -dz_dx * ninv
    ny = -dz_dy * ninv
    nz = ninv

    dh = wz - z
    contact = 1.0 / (1.0 + torch.exp(10.0 * dh))
    vn = vx * nx + vy * ny + vz * nz
    scale = -(stiff * dh + damp * vn)
    n_cp = contact.sum(dim=1, keepdim=True)
    # guard the reference's 0/0 at exactly-zero contact only
    cs = scale * contact / torch.where(n_cp > 0, n_cp, 1.0)
    mg = m * g
    fsx = torch.clamp(cs * nx, -mg, mg)
    fsy = torch.clamp(cs * ny, -mg, mg)
    fsz = torch.clamp(cs * nz, -mg, mg)
    spring = torch.sqrt(fsx * fsx + fsy * fsy + fsz * fsz + 1e-30)

    tn = torch.rsqrt(torch.clamp(r00 * r00 + r10 * r10 + r20 * r20,
                                 min=1e-12))
    t0, t1, t2 = r00 * tn, r10 * tn, r20 * tn
    cmd = tv[:, 0:1] * pts[3:4]
    for k in range(1, tv.shape[1]):
        cmd = cmd + tv[:, k:k + 1] * pts[3 + k:4 + k]
    sfx = cmd * t0 - vx
    sfy = cmd * t1 - vy
    sfz = cmd * t2 - vz
    if mu is not None:
        sfx, sfy, sfz = mu * sfx, mu * sfy, mu * sfz
    sn = sfx * nx + sfy * ny + sfz * nz
    fx = fsx + torch.clamp(spring * (sfx - sn * nx), -mg, mg)
    fy = fsy + torch.clamp(spring * (sfy - sn * ny), -mg, mg)
    fz = fsz + torch.clamp(spring * (sfz - sn * nz), -mg, mg)

    tq0, tq1, tq2, fx_s, fy_s, fz_s, s_sum, s_sumsq = (
        p.sum(dim=1, keepdim=True) for p in (
            ry * fz - rz * fy, rz * fx - rx * fz, rx * fy - ry * fx,
            fx, fy, fz, spring, spring * spring))
    om = cst[_C_OMAX]
    i00, i01, i02 = cst[_C_I00], cst[_C_I01], cst[_C_I02]
    i11, i12, i22 = cst[_C_I11], cst[_C_I12], cst[_C_I22]
    aw0 = torch.clamp(i00 * tq0 + i01 * tq1 + i02 * tq2, -om, om)
    aw1 = torch.clamp(i01 * tq0 + i11 * tq1 + i12 * tq2, -om, om)
    aw2 = torch.clamp(i02 * tq0 + i12 * tq1 + i22 * tq2, -om, om)
    ax = (m * g * cst[_C_GD0] + fx_s) / m
    ay = (m * g * cst[_C_GD1] + fy_s) / m
    az = (m * g * cst[_C_GD2] + fz_s) / m
    s_mean = s_sum / n_real
    if fmt in _DIVIDE:  # two passes (fk_step_pallas.py:256-258)
        s_var = ((spring - s_mean) ** 2).sum(dim=1, keepdim=True) / n_real
    else:
        s_var = torch.clamp(s_sumsq / n_real - s_mean * s_mean, min=0.0)
    s_std = torch.sqrt(s_var + 1e-30)
    return torch.cat([ax, ay, az, aw0, aw1, aw2, s_std, n_cp], dim=1)


def _check(fmt, cst, patch, state, tv, sxy, pts):
    B = state.shape[0]
    P = pts.shape[1]
    words = torch.float32 if fmt == "exact" else torch.int32
    expect = {"cst": (cst, torch.float32, (18,)),
              "patch": (patch, words, (B, FORMATS[fmt])),
              "state": (state, torch.float32, (B, 18)),
              "tv": (tv, torch.float32, (B, tv.shape[1])),
              "sxy": (sxy, torch.float32, (B, 2)),
              "pts": (pts, torch.float32, (7, P))}
    for name, (t, dtype, shape) in expect.items():
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= tv.shape[1] <= 4:
        raise ValueError(f"1 to 4 driving parts, got {tv.shape[1]}")
    if not 1 <= P <= 256:
        raise ValueError(f"1 to 256 contact points, got {P}")


class _StepKernel:
    """The step in one window format: plain version on the CPU, the CUDA
    kernel on the card, and the count of kernel launches."""

    def __init__(self, fmt: str, name: str = ""):
        self.fmt = fmt
        self.__name__ = name or f"fk_step_{fmt}"
        self.launches = 0

    def __call__(self, cst, patch, state, tv, sxy, pts):
        """cst: (18,) f32 (pack_consts); patch: (B, FORMATS[fmt]) window
        words, int32 bit patterns (float32 values for ``exact``); state:
        (B, 18) f32; tv: (B, K) f32 track velocities; sxy: (B, 2) f32 window
        corners; pts: (7, P) f32 (pack_points).  Returns (B, 8) f32
        [ax, ay, az, aw0, aw1, aw2, spring_std, n_cp]."""
        _check(self.fmt, cst, patch, state, tv, sxy, pts)
        if state.device.type == "cpu":
            return fk_step_plain(self.fmt, cst, patch, state, tv, sxy, pts)
        if state.device.type != "cuda":
            raise NotImplementedError(f"{self.__name__} runs on cuda or cpu, "
                                      f"not {state.device.type}")
        return self.launch(cst, patch, state, tv, sxy, pts)

    def launch(self, cst, patch, state, tv, sxy, pts):
        launch = _build.load("fk_step", "fk_step_launch", _ARGTYPES)
        B, P = state.shape[0], pts.shape[1]
        out = torch.empty((B, 8), dtype=torch.float32, device=state.device)
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = launch(_FMT_CODE[self.fmt], cst.data_ptr(), patch.data_ptr(),
                        state.data_ptr(), tv.data_ptr(), sxy.data_ptr(),
                        pts.data_ptr(), B, P, tv.shape[1], out.data_ptr(),
                        stream)
        if rc != 0:
            raise RuntimeError(f"{self.__name__} kernel launch failed: "
                               f"CUDA error {rc}")
        self.launches += 1
        return out


class _ExactStep(torch.autograd.Function):
    """The exact step on the card: the kernel forward; backward through the
    plain version for patch, state and tv (``_fks_bwd``, :347-353)."""

    @staticmethod
    def forward(ctx, kernel, cst, patch, state, tv, sxy, pts):
        ctx.save_for_backward(cst, patch, state, tv, sxy, pts)
        return _StepKernel.launch(kernel, cst, patch, state, tv, sxy, pts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        cst, patch, state, tv, sxy, pts = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (patch, state, tv)]
            out = fk_step_plain("exact", cst, leaves[0], leaves[1], leaves[2],
                                sxy, pts)
            dp, ds, dt = torch.autograd.grad(out, leaves, g)
        return None, None, dp, ds, dt, None, None


class _ExactStepKernel(_StepKernel):
    """``fk_step``: the exact format, differentiable in patch, state and tv.
    On the CPU autograd differentiates the plain version directly."""

    def launch(self, cst, patch, state, tv, sxy, pts):
        return _ExactStep.apply(self, cst, patch, state, tv, sxy, pts)


fk_step_zu = _StepKernel("zu")
fk_step_muq = _StepKernel("muq")
fk_step_pairmu = _StepKernel("pairmu")
fk_step_pair3 = _StepKernel("pair3")
fk_step_packed = _StepKernel("packed")
fk_step = _ExactStepKernel("exact", name="fk_step")
