"""The per-point physics of one serving step and the terrain lookup, plain.

Frozen copy of the plain versions of the port's step kernel
(``fk_step_plain``, ``pack_consts``, ``pack_points``) and of its lookup
kernel (``fk_interp_plain``), as the port defined them when this benchmark
was written.  They are the reference that the port's CUDA kernels are held
against; nothing here launches a kernel of the port.
"""

from __future__ import annotations

import torch

__all__ = ["TAP_OFFSETS", "pack_consts", "pack_points", "fk_step_plain",
           "fk_interp_plain"]

TAP_OFFSETS = (0, 16, 1, 17)  # c, x+1 (front), y+1 (left), x+1 & y+1

# _step_math's formats: IEEE divide in the index path, two-pass spring std
_DIVIDE = ("packed", "exact")

# cst layout (fk_step_pallas.py:68-71)
_C_DMAX, _C_RES, _C_STIFF, _C_DAMP, _C_MASS, _C_G = range(6)
_C_GD0, _C_GD1, _C_GD2, _C_OMAX, _C_NREAL = range(6, 11)
_C_I00, _C_I01, _C_I02, _C_I11, _C_I12, _C_I22, _C_DT = range(11, 18)

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


