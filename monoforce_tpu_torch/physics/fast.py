"""The rollouts of the port: window extraction, the step kernels, the
differentiable path and integration.

Port of ``monoforce_tpu/physics/fast.py`` (whole module): ``StepStats``
(:89-92), the window extractors (:95-135, :204-380), ``fast_rollout`` with
its helpers (:382-757), ``planner_kernel_mode`` (:760-788) and
``planner_rollout`` (:791-1073).

Windows are cut out with index gathers (``grid[rows, cols]``), where the
TPU used one-hot matrix products; both select the same values, so the
windows, their bf16 rounding (round to nearest even) and their packed
words are bit-identical to the JAX extractors'.  Packed words are int32
tensors holding the bit pattern, never floats, so no float operation can
touch them (a friction-quad word sets the sign bit once mu >= 2).  The
exact float32 windows of ``_extract_windows`` are differentiable in the
grids (the gather's backward adds into them).

Two rollouts:

- :func:`fast_rollout`, the differentiable path: eighteen (B,) state planes
  and (B, P) point planes in plain PyTorch, one ``fk_interp`` per step
  (``ops/interp_cuda.py``, whose backward is a kernel too) on exact windows
  refreshed every 8 steps, flipper articulation, euler or rk4.
- :func:`planner_rollout`, the serving path: one launch of a step kernel
  (``ops/fk_step_cuda.py``) per step on bf16 windows refreshed every 32
  steps; the launch also integrates the packed (B, 18) state
  (:func:`_integrate`, the Rodrigues update included) and writes it into the
  rollout's (B, N, 18) sequence; on the CPU the steps are the plain
  versions, :class:`PlainStep`.  Its ``fallback`` mode is
  :func:`fast_rollout`.

Both run ``fk_interp`` once in the settle step.  The TPU layout's ghost
points (contact points padded to a multiple of 128 lanes, masked out of
contact) are dropped: their only trace in the JAX package is 1e-15 N terms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from monoforce_tpu_torch.ops.fk_step_cuda import fk_step_plain
from monoforce_tpu_torch.physics.controls import vw_to_track_vels
from monoforce_tpu_torch.physics.engine import (RigidState, _default_state0,
                                                on_device)
from monoforce_tpu_torch.utils.profiling import count, span

__all__ = ["fast_rollout", "planner_rollout", "planner_kernel_mode",
           "StepStats", "quantize_mu_grid"]

_PATCH = 16
_REFRESH = 8        # steps between window refreshes on the exact path
_REFRESH_PRED = 32  # steps between window refreshes, with motion-predicted
                    # corners (the window covers the footprint now and at the
                    # velocity-predicted end of the block; fast.py:75-86)


class StepStats(NamedTuple):
    spring_std: torch.Tensor  # (B, N) std over points of |F_spring|
    abs_roll: torch.Tensor    # (B, N)
    abs_pitch: torch.Tensor   # (B, N)


def _corners(qx, qy, d_max, grid_res, shape, dqx=None, dqy=None):
    """Window min-corners (sx, sy) as int64 (B,): the occupied span with a
    2-cell margin, or with motion prediction the union of the footprint now
    and displaced by (dqx, dqy), with a 1-cell margin.  The TPU layout's
    ghost points sit at the body origin, inside every preset's footprint,
    so leaving them out changes no minimum."""
    H, W = shape
    xi = ((qx + d_max) / grid_res).to(torch.int32)
    yi = ((qy + d_max) / grid_res).to(torch.int32)
    if dqx is None:
        sx = xi.min(dim=1).values - 2
        sy = yi.min(dim=1).values - 2
    else:
        xi2 = ((qx + dqx + d_max) / grid_res).to(torch.int32)
        yi2 = ((qy + dqy + d_max) / grid_res).to(torch.int32)
        sx = torch.minimum(xi.min(dim=1).values, xi2.min(dim=1).values) - 1
        sy = torch.minimum(yi.min(dim=1).values, yi2.min(dim=1).values) - 1
    return (torch.clamp(sx, 0, H - _PATCH).long(),
            torch.clamp(sy, 0, W - _PATCH).long())


def _window(grid, sx, sy):
    """(B, 16, 16) windows of a (H, W) or (B, H, W) grid at corners sx, sy."""
    ar = torch.arange(_PATCH, device=grid.device)
    rows = (sx[:, None] + ar)[:, :, None]
    cols = (sy[:, None] + ar)[:, None, :]
    if grid.ndim == 2:
        return grid[rows, cols]
    b = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    return grid[b, rows, cols]


def _sxy(sx, sy):
    return torch.stack([sx, sy], dim=1).to(torch.float32)


def _bf16_bits(v):
    """The 16 bits of bf16(v) (round to nearest even) as int64 in [0, 2^16)."""
    return v.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF


def _words(hi, lo):
    """int32 words whose bit pattern is (hi << 16) | lo, for 16-bit int64
    halves (built in int64, then reinterpreted)."""
    u = (hi << 16) | lo
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _next_col(p):
    """p shifted one column left, the last column repeated (j+1 clamped)."""
    return torch.cat([p[:, :, 1:], p[:, :, 15:16]], dim=2)


def _next_row(p):
    return torch.cat([p[:, 1:, :], p[:, 15:16, :]], dim=1)


def _extract_windows(z_grid, friction, qx, qy, d_max, grid_res):
    """Exact f32 windows for the settle step: sxy (B, 2) f32 corners and
    (B, 512) row-major [z(256) | friction(256)] (fast.py:95-134)."""
    sx, sy = _corners(qx, qy, d_max, grid_res, z_grid.shape[-2:])
    B = qx.shape[0]
    patch = torch.cat([_window(z_grid, sx, sy).reshape(B, 256),
                       _window(friction, sx, sy).reshape(B, 256)], dim=1)
    return _sxy(sx, sy), patch


def _extract_windows_packed1(z_grid, friction, qx, qy, d_max, grid_res,
                             dqx=None, dqy=None):
    """(B, 256) int32 bf16 [z | mu] words per cell (fast.py:204-250)."""
    sx, sy = _corners(qx, qy, d_max, grid_res, z_grid.shape[-2:], dqx, dqy)
    B = qx.shape[0]
    uz = _bf16_bits(_window(z_grid, sx, sy)).reshape(B, 256)
    uf = _bf16_bits(_window(friction, sx, sy)).reshape(B, 256)
    return _sxy(sx, sy), _words(uz, uf)


def _extract_windows_zpair(z_grid, qx, qy, d_max, grid_res, dqx=None,
                           dqy=None):
    """(B, 256) int32 bf16 [z(i,j) | z(i,j+1)] words (fast.py:253-299)."""
    sx, sy = _corners(qx, qy, d_max, grid_res, z_grid.shape[-2:], dqx, dqy)
    B = qx.shape[0]
    pz = _window(z_grid, sx, sy)
    uz = _bf16_bits(pz).reshape(B, 256)
    un = _bf16_bits(_next_col(pz)).reshape(B, 256)
    return _sxy(sx, sy), _words(uz, un)


def quantize_mu_grid(friction):
    """u8 friction at scale 1/64, as exact float32 integers 0..255
    (fast.py:302-310); computed once per rollout."""
    return torch.clamp(torch.round(friction * 64.0), 0.0, 255.0)


def _extract_windows_zmuq(z_grid, mu_q, qx, qy, d_max, grid_res, dqx=None,
                          dqy=None):
    """(B, 512) int32 = [z-pair words(256) | friction quads(256)]
    (fast.py:313-379).  A quad packs the four u8 friction taps of a cell in
    tap order [(i,j), (i+1,j), (i,j+1), (i+1,j+1)], high byte first;
    ``mu_q`` comes from :func:`quantize_mu_grid`."""
    sx, sy = _corners(qx, qy, d_max, grid_res, z_grid.shape[-2:], dqx, dqy)
    B = qx.shape[0]
    pz = _window(z_grid, sx, sy)
    zwords = _words(_bf16_bits(pz).reshape(B, 256),
                    _bf16_bits(_next_col(pz)).reshape(B, 256))
    # the bf16 round is exact for integers 0..255
    m0 = _window(mu_q, sx, sy).long()
    m1 = _next_row(m0)
    m2 = _next_col(m0)
    m3 = _next_col(m1)
    mwords = _words((m0 * 256 + m1).reshape(B, 256),
                    (m2 * 256 + m3).reshape(B, 256))
    return _sxy(sx, sy), torch.cat([zwords, mwords], dim=1)


class _Consts(NamedTuple):
    """Per-rollout constants: body-frame point components, driving masks,
    the lookup's [d_max, grid_res] (the JAX docstring's "1/grid_res" is
    wrong: fast.py:439 stores grid_res, and fk_interp divides by it) and
    the flipper joints' x and z."""
    px: torch.Tensor      # (P,)
    py: torch.Tensor
    pz: torch.Tensor
    dmask: torch.Tensor   # (K, P) driving-part masks
    n_real: float         # P
    cst: torch.Tensor     # (2,) [d_max, grid_res]
    jx: torch.Tensor      # (4,) flipper joint x positions
    jz: torch.Tensor      # (4,) flipper joint z positions


def _make_consts(robot) -> _Consts:
    return _Consts(px=robot.points[:, 0], py=robot.points[:, 1],
                   pz=robot.points[:, 2], dmask=robot.driving_masks,
                   n_real=float(robot.points.shape[0]),
                   cst=torch.stack([robot.d_max, robot.grid_res]),
                   jx=robot.joint_positions[:, 0],
                   jz=robot.joint_positions[:, 2])


def _unpack_state(state0: RigidState):
    """The eighteen (B,) planes of a RigidState, row-major rotation."""
    x, xd, R, omega = state0
    return (x[:, 0], x[:, 1], x[:, 2], xd[:, 0], xd[:, 1], xd[:, 2],
            R[:, 0, 0], R[:, 0, 1], R[:, 0, 2],
            R[:, 1, 0], R[:, 1, 1], R[:, 1, 2],
            R[:, 2, 0], R[:, 2, 1], R[:, 2, 2],
            omega[:, 0], omega[:, 1], omega[:, 2])


def _world_xy(c: _Consts, state18):
    """World-frame x/y (B, P) of the contact points from the packed state."""
    return _world_planes(state18.unbind(1), c.px[None], c.py[None],
                         c.pz[None])


def _world_planes(st, px, py, pz):
    """World x/y (B, P) of points given as (1, P) or (B, P) planes, from
    the eighteen state planes (fast.py:499-507)."""
    x0, x1 = st[0][:, None], st[1][:, None]
    r00, r01, r02, r10, r11, r12 = (r[:, None] for r in st[6:12])
    wx = r00 * px + r01 * py + r02 * pz + x0
    wy = r10 * px + r11 * py + r12 * pz + x1
    return wx, wy


def _rodrigues_components(r, w0, w1, w2, dt, eps=1e-6):
    """R <- R expm([w]_x dt) expanded over the nine rotation entries
    (fast.py:382-412, engine.integrate_rotation in component form)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    theta = torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
    inv_t = 1.0 / torch.clamp(theta, min=eps)
    nx, ny, nz = w0 * inv_t, w1 * inv_t, w2 * inv_t
    s = torch.sin(theta * dt)
    c1 = 1.0 - torch.cos(theta * dt)
    m00 = 1.0 + c1 * (-(ny * ny + nz * nz))
    m01 = -nz * s + c1 * nx * ny
    m02 = ny * s + c1 * nx * nz
    m10 = nz * s + c1 * nx * ny
    m11 = 1.0 + c1 * (-(nx * nx + nz * nz))
    m12 = -nx * s + c1 * ny * nz
    m20 = -ny * s + c1 * nx * nz
    m21 = nx * s + c1 * ny * nz
    m22 = 1.0 + c1 * (-(nx * nx + ny * ny))
    return (
        r00 * m00 + r01 * m10 + r02 * m20,
        r00 * m01 + r01 * m11 + r02 * m21,
        r00 * m02 + r01 * m12 + r02 * m22,
        r10 * m00 + r11 * m10 + r12 * m20,
        r10 * m01 + r11 * m11 + r12 * m21,
        r10 * m02 + r11 * m12 + r12 * m22,
        r20 * m00 + r21 * m10 + r22 * m20,
        r20 * m01 + r21 * m11 + r22 * m21,
        r20 * m02 + r21 * m12 + r22 * m22,
    )


def _articulate(c: _Consts, ja_t):
    """Rotate the four flipper point groups about their y-axis joints
    (fast.py:445-463, engine.update_joints).  ja_t: (B, 4).  Returns the
    (B, P) point planes px, py, pz."""
    px = c.px.expand(ja_t.shape[0], -1)
    pz = c.pz.expand(ja_t.shape[0], -1)
    for i in range(4):
        a = ja_t[:, i:i + 1]
        cos_a, sin_a = torch.cos(a), torch.sin(a)
        gx = px - c.jx[i]
        gz = pz - c.jz[i]
        rx = cos_a * gx + sin_a * gz + c.jx[i]
        rz = -sin_a * gx + cos_a * gz + c.jz[i]
        gm = c.dmask[i]
        px = gm * rx + (1.0 - gm) * px
        pz = gm * rz + (1.0 - gm) * pz
    return px, c.py.expand(px.shape), pz


def _inertia_inv_planes(c: _Consts, mass, px, py, pz):
    """Per-trajectory inertia tensor of the articulated points and its
    symmetric 3x3 inverse by the adjugate, as (B,) planes
    (fast.py:466-496)."""
    m_pt = mass / c.n_real
    xx = torch.sum(px * px, dim=1)
    yy = torch.sum(py * py, dim=1)
    zz = torch.sum(pz * pz, dim=1)
    xy = torch.sum(px * py, dim=1)
    xz = torch.sum(px * pz, dim=1)
    yz = torch.sum(py * pz, dim=1)
    a = m_pt * (yy + zz)   # ixx
    d = m_pt * (xx + zz)   # iyy
    f = m_pt * (xx + yy)   # izz
    b = -m_pt * xy
    cc = -m_pt * xz
    e = -m_pt * yz
    ca = d * f - e * e
    cb = cc * e - b * f
    cf = b * e - cc * d
    inv_det = 1.0 / (a * ca + b * cb + cc * cf)
    return (ca * inv_det, cb * inv_det, cf * inv_det,
            (a * f - cc * cc) * inv_det, (b * cc - a * e) * inv_det,
            (a * d - b * b) * inv_det)


def _step(robot, c: _Consts, fk_interp, windows, st, tv_t, ja_t, integ, dt,
          with_stats):
    """One physics step over the state planes (fast.py:510-623); returns
    (new state planes, outputs: the new planes and, with stats, spring std,
    |roll| and |pitch|)."""
    (x0, x1, x2, v0, v1, v2,
     r00, r01, r02, r10, r11, r12, r20, r21, r22, w0, w1, w2) = st
    m, g = robot.mass, robot.gravity
    sxy, patch = windows

    if ja_t is not None:
        px, py, pz = _articulate(c, ja_t)
        ii = _inertia_inv_planes(c, m, px, py, pz)
    else:
        px, py, pz = c.px[None], c.py[None], c.pz[None]
        ii = None

    # rotated body points (the lever arms) and world points
    col = [t[:, None] for t in st]
    rx = col[6] * px + col[7] * py + col[8] * pz
    ry = col[9] * px + col[10] * py + col[11] * pz
    rz = col[12] * px + col[13] * py + col[14] * pz
    wx = rx + col[0]
    wy = ry + col[1]
    wz = rz + col[2]

    # point velocities (Koenig): xd + omega x r
    vx = col[3] + col[16] * rz - col[17] * ry
    vy = col[4] + col[17] * rx - col[15] * rz
    vz = col[5] + col[15] * ry - col[16] * rx

    P = wx.shape[1]
    out = fk_interp(patch, wx, wy, sxy, c.cst)      # (B, 5P)
    z, nx, ny, nz, mu = out.split(P, dim=1)

    # soft contact and spring-damper (dphysics.py:220-234)
    dh = wz - z
    contact = torch.sigmoid(-10.0 * dh)
    vn = vx * nx + vy * ny + vz * nz
    scale = -(robot.stiffness * dh + robot.damping * vn)
    n_cp = torch.sum(contact, dim=1, keepdim=True)
    # the reference's unguarded 0/0 at exactly-zero contact only
    cs = scale * contact / torch.where(n_cp > 0, n_cp, 1.0)
    mg = m * g
    fsx = torch.clamp(cs * nx, -mg, mg)
    fsy = torch.clamp(cs * ny, -mg, mg)
    fsz = torch.clamp(cs * nz, -mg, mg)
    # the bias keeps sqrt's derivative finite at a zero force
    spring_mag = torch.sqrt(fsx * fsx + fsy * fsy + fsz * fsz + 1e-30)

    # velocity-based friction (dphysics.py:236-252)
    tn = torch.rsqrt(torch.clamp(r00 * r00 + r10 * r10 + r20 * r20,
                                 min=1e-12))
    t0 = (r00 * tn)[:, None]
    t1 = (r10 * tn)[:, None]
    t2 = (r20 * tn)[:, None]
    cmd = torch.matmul(tv_t, c.dmask)               # (B, P)
    sfx = mu * (cmd * t0 - vx)
    sfy = mu * (cmd * t1 - vy)
    sfz = mu * (cmd * t2 - vz)
    sn = sfx * nx + sfy * ny + sfz * nz
    ffx = torch.clamp(spring_mag * (sfx - sn * nx), -mg, mg)
    ffy = torch.clamp(spring_mag * (sfy - sn * ny), -mg, mg)
    ffz = torch.clamp(spring_mag * (sfz - sn * nz), -mg, mg)

    # torques and accelerations (dphysics.py:254-267)
    fx_ = fsx + ffx
    fy_ = fsy + ffy
    fz_ = fsz + ffz
    tq0 = torch.sum(ry * fz_ - rz * fy_, dim=1)
    tq1 = torch.sum(rz * fx_ - rx * fz_, dim=1)
    tq2 = torch.sum(rx * fy_ - ry * fx_, dim=1)
    om = robot.omega_max
    if ii is None:
        si = robot.inertia_inv
        aw0 = torch.clamp(si[0, 0] * tq0 + si[0, 1] * tq1 + si[0, 2] * tq2,
                          -om, om)
        aw1 = torch.clamp(si[1, 0] * tq0 + si[1, 1] * tq1 + si[1, 2] * tq2,
                          -om, om)
        aw2 = torch.clamp(si[2, 0] * tq0 + si[2, 1] * tq1 + si[2, 2] * tq2,
                          -om, om)
    else:
        i00, i01, i02, i11, i12, i22 = ii
        aw0 = torch.clamp(i00 * tq0 + i01 * tq1 + i02 * tq2, -om, om)
        aw1 = torch.clamp(i01 * tq0 + i11 * tq1 + i12 * tq2, -om, om)
        aw2 = torch.clamp(i02 * tq0 + i12 * tq1 + i22 * tq2, -om, om)
    gd = robot.gravity_direction
    ax = (m * g * gd[0] + torch.sum(fx_, dim=1)) / m
    ay = (m * g * gd[1] + torch.sum(fy_, dim=1)) / m
    az = (m * g * gd[2] + torch.sum(fz_, dim=1)) / m

    # semi-implicit integration: velocity first, position with the new one
    v0n, v1n, v2n = integ(v0, ax), integ(v1, ay), integ(v2, az)
    x0n, x1n, x2n = integ(x0, v0n), integ(x1, v1n), integ(x2, v2n)
    w0n, w1n, w2n = integ(w0, aw0), integ(w1, aw1), integ(w2, aw2)
    r = _rodrigues_components(
        (r00, r01, r02, r10, r11, r12, r20, r21, r22), w0n, w1n, w2n, dt)
    new = (x0n, x1n, x2n, v0n, v1n, v2n) + r + (w0n, w1n, w2n)

    outs = new
    if with_stats:
        mean = torch.sum(spring_mag, dim=1) / c.n_real
        var = torch.sum((spring_mag - mean[:, None]) ** 2, dim=1) / c.n_real
        roll = torch.atan2(r[7], r[8])
        pitch = torch.atan2(-r[6], torch.sqrt(r[7] ** 2 + r[8] ** 2))
        outs = outs + (torch.sqrt(var + 1e-30), roll.abs(), pitch.abs())
    return new, outs


def fast_rollout(robot, z_grid, controls, state0: Optional[RigidState] = None,
                 friction=None, track_vels=None, joint_angles=None,
                 with_stats: bool = True):
    """Batched differentiable rollout, on ``robot``'s device.

    Args:
      robot: RobotModel.
      z_grid: (H, W) shared terrain or (B, H, W) per trajectory.
      controls: (B, N, 2) commanded (v, w).
      state0: optional initial state with (B, ...) leaves.
      friction: friction grid(s) shaped like z_grid; ones if None.
      track_vels: optional (B, N, K) track velocities (else from controls).
      joint_angles: optional (B, N, 4) flipper angles (marv articulation).
      with_stats: also return per-step cost statistics.

    Returns (RigidState with (B, N, ...) leaves, StepStats or None).
    Gradients flow to z_grid, friction, controls, track_vels, state0 and
    joint_angles through every step's ``fk_interp``.  Raises ValueError for
    an input tensor on another device than the robot's.
    """
    # imported at every call: chip_smoke.py swaps the module attribute for
    # the plain version to build the rollout it holds the kernels' against
    from monoforce_tpu_torch.ops.interp_cuda import fk_interp

    dev = robot.device
    controls = on_device(controls, dev, "controls")
    z_grid = on_device(z_grid, dev, "z_grid")
    friction = (torch.ones_like(z_grid) if friction is None else
                on_device(friction, dev, "friction"))
    if state0 is None:
        state0 = _default_state0(controls)
    else:
        state0 = RigidState(*(on_device(v, dev, f"state0.{k}")
                              for k, v in state0._asdict().items()))
    if track_vels is None:
        track_vels = vw_to_track_vels(controls[..., 0], controls[..., 1],
                                      robot.robot_size, robot.n_tracks)
    else:
        track_vels = on_device(track_vels, dev, "track_vels")
    articulated = robot.has_flippers and joint_angles is not None
    if articulated:
        ja_t = on_device(joint_angles, dev, "joint_angles").transpose(0, 1)

    c = _make_consts(robot)
    d_max, res = robot.d_max, robot.grid_res
    st = _unpack_state(state0)
    dt = robot.dt
    rk4 = robot.integration_mode == "rk4"

    def integ(a, da):
        if not rk4:
            return a + da * dt
        # the reference's 'rk4' formula (dphysics.py:375-380)
        k1 = dt * da
        k2 = dt * (da + k1 / 2)
        k3 = dt * (da + k2 / 2)
        k4 = dt * (da + k3)
        return a + (k1 + 2 * k2 + 2 * k3 + k4) / 6

    # settle to the mean terrain height under the body (dphysics.py:566-571),
    # with the unarticulated cloud as the reference does
    p0 = (c.px[None], c.py[None], c.pz[None])
    wx0, wy0 = _world_planes(st, *p0)
    sxy0, patch0 = _extract_windows(z_grid, friction, wx0, wy0, d_max, res)
    z0 = fk_interp(patch0, wx0, wy0, sxy0, c.cst)[:, :wx0.shape[1]]
    st = st[:2] + (z0.sum(dim=1) / c.n_real,) + st[3:]

    tv_t = track_vels.transpose(0, 1)                 # (N, B, K)
    n_total = tv_t.shape[0]
    outs = []
    for start in range(0, n_total, _REFRESH):
        # refresh the windows, then run the block's steps (the last block
        # runs the N mod 8 steps that remain)
        pts = _articulate(c, ja_t[start]) if articulated else p0
        wx, wy = _world_planes(st, *pts)
        windows = _extract_windows(z_grid, friction, wx, wy, d_max, res)
        for k in range(start, min(start + _REFRESH, n_total)):
            st, out_k = _step(robot, c, fk_interp, windows, st, tv_t[k],
                              ja_t[k] if articulated else None, integ, dt,
                              with_stats)
            outs.append(out_k)

    planes = [torch.stack(p, dim=1) for p in zip(*outs)]    # each (B, N)
    xs = torch.stack(planes[0:3], dim=-1)
    xds = torch.stack(planes[3:6], dim=-1)
    Rs = torch.stack(planes[6:15], dim=-1).unflatten(-1, (3, 3))
    omegas = torch.stack(planes[15:18], dim=-1)
    # equilibrium sink-in compensation (dphysics.py:586-589)
    delta_h = robot.mass * robot.gravity / (robot.stiffness + 1e-6)
    xs = xs + Rs[..., :, 2] * delta_h
    stats = StepStats(*planes[18:21]) if with_stats else None
    return RigidState(xs, xds, Rs, omegas), stats


def planner_kernel_mode(robot, batch_size: int,
                        uniform_friction: bool = True) -> str:
    """The serving mode :func:`planner_rollout` runs, with the JAX
    package's names and dispatch: ``pair_zu``/``pair`` (P <= 64,
    B % 16 == 0), ``pair3_zu``/``pair3_muq`` (64 < P <= 192, B % 16 == 0),
    ``packed`` (P <= 256 otherwise) or ``fallback`` (non-euler or P > 256).
    The ``_zu`` modes are taken when friction is uniform (friction=None)."""
    P = robot.points.shape[0]
    if robot.integration_mode != "euler" or P > 256:
        return "fallback"
    zu = "_zu" if uniform_friction else ""
    if P <= 64 and batch_size % 16 == 0:
        return "pair" + zu
    if 64 < P <= 192 and batch_size % 16 == 0:
        return "pair3" + (zu or "_muq")
    return "packed"


def _integrate(state18, acc8, dt):
    """Semi-implicit Euler and the Rodrigues update on the packed (B, 18)
    state (fast.py:915-934): R' = R (I + sin(th dt) K + (1 - cos(th dt))
    (k k^T - I))."""
    vn = state18[:, 3:6] + acc8[:, 0:3] * dt
    xn = state18[:, 0:3] + vn * dt
    wn = state18[:, 15:18] + acc8[:, 3:6] * dt
    theta = torch.sqrt(torch.sum(wn * wn, dim=1, keepdim=True))
    k = wn / torch.clamp(theta, min=1e-6)
    s = torch.sin(theta * dt)
    c1 = 1.0 - torch.cos(theta * dt)
    kk = (k[:, :, None] * k[:, None, :]).reshape(-1, 9)
    zc = torch.zeros_like(theta)
    K_ = torch.cat([zc, -k[:, 2:3], k[:, 1:2],
                    k[:, 2:3], zc, -k[:, 0:1],
                    -k[:, 1:2], k[:, 0:1], zc], dim=1)
    eye9 = torch.eye(3, dtype=state18.dtype, device=state18.device).reshape(9)
    M = eye9 + s * K_ + c1 * (kk - eye9)
    R = state18[:, 6:15].reshape(-1, 3, 3)
    Rn = (R[:, :, :, None] * M.reshape(-1, 1, 3, 3)).sum(dim=2)
    return torch.cat([xn, vn, Rn.reshape(-1, 9), wn], dim=1)


class PlainStep:
    """A step kernel's fused rollout steps (``_StepKernel.into``) through
    the plain versions, on any device: step k is ``fk_step_plain`` on the
    state before it followed by :func:`_integrate`, written into the
    rollout's sequence as the kernel writes it.  The serving rollout's steps
    on the CPU; on the card, the version the fused kernel is held against."""

    def __init__(self, kernel):
        self.fmt = kernel.fmt
        self.__name__ = kernel.__name__

    def into(self, cst, tv_t, state0, seq, spring, pts):
        return _PlainSteps(self.fmt, cst, tv_t, state0, seq, spring, pts)


class _PlainSteps:
    """:class:`PlainStep`'s steps of one rollout: ``window(patch, sxy)`` at
    each window refresh, then ``step(k)``."""

    def __init__(self, fmt, cst, tv_t, state0, seq, spring, pts):
        self.fmt, self.cst, self.tv_t, self.pts = fmt, cst, tv_t, pts
        self.state0, self.seq, self.spring = state0, seq, spring

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def window(self, patch, sxy):
        self.patch, self.sxy = patch, sxy

    def step(self, k):
        if not 0 <= k < self.seq.shape[1]:
            raise IndexError(f"step {k} of a rollout of {self.seq.shape[1]}")
        state = self.state0 if k == 0 else self.seq[:, k - 1]
        acc8 = fk_step_plain(self.fmt, self.cst, self.patch, state,
                             self.tv_t[k], self.sxy, self.pts)
        # cst[17] is the step dt (pack_consts)
        self.seq[:, k] = _integrate(state, acc8, self.cst[17])
        self.spring[:, k] = acc8[:, 6]


def planner_rollout(robot, z_grid, controls,
                    state0: Optional[RigidState] = None, friction=None,
                    track_vels=None, with_stats: bool = True):
    """Serving rollout for the shooting planner, on ``robot``'s device.

    The mode is :func:`planner_kernel_mode`'s: ``pair_zu``, ``pair3_zu``
    (``fk_step_zu``), ``pair3_muq`` (``fk_step_muq``), ``pair``
    (``fk_step_pairmu``) and ``packed`` (``fk_step_packed``) launch one step
    kernel per step, which also integrates the state into the rollout's
    sequence (``_StepKernel.into``); ``fallback`` (rk4 or P > 256) is
    :func:`fast_rollout`.

    Args:
      robot: RobotModel (no flipper articulation).
      z_grid: (H, W) shared terrain or (B, H, W) per trajectory.
      controls: (B, N, 2) commanded (v, w).
      state0: optional initial state with (B, ...) leaves.
      friction: friction grid(s) shaped like z_grid; None means exactly
        uniform mu = 1 and selects the friction-free ``_zu`` modes.
      track_vels: optional (B, N, K) track velocities (else from controls).

    Returns (RigidState with (B, N, ...) leaves, StepStats or None).
    Raises ValueError for an input tensor on another device than the
    robot's.

    Recorded as span ``rollout`` (``utils.profiling``) over
    ``rollout.settle``, a ``rollout.extract`` and a ``rollout.steps`` per
    block of steps between window refreshes, and ``rollout.stats``; its
    counters ``rollout.steps`` (N) and ``rollout.fused_steps`` (the steps
    issued as one fused launch each: N, or none on ``fallback``).
    """
    with span("rollout"):
        return _planner_rollout(robot, z_grid, controls, state0, friction,
                                track_vels, with_stats)


def _planner_rollout(robot, z_grid, controls, state0, friction, track_vels,
                     with_stats):
    B = controls.shape[0]
    mode = planner_kernel_mode(robot, B, uniform_friction=friction is None)
    if mode == "fallback":
        count("rollout.steps", controls.shape[1])
        return fast_rollout(robot, z_grid, controls, state0=state0,
                            friction=friction, track_vels=track_vels,
                            with_stats=with_stats)
    # imported here, at every call, and not at module level: chip_smoke.py
    # swaps these module attributes for the plain versions to build the
    # rollout it holds the kernels' rollout against
    from monoforce_tpu_torch.ops.fk_step_cuda import (
        fk_step_muq, fk_step_packed, fk_step_pairmu, fk_step_zu, pack_consts,
        pack_points)
    from monoforce_tpu_torch.ops.interp_cuda import fk_interp

    dev = robot.device
    controls = on_device(controls, dev, "controls")
    z_grid = on_device(z_grid, dev, "z_grid")
    uniform_mu = friction is None
    friction = (torch.ones_like(z_grid) if uniform_mu else
                on_device(friction, dev, "friction"))
    if state0 is None:
        state0 = _default_state0(controls)
    else:
        state0 = RigidState(*(on_device(v, dev, f"state0.{k}")
                              for k, v in state0._asdict().items()))
    if track_vels is None:
        track_vels = vw_to_track_vels(controls[..., 0], controls[..., 1],
                                      robot.robot_size, robot.n_tracks)
    else:
        track_vels = on_device(track_vels, dev, "track_vels")
    d_max, res = robot.d_max, robot.grid_res
    c = _make_consts(robot)
    cst = pack_consts(robot)
    pts = pack_points(robot)
    state18 = torch.stack(_unpack_state(state0), dim=1).to(dev, torch.float32)

    # settle: rest the body on the terrain under its contact points
    with span("rollout.settle"):
        wx0, wy0 = _world_xy(c, state18)
        sxy0, patch0 = _extract_windows(z_grid, friction, wx0, wy0, d_max,
                                        res)
        z0 = fk_interp(patch0, wx0.contiguous(), wy0.contiguous(), sxy0,
                       c.cst)[:, :wx0.shape[1]]
        state18 = state18.clone()
        state18[:, 2] = z0.sum(dim=1) / wx0.shape[1]

    if mode in ("pair_zu", "pair3_zu"):
        step = fk_step_zu

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_zpair(z_grid, wx, wy, d_max, res,
                                          dqx, dqy)
    elif mode == "pair3_muq":
        step = fk_step_muq
        mu_q = quantize_mu_grid(friction)

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_zmuq(z_grid, mu_q, wx, wy, d_max, res,
                                         dqx, dqy)
    else:
        # "pair": bf16 z taps, nearest-cell friction; "packed": bilinear
        # friction, divide and two-pass std (ones when friction is None)
        step = fk_step_pairmu if mode == "pair" else fk_step_packed

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_packed1(z_grid, friction, wx, wy, d_max,
                                            res, dqx, dqy)

    dt = robot.dt
    tv_t = track_vels.to(dev, torch.float32).transpose(0, 1).contiguous()
    n_total = tv_t.shape[0]
    # step k writes the state after it to seq[:, k] and its spring std to
    # spring[:, k], reading the state before it from seq[:, k - 1]
    seq = torch.empty((B, n_total, 18), dtype=torch.float32, device=dev)
    spring = torch.empty((B, n_total), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        step = PlainStep(step)
    with step.into(cst, tv_t, state18, seq, spring, pts) as steps:
        for start in range(0, n_total, _REFRESH_PRED):
            n_blk = min(_REFRESH_PRED, n_total - start)
            # windows over the footprint now and at the velocity-predicted
            # end of the block (the remainder block predicts over its own
            # length)
            t_blk = n_blk * dt
            count("rollout.steps", n_blk)
            count("rollout.fused_steps", n_blk)
            with span("rollout.extract"):
                state = state18 if start == 0 else seq[:, start - 1]
                wx, wy = _world_xy(c, state)
                sxy, patch = extract(wx, wy, state[:, 3:4] * t_blk,
                                     state[:, 4:5] * t_blk)
                steps.window(patch, sxy)
            with span("rollout.steps"):
                for k in range(start, start + n_blk):
                    steps.step(k)

    with span("rollout.stats"):
        xs = seq[..., 0:3]
        Rs = seq[..., 6:15].reshape(seq.shape[:2] + (3, 3))
        delta_h = robot.mass * robot.gravity / (robot.stiffness + 1e-6)
        xs = xs + Rs[..., :, 2] * delta_h
        out = RigidState(xs, seq[..., 3:6], Rs, seq[..., 15:18])

        stats = None
        if with_stats:
            roll = torch.atan2(Rs[..., 2, 1], Rs[..., 2, 2])
            pitch = torch.atan2(-Rs[..., 2, 0], torch.sqrt(
                Rs[..., 2, 1] ** 2 + Rs[..., 2, 2] ** 2))
            stats = StepStats(spring, roll.abs(), pitch.abs())
        return out, stats
