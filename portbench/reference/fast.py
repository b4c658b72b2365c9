"""The serving rollout, plain: window extraction and ``planner_rollout``.

Frozen copy of the port's ``physics/fast.py`` serving path as it stood
when this benchmark was written, with every kernel call replaced by the
plain version in ``step.py``.  Windows, their bf16 rounding and their
packed words are the kernels' semantics, so they are kept bit for bit.

``planner_rollout(..., state_round=dtype)`` rounds the packed state to
``dtype`` after every step: the benchmark's lower-precision control.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from portbench.reference.controls import vw_to_track_vels
from portbench.reference.engine import (RigidState, _default_state0,
                                                on_device)

__all__ = ["planner_rollout", "planner_kernel_mode", "StepStats",
           "quantize_mu_grid"]

_PATCH = 16
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


def planner_rollout(robot, z_grid, controls,
                    state0: Optional[RigidState] = None, friction=None,
                    track_vels=None, with_stats: bool = True,
                    state_round: Optional[torch.dtype] = None):
    """Serving rollout for the shooting planner, on ``robot``'s device.

    The mode is :func:`planner_kernel_mode`'s: ``pair_zu``, ``pair3_zu``
    (``fk_step_zu``), ``pair3_muq`` (``fk_step_muq``), ``pair``
    (``fk_step_pairmu``) and ``packed`` (``fk_step_packed``) launch one step
    kernel per step in the port; here each step is ``fk_step_plain`` in
    that format.  ``fallback`` (rk4 or P > 256) is not part of the
    reference and raises.

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
    """
    B = controls.shape[0]
    mode = planner_kernel_mode(robot, B, uniform_friction=friction is None)
    if mode == "fallback":
        raise NotImplementedError("the reference has no fallback rollout")
    from portbench.reference.step import (fk_interp_plain as fk_interp,
                                          fk_step_plain, pack_consts,
                                          pack_points)

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
    wx0, wy0 = _world_xy(c, state18)
    sxy0, patch0 = _extract_windows(z_grid, friction, wx0, wy0, d_max, res)
    z0 = fk_interp(patch0, wx0.contiguous(), wy0.contiguous(), sxy0,
                   c.cst)[:, :wx0.shape[1]]
    state18 = state18.clone()
    state18[:, 2] = z0.sum(dim=1) / wx0.shape[1]

    if mode in ("pair_zu", "pair3_zu"):
        fmt = "zu"

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_zpair(z_grid, wx, wy, d_max, res,
                                          dqx, dqy)
    elif mode == "pair3_muq":
        fmt = "muq"
        mu_q = quantize_mu_grid(friction)

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_zmuq(z_grid, mu_q, wx, wy, d_max, res,
                                         dqx, dqy)
    else:
        # "pair": bf16 z taps, nearest-cell friction; "packed": bilinear
        # friction, divide and two-pass std (ones when friction is None)
        fmt = "pairmu" if mode == "pair" else "packed"

        def extract(wx, wy, dqx, dqy):
            return _extract_windows_packed1(z_grid, friction, wx, wy, d_max,
                                            res, dqx, dqy)

    dt = robot.dt
    tv_t = track_vels.to(dev, torch.float32).transpose(0, 1).contiguous()
    n_total = tv_t.shape[0]
    states, accs = [], []
    for start in range(0, n_total, _REFRESH_PRED):
        n_blk = min(_REFRESH_PRED, n_total - start)
        # windows over the footprint now and at the velocity-predicted end
        # of the block (the remainder block predicts over its own length)
        t_blk = n_blk * dt
        wx, wy = _world_xy(c, state18)
        sxy, patch = extract(wx, wy, state18[:, 3:4] * t_blk,
                             state18[:, 4:5] * t_blk)
        for k in range(start, start + n_blk):
            acc8 = fk_step_plain(fmt, cst, patch, state18, tv_t[k], sxy, pts)
            state18 = _integrate(state18, acc8, dt)
            if state_round is not None:
                state18 = state18.to(state_round).to(torch.float32)
            states.append(state18)
            accs.append(acc8)

    seq = torch.stack(states, dim=1)                           # (B, N, 18)
    xs = seq[..., 0:3]
    Rs = seq[..., 6:15].reshape(seq.shape[:2] + (3, 3))
    delta_h = robot.mass * robot.gravity / (robot.stiffness + 1e-6)
    xs = xs + Rs[..., :, 2] * delta_h
    out = RigidState(xs, seq[..., 3:6], Rs, seq[..., 15:18])

    stats = None
    if with_stats:
        roll = torch.atan2(Rs[..., 2, 1], Rs[..., 2, 2])
        pitch = torch.atan2(-Rs[..., 2, 0],
                            torch.sqrt(Rs[..., 2, 1] ** 2 + Rs[..., 2, 2] ** 2))
        spring_std = torch.stack([a[:, 6] for a in accs], dim=1)
        stats = StepStats(spring_std, roll.abs(), pitch.abs())
    return out, stats
