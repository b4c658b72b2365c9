"""Rigid-body state and robot parameters of the PyTorch port.

Port of ``monoforce_tpu/physics/engine.py``: ``RigidState`` (:64-70),
``RobotModel.from_config`` (:82-133), ``inertia_tensor`` (:136-152),
``auto_remat_segment`` (:483-494), ``_default_state0`` (:497-505), and the
exact engine: ``skew`` (:155), ``integrate_rotation`` (:165),
``integration_step`` (:177), ``update_joints`` (:191),
``forward_kinematics`` (:213-288), ``_update_state`` (:291), the BPTT
gradient clip (:302-320), ``rollout`` (:322-393, :508-547),
``rollout_odeint`` (:395-480) and ``DPhysics`` (:550-597).

``RobotModel`` holds the robot's parameter set as float32 tensors on one
device; scalars are 0-d tensors so that the port's arithmetic runs in
float32 like the reference's.  It has no learned weights: the robot model
is the whole parameter set of the planner path.

The exact engine is the JAX one written for a leading batch axis B (the
JAX package writes one trajectory and vmaps it): each step is a few dozen
(B, P) tensor operations, and time is a Python loop over the steps.  It is
plain PyTorch on every device; its terrain lookup is four index gathers
(``physics/terrain.py``), like the JAX engine's four XLA gathers.  Remat
segments are ``torch.utils.checkpoint`` (non-reentrant), the BPTT clip a
``torch.autograd.Function``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from monoforce_tpu_torch.physics.terrain import interpolate_grid, normalized

__all__ = ["RigidState", "RobotModel", "DPhysics", "rollout",
           "rollout_single", "rollout_odeint", "inertia_tensor",
           "integrate_rotation", "forward_kinematics", "on_device",
           "resolve_device", "auto_remat_segment"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  A CUDA device without a visible card raises here rather than
    letting the caller carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return device


def on_device(x, device: torch.device, name: str) -> torch.Tensor:
    """``x`` as float32 on ``device``.  Arrays and lists are copied there;
    a tensor already on another device raises instead of being moved, so
    an entry point never carries on quietly on a device it was not given."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"{name} is on {x.device}, the robot on {device}")
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class RigidState(NamedTuple):
    """State of the rigid body: position, velocity, rotation, angular rate."""

    x: torch.Tensor      # (..., 3)
    xd: torch.Tensor     # (..., 3)
    R: torch.Tensor      # (..., 3, 3)
    omega: torch.Tensor  # (..., 3)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Device-side robot + terrain-interaction parameters (float32).

    ``n_tracks`` / ``has_flippers`` / ``integration_mode`` are the static
    fields that select code paths; every other field is a tensor.
    """

    points: torch.Tensor            # (P, 3) body-frame contact points
    driving_masks: torch.Tensor     # (K, P) 0/1 disjoint driving parts
    mass: torch.Tensor              # ()
    inertia_inv: torch.Tensor       # (3, 3) inverse inertia of the points
    joint_positions: torch.Tensor   # (4, 3) flipper joint positions (marv)
    robot_size: torch.Tensor        # (2,) (s_x, s_y)
    gravity: torch.Tensor           # ()
    gravity_direction: torch.Tensor  # (3,)
    stiffness: torch.Tensor         # () N/m
    damping: torch.Tensor           # () N s/m
    omega_max: torch.Tensor         # () clamp for angular acceleration
    d_max: torch.Tensor             # () heightmap half-extent
    grid_res: torch.Tensor          # () heightmap cell size
    dt: torch.Tensor                # () integration step
    n_tracks: int = 2
    has_flippers: bool = False
    integration_mode: str = "euler"

    @property
    def device(self) -> torch.device:
        return self.points.device

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "RobotModel":
        device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32).to(device)

        # the inverse is taken on the CPU so that every device gets the same
        # float32 parameters
        pts = torch.as_tensor(cfg.robot_points, dtype=torch.float32)
        inertia_inv = torch.linalg.inv(inertia_tensor(cfg.robot_mass, pts))
        return cls(
            points=pts.to(device),
            driving_masks=f32(cfg.driving_parts.astype("float32")),
            mass=f32(cfg.robot_mass),
            inertia_inv=inertia_inv.to(device),
            joint_positions=f32(
                [cfg.joint_positions[k] for k in ("fl", "fr", "rl", "rr")]),
            robot_size=f32(cfg.robot_size),
            gravity=f32(cfg.gravity),
            gravity_direction=f32(cfg.gravity_direction),
            stiffness=f32(cfg.stiffness),
            damping=f32(cfg.damping),
            omega_max=f32(cfg.omega_max),
            d_max=f32(cfg.d_max),
            grid_res=f32(cfg.grid_res),
            dt=f32(cfg.dt),
            n_tracks=int(cfg.driving_parts.shape[0]),
            has_flippers=("marv" in cfg.robot),
            integration_mode=cfg.integration_mode,
        )


def inertia_tensor(mass, points: torch.Tensor) -> torch.Tensor:
    """Inertia tensor of equal point masses (reference: dphysics.py:107-141).

    points: (..., P, 3) -> (..., 3, 3).
    """
    m_pt = mass / points.shape[-2]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ixx = torch.sum(m_pt * (y ** 2 + z ** 2), dim=-1)
    iyy = torch.sum(m_pt * (x ** 2 + z ** 2), dim=-1)
    izz = torch.sum(m_pt * (x ** 2 + y ** 2), dim=-1)
    ixy = -torch.sum(m_pt * x * y, dim=-1)
    ixz = -torch.sum(m_pt * x * z, dim=-1)
    iyz = -torch.sum(m_pt * y * z, dim=-1)
    return torch.stack([torch.stack([ixx, ixy, ixz], dim=-1),
                        torch.stack([ixy, iyy, iyz], dim=-1),
                        torch.stack([ixz, iyz, izz], dim=-1)], dim=-2)


def auto_remat_segment(n: int, threshold: int = 64) -> Optional[int]:
    """Pick a remat segment length for an N-step BPTT horizon: the divisor of
    N closest to sqrt(N) (minimizing stored-boundaries + recompute-window
    memory).  Returns None for short horizons where remat only adds
    recompute."""
    if n < threshold:
        return None
    target = max(1, int(round(n ** 0.5)))
    divisors = [k for k in range(2, n) if n % k == 0]
    if not divisors:
        return None
    return min(divisors, key=lambda k: abs(k - target))


def _default_state0(controls: torch.Tensor) -> RigidState:
    """Reference default initial state (dphysics.py:554-559): at the origin,
    moving with the first commanded (v, w)."""
    B = controls.shape[0]
    kw = dict(dtype=controls.dtype, device=controls.device)
    x = torch.zeros((B, 3), **kw)
    xd = torch.zeros((B, 3), **kw)
    xd[:, 0] = controls[:, 0, 0]
    R = torch.eye(3, **kw).expand(B, 3, 3)
    omega = torch.zeros((B, 3), **kw)
    omega[:, 2] = controls[:, 0, 1]
    return RigidState(x, xd, R, omega)


# ------------------------------------------------------------ exact engine


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: (..., 3) -> (..., 3, 3)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def integrate_rotation(R, omega, dt, eps: float = 1e-6):
    """Rodrigues update R <- R expm([omega]_x dt) (reference:
    dphysics.py:290-324).  R (..., 3, 3), omega (..., 3)."""
    omega_x = skew(omega)
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)[..., None]
    omega_n = omega_x / torch.clamp(theta, min=eps)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    rot = (eye
           + omega_n * torch.sin(theta * dt)
           + torch.matmul(omega_n, omega_n) * (1.0 - torch.cos(theta * dt)))
    return torch.matmul(R, rot)


def integration_step(x, xd, dt, mode: str = "euler"):
    """Explicit integration step (reference: dphysics.py:360-383)."""
    if mode == "euler":
        return x + xd * dt
    if mode == "rk4":
        # the reference's formula, verbatim (dphysics.py:375-380)
        k1 = dt * xd
        k2 = dt * (xd + k1 / 2)
        k3 = dt * (xd + k2 / 2)
        k4 = dt * (xd + k3)
        return x + (k1 + 2 * k2 + 2 * k3 + k4) / 6
    raise ValueError(f"Unknown integration mode: {mode}")


def update_joints(robot: RobotModel, joint_angles):
    """Rotate the flipper point groups about the y-axis at their joints
    (reference: dphysics.py:326-358).  joint_angles (B, 4) -> points
    (B, P, 3); the robot's own (P, 3) points without flippers.  Each of the
    four rotations is applied through its driving mask, as in the JAX
    engine (a zero angle rotates exactly)."""
    pts = robot.points
    if not robot.has_flippers:
        return pts
    pts = pts.expand(joint_angles.shape[:-1] + pts.shape)
    for i in range(4):
        a = joint_angles[..., i]
        c, s = torch.cos(a), torch.sin(a)
        zero, one = torch.zeros_like(a), torch.ones_like(a)
        rot = torch.stack([c, zero, s, zero, one, zero, -s, zero, c],
                          dim=-1).unflatten(-1, (3, 3))
        jp = robot.joint_positions[i]
        rotated = torch.matmul(pts - jp, rot.transpose(-1, -2)) + jp
        mask = robot.driving_masks[i][:, None]
        pts = mask * rotated + (1.0 - mask) * pts
    return pts


def forward_kinematics(robot: RobotModel, z_grid, friction,
                       state: RigidState, control, joint_angles):
    """Net forces and the state derivative of B trajectories at one instant
    (reference: dphysics.py:172-272).

    Args:
      z_grid, friction: (B, H, W) terrain grids, one per trajectory.
      state: RigidState with (B, 3) and (B, 3, 3) leaves.
      control: (B, 2) commanded (v, w).
      joint_angles: (B, 4) flipper angles (used by robots with flippers).

    Returns ((xd, xdd, omega_d), (F_spring, F_friction)), forces (B, P, 3).
    """
    from monoforce_tpu_torch.physics.controls import vw_to_track_vels

    x, xd, R, omega = state
    m, g = robot.mass, robot.gravity

    # body points of this step (and the inertia, if the body articulates)
    if robot.has_flippers:
        pts_body = update_joints(robot, joint_angles)
        inertia_inv = torch.linalg.inv(inertia_tensor(m, pts_body))
    else:
        pts_body = robot.points
        inertia_inv = robot.inertia_inv

    # world-frame points and their velocities (Koenig)
    pts = torch.matmul(pts_body, R.transpose(-1, -2)) + x[:, None]
    r = pts - x[:, None]
    xd_pts = xd[:, None] + torch.linalg.cross(omega[:, None].expand_as(r), r)

    # terrain lookup
    z, n = interpolate_grid(z_grid, pts[..., 0], pts[..., 1], robot.d_max,
                            robot.grid_res, return_normals=True)
    mu = interpolate_grid(friction, pts[..., 0], pts[..., 1], robot.d_max,
                          robot.grid_res)

    # soft contact and spring-damper reaction (dphysics.py:220-234)
    dh = pts[..., 2] - z
    in_contact = torch.sigmoid(-10.0 * dh)
    vn = torch.sum(xd_pts * n, dim=-1)
    f_spring = -(robot.stiffness * dh + robot.damping * vn)[..., None] * n
    n_contacts = torch.sum(in_contact, dim=-1)
    # the reference divides unguarded (dphysics.py:231-232) and NaNs once
    # every point is ~9 m above the terrain; as in the JAX engine, the
    # denominator is replaced only where the contact sum is exactly zero
    f_spring = (f_spring * in_contact[..., None]
                / torch.where(n_contacts > 0, n_contacts, 1.0)[:, None, None])
    f_spring = torch.clamp(f_spring, -m * g, m * g)

    # velocity-based Coulomb-style friction (dphysics.py:236-252)
    thrust_dir = normalized(R[..., :, 0])
    normal_mag = torch.linalg.vector_norm(f_spring, dim=-1)
    track_vels = vw_to_track_vels(control[:, 0], control[:, 1],
                                  robot.robot_size, robot.n_tracks)
    cmd_scale = torch.matmul(track_vels, robot.driving_masks)   # (B, P)
    cmd_vels = cmd_scale[..., None] * thrust_dir[:, None]
    slip = mu[..., None] * (cmd_vels - xd_pts)
    slip_n = torch.sum(slip * n, dim=-1, keepdim=True) * n
    slip_tau = slip - slip_n
    f_friction = normal_mag[..., None] * slip_tau
    f_friction = torch.clamp(f_friction, -m * g, m * g)

    # torques and accelerations (dphysics.py:254-267)
    torque = torch.sum(torch.linalg.cross(r, f_spring + f_friction), dim=1)
    omega_d = torch.matmul(inertia_inv, torque[..., None])[..., 0]
    omega_d = torch.clamp(omega_d, -robot.omega_max, robot.omega_max)
    f_total = (m * g * robot.gravity_direction
               + torch.sum(f_spring, dim=1) + torch.sum(f_friction, dim=1))
    xdd = f_total / m

    return (xd, xdd, omega_d), (f_spring, f_friction)


def _update_state(robot: RobotModel, state: RigidState, dstate) -> RigidState:
    """Semi-implicit integration step (reference: dphysics.py:274-288):
    the velocity first, the position with the new velocity, Rodrigues with
    the new omega."""
    _, xdd, omega_d = dstate
    mode, dt = robot.integration_mode, robot.dt
    xd = integration_step(state.xd, xdd, dt, mode)
    x = integration_step(state.x, xd, dt, mode)
    omega = integration_step(state.omega, omega_d, dt, mode)
    R = integrate_rotation(state.R, omega, dt)
    return RigidState(x, xd, R, omega)


class _IdentityClipGrad(torch.autograd.Function):
    """Identity in the forward pass; the cotangent of each input clamped
    elementwise to [-limit, limit] in the backward pass.  Applied to the
    state at every step, it keeps BPTT through the stiff contact dynamics
    from overflowing float32 (the reference instead crashes on NaN losses,
    train.py:161-163)."""

    @staticmethod
    def forward(ctx, limit, *tensors):
        ctx.limit = limit
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(
            None if g is None else torch.clamp(g, -ctx.limit, ctx.limit)
            for g in grads)


def _identity_clip_grad(limit: float, state: RigidState) -> RigidState:
    return RigidState(*_IdentityClipGrad.apply(limit, *state))


def _stack_time(items):
    """Per-step outputs (tensors, or tuples and dicts of them) stacked
    along a new time axis 1."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items, dim=1)
    if isinstance(first, dict):
        return {k: _stack_time([it[k] for it in items]) for k in first}
    parts = [_stack_time(list(p)) for p in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)


def _settle(robot: RobotModel, z_grid, state0: RigidState) -> RigidState:
    """Place the body at the mean terrain height under its (unarticulated)
    points (dphysics.py:566-571)."""
    pts0 = torch.matmul(robot.points, state0.R.transpose(-1, -2)) + state0.x[:, None]
    z0 = interpolate_grid(z_grid, pts0[..., 0], pts0[..., 1], robot.d_max,
                          robot.grid_res).mean(dim=-1)
    return state0._replace(x=torch.cat([state0.x[:, :2], z0[:, None]], dim=1))


def _equilibrium_offset(robot: RobotModel, states: RigidState) -> RigidState:
    """Sink-in compensation along the body z-axis (dphysics.py:586-589)."""
    delta_h = robot.mass * robot.gravity / (robot.stiffness + 1e-6)
    return states._replace(x=states.x + states.R[..., :, 2] * delta_h)


def _rollout(robot, z_grid, friction, controls, joint_angles, state0,
             return_forces, extras_fn, bptt_grad_clip, remat_segment):
    """The batched semi-implicit rollout on inputs already on the device."""
    state0 = _settle(robot, z_grid, state0)

    def steps(state, start, stop):
        outs = []
        for k in range(start, stop):
            if bptt_grad_clip is not None:
                state = _identity_clip_grad(bptt_grad_clip, state)
            dstate, forces = forward_kinematics(
                robot, z_grid, friction, state, controls[:, k],
                joint_angles[:, k])
            state = _update_state(robot, state, dstate)
            out = [state]
            if return_forces:
                out.append(forces)
            if extras_fn is not None:
                out.append(extras_fn(state, forces))
            outs.append(tuple(out))
        return state, outs

    n = controls.shape[1]
    if remat_segment is not None and remat_segment > 1:
        K = int(remat_segment)
        if n % K != 0:
            raise ValueError(
                f"remat_segment={K} must divide the horizon N={n}")
        # BPTT stores only the segment-boundary states and recomputes each
        # segment's steps in the backward pass: O(N/K + K) live memory
        state, outs = state0, []
        for start in range(0, n, K):
            state, seg = checkpoint(steps, state, start, start + K,
                                    use_reentrant=False)
            outs += seg
    else:
        _, outs = steps(state0, 0, n)

    stacked = _stack_time(outs)
    states = _equilibrium_offset(robot, stacked[0])
    idx = 1
    forces = None
    if return_forces:
        forces = stacked[idx]
        idx += 1
    extras = stacked[idx] if extras_fn is not None else None
    return states, forces, extras


def _inputs(robot, z_grid, controls, joint_angles, state0, friction):
    """rollout's inputs as float32 on the robot's device, with the JAX
    engine's defaults: no joint angles, unit friction, the reference's
    initial state."""
    dev = robot.device
    controls = on_device(controls, dev, "controls")
    z_grid = on_device(z_grid, dev, "z_grid")
    B, N = controls.shape[0], controls.shape[1]
    joint_angles = (torch.zeros((B, N, 4), device=dev) if joint_angles is None
                    else on_device(joint_angles, dev, "joint_angles"))
    friction = (torch.ones_like(z_grid) if friction is None
                else on_device(friction, dev, "friction"))
    if state0 is None:
        state0 = _default_state0(controls)
    else:
        state0 = RigidState(*(on_device(v, dev, f"state0.{k}")
                              for k, v in state0._asdict().items()))
    return z_grid, controls, joint_angles, state0, friction


def rollout(robot: RobotModel, z_grid, controls, joint_angles=None,
            state0: Optional[RigidState] = None, friction=None,
            return_forces: bool = True, extras_fn: Optional[Callable] = None,
            bptt_grad_clip: Optional[float] = None,
            remat_segment: Optional[int] = None):
    """Batched differentiable rollout (the reference ``DPhysics.forward``),
    on ``robot``'s device.

    Args:
      robot: RobotModel.
      z_grid: (B, H, W) heightmaps, one per trajectory (an expanded view of
        one shared grid costs no copy).
      controls: (B, N, 2) commanded (v, w) per step.
      joint_angles: (B, N, 4) flipper angles; zeros if None.
      state0: RigidState with (B, ...) leaves; the reference default if None.
      friction: (B, H, W) friction grids; ones if None.
      return_forces: stack the per-step (F_spring, F_friction), (B, N, P, 3)
        each.
      extras_fn: optional per-step ``f(state, (F_s, F_f))`` returning a
        tensor or a tuple or dict of them, stacked over the steps.
      bptt_grad_clip: clamp the cotangent of the state at every step to
        this bound (the forward values are untouched).
      remat_segment: K; every K steps run under ``torch.utils.checkpoint``,
        so BPTT keeps only the segment boundaries.  K must divide N.

    Returns (RigidState with (B, N, ...) leaves, forces or None, extras or
    None).  States are recorded after each update, forces at the state
    before it (dphysics.py:467-497).
    """
    z_grid, controls, joint_angles, state0, friction = _inputs(
        robot, z_grid, controls, joint_angles, state0, friction)
    return _rollout(robot, z_grid, friction, controls, joint_angles, state0,
                    return_forces, extras_fn, bptt_grad_clip, remat_segment)


def rollout_single(robot: RobotModel, z_grid, friction, controls,
                   joint_angles, state0: RigidState, return_forces: bool = True,
                   extras_fn: Optional[Callable] = None,
                   bptt_grad_clip: Optional[float] = None,
                   remat_segment: Optional[int] = None):
    """Roll ONE trajectory: (H, W) grids, (N, 2) controls, (N, 4) joint
    angles, a state with unbatched leaves; :func:`rollout` on a batch of
    one.  Returns (states with (N, ...) leaves, forces | None, extras |
    None)."""
    def one(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return t[0]
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        parts = [one(v) for v in t]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)

    state0 = RigidState(*(torch.as_tensor(v)[None] for v in state0))
    states, forces, extras = rollout(
        robot, torch.as_tensor(z_grid)[None], torch.as_tensor(controls)[None],
        torch.as_tensor(joint_angles)[None], state0,
        torch.as_tensor(friction)[None], return_forces, extras_fn,
        bptt_grad_clip, remat_segment)
    return one(states), one(forces), one(extras)


def rollout_odeint(robot: RobotModel, z_grid, controls, joint_angles=None,
                   state0: Optional[RigidState] = None, friction=None,
                   dt=None):
    """Batched rollout with the reference's DEFAULT integrator
    (``use_odeint=True``, dphys_config.py:153): ``torchdiffeq.odeint(
    method='euler')`` over the extended state (dphysics.py:499-528,
    191-196), fully explicit, unlike :func:`rollout`'s semi-implicit
    update.  Kept as the reference has it:

    - output row 0 is the settled initial state; N-1 steps give rows 1..N-1,
    - the step is ``dt`` (``T/(int(T/dt)-1)`` from the reference's linspace,
      which ``DPhysics`` passes; ``robot.dt`` if None),
    - the rotation integrates linearly, ``R += dt [omega]_x R`` (no
      re-orthonormalization),
    - the force slots are integrated from zero: the returned forces are
      running time integrals (impulses),
    - the control at grid time ``ts[k]`` is the k-th (dphysics.py:183).

    Returns (states with (B, N, ...) leaves, (F_spring_int, F_friction_int)).
    """
    z_grid, controls, joint_angles, state0, friction = _inputs(
        robot, z_grid, controls, joint_angles, state0, friction)
    if dt is None:
        dt = robot.dt
    state0 = _settle(robot, z_grid, state0)
    f_zero = torch.zeros(state0.x.shape[:1] + robot.points.shape,
                         device=robot.device)
    y = (state0.x, state0.xd, state0.R, state0.omega, f_zero, f_zero)
    rows = [y]
    for k in range(controls.shape[1] - 1):
        x, xd, R, omega, fs_acc, ff_acc = y
        (dx, xdd, omega_d), (f_spring, f_friction) = forward_kinematics(
            robot, z_grid, friction, RigidState(x, xd, R, omega),
            controls[:, k], joint_angles[:, k])
        dR = torch.matmul(skew(omega), R)
        y = (x + dt * dx, xd + dt * xdd, R + dt * dR, omega + dt * omega_d,
             fs_acc + dt * f_spring, ff_acc + dt * f_friction)
        rows.append(y)
    out = [torch.stack(p, dim=1) for p in zip(*rows)]
    states = _equilibrium_offset(robot, RigidState(*out[:4]))
    return states, (out[4], out[5])


class DPhysics:
    """Convenience wrapper with the reference call signature (reference:
    dphysics.py:596-605), on ``cuda`` unless the caller names another
    device.

    >>> engine = DPhysics(PhysicsConfig(robot="tradr"))
    >>> states, forces = engine(z_grid, controls)
    """

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.robot = RobotModel.from_config(cfg, device=device)

    def __call__(self, z_grid, controls, joint_angles=None, state=None,
                 friction=None, return_forces: bool = True, extras_fn=None):
        n_ts = min(self.cfg.n_sim_steps, controls.shape[1])
        controls = controls[:, :n_ts]
        if joint_angles is not None:
            joint_angles = joint_angles[:, :n_ts]
        state0 = RigidState(*state) if state is not None else None
        if getattr(self.cfg, "use_odeint", False):
            # the reference's default integrator, with the step of its
            # linspace grid of int(T/dt) points over [0, T]; its forces are
            # time integrals, and it has no per-step tap (dphysics.py:499-528)
            if extras_fn is not None:
                raise ValueError(
                    "extras_fn is not supported with use_odeint=True: the "
                    "reference's odeint integrator exposes no per-step tap "
                    "(dphysics.py:499-528); set cfg.use_odeint=False")
            n_full = self.cfg.n_sim_steps
            dt_eff = self.cfg.traj_sim_time / max(n_full - 1, 1)
            states, forces = rollout_odeint(
                self.robot, z_grid, controls, joint_angles=joint_angles,
                state0=state0, friction=friction, dt=dt_eff)
            if not return_forces:
                return states, None
            return states, forces
        states, forces, extras = rollout(
            self.robot, z_grid, controls, joint_angles=joint_angles,
            state0=state0, friction=friction,
            return_forces=return_forces, extras_fn=extras_fn)
        if extras_fn is not None:
            return states, forces, extras
        return states, forces
