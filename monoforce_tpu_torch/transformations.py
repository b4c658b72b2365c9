"""SE(3) helpers of the PyTorch port.

Port of ``monoforce_tpu/transformations.py`` (whole module); reference
parity: monoforce/src/monoforce/transformations.py -- cloud transforms,
xyz+rpy <-> matrix conversions, pose -> xyz+quaternion.  Each function
computes on its input's device; Python numbers and numpy arrays become
float32 tensors on the CPU, as ``jnp.asarray`` makes float32 arrays.
"""

from __future__ import annotations

import torch

__all__ = [
    "transform_cloud", "xyz_rpy_to_matrix", "rot2rpy", "rpy2rot",
    "pose_to_xyz_q", "quat_to_rot", "rot_to_quat",
]


def _f32(a) -> torch.Tensor:
    """A tensor stays as it is; anything else becomes a float32 tensor."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        a, dtype=torch.float32)


def transform_cloud(cloud, Tr):
    """(N, 3) points through a (4, 4) homogeneous transform."""
    cloud, Tr = _f32(cloud), _f32(Tr)
    return cloud @ Tr[:3, :3].T + Tr[:3, 3]


def rot2rpy(R):
    """Rotation matrix (..., 3, 3) -> (roll, pitch, yaw)."""
    R = _f32(R)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.atan2(-R[..., 2, 0],
                        torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def rpy2rot(roll, pitch, yaw):
    """Euler xyz angles -> rotation matrix R = Rz @ Ry @ Rx."""
    roll, pitch, yaw = (_f32(a) for a in (roll, pitch, yaw))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def xyz_rpy_to_matrix(xyz_rpy):
    """(6,) [x y z roll pitch yaw] -> (4, 4)."""
    xyz_rpy = _f32(xyz_rpy)
    dtype = torch.promote_types(xyz_rpy.dtype, torch.float32)
    T = torch.eye(4, dtype=dtype, device=xyz_rpy.device)
    T[:3, :3] = rpy2rot(xyz_rpy[3], xyz_rpy[4], xyz_rpy[5])
    T[:3, 3] = xyz_rpy[:3]
    return T


def rot_to_quat(R):
    """(3, 3) rotation -> (x, y, z, w) quaternion (scipy convention),
    numerically-stable branch-free (Shepperd via elementwise selects).
    ``torch.copysign`` takes the sign of +0.0 as ``jnp.copysign`` does."""
    R = _f32(R)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions
    qw = torch.sqrt(torch.clamp(1 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2
    qx = torch.copysign(qx, R[2, 1] - R[1, 2])
    qy = torch.copysign(qy, R[0, 2] - R[2, 0])
    qz = torch.copysign(qz, R[1, 0] - R[0, 1])
    q = torch.stack([qx, qy, qz, qw])
    return q / torch.linalg.vector_norm(q)


def quat_to_rot(q):
    """(x, y, z, w) quaternion -> (3, 3) rotation; the zero quaternion gives
    the identity (the ``n > 0`` guard)."""
    q = _f32(q)
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy]),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx]),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)]),
    ])


def pose_to_xyz_q(pose):
    """(4, 4) pose -> (7,) [xyz, quat_xyzw]."""
    pose = _f32(pose)
    return torch.cat([pose[:3, 3], rot_to_quat(pose[:3, :3])])
