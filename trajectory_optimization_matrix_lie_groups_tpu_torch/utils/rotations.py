"""Rotation-representation conversions (counterpart of the JAX
`utils/rotations.py`).

Replaces the conversion helpers of `traoptlibrary/traopt_utilis.py`
(`quat2rotm:159`, `rotm2quat:167`, `quat2euler:163`, `rotm2euler:183`,
`euler2quat:209`, `SE32quatpos:299`, `quatpos2SE3:252`, `SE32absangle:94`,
`rotm2absangle:121`).  Quaternions are scalar-first [qw, qx, qy, qz], like
the reference's artifact format.  Every function broadcasts over leading
batch dims and runs on its input's device.
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3

quat_to_matrix = so3.matrix_from_quat
matrix_to_quat = so3.quat_from_matrix
quatpos_to_se3 = se3.matrix_from_quatpos
se3_to_quatpos = se3.quatpos_from_matrix


def euler_zyx_to_quat(rpy):
    """[roll, pitch, yaw] (radians, intrinsic ZYX / yaw-pitch-roll) -> quat.

    Matches the reference's `euler2quat` convention (traopt_utilis.py:209-250).
    """
    rpy = torch.as_tensor(rpy)
    r, p, y = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def matrix_to_euler_zyx(R):
    """Rotation matrix -> [roll, pitch, yaw] (radians, intrinsic ZYX)."""
    R = torch.as_tensor(R)
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def rotation_angle(R):
    """Geodesic rotation angle (radians) of a rotation matrix.

    Numerically stable version of the reference's `rotm2absangle`
    (arccos of the trace, traopt_utilis.py:121-138) via the quaternion.
    """
    q = so3.quat_from_matrix(torch.as_tensor(R))
    nv = torch.linalg.norm(q[..., 1:], dim=-1)
    return 2.0 * torch.arctan2(nv, q[..., 0])


def se3_rotation_angle(T):
    """Rotation angle of the SO(3) block of an SE(3) matrix (`SE32absangle`)."""
    return rotation_angle(torch.as_tensor(T)[..., :3, :3])
