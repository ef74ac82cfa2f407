"""Batched closed-form SE(3) operations, twist order ``[omega, v]``
(counterpart of the JAX `ops/se3.py`).

Group elements are (..., 4, 4) homogeneous matrices.  All functions
broadcast over leading batch dimensions, with Taylor-guarded small-angle
branches.
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import so3

_EPS = 1e-8


def hat(xi):
    """(..., 6) [w, v] -> (..., 4, 4) se(3) matrix."""
    top = torch.cat([so3.hat(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def vee(M):
    """(..., 4, 4) -> (..., 6) [w, v]."""
    return torch.cat([so3.vee(M[..., :3, :3]), M[..., :3, 3]], dim=-1)


def _blk2(A, B, C, D):
    return torch.cat([torch.cat([A, B], dim=-1), torch.cat([C, D], dim=-1)],
                     dim=-2)


def ad(xi):
    """Small adjoint [[W, 0], [V, W]] in [w, v] order."""
    W = so3.hat(xi[..., :3])
    V = so3.hat(xi[..., 3:])
    return _blk2(W, torch.zeros_like(W), V, W)


def coad(xi):
    """Coadjoint ad(xi)^T."""
    return ad(xi).transpose(-1, -2)


def exp(xi):
    """Exponential map (..., 6) -> (..., 4, 4); translation V(w) = Jl_so3(w)."""
    w = xi[..., :3]
    R = so3.exp(w)
    p = (so3.left_jacobian(w) @ xi[..., 3:, None])[..., 0]
    return from_rotation_translation(R, p)


def log(T):
    """Logarithm map (..., 4, 4) -> (..., 6), robust near 0 and pi."""
    w = so3.log(T[..., :3, :3])
    v = (so3.left_jacobian_inv(w) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([w, v], dim=-1)


def from_rotation_translation(R, p):
    top = torch.cat([R, p[..., :, None]], dim=-1)
    bot = torch.cat([torch.zeros_like(p), torch.ones_like(p[..., :1])], dim=-1)
    return torch.cat([top, bot[..., None, :]], dim=-2)


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def inverse(T):
    """[[R^T, -R^T p], [0, 1]]."""
    Rt = rotation(T).transpose(-1, -2)
    return from_rotation_translation(Rt, -(Rt @ translation(T)[..., :, None])[..., 0])


def compose(T1, T2):
    return T1 @ T2


def Ad(T):
    """Group adjoint in [w, v] order: [[R, 0], [hat(p) R, R]]."""
    R = rotation(T)
    return _blk2(R, torch.zeros_like(R), so3.hat(translation(T)) @ R, R)


def _Q_matrix(w, v):
    """Barfoot's Q(w, v) block of the SE(3) left Jacobian (Taylor-guarded),
    "State Estimation for Robotics", eq. (7.86)."""
    th_sq = torch.sum(w * w, dim=-1)
    small = th_sq < _EPS
    th_sq_safe = torch.where(small, torch.ones_like(th_sq), th_sq)
    th = torch.sqrt(th_sq_safe)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    c1 = torch.where(small, 1.0 / 6.0 - th_sq / 120.0,
                     (th - sin_t) / (th_sq_safe * th))
    c2 = torch.where(small, 1.0 / 24.0 - th_sq / 720.0,
                     (th_sq_safe + 2.0 * cos_t - 2.0) / (2.0 * th_sq_safe * th_sq_safe))
    c3 = torch.where(small, 1.0 / 120.0 - th_sq / 2520.0,
                     (2.0 * th - 3.0 * sin_t + th * cos_t)
                     / (2.0 * th_sq_safe * th_sq_safe * th))
    W = so3.hat(w)
    V = so3.hat(v)
    WV = W @ V
    VW = V @ W
    WVW = WV @ W
    e = lambda c: c[..., None, None]
    return (0.5 * V + e(c1) * (WV + VW + WVW)
            + e(c2) * (W @ WV + VW @ W - 3.0 * WVW)
            + e(c3) * (WVW @ W + W @ WVW))


def left_jacobian(xi):
    """SE(3) left Jacobian in [w, v] order: [[Jl, 0], [Q, Jl]]."""
    Jw = so3.left_jacobian(xi[..., :3])
    return _blk2(Jw, torch.zeros_like(Jw), _Q_matrix(xi[..., :3], xi[..., 3:]), Jw)


def right_jacobian(xi):
    """Jr(xi) = Jl(-xi)."""
    return left_jacobian(-xi)


def left_jacobian_inv(xi):
    """[[Jl^-1, 0], [-Jl^-1 Q Jl^-1, Jl^-1]]."""
    Jw_inv = so3.left_jacobian_inv(xi[..., :3])
    Q = _Q_matrix(xi[..., :3], xi[..., 3:])
    return _blk2(Jw_inv, torch.zeros_like(Jw_inv), -(Jw_inv @ Q @ Jw_inv), Jw_inv)


def right_jacobian_inv(xi):
    """Jr^-1(xi) = Jl^-1(-xi)."""
    return left_jacobian_inv(-xi)


def rplus(T, xi):
    """T Exp(xi)."""
    return T @ exp(xi)


def rminus(X, Y):
    """Log(Y^-1 X)."""
    return log(inverse(Y) @ X)


def lminus(X, Y):
    """Log(X Y^-1)."""
    return log(X @ inverse(Y))


def quatpos_from_matrix(T):
    """(..., 4, 4) -> (..., 7) [qw, qx, qy, qz, px, py, pz]."""
    return torch.cat([so3.quat_from_matrix(rotation(T)), translation(T)], dim=-1)


def matrix_from_quatpos(x7):
    """(..., 7) [qw, qx, qy, qz, p] -> (..., 4, 4)."""
    return from_rotation_translation(so3.matrix_from_quat(x7[..., :4]), x7[..., 4:])


def normalize(T):
    """Re-orthonormalize the rotation block (quaternion round-trip)."""
    return from_rotation_translation(so3.normalize(rotation(T)), translation(T))
