"""Batched closed-form SO(3) operations (counterpart of the JAX `ops/so3.py`).

Exp/log, left/right Jacobians and their inverses as plain torch functions
that broadcast over leading batch dimensions.  Every trigonometric
coefficient has a Taylor-guarded small-angle branch (`torch.where` on a safe
argument), and `log` goes through a Shepperd quaternion extraction so it
stays accurate for rotations arbitrarily close to pi.
"""

import torch

# Small-angle switch point: below this squared angle the Taylor expansions are
# more accurate than the closed forms in either f32 or f64.
_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([z, -w2, w1], dim=-1),
        torch.stack([w2, z, -w0], dim=-1),
        torch.stack([-w1, w0, z], dim=-1),
    ], dim=-2)


def vee(W):
    """(..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_sq(w):
    return torch.sum(w * w, dim=-1)


def _sinc_coeffs(th_sq):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with Taylor guards."""
    small = th_sq < _EPS
    th_sq_safe = torch.where(small, torch.ones_like(th_sq), th_sq)
    th = torch.sqrt(th_sq_safe)
    a = torch.where(small, 1.0 - th_sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th_sq / 24.0, (1.0 - torch.cos(th)) / th_sq_safe)
    c = torch.where(small, 1.0 / 6.0 - th_sq / 120.0,
                    (th - torch.sin(th)) / (th_sq_safe * th))
    return a, b, c


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w):
    """Exponential map (..., 3) -> (..., 3, 3) (Rodrigues)."""
    a, b, _ = _sinc_coeffs(_theta_sq(w))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def quat_from_matrix(R):
    """(..., 3, 3) -> (..., 4) unit quaternion [qw, qx, qy, qz] (Shepperd).

    All four candidate extractions are computed; the one with the largest
    pivot is taken (first on ties), with the canonical sign qw >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    s_w = safe_sqrt(1.0 + tr)
    q_w = torch.stack([s_w * s_w, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    s_x = safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack([m21 - m12, s_x * s_x, m01 + m10, m02 + m20], dim=-1)
    s_y = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack([m02 - m20, m01 + m10, s_y * s_y, m12 + m21], dim=-1)
    s_z = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, s_z * s_z], dim=-1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def log(R):
    """Logarithm map (..., 3, 3) -> (..., 3), robust near 0 and pi."""
    q = quat_from_matrix(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    nv_sq = torch.sum(qv * qv, dim=-1)
    small = nv_sq < 1e-14
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    big = 2.0 * torch.atan2(nv, qw) / nv
    taylor = 2.0 / qw - 2.0 * nv_sq / (3.0 * qw ** 3)
    return torch.where(small, taylor, big)[..., None] * qv


def left_jacobian(w):
    """SO(3) left Jacobian Jl(w): (..., 3) -> (..., 3, 3)."""
    _, b, c = _sinc_coeffs(_theta_sq(w))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def right_jacobian(w):
    """Jr(w) = Jl(-w)."""
    return left_jacobian(-w)


def left_jacobian_inv(w):
    """Inverse SO(3) left Jacobian."""
    th_sq = _theta_sq(w)
    small = th_sq < _EPS
    th_sq_safe = torch.where(small, torch.ones_like(th_sq), th_sq)
    th = torch.sqrt(th_sq_safe)
    half = th / 2.0
    k = torch.where(small, 1.0 / 12.0 + th_sq / 720.0,
                    1.0 / th_sq_safe - torch.cos(half) / (2.0 * th * torch.sin(half)))
    W = hat(w)
    return _eye_like(W) - 0.5 * W + k[..., None, None] * (W @ W)


def right_jacobian_inv(w):
    """Jr^-1(w) = Jl^-1(-w)."""
    return left_jacobian_inv(-w)


def inverse(R):
    return R.transpose(-1, -2)


def compose(R1, R2):
    return R1 @ R2


def Ad(R):
    """The adjoint of SO(3) is the rotation itself."""
    return R


def ad(w):
    """Small adjoint of so(3): hat(w)."""
    return hat(w)


def rplus(R, w):
    """R Exp(w)."""
    return R @ exp(w)


def rminus(X, Y):
    """Log(Y^-1 X)."""
    return log(inverse(Y) @ X)


def lminus(X, Y):
    """Log(X Y^-1)."""
    return log(X @ inverse(Y))


def matrix_from_quat(q):
    """(..., 4) unit quaternion [qw, qx, qy, qz] -> (..., 3, 3) rotation."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz),
                     2.0 * (qx * qz + qw * qy)], dim=-1),
        torch.stack([2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz),
                     2.0 * (qy * qz - qw * qx)], dim=-1),
        torch.stack([2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
                     1.0 - 2.0 * (qx * qx + qy * qy)], dim=-1),
    ], dim=-2)


def normalize(R):
    """Project a near-rotation back onto SO(3) by a quaternion round-trip."""
    return matrix_from_quat(quat_from_matrix(R))
