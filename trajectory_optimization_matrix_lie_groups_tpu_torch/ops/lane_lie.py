"""Lane-layout SO(3)/SE(3) primitives on batch-last tensors (counterpart of
the JAX `ops/pallas_lie.py`).

A rotation is a (3, 3, *batch) tensor whose entries are batch vectors, a
translation (3, *batch), a twist (6, *batch); ``batch`` is (B,) for one
stage or (N, B) for all stages at once.  These are the plain versions of
the stage math in `csrc/lie.cuh`: the same formulas, the same Taylor guards
and the same Shepperd pivot order (``>=``, x before y before z before w), so
that kernel and plain version agree to rounding.  The angle of `so3_log`
uses native `torch.atan2`.

Constants (inertia, weights) may be passed without batch dimensions: the
einsum products broadcast them.

One deliberate difference from the JAX lane primitives: five rotation-angle
coefficients, (th - sin th)/th^3, (th^2 + 2 cos th - 2)/(2 th^4),
(2 th - 3 sin th + th cos th)/(2 th^5) and 1/th^2 - cos(th/2)/(2 th sin(th/2)),
cancel catastrophically in their closed forms for 1e-8 <= th^2 < 1 (in f32
the Q-matrix coefficient c3 keeps no correct digit at th ~ 1e-2, and two f32
evaluations that differ by one ulp in th disagree at ~1e-4 in the cost
gradient).  Below th^2 = 1 they are evaluated as their power series in th^2
(11 terms: exact to f64 rounding there), above it by the closed forms.
"""

import torch

_EPS = 1e-8

# Power series in x = th^2, used for x < _SERIES_MAX; the coefficients are
# the same doubles as in csrc/lie.cuh.
_SERIES_MAX = 1.0
# (th - sin th) / th^3 = sum (-1)^n x^n / (2n+3)!
_C1 = (0.16666666666666666, -0.008333333333333333, 0.0001984126984126984,
       -2.7557319223985893e-06, 2.505210838544172e-08, -1.6059043836821613e-10,
       7.647163731819816e-13, -2.8114572543455206e-15, 8.22063524662433e-18,
       -1.9572941063391263e-20, 3.868170170630684e-23)
# (th^2 + 2 cos th - 2) / (2 th^4) = sum (-1)^n x^n / (2n+4)!
_C2 = (0.041666666666666664, -0.001388888888888889, 2.48015873015873e-05,
       -2.755731922398589e-07, 2.08767569878681e-09, -1.1470745597729725e-11,
       4.779477332387385e-14, -1.5619206968586225e-16, 4.110317623312165e-19,
       -8.896791392450574e-22, 1.6117375710961184e-24)
# (2 th - 3 sin th + th cos th) / (2 th^5) = sum (-1)^n (n+1) x^n / (2n+5)!
_C3 = (0.008333333333333333, -0.0003968253968253968, 8.267195767195768e-06,
       -1.0020843354176688e-07, 8.029521918410807e-10, -4.58829823909189e-12,
       1.9680200780418645e-14, -6.576508197299464e-17, 1.7615646957052136e-19,
       -3.868170170630684e-22, 7.091645312822921e-25)
# 1/th^2 - cos(th/2) / (2 th sin(th/2)) = sum |B_2n| x^(n-1) / (2n)!
_JINV = (0.08333333333333333, 0.001388888888888889, 3.306878306878307e-05,
         8.267195767195768e-07, 2.08767569878681e-08, 5.284190138687493e-10,
         1.3382536530684679e-11, 3.3896802963225827e-13, 8.586062056277845e-15,
         2.174868698558062e-16, 5.5090028283602295e-18)


def _series(x, coeffs):
    """Horner evaluation of sum coeffs[n] x^n."""
    acc = coeffs[-1] * x + coeffs[-2]
    for c in reversed(coeffs[:-2]):
        acc = acc * x + c
    return acc


def _series_or(th_sq, coeffs, closed):
    """The series below _SERIES_MAX, else ``closed(th_sq_safe, th)``."""
    small = th_sq < _SERIES_MAX
    th_sq_safe = _safe(small, th_sq)
    return torch.where(small, _series(th_sq, coeffs),
                       closed(th_sq_safe, torch.sqrt(th_sq_safe)))


# -- small helpers -----------------------------------------------------------

def matmul(A, B):
    """(n, m, *b) @ (m, p, *b)."""
    return torch.einsum("ik...,kj...->ij...", A, B)


def matvec(A, v):
    """(n, m, *b) @ (m, *b)."""
    return torch.einsum("ik...,k...->i...", A, v)


def transpose(A):
    return A.transpose(0, 1)


def _mat3(rows):
    """(3, 3, *b) from a 3x3 nest of batch tensors."""
    return torch.stack([torch.stack(list(r)) for r in rows])


def _vec(entries):
    return torch.stack(list(entries))


def _eye(n, like):
    """(n, n, *b) identity with ``like``'s batch shape."""
    bs = like.shape[1:] if like.dim() > 0 else ()
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return eye.reshape((n, n) + (1,) * len(bs)).expand((n, n) + tuple(bs))


def blk(A, Bm, C, D):
    """[[A, Bm], [C, D]] from (r, c, *b) quadrants."""
    return torch.cat([torch.cat([A, Bm], dim=1), torch.cat([C, D], dim=1)],
                     dim=0)


def hat(w):
    """(3, *b) -> (3, 3, *b)."""
    z = torch.zeros_like(w[0])
    return _mat3([[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]])


def _th_sq(w):
    return w[0] * w[0] + w[1] * w[1] + w[2] * w[2]


def _safe(small, th_sq):
    return torch.where(small, torch.ones_like(th_sq), th_sq)


# -- SO(3) -------------------------------------------------------------------

def so3_exp(w):
    """(3, *b) -> (3, 3, *b), Rodrigues with Taylor guards."""
    th_sq = _th_sq(w)
    small = th_sq < _EPS
    th = torch.sqrt(_safe(small, th_sq))
    a = torch.where(small, 1.0 - th_sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th_sq / 24.0,
                    (1.0 - torch.cos(th)) / _safe(small, th_sq))
    W = hat(w)
    return _eye(3, w) + a * W + b * matmul(W, W)


def quat_from_matrix(R):
    """(3, 3, *b) -> (qw, qx, qy, qz), branchless Shepperd, qw >= 0."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def ssq(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    s_w = ssq(1.0 + tr)
    cw = (s_w * s_w, m21 - m12, m02 - m20, m10 - m01)
    s_x = ssq(1.0 + m00 - m11 - m22)
    cx = (m21 - m12, s_x * s_x, m01 + m10, m02 + m20)
    s_y = ssq(1.0 - m00 + m11 - m22)
    cy = (m02 - m20, m01 + m10, s_y * s_y, m12 + m21)
    s_z = ssq(1.0 - m00 - m11 + m22)
    cz = (m10 - m01, m02 + m20, m12 + m21, s_z * s_z)

    pw = 1.0 + tr
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22
    use_x = (px >= pw) & (px >= py) & (px >= pz)
    use_y = ~use_x & (py >= pw) & (py >= px) & (py >= pz)
    use_z = ~use_x & ~use_y & (pz >= pw) & (pz >= px) & (pz >= py)
    q = [torch.where(use_x, cx[i], torch.where(use_y, cy[i],
                     torch.where(use_z, cz[i], cw[i]))) for i in range(4)]
    norm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    sign = torch.where(q[0] < 0.0, -1.0, 1.0).to(R.dtype)
    return tuple(sign * qq / norm for qq in q)


def matrix_from_quat(q):
    qw, qx, qy, qz = q
    return _mat3([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])


def so3_log(R):
    """(3, 3, *b) -> (3, *b), robust near 0 and pi (quaternion path)."""
    qw, qx, qy, qz = quat_from_matrix(R)
    nv_sq = qx * qx + qy * qy + qz * qz
    small = nv_sq < 1e-14
    nv = torch.sqrt(_safe(small, nv_sq))
    big = 2.0 * torch.atan2(nv, qw) / nv
    taylor = 2.0 / qw - 2.0 * nv_sq / (3.0 * qw ** 3)
    s = torch.where(small, taylor, big)
    return _vec([s * qx, s * qy, s * qz])


def so3_normalize(R):
    return matrix_from_quat(quat_from_matrix(R))


def _c1(th_sq):
    return _series_or(th_sq, _C1, lambda x, th: (th - torch.sin(th)) / (x * th))


def _jl_coeffs(th_sq):
    small = th_sq < _EPS
    th_sq_safe = _safe(small, th_sq)
    th = torch.sqrt(th_sq_safe)
    b = torch.where(small, 0.5 - th_sq / 24.0, (1.0 - torch.cos(th)) / th_sq_safe)
    return b, _c1(th_sq)


def so3_left_jacobian(w):
    b, c = _jl_coeffs(_th_sq(w))
    W = hat(w)
    return _eye(3, w) + b * W + c * matmul(W, W)


def _jinv_coeff(th_sq):
    return _series_or(th_sq, _JINV, lambda x, th: 1.0 / x - torch.cos(th / 2.0)
                      / (2.0 * th * torch.sin(th / 2.0)))


def so3_left_jacobian_inv(w):
    W = hat(w)
    return _eye(3, w) - 0.5 * W + _jinv_coeff(_th_sq(w)) * matmul(W, W)


# -- SE(3) (R (3, 3, *b), p (3, *b)) ------------------------------------------

def se3_exp(xi):
    """(6, *b) twist [w, v] -> (R, p)."""
    w, v = xi[:3], xi[3:]
    return so3_exp(w), matvec(so3_left_jacobian(w), v)


def se3_log(R, p):
    """(R, p) -> (6, *b)."""
    w = so3_log(R)
    return torch.cat([w, matvec(so3_left_jacobian_inv(w), p)], dim=0)


def se3_compose(R1, p1, R2, p2):
    return matmul(R1, R2), matvec(R1, p2) + p1


def se3_inverse(R, p):
    Rt = transpose(R)
    return Rt, -matvec(Rt, p)


def _q_coeffs(th_sq):
    """Barfoot Q-matrix coefficients, series below th^2 = 1."""
    c2 = _series_or(th_sq, _C2, lambda x, th: (x + 2.0 * torch.cos(th) - 2.0)
                    / (2.0 * x * x))
    c3 = _series_or(th_sq, _C3, lambda x, th: (2.0 * th - 3.0 * torch.sin(th)
                                               + th * torch.cos(th))
                    / (2.0 * x * x * th))
    return _c1(th_sq), c2, c3


def _q_matrix(w, v):
    c1, c2, c3 = _q_coeffs(_th_sq(w))
    W = hat(w)
    V = hat(v)
    WV = matmul(W, V)
    VW = matmul(V, W)
    WVW = matmul(WV, W)
    return (0.5 * V + c1 * (WV + VW + WVW)
            + c2 * (matmul(W, WV) + matmul(VW, W) - 3.0 * WVW)
            + c3 * (matmul(WVW, W) + matmul(W, WVW)))


def se3_right_jacobian(xi):
    """(6, *b) -> (6, 6, *b), Jr(xi) = Jl(-xi)."""
    w, v = -xi[:3], -xi[3:]
    Jw = so3_left_jacobian(w)
    return blk(Jw, torch.zeros_like(Jw), _q_matrix(w, v), Jw)


def se3_right_jacobian_inv(xi):
    """(6, *b) -> (6, 6, *b), Jr^-1(xi) = Jl^-1(-xi)."""
    w, v = -xi[:3], -xi[3:]
    Jwi = so3_left_jacobian_inv(w)
    Q = _q_matrix(w, v)
    return blk(Jwi, torch.zeros_like(Jwi), -matmul(matmul(Jwi, Q), Jwi), Jwi)


def se3_Ad(R, p):
    """Group adjoint [[R, 0], [hat(p) R, R]] as (6, 6, *b)."""
    return blk(R, torch.zeros_like(R), matmul(hat(p), R), R)
