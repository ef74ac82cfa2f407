"""The port's Lie core against the JAX package's, f64 on the same inputs.

- `ops/so3`, `ops/se3` (batch-first) and the lane primitives `ops/lane_lie`
  against JAX `ops/so3`, `ops/se3`: atol 1e-10.
- `ops/lane_lie` against the JAX lane primitives `ops/pallas_lie`: atol 1e-7,
  the bound of `pallas_lie.atan2_pos`'s polynomial (8e-9 measured) as it
  reaches log and the Jacobians built on it.

Angles: moderate (0.3 to 2.5 rad), small (1e-6 rad: the Taylor branches)
and near pi (pi - 1e-6).  Rotation angles between ~1e-4 and ~1e-2 rad are
left out of the batch-first comparisons on purpose: there the closed-form
Q-matrix coefficients of both packages cancel to ~1e-9 even in f64, so two
correct implementations disagree beyond 1e-10 (the lane primitives use
power series there, see `lane_lie`).
"""

import math
from decimal import Decimal, getcontext

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.ops import pallas_lie as jpl
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.ops import so3 as jso3
from trajectory_optimization_matrix_lie_groups_tpu.utils import trajectories as jtraj
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import group
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3 as tse3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import so3 as tso3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import trajectories as ttraj

ATOL = 1e-10
ATOL_PALLAS = 1e-7


def _twists(seed=0):
    """(M, 6) twists whose rotation parts cover moderate, small and
    near-pi angles."""
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.3, 2.5, 6), [1e-6, 1e-6, 0.0],
                             [np.pi - 1e-6, np.pi - 1e-6, np.pi - 1e-3]])
    w = axes * angles[:, None]
    v = rng.standard_normal((12, 3))
    return np.concatenate([w, v], axis=1)


XI = _twists()
J = lambda x: jnp.asarray(x)
T = lambda x: torch.as_tensor(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["hat", "exp", "left_jacobian", "right_jacobian",
                                  "left_jacobian_inv", "right_jacobian_inv", "ad"])
def test_so3_tangent_functions(name):
    w = XI[:, :3]
    _close(getattr(tso3, name)(T(w)), getattr(jso3, name)(J(w)))


@pytest.mark.parametrize("name", ["log", "quat_from_matrix", "normalize", "vee"])
def test_so3_matrix_functions(name):
    R = np.asarray(jso3.exp(J(XI[:, :3])))
    _close(getattr(tso3, name)(T(R)), getattr(jso3, name)(J(R)))


def test_so3_quaternion_round_trip():
    q = np.asarray(jso3.quat_from_matrix(jso3.exp(J(XI[:, :3]))))
    _close(tso3.matrix_from_quat(T(q)), jso3.matrix_from_quat(J(q)))
    _close(tso3.quat_from_matrix(tso3.matrix_from_quat(T(q))), q)


@pytest.mark.parametrize("name", ["hat", "ad", "coad", "exp", "left_jacobian",
                                  "right_jacobian", "left_jacobian_inv",
                                  "right_jacobian_inv"])
def test_se3_tangent_functions(name):
    _close(getattr(tse3, name)(T(XI)), getattr(jse3, name)(J(XI)))


@pytest.mark.parametrize("name", ["log", "inverse", "Ad", "normalize", "vee",
                                  "quatpos_from_matrix"])
def test_se3_matrix_functions(name):
    Tm = np.asarray(jse3.exp(J(XI)))
    _close(getattr(tse3, name)(T(Tm)), getattr(jse3, name)(J(Tm)))


def test_se3_group_ops():
    A = np.asarray(jse3.exp(J(XI)))
    Bm = np.asarray(jse3.exp(J(XI[::-1].copy())))
    _close(tse3.compose(T(A), T(Bm)), jse3.compose(J(A), J(Bm)))
    _close(tse3.rminus(T(A), T(Bm)), jse3.rminus(J(A), J(Bm)))
    _close(tse3.lminus(T(A), T(Bm)), jse3.lminus(J(A), J(Bm)))
    _close(tse3.rplus(T(A), T(XI)), jse3.rplus(J(A), J(XI)))
    x7 = np.asarray(jse3.quatpos_from_matrix(J(A)))
    _close(tse3.matrix_from_quatpos(T(x7)), jse3.matrix_from_quatpos(J(x7)))


@pytest.mark.parametrize("m", [4, 3], ids=["se3", "so3"])
def test_generate_reference(m):
    """Twist integration with a time-varying twist, SE(3) and SO(3)."""
    d = 6 if m == 4 else 3
    q0 = np.asarray((jse3 if m == 4 else jso3).exp(J(XI[0, :d])))
    xi_of_i = lambda i: XI[i % len(XI), :d]
    tq, txi = ttraj.generate_reference(T(q0), xi_of_i, 20, 0.05)
    jq, jxi = jtraj.generate_reference(J(q0), xi_of_i, 20, 0.05)
    _close(tq, jq)
    _close(txi, jxi)


def test_group_namespaces():
    assert (group.SE3.dim, group.SE3.mat, group.SO3.dim, group.SO3.mat) == (6, 4, 3, 3)
    _close(group.SE3.normalize(group.SE3.exp(T(XI))),
           jse3.normalize(jse3.exp(J(XI))))


# -- lane primitives: (k, ..., M) batch-last ---------------------------------

L = lambda x: T(np.moveaxis(np.asarray(x), 0, -1).copy())       # (M, ...) -> (..., M)
BF = lambda x: np.moveaxis(np.asarray(x), -1, 0)                 # back to (M, ...)


def test_lane_so3_and_se3_against_batch_first():
    w, Rm = XI[:, :3], np.asarray(jso3.exp(J(XI[:, :3])))
    Tm = np.asarray(jse3.exp(J(XI)))
    _close(BF(ll.so3_exp(L(w))), jso3.exp(J(w)))
    _close(BF(ll.so3_log(L(Rm))), jso3.log(J(Rm)))
    _close(BF(ll.so3_normalize(L(Rm))), jso3.normalize(J(Rm)))
    _close(BF(ll.so3_left_jacobian(L(w))), jso3.left_jacobian(J(w)))
    _close(BF(ll.so3_left_jacobian_inv(L(w))), jso3.left_jacobian_inv(J(w)))
    R, p = ll.se3_exp(L(XI))
    _close(BF(R), Tm[:, :3, :3])
    _close(BF(p), Tm[:, :3, 3])
    _close(BF(ll.se3_log(L(Tm[:, :3, :3]), L(Tm[:, :3, 3]))), jse3.log(J(Tm)))
    _close(BF(ll.se3_right_jacobian(L(XI))), jse3.right_jacobian(J(XI)))
    _close(BF(ll.se3_right_jacobian_inv(L(XI))), jse3.right_jacobian_inv(J(XI)))
    _close(BF(ll.se3_Ad(L(Tm[:, :3, :3]), L(Tm[:, :3, 3]))), jse3.Ad(J(Tm)))
    Ri, pi = ll.se3_inverse(L(Tm[:, :3, :3]), L(Tm[:, :3, 3]))
    Ti = np.asarray(jse3.inverse(J(Tm)))
    _close(BF(Ri), Ti[:, :3, :3])
    _close(BF(pi), Ti[:, :3, 3])


def _exact_coeffs(th):
    """c1, c2, c3 of the Q matrix and the Jl^-1 coefficient k from their
    closed forms in 60-digit decimal arithmetic (no cancellation left)."""
    getcontext().prec = 60

    def series(x, k0, sign):  # sum of sign^n x^(2n+k0) / (2n+k0)!
        s, t, n = Decimal(0), x ** k0 / math.factorial(k0), k0
        while abs(t) > Decimal(10) ** -58:
            s += t
            t = sign * t * x * x / ((n + 1) * (n + 2))
            n += 2
        return s

    t = Decimal(th)
    x = t * t
    sin, cos = series(t, 1, -1), series(t, 0, -1)
    sin_h, cos_h = series(t / 2, 1, -1), series(t / 2, 0, -1)
    return [float(c) for c in ((t - sin) / (x * t),
                               (x + 2 * cos - 2) / (2 * x * x),
                               (2 * t - 3 * sin + t * cos) / (2 * x * x * t),
                               1 / x - cos_h / (2 * t * sin_h))]


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13), (torch.float32, 2e-5)],
                         ids=["f64", "f32"])
def test_lane_angle_coefficients_are_accurate(dtype, rtol):
    """The lane primitives' cancelling coefficients (series below th^2 = 1,
    closed forms above) against exact values, 1e-4 to 3 rad.  The JAX closed
    forms miss this by orders of magnitude in the band (in f32 c2 keeps no
    correct digit at th = 1e-2, in f64 at th = 1e-4)."""
    th = np.concatenate([np.geomspace(1e-4, 3.0, 15), [1.0 - 1e-7, 1.0 + 1e-7]])
    x = torch.tensor(th * th, dtype=dtype)
    port = torch.stack([*ll._q_coeffs(x), ll._jinv_coeff(x)], dim=1).double().numpy()
    want = np.array([_exact_coeffs(t) for t in th])
    np.testing.assert_allclose(port, want, rtol=rtol, atol=0)


def test_lane_against_pallas_lie():
    w, Rm = XI[:, :3], np.asarray(jso3.exp(J(XI[:, :3])))
    Tm = np.asarray(jse3.exp(J(XI)))
    jl = lambda x: jnp.asarray(np.moveaxis(np.asarray(x), 0, -1))  # pallas lanes
    c = lambda a, b: _close(a, b, atol=ATOL_PALLAS)
    c(ll.so3_exp(L(w)), jpl.so3_exp(jl(w)))
    c(ll.so3_log(L(Rm)), jpl.so3_log(jl(Rm)))
    c(ll.so3_normalize(L(Rm)), jpl.so3_normalize(jl(Rm)))
    c(ll.hat(L(w)), jpl.hat(jl(w)))
    c(ll.so3_left_jacobian_inv(L(w)), jpl.so3_left_jacobian_inv(jl(w)))
    q = jpl.quat_from_matrix(jl(Rm))
    for a, b in zip(ll.quat_from_matrix(L(Rm)), q):
        c(a, b)
    c(ll.matrix_from_quat(tuple(T(np.asarray(x)) for x in q)), jpl.matrix_from_quat(q))
    c(ll.se3_log(L(Tm[:, :3, :3]), L(Tm[:, :3, 3])),
      jpl.se3_log(jl(Tm[:, :3, :3]), jl(Tm[:, :3, 3])))
    for a, b in zip(ll.se3_exp(L(XI)), jpl.se3_exp(jl(XI))):
        c(a, b)
    c(ll.se3_right_jacobian(L(XI)), jpl.se3_right_jacobian(jl(XI)))
    c(ll.se3_right_jacobian_inv(L(XI)), jpl.se3_right_jacobian_inv(jl(XI)))
    c(ll._q_matrix(L(XI[:, :3]), L(XI[:, 3:])), jpl._q_matrix(jl(XI[:, :3]), jl(XI[:, 3:])))
    c(ll.se3_Ad(L(Tm[:, :3, :3]), L(Tm[:, :3, 3])),
      jpl.se3_Ad(jl(Tm[:, :3, :3]), jl(Tm[:, :3, 3])))
