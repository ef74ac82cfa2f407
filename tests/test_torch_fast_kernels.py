"""The generic fast tier's pieces against the JAX package, f64 unless
stated, on the same numpy inputs:

- the batch-first SE(3) Jacobians (`models/dynamics._se3_jac`,
  `_rigid_body_jac`) with the quirk flags on and off, and the generic
  `models/costs.tracking_cost` for SE(3) and SO(3);
- `utils/linalg.chol_solve_psd`, the f64 loop backward's solve;
- kernel B13's plain version (`ops/riccati`) against the JAX
  `pallas_backward` (interpret mode) at the tuned instances' (nx, nu) and
  at runtime shapes (6, 2), (9, 3), (12, 3), (12, 12) and (3, 12);
- kernel B14's plain version (`ops/rollout`) against the JAX
  `pallas_rollout` (interpret mode, f32) and the JAX `FastBatchSolver`'s scan
  rollout (f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SO3 as JSO3
from trajectory_optimization_matrix_lie_groups_tpu.ops.pallas_riccati import (
    pallas_backward,
)
from trajectory_optimization_matrix_lie_groups_tpu.ops.pallas_rollout import (
    pallas_rollout,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver as JaxFastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.utils.linalg import (
    chol_solve_psd as jchol_solve_psd,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import dyn_from_numpy
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tcosts
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as tdyn
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.riccati import (
    SHAPES,
    fast_backward,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.rollout import fast_rollout
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import chol_solve_psd

from test_torch_pipeline_so3 import problem as so3_problem
from torch_port_cases import TORCH_DTYPE, initial_batch, problem

T = lambda x: torch.as_tensor(np.array(x))


def _fields(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def _se3_states(B, seed):
    """Random SE(3) states at moderate angles (f64 numpy): q (B, 4, 4),
    xi (B, 6), u (B, 6)."""
    rng = np.random.default_rng(seed)
    q = np.asarray(JSE3.exp(jnp.asarray(rng.uniform(-1.0, 1.0, (B, 6)))))
    return q, rng.normal(size=(B, 6)), rng.normal(size=(B, 6))


@pytest.mark.parametrize("swap", [True, False], ids=["coad_swap", "exact_coad"])
def test_se3_jacobian_matches_jax(swap):
    """`_se3_jac` with ``ref_coad_swap`` on (the reference's quirk) and off,
    f64 at 1e-12 (moderate angles: the closed forms of both packages are the
    same formulas)."""
    dp = problem(4)[0]
    dp = dp._replace(ref_coad_swap=jnp.asarray(swap))
    tdp = dyn_from_numpy(_fields(dp))
    q, xi, u = _se3_states(7, 0)
    Fx, Fu = jdyn._se3_jac(dp, jnp.asarray(q), jnp.asarray(xi), jnp.asarray(u), 0)
    tFx, tFu = tdyn._se3_jac(tdp, T(q), T(xi), T(u))
    np.testing.assert_allclose(tFx.numpy(), np.asarray(Fx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tFu.numpy(), np.asarray(Fu), rtol=0, atol=1e-12)


@pytest.mark.parametrize("swap", [True, False], ids=["coad_swap", "exact_coad"])
@pytest.mark.parametrize("exact_grav", [False, True], ids=["ref_gravity", "exact_gravity"])
def test_drone_jacobian_and_step_match_jax(exact_grav, swap):
    """`_rigid_body_jac` of the drone with ``exact_gravity_jacobian`` and
    ``ref_coad_swap`` on and off, and its step, f64 at 1e-12."""
    dp0 = problem(4)[0]
    dp = jdyn.drone_params(dp0.J, dp0.dt, exact_gravity_jacobian=exact_grav,
                           ref_coad_swap=swap)
    tdp = dyn_from_numpy(_fields(dp))
    q, xi, u = _se3_states(6, 1)
    u = u[:, :4]
    args = (jnp.asarray(q), jnp.asarray(xi), jnp.asarray(u), 0)
    Fx, Fu = jdyn._rigid_body_jac(dp, *args)
    tFx, tFu = tdyn._rigid_body_jac(tdp, T(q), T(xi), T(u))
    np.testing.assert_allclose(tFx.numpy(), np.asarray(Fx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tFu.numpy(), np.asarray(Fu), rtol=0, atol=1e-12)
    qn, xin = jdyn._rigid_body_step(dp, *args)
    tqn, txin = tdyn.drone_dynamics().step(tdp, T(q), T(xi), T(u), 0)
    np.testing.assert_allclose(tqn.numpy(), np.asarray(qn), rtol=0, atol=1e-12)
    np.testing.assert_allclose(txin.numpy(), np.asarray(xin), rtol=0, atol=1e-12)


def _near_reference(q_ref, idx, scale, seed):
    """States q_ref[idx] Exp(scale n) (f64 numpy), their twists and
    controls."""
    rng = np.random.default_rng(seed)
    dim = 6 if q_ref.shape[-1] == 4 else 3
    grp = JSE3 if dim == 6 else JSO3
    q = np.asarray(grp.compose(jnp.asarray(q_ref[idx]),
                               grp.exp(jnp.asarray(scale * rng.normal(size=idx.shape + (dim,))))))
    return q, rng.normal(size=idx.shape + (dim,))


def _check_quads(cd, tcd, cp, tcp, q, xi, u, i, atol):
    got = tcd.stage_quad(tcp, T(q), T(xi), T(u), torch.as_tensor(i))
    want = cd.stage_quad(cp, jnp.asarray(q), jnp.asarray(xi), jnp.asarray(u), jnp.asarray(i))
    for n, g, w in zip(("l", "lx", "lu", "lxx", "lux", "luu"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=n)
    np.testing.assert_allclose(tcd.stage_cost(tcp, T(q), T(xi), T(u), torch.as_tensor(i)).numpy(),
                               np.asarray(want[0]), rtol=0, atol=atol)
    N = cp.q_ref.shape[0] - 1
    got = tcd.term_quad(tcp, T(q[..., 0, :, :]), T(xi[..., 0, :]), N)
    want = cd.term_quad(cp, jnp.asarray(q[..., 0, :, :]), jnp.asarray(xi[..., 0, :]), N)
    for n, g, w in zip(("l", "lx", "lxx"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=n)
    np.testing.assert_allclose(
        tcd.term_cost(tcp, T(q[..., 0, :, :]), T(xi[..., 0, :]), N).numpy(),
        np.asarray(want[0]), rtol=0, atol=atol)


def test_se3_tracking_cost_matches_jax():
    """`tracking_cost(SE3, 6)` stage and terminal quadratizations and values,
    and `tracking_error`, over a (B, N) batch of states against JAX, f64 at
    1e-12 (moderate angles)."""
    H, B = 6, 3
    _, cp, _, tcp, _, _, _ = problem(H)
    idx = np.broadcast_to(np.arange(H), (B, H))
    q, xi = _near_reference(np.asarray(cp.q_ref), idx, 0.5, 2)
    u = np.random.default_rng(3).normal(size=(B, H, 6))
    _check_quads(jcosts.tracking_cost(JSE3, 6), tcosts.tracking_cost(SE3, 6), cp, tcp,
                 q, xi, u, np.arange(H), atol=1e-12)
    got = tcosts.tracking_error(SE3, tcp, T(q), T(xi), torch.arange(H))
    want = jcosts.tracking_error(JSE3, cp, jnp.asarray(q), jnp.asarray(xi), jnp.arange(H))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
def test_so3_tracking_cost_matches_jax(quirk):
    """`tracking_cost(SO3, 3, ref_so3_terminal_quirk)` against JAX, f64 at
    1e-10: `tests/test_torch_lie.py`'s batch-first tolerance, because the
    tracking errors here include small rotation angles where both packages'
    closed-form Jr^-1 coefficient cancels, so two correct evaluations agree
    only to ~1e-10 there."""
    H, B = 6, 3
    _, cp, _, tcp = so3_problem("so3_track249", H)
    idx = np.broadcast_to(np.arange(H), (B, H))
    q, xi = _near_reference(np.asarray(cp.q_ref), idx, 0.05, 4)
    u = np.random.default_rng(5).normal(size=(B, H, 3))
    _check_quads(jcosts.tracking_cost(JSO3, 3, ref_so3_terminal_quirk=quirk),
                 tcosts.tracking_cost(SO3, 3, ref_so3_terminal_quirk=quirk), cp, tcp,
                 q, xi, u, np.arange(H), atol=1e-10)


def _random_riccati_problem(B, N, nx, nu, seed):
    """`tests/test_pallas_riccati.py`'s random problem (solver layout, f64
    numpy): Fx near I, small Fu, d, and positive definite Lxx, Luu."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    W = n((B, N + 1, nx, nx))
    U = n((B, N, nu, nu))
    return (0.1 * n((B, N, nx, nx)) + np.eye(nx), 0.1 * n((B, N, nx, nu)),
            0.01 * n((B, N, nx)), n((B, N + 1, nx)), n((B, N, nu)),
            W @ np.swapaxes(W, -1, -2) * 0.1 + np.eye(nx), 0.1 * n((B, N, nu, nx)),
            U @ np.swapaxes(U, -1, -2) * 0.1 + np.eye(nu))


@pytest.mark.parametrize("rhs", [(), (12,)], ids=["vector", "matrix"])
def test_chol_solve_psd_matches_jax(rhs):
    """The port's `utils/linalg.chol_solve_psd` (the f64 loop backward's
    solve, on the lane Cholesky that B13's plain version uses) against the
    JAX one, f64, batch (3, 2) of 6 x 6 positive definite systems."""
    rng = np.random.default_rng(5)
    W = rng.standard_normal((3, 2, 6, 6))
    A = W @ np.swapaxes(W, -1, -2) + 0.5 * np.eye(6)
    B = rng.standard_normal((3, 2, 6) + rhs)
    want = np.asarray(jchol_solve_psd(jnp.asarray(A), jnp.asarray(B)))
    got = chol_solve_psd(T(A), T(B)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(A @ (got if rhs else got[..., None]),
                               B if rhs else B[..., None], atol=1e-11)


# the tuned instances' shapes, and shapes that only the runtime-shape
# instance takes (nu > nx in (3, 12))
BACKWARD_SHAPES = tuple(SHAPES) + ((6, 2), (9, 3), (12, 3), (12, 12), (3, 12))


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nx,nu", BACKWARD_SHAPES, ids=[f"{a}x{b}" for a, b in BACKWARD_SHAPES])
def test_backward_plain_matches_pallas_backward(nx, nu, dtype):
    """B13's plain version against JAX `pallas_backward(interpret=True)`,
    B = 4, N = 9: f64 at `tests/test_pallas_riccati.py`'s atol (1e-10 on k
    and K, 1e-9 on Vx1 and Vxx1); f32 at rtol 1e-4 (atol 1e-4 of each
    output's largest entry, for the entries near 0)."""
    np_dt = np.float64 if dtype == jnp.float64 else np.float32
    args = [a.astype(np_dt) for a in _random_riccati_problem(4, 9, nx, nu, nx + nu)]
    want = pallas_backward(*(jnp.asarray(a) for a in args), interpret=True)
    got = fast_backward(*(T(a) for a in args))
    for n, g, w, atol in zip(("k", "K", "Vx1", "Vxx1"), got, want,
                             (1e-10, 1e-10, 1e-9, 1e-9)):
        w = np.asarray(w)
        assert g.dtype == TORCH_DTYPE[dtype] and g.shape == w.shape
        if dtype == jnp.float64:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=n)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=n)


def _rollout_case(dtype, H=20, B=3):
    """A JAX `FastBatchSolver` (XLA path) iterate of the screw problem, cut
    to H: the trajectory from perturbed initial poses with the reference
    tail and random controls, its linearization and gains, in ``dtype``.
    Returns (solver, params, qs, xis, us, lin, k, K) as JAX arrays."""
    dp, cp, _, _, q0, xi0, nu = problem(H, dtype)
    model, params = jmake(jdyn.se3_dynamics(), jcosts.tracking_cost(JSE3, 6), dp, cp)
    q0s, xi0s, _ = initial_batch(q0, xi0, B, H, nu, 0, dtype)
    qs = jnp.concatenate([jnp.asarray(q0s)[:, None],
                          jnp.broadcast_to(cp.q_ref[1:], (B, H, 4, 4))], axis=1)
    xis = jnp.concatenate([jnp.asarray(xi0s)[:, None],
                           jnp.broadcast_to(cp.xi_ref[1:], (B, H, 6))], axis=1)
    us = jnp.asarray(0.1 * np.random.default_rng(1).standard_normal((B, H, 6)), dtype)
    fast = JaxFastBatchSolver(model, N=H, iterations=1, use_pallas=False)
    lin = fast._linearize(params, qs, xis, us)
    k, K, _, _ = fast._backward(lin)
    return fast, params, qs, xis, us, lin, k, K


def _port_rollout(params, qs, xis, us, lin, k, K):
    dp = params["dyn"]
    exp_d = jse3.exp(lin["d"][..., :6])
    fq_inv = jse3.inverse(lin["fq"])
    return fast_rollout(*(T(a) for a in (qs, xis, us, k, K, lin["d"], lin["fxi"], exp_d,
                                         fq_inv, dp.J, dp.Jinv)), float(dp.dt))


def test_rollout_plain_matches_pallas_rollout_f32():
    """B14's plain version against JAX `pallas_rollout(interpret=True)` in
    f32 at `tests/test_pallas_rollout.py`'s tolerances (atol 5e-4, rtol
    1e-5: the JAX kernel's polynomial atan is f32-grade), stage 0 kept."""
    _, params, qs, xis, us, lin, k, K = _rollout_case(jnp.float32)
    dp = params["dyn"]
    want = pallas_rollout(qs, xis, us, k, K, lin["d"], lin["fxi"],
                          jse3.exp(lin["d"][..., :6]), jse3.inverse(lin["fq"]),
                          dp.J, dp.Jinv, float(dp.dt), interpret=True)
    got = _port_rollout(params, qs, xis, us, lin, k, K)
    for n, g, w in zip(("qs", "xis", "us"), got, want):
        assert g.dtype == torch.float32 and g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-5, err_msg=n)
    np.testing.assert_array_equal(got[0][:, 0].numpy(), np.asarray(qs[:, 0]))


def test_rollout_plain_matches_jax_scan_rollout_f64():
    """B14's plain version against the JAX `FastBatchSolver._rollout` scan
    (alpha = 1), f64 at 1e-10."""
    fast, params, qs, xis, us, lin, k, K = _rollout_case(jnp.float64)
    want = fast._rollout(params, lin, qs, xis, us, k, K)
    got = _port_rollout(params, qs, xis, us, lin, k, K)
    for n, g, w in zip(("qs", "xis", "us"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10, err_msg=n)
