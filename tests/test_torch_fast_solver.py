"""The port's generic fast tier (`solvers/batched.FastBatchSolver`) against
the JAX `FastBatchSolver` on the same numpy inputs, H = 20, B = 3,
3 iterations (the line search: H = 40, 6 iterations):

- the SE(3) free body on all three kernels' plain versions (B1, B13, B14),
  f32 against the JAX kernels in interpret mode at
  `torch_port_cases.check_solves`' f32 tolerances, f64 against the JAX XLA
  path at `tests/test_batched_fast.py`'s us atol 1e-8;
- the drone (nu = 4) on B13, the same way;
- the SO(3) free attitude on B13, f64 at us 1e-6 and J rtol 1e-7 (the JAX
  closed forms of Jr, Jr^-1 cancel at small angles where the port's lane
  series do not: `tests/test_torch_pipeline_so3.py`);
- the per-lane merit line search, f64, against JAX ``line_search=True``;
- the free body against the port's own `PipelineSolver`, f64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SO3 as JSO3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver as JaxFastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tcosts
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as tdyn
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

from test_torch_pipeline_so3 import initial_batch as so3_initial_batch
from test_torch_pipeline_so3 import problem as so3_problem
from torch_port_cases import check_solves, initial_batch, problem

H, B, ITERS = 20, 3, 3
T = lambda x: torch.as_tensor(np.array(x))


def _models(kind, dtype, H_=H):
    """(jax model, jax params, port model, port params, q0, xi0, nu) of the
    screw problem (free body or drone) or the free attitude, in ``dtype``."""
    if kind == "so3":
        dp, cp, tdp, tcp = so3_problem("so3_track249", H_, dtype)
        jm, jp = jmake(jdyn.so3_dynamics(),
                       jcosts.tracking_cost(JSO3, 3, ref_so3_terminal_quirk=True), dp, cp)
        tm, tp = make_model(tdyn.so3_dynamics(),
                            tcosts.tracking_cost(SO3, 3, ref_so3_terminal_quirk=True), tdp, tcp)
        return jm, jp, tm, tp, None, None, 3
    drone = kind == "drone"
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H_, dtype, drone=drone)
    jdef, tdef = ((jdyn.drone_dynamics(), tdyn.drone_dynamics()) if drone
                  else (jdyn.se3_dynamics(), tdyn.se3_dynamics()))
    jm, jp = jmake(jdef, jcosts.tracking_cost(JSE3, nu), dp, cp)
    tm, tp = make_model(tdef, tcosts.tracking_cost(SE3, nu), tdp, tcp)
    return jm, jp, tm, tp, q0, xi0, nu


def _solve_both(kind, dtype, jax_kw, port_kw, seed=0):
    jm, jp, tm, tp, q0, xi0, nu = _models(kind, dtype)
    if kind == "so3":
        q0s, xi0s, us0 = so3_initial_batch(B, H, seed, dtype)
    else:
        q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed, dtype)
    cp, tcp = jp["cost"], tp["cost"]
    jout = JaxFastBatchSolver(jm, N=H, iterations=ITERS, **jax_kw).solve(
        jp, q0s, xi0s, us0, cp.q_ref, cp.xi_ref)
    tout = F.FastBatchSolver(tm, H, ITERS, **port_kw).solve(
        tp, T(q0s), T(xi0s), T(us0), tcp.q_ref, tcp.xi_ref)
    return jout, tout


def _kernels(kind, dtype):
    """The port's kernel configuration of ``kind``: B1, B13 and B14 for the
    free body (B14 needs the time step), B13 alone for the others."""
    if kind != "free_body":
        return {}
    dt = float(problem(2, dtype)[0].dt)
    return dict(pallas_rollout_dt=dt, use_pallas_linearize=True)


@pytest.mark.parametrize("kind", ["free_body", "drone"])
def test_fast_solver_f32_matches_jax_kernels(kind):
    """f32, the port's plain kernels against the JAX kernels in interpret
    mode (the same configuration on both sides)."""
    kw = _kernels(kind, jnp.float32)
    jout, tout = _solve_both(kind, jnp.float32, dict(interpret=True, **kw), kw)
    check_solves(jout, tout, jnp.float32)


@pytest.mark.parametrize("kind", ["free_body", "drone"])
def test_fast_solver_f64_matches_jax_xla(kind):
    """f64, the port's plain kernels against the JAX XLA path
    (``use_pallas=False``): us at 1e-8, J at rtol 1e-10."""
    jout, tout = _solve_both(kind, jnp.float64, dict(use_pallas=False),
                             _kernels(kind, jnp.float64))
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), rtol=1e-10)
    np.testing.assert_allclose(tout.grad_norm.numpy(), np.asarray(jout.grad_norm),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tout.qs.numpy(), np.asarray(jout.qs), rtol=0, atol=1e-9)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["b13", "loop_backward"])
def test_fast_solver_so3_matches_jax(use_pallas):
    """The SO(3) free attitude (nx = 6, nu = 3), f64, B13's plain version or
    the loop backward against the JAX XLA path: us 1e-6, J rtol 1e-7."""
    jout, tout = _solve_both("so3", jnp.float64, dict(use_pallas=False),
                             dict(use_pallas=use_pallas))
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), rtol=1e-7)
    assert tout.qs.shape == (B, H + 1, 3, 3) and tout.xis.shape == (B, H + 1, 3)


def test_fast_solver_loop_backward_f32_matches_jax_xla():
    """``use_pallas=False`` in f32 (the linear-solve backward) against the
    JAX XLA path in f32, at check_solves' f32 tolerances."""
    jout, tout = _solve_both("free_body", jnp.float32, dict(use_pallas=False),
                             dict(use_pallas=False))
    check_solves(jout, tout, jnp.float32)


def test_line_search_matches_jax_and_takes_short_steps():
    """``line_search=True``, f64, H = 40, B = 3, 6 iterations from poses
    perturbed by Exp(0.4 n) and twists shifted by 0.3 (so that short steps
    get chosen): us and xis at 1e-8 against JAX ``line_search=True``, as
    `tests/test_batched_fast.py` holds JAX against the reference engine; the
    result differs from the full-step solve."""
    H_, iters = 40, 6
    jm, jp, tm, tp, q0, xi0, _ = _models("free_body", jnp.float64, H_)
    dq = 0.4 * np.random.default_rng(3).standard_normal((B, 6))
    q0s = np.asarray(JSE3.normalize(jnp.asarray(q0)[None] @ JSE3.exp(jnp.asarray(dq))))
    xi0s = np.broadcast_to(xi0, (B, 6)) + 0.3
    us0 = np.zeros((B, H_, 6))
    cp, tcp = jp["cost"], tp["cost"]
    jout = JaxFastBatchSolver(jm, N=H_, iterations=iters, use_pallas=False,
                              line_search=True).solve(jp, q0s, xi0s, us0, cp.q_ref, cp.xi_ref)
    mk = lambda ls: F.FastBatchSolver(tm, H_, iters, line_search=ls)
    tout = mk(True).solve(tp, T(q0s), T(xi0s), T(us0), tcp.q_ref, tcp.xi_ref)
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tout.xis.numpy(), np.asarray(jout.xis), rtol=0, atol=1e-8)
    full = mk(False).solve(tp, T(q0s), T(xi0s), T(us0), tcp.q_ref, tcp.xi_ref)
    assert (full.us - tout.us).abs().max() > 1e-3


def test_probe_prefix_matches_jax_associative_scan():
    """`_probe_errs`' prefix over stages against the JAX associative scan,
    f64 at 1e-12 (the same affine maps composed in another order)."""
    jm, jp, tm, tp, q0, xi0, nu = _models("free_body", jnp.float64)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, 4, jnp.float64, u_scale=0.1)
    jfast = JaxFastBatchSolver(jm, N=H, iterations=1, use_pallas=False)
    qs = jnp.concatenate([jnp.asarray(q0s)[:, None],
                          jnp.broadcast_to(jp["cost"].q_ref[1:], (B, H, 4, 4))], axis=1)
    xis = jnp.concatenate([jnp.asarray(xi0s)[:, None],
                           jnp.broadcast_to(jp["cost"].xi_ref[1:], (B, H, 6))], axis=1)
    lin = jfast._linearize(jp, qs, xis, jnp.asarray(us0))
    k, K, _, _ = jfast._backward(lin)
    want = jfast._probe_errs(lin, k, K)
    tlin = {n: T(v) for n, v in lin.items()}
    got = F.FastBatchSolver(tm, H, 1)._probe_errs(tlin, T(k), T(K))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_fast_solver_matches_port_pipeline():
    """The free body on all three kernels against the port's
    `PipelineSolver` (the same iterates), f64, H = 16: us to 1e-10."""
    H_ = 16
    model, params, q0, xi0 = al_bench.screw200_model(torch.float64, "cpu", horizon=H_)
    q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed=5)
    us0 = torch.zeros((B, H_, 6), dtype=torch.float64)
    dyn, cost = params["dyn"], params["cost"]
    fast = F.FastBatchSolver(model, H_, 4, pallas_rollout_dt=float(dyn.dt),
                             use_pallas_linearize=True).solve(
        params, q0s, xi0s, us0, cost.q_ref, cost.xi_ref)
    pipe = PipelineSolver(H_, 4, float(dyn.dt)).solve(dyn, cost, q0s, xi0s, us0)
    torch.testing.assert_close(fast.us, pipe.us, rtol=0, atol=1e-10)
    torch.testing.assert_close(fast.J_opt, pipe.J_opt, rtol=1e-12, atol=0)


@pytest.mark.parametrize("make", [
    lambda **kw: al_bench.screw200_model(torch.float32, **kw),
    lambda **kw: al_bench.screw200_model(torch.float32, drone=True, **kw),
    lambda **kw: so3_bench.so3_track249_model(torch.float32, **kw)],
    ids=["free_body", "drone", "so3_track249"])
def test_model_builders_ask_for_the_card(make):
    """The model builders put their problem on the card unless given a
    device, and a FastBatchSolver solve given numpy inputs runs on the card:
    here, with no CUDA device, both fail with torch's CUDA error."""
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    with pytest.raises(AssertionError, match="CUDA"):
        make()
    model, params, q0, xi0 = make(device="cpu", horizon=4)
    m = q0.shape[-1]
    inputs = (np.broadcast_to(q0.numpy(), (2, m, m)), np.zeros((2, xi0.shape[0]), np.float32),
              np.zeros((2, 4, model.nu), np.float32))
    cp = params["cost"]
    with pytest.raises(AssertionError, match="CUDA"):
        F.FastBatchSolver(model, 4, 1).solve(params, *inputs, cp.q_ref.numpy(),
                                             cp.xi_ref.numpy())
