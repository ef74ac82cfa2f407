"""The port's reference-exact `LieILQR` (`solvers/lie_ilqr.py`) against the
JAX package's on the same numpy inputs, f64, multiple shooting; single
shooting and the SO(3) problems are in test_torch_lie_ilqr_ss_so3.py.

The screw-tracking problem (R = 1e-3 I) cut to H = 16, a perturbed start,
every MS mode: backward sequential/sequential_fixed/associative x rollout
linear/nonlinear x line search on/off.  Gates: the same iteration count; J
and grad-norm histories rtol 1e-8 (grad norms also atol 1e-13: near
convergence they are differences of O(1) terms); controls atol 1e-8.  Each
`fit` runs to tol_grad_norm 1e-8, except with the nonlinear rollout and the
line search: there to 1e-5, because on this problem both packages' merit
tests stall on roundoff near grad 1e-7, and the iteration at which they
stall is then roundoff.

A batch of three equals three B = 1 solves (a converged problem is frozen
while the others iterate), `solve` equals the JAX jitted `solve`, a JAX
state continues in the port as in the JAX package (`convert`), and the MS
rollout on kernel B14 (``pallas_rollout_dt``; its plain version here)
equals the loop over stages (1e-12).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)

from torch_port_cases import check_fits, fit_both, lie_se3_case, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H = 16
MODES = [(bw, ro, ls) for bw, ro, ls in itertools.product(
    ("sequential", "sequential_fixed", "associative"), ("nonlinear", "linear"), (False, True))]


@pytest.fixture(scope="module")
def se3_case():
    return lie_se3_case(H)


@pytest.mark.parametrize("backward,rollout,ls", MODES, ids=[
    f"ms-{bw}-{ro}{'-ls' if ls else ''}" for bw, ro, ls in MODES])
def test_fit_matches_jax_se3(se3_case, backward, rollout, ls):
    jm, jp, tm, tp, q0s, xi0s, us0 = se3_case
    stall = rollout == "nonlinear" and ls
    cfg = dict(N=H, backward=backward, rollout=rollout, line_search=ls,
               tol_grad_norm=1e-5 if stall else 1e-8, max_iterations=30)
    jout, tout = fit_both(jm, jp, tm, tp, q0s[1], xi0s[1], us0[1], cfg)
    check_fits(jout, tout, rtol=1e-8, grad_atol=1e-13, us_atol=1e-8)


@pytest.mark.parametrize("cfg", [dict(), dict(line_search=True, rollout="linear"),
                                 dict(backward="associative", multiple_shooting=False)],
                         ids=["default", "ms-ls-linear", "ss-associative"])
def test_batch_equals_single_solves(se3_case, cfg):
    """Three problems solved together equal each solved alone: the same
    iteration count, controls to 1e-12."""
    _, _, tm, tp, q0s, xi0s, us0 = se3_case
    solver = LieILQR(tm, SolverConfig(N=H, tol_grad_norm=1e-8, max_iterations=30, **cfg))
    t = lambda x: torch.as_tensor(x)
    batch = solver.solve(tp, (t(q0s), t(xi0s)), t(us0))
    for b in range(3):
        one = solver.solve(tp, (t(q0s[b:b + 1]), t(xi0s[b:b + 1])), t(us0[b:b + 1]))
        assert int(batch.iteration[b]) == int(one.iteration[0])
        np.testing.assert_allclose(batch.us[b].numpy(), one.us[0].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(batch.J_opt[b].item(), one.J_opt[0].item(), rtol=1e-14)
    assert bool(((batch.iteration == 30) | batch.converged | batch.failed).all())


def test_solve_matches_jax_solve(se3_case):
    """`solve` (to convergence or max_iterations) against the JAX jitted
    `solve` on one problem."""
    jm, jp, tm, tp, q0s, xi0s, us0 = se3_case
    cfg = dict(N=H, tol_grad_norm=1e-8, max_iterations=4)
    js = JL.LieILQR(jm, JL.SolverConfig(**cfg)).solve(
        jp, (jnp.asarray(q0s[2]), jnp.asarray(xi0s[2])), jnp.asarray(us0[2]))
    ts = LieILQR(tm, SolverConfig(**cfg)).solve(
        tp, (torch.as_tensor(q0s[2:3]), torch.as_tensor(xi0s[2:3])), torch.as_tensor(us0[2:3]))
    assert int(ts.iteration[0]) == int(js.iteration) == 4
    np.testing.assert_allclose(ts.us[0].numpy(), np.asarray(js.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts.grad_norm[0].item(), float(js.grad_norm), rtol=1e-8)


@pytest.mark.parametrize("ls", [False, True], ids=["full-step", "line-search"])
def test_kernel_rollout_route_equals_the_loop(se3_case, ls):
    """``pallas_rollout_dt`` (the MS nonlinear rollout, every candidate at
    once, on B14; here its plain version) equals the loop over stages: the
    same iterations, controls to 1e-12."""
    _, _, tm, tp, q0s, xi0s, us0 = se3_case
    # with the line search, to 1e-5: below, its accept test stalls on roundoff
    cfg = SolverConfig(N=H, tol_grad_norm=1e-5 if ls else 1e-8, max_iterations=30,
                       line_search=ls)
    t = lambda x: torch.as_tensor(x)
    loop = LieILQR(tm, cfg).solve(tp, (t(q0s), t(xi0s)), t(us0))
    kern = LieILQR(tm, cfg, pallas_rollout_dt=0.01).solve(tp, (t(q0s), t(xi0s)), t(us0))
    assert kern.iteration.tolist() == loop.iteration.tolist()
    np.testing.assert_allclose(kern.us.numpy(), loop.us.numpy(), rtol=0, atol=1e-12)


def test_warm_start_from_a_jax_state(se3_case):
    """A JAX solver state after two iterations (`convert.lie_state_from_numpy`)
    continues in the port as in the JAX package: the same remaining
    iterations, controls at 1e-8."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
        lie_state_from_numpy,
    )

    jm, jp, tm, tp, q0s, xi0s, us0 = se3_case
    cfg = dict(N=H, tol_grad_norm=1e-8, max_iterations=30, line_search=True,
               rollout="linear")
    js = JL.LieILQR(jm, JL.SolverConfig(**cfg))
    x0 = (jnp.asarray(q0s[0]), jnp.asarray(xi0s[0]))
    mid = js.fit(jp, x0, jnp.asarray(us0[0]), n_iterations=2)[5]
    jout = js.fit(jp, x0, None, state=mid)
    state = lie_state_from_numpy({k: np.asarray(v) for k, v in mid._asdict().items()})
    assert tuple(state.qs.shape) == (1, H + 1, 4, 4) and tuple(state.mu.shape) == (1,)
    tout = LieILQR(tm, SolverConfig(**cfg)).fit(tp, None, None, state=state)
    assert len(tout[2]) == len(jout[2])
    np.testing.assert_allclose(tout[1][0].numpy(), np.asarray(jout[1]), rtol=0, atol=1e-8)
    assert int(tout[5].iteration[0]) == int(jout[5].iteration)
