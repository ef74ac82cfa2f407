"""The port's `ALFastSolver` (its inner `FastBatchSolver` on B13 and B14's
plain versions) against the JAX one on its XLA path (``use_pallas=False``),
f64 at 1e-8, on the reference's AL problem (`build_al1400`, R = 0) cut to
H = 10 with the box at +-9, where it binds: `solve`, `solve_in_graph`
(equal to `solve` when every lane converges, as
tests/test_al_rescue.py:58-86 holds the JAX pair), and B13's plain version
against the loop backward on the AL problem's linearization.  The rescue
is in test_torch_al_rescue.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)

from torch_port_cases import al_fast_pair, al_problem, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B, ITERS, NAL, BOX = 10, 3, 4, 10, 9.0
TOL = dict(rtol=0, atol=1e-8)


def _case(**port_kw):
    jp, tp, q0s, xi0s, us0 = al_problem(H, jnp.float64, seed=0, B=B)
    js, jparams, ts, tparams = al_fast_pair(jp, tp, H, BOX, ITERS, **port_kw)
    T = torch.as_tensor
    return js, jparams, ts, tparams, (q0s, xi0s, us0), (T(q0s), T(xi0s), T(us0))


def _check(tres, jres, tol=TOL):
    for f in ("us", "J_opt", "constr_eval", "max_violation", "qs", "xis"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   err_msg=f, **tol)
    for f in ("lmbd", "Imu", "mu"):
        np.testing.assert_allclose(getattr(tres.al_params, f).numpy(),
                                   np.asarray(getattr(jres.al_params, f)), err_msg=f,
                                   rtol=1e-8, atol=1e-8)
    assert tres.outer_iterations == jres.outer_iterations
    assert bool(tres.constr_converged) == bool(jres.constr_converged)


@pytest.fixture(scope="module")
def solved():
    js, jparams, ts, tparams, jin, tin = _case()
    jres = js.solve(jparams, *jin, n_al_iters=NAL)
    tres = ts.solve(tparams, *tin, n_al_iters=NAL)
    return dict(js=js, jparams=jparams, ts=ts, tparams=tparams, jin=jin, tin=tin,
                jres=jres, tres=tres)


def test_al_fast_solve_matches_jax(solved):
    tres, jres = solved["tres"], solved["jres"]
    assert tres.constr_converged and tres.outer_iterations > 2
    assert (tres.us.abs() >= BOX - 1e-3).sum() >= 10, "the box does not bind"
    # the multipliers became per problem after the first update
    assert tres.al_params.lmbd.shape == (B, H + 1, 12)
    _check(tres, jres)


def test_al_fast_solve_in_graph_matches_jax_and_solve(solved):
    """No rescue: the in-graph loop runs the full budget with per-problem
    freeze, which re-solves converged problems to the same iterate, so it
    equals `solve` exactly; and it equals the JAX in-graph solve."""
    s = solved
    tres = s["ts"].solve_in_graph(s["tparams"], *s["tin"], n_al_iters=NAL)
    jres = s["js"].solve_in_graph(s["jparams"], *s["jin"], n_al_iters=NAL)
    _check(tres, jres)
    for f in ("us", "max_violation"):
        assert torch.equal(getattr(tres, f), getattr(s["tres"], f)), f
    assert isinstance(tres.constr_converged, torch.Tensor) and bool(tres.constr_converged)


def test_b13_plain_matches_loop_backward_on_the_al_problem(solved):
    """B13's plain version (the kernel's reference on the card) against the
    solver's loop backward on the linearization of an AL iterate with
    per-problem multipliers, then the whole AL solve on each backward."""
    s = solved
    ts = s["ts"]
    al = costs.al_update_params(s["tparams"]["cost"], s["tres"].constr_eval,
                                freeze=torch.tensor([False, True, False]))
    params = {"dyn": s["tparams"]["dyn"], "cost": al}
    res = s["tres"]
    lin = ts.inner._linearize(params, res.qs, res.xis, res.us)
    loop = FastBatchSolver(ts.inner.model, H, ITERS, use_pallas=False)
    for a, b, name in zip(ts.inner._backward(lin), loop._backward(lin), ("k", "K", "Vx1", "Vxx1")):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10 * scale,
                                   err_msg=name)
    loop_res = type(ts)(loop, ts.constraint).solve(s["tparams"], *s["tin"], n_al_iters=NAL)
    np.testing.assert_allclose(loop_res.us.numpy(), res.us.numpy(), rtol=0, atol=1e-9)
    assert loop_res.outer_iterations == res.outer_iterations


def test_al_fast_refuses_the_plain_tracking_linearization():
    jp, tp, *_ = al_problem(4)
    with pytest.raises(ValueError):
        al_fast_pair(jp, tp, 4, BOX, 1, use_pallas_linearize=True)
