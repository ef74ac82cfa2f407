"""The rescue of the port's `ALFastSolver` against the JAX one's, f64 at
1e-8: `solve(rescue=True)` (the host re-solve of the failing lanes with
the line-searched inner) and `solve_in_graph(rescue=True)` (the masked
re-solve of every lane).  The case: lanes 0 and 7 of seed 0 on the
reference's AL problem cut to H = 6 with the box at +-8 and 8 AL outers;
the fixed-budget inner leaves lane 7 limit-cycling at a violation of ~1
(tests/test_al_fast.py:77-117's premise), the line search converges it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_cases import al_fast_pair, al_problem, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, ITERS, NAL, BOX, RESCUE_OUTERS = 6, 4, 8, 8.0, 8


@pytest.fixture(scope="module")
def case():
    jp, tp, q0s, xi0s, us0 = al_problem(H, jnp.float64, seed=0, lanes=(0, 7))
    js, jparams, ts, tparams = al_fast_pair(jp, tp, H, BOX, ITERS)
    T = torch.as_tensor
    return dict(js=js, jparams=jparams, ts=ts, tparams=tparams, jin=(q0s, xi0s, us0),
                tin=(T(q0s), T(xi0s), T(us0)))


def _check(tres, jres):
    for f in ("us", "J_opt", "constr_eval", "max_violation", "qs", "xis"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    assert bool(tres.constr_converged) == bool(jres.constr_converged)


def test_rescue_converges_the_hard_lane_as_jax(case):
    c = case
    fast = c["ts"].solve(c["tparams"], *c["tin"], n_al_iters=NAL)
    assert not fast.constr_converged
    assert float(fast.max_violation[0]) < 1e-2 < float(fast.max_violation[1])
    tres = c["ts"].solve(c["tparams"], *c["tin"], n_al_iters=NAL, rescue=True)
    jres = c["js"].solve(c["jparams"], *c["jin"], n_al_iters=NAL, rescue=True)
    assert tres.constr_converged
    _check(tres, jres)
    # the easy lane keeps the fast pass's solution
    assert torch.equal(tres.us[0], fast.us[0])
    assert float(tres.us.abs().max()) <= BOX + 1e-2


def test_in_graph_rescue_matches_jax(case):
    c = case
    kw = dict(n_al_iters=NAL, rescue=True, rescue_outers=RESCUE_OUTERS)
    tres = c["ts"].solve_in_graph(c["tparams"], *c["tin"], **kw)
    jres = c["js"].solve_in_graph(c["jparams"], *c["jin"], **kw)
    assert bool(tres.constr_converged)
    _check(tres, jres)
    for f in ("lmbd", "Imu", "mu"):
        np.testing.assert_allclose(getattr(tres.al_params, f).numpy(),
                                   np.asarray(getattr(jres.al_params, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
