"""The port's reference-exact `LieILQR` (`solvers/lie_ilqr.py`) against the
JAX package's on the same numpy inputs, f64: single shooting on SE(3), and
multiple shooting on the SO(3) problems (test_torch_lie_ilqr.py has the MS
modes on SE(3)).

SE(3), single shooting: the screw-tracking problem (R = 1e-3 I) cut to
H = 16, a perturbed start, backward sequential/sequential_fixed/associative
x rollout linear/nonlinear (SS always backtracks).  Gates as in
test_torch_lie_ilqr.py: the same iteration count; J and grad-norm histories
rtol 1e-8 (grad norms also atol 1e-13); controls atol 1e-8.  Each `fit`
runs to tol_grad_norm 1e-8, except with the nonlinear rollout: there to
1e-5, because on this problem both packages' backtracking stalls on
roundoff near grad 6e-6.

SO(3): the free attitude (so3_track249, with and without the merit line
search) and the pendulum (pendulum_swingup80) cut to H = 20, MS, to 1e-7,
at rtol 1e-6 on the histories (atol 1e-9 on the grad norms) and atol 1e-6 on
the controls (the port's series for the Q-matrix and Jl^-1 coefficients
against the JAX closed forms, ROADMAP.md C).
"""

import itertools

import numpy as np
import pytest

from torch_port_cases import (  # noqa: F401
    check_fits,
    fit_both,
    lie_se3_case,
    one_cpu_thread,
    so3_case,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H = 16
SS_MODES = list(itertools.product(("sequential", "sequential_fixed", "associative"),
                                  ("nonlinear", "linear")))


@pytest.fixture(scope="module")
def se3_case():
    return lie_se3_case(H)


@pytest.mark.parametrize("backward,rollout", SS_MODES,
                         ids=[f"ss-{bw}-{ro}" for bw, ro in SS_MODES])
def test_fit_matches_jax_se3_single_shooting(se3_case, backward, rollout):
    jm, jp, tm, tp, q0s, xi0s, us0 = se3_case
    cfg = dict(N=H, multiple_shooting=False, backward=backward, rollout=rollout,
               tol_grad_norm=1e-5 if rollout == "nonlinear" else 1e-8, max_iterations=30)
    jout, tout = fit_both(jm, jp, tm, tp, q0s[1], xi0s[1], us0[1], cfg)
    check_fits(jout, tout, rtol=1e-8, grad_atol=1e-13, us_atol=1e-8)


@pytest.mark.parametrize("name,ls", [("so3_track249", False), ("so3_track249", True),
                                     ("pendulum_swingup80", False)])
def test_fit_matches_jax_so3(name, ls):
    jm, jp, tm, tp, q0, xi0 = so3_case(name, 20)
    cfg = dict(N=20, line_search=ls, tol_grad_norm=1e-7, max_iterations=40)
    jout, tout = fit_both(jm, jp, tm, tp, q0, xi0, np.zeros((20, 3)), cfg)
    check_fits(jout, tout, rtol=1e-6, grad_atol=1e-9, us_atol=1e-6)
