"""The port's `ALILQR` (`solvers/al_ilqr.py`) against the JAX package's on
the reference's AL problem (`build_al1400`: R = 0) cut to H = 16 with the
input box at +-9, where it binds (the solution rails at 9), f64, the inner
`LieILQR` to tol_grad_norm 1e-8.

Gates: the same outer count and inner iteration count at every outer; the
multipliers at rtol 1e-6 (atol 1e-12); the controls at atol 1e-8; the
penalty exactly.  A batch of two problems equals each problem's B = 1
loop: the second, started on the reference, is met at the first outer and
frozen while the first goes on (the controls at 1e-12, the multipliers at
rtol 1e-10).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import constraints as jcs
from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jd
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers import al_ilqr as JA
from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import al_result_from_numpy
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_ilqr import ALILQR
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)

from torch_port_cases import al_problem, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, BOX, OUTERS, INNERS = 16, 9.0, 20, 60
CFG = dict(N=H, tol_grad_norm=1e-8, max_iterations=100)


@pytest.fixture(scope="module")
def case():
    jp, tp, q0s, xi0s, us0 = al_problem(H, B=2)
    # problem 1 starts on the reference: its box is met at the first outer
    q0s[1], xi0s[1] = tp["cost"].q_ref[0].numpy(), tp["cost"].xi_ref[0].numpy()
    jcon = jcs.input_box(12, 6)
    jm, _ = jmm(jd.se3_dynamics(), jc.al_cost(jc.tracking_cost(JSE3, 6), jcon), jp["dyn"], None)
    jalp = jc.al_init_params(jp["cost"], jcs.input_box_params(-BOX, BOX, 6), H, 12, mu0=1e-2)
    jres = JA.ALILQR(JL.LieILQR(jm, JL.SolverConfig(**CFG)), jcon).fit(
        {"dyn": jp["dyn"], "cost": jalp}, (jnp.asarray(q0s[0]), jnp.asarray(xi0s[0])),
        jnp.asarray(us0[0]), n_al_iters=OUTERS, n_ilqr_iters=INNERS)
    tcon = cs.input_box(12, 6)
    tm, _ = make_model(td.se3_dynamics(), tc.al_cost(tc.tracking_cost(SE3, 6), tcon),
                       tp["dyn"], None)
    talp = tc.al_init_params(tp["cost"], cs.input_box_params(-BOX, BOX, 6), H, 12, mu0=1e-2)
    solver = ALILQR(LieILQR(tm, SolverConfig(**CFG)), tcon)
    t = torch.as_tensor

    def fit(lanes):
        return solver.fit({"dyn": tp["dyn"], "cost": talp}, (t(q0s[lanes]), t(xi0s[lanes])),
                          t(us0[lanes]), n_al_iters=OUTERS, n_ilqr_iters=INNERS)

    return jres, fit


def test_al_ilqr_matches_jax(case):
    jres, fit = case
    res = fit([0])
    assert res.constr_converged and jres.constr_converged
    assert res.outer_iterations == jres.outer_iterations
    assert ([len(h["J"]) for h in res.inner_histories]
            == [len(h["J"]) for h in jres.inner_histories])
    # the box binds: the unconstrained optimum leaves it, the solution rails
    assert float(jnp.max(jnp.abs(jres.us))) > BOX - 1e-6
    fields = jres._asdict()
    fields["al_params"] = {
        "cost": {k: np.asarray(v) for k, v in jres.al_params.cost._asdict().items()},
        "constr": {k: np.asarray(v) for k, v in jres.al_params.constr._asdict().items()},
        **{k: np.asarray(getattr(jres.al_params, k)) for k in ("lmbd", "Imu", "mu")}}
    fields.update({k: np.asarray(fields[k]) for k in ("qs", "xis", "us", "constr_eval")})
    want = al_result_from_numpy(fields)
    np.testing.assert_allclose(res.al_params.lmbd[0].numpy(), want.al_params.lmbd.numpy(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.al_params.Imu[0].numpy(), want.al_params.Imu.numpy(),
                               rtol=1e-6, atol=1e-12)
    assert float(res.al_params.mu[0]) == float(want.al_params.mu)
    np.testing.assert_allclose(res.us.numpy(), want.us.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.constr_eval.numpy(), want.constr_eval.numpy(), rtol=0,
                               atol=1e-8)


def test_al_ilqr_batch_equals_single_loops(case):
    _, fit = case
    both = fit([0, 1])
    singles = [fit([b]) for b in (0, 1)]
    assert singles[1].outer_iterations == 1 < singles[0].outer_iterations
    assert both.outer_iterations == singles[0].outer_iterations
    assert both.constr_converged
    for b, s in enumerate(singles):
        np.testing.assert_allclose(both.us[b].numpy(), s.us[0].numpy(), rtol=0, atol=1e-12)
        lm = s.al_params.lmbd[0] if s.al_params.lmbd.dim() == 3 else s.al_params.lmbd
        np.testing.assert_allclose(both.al_params.lmbd[b].numpy(), lm.numpy(), rtol=1e-10,
                                   atol=1e-14)
        assert float(both.al_params.mu[b]) == float(s.al_params.mu.reshape(-1)[0])
