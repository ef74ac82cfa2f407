"""The port's error-state tier (`models/errorstate.py`,
`solvers/errorstate_ilqr.py`) against the JAX package's on the same numpy
inputs, f64, on `tests/test_errorstate.py`'s problems (the anchor the
nominal rollout of zero controls from the identity with the twist
(0.3, 0.2, 0.5, 1, 1, 1), dt = 0.01) at N = 40.

Gates: the model functions (`fc_errstate`, both steps, `group_step`,
`rollout_nominal`, `reanchor`, both costs) to 1e-12; the quantities built
on `se3.log` (`goal_cost_params`' phi_goal, the re-logged initial error
state) to 1e-8 (the port's Log uses series where the JAX closed forms
cancel); `jac_autodiff` against `jac_analytic` for the Euler step to 1e-12
(it is exact) and against the JAX `jac_autodiff` to 1e-12.  Each mode's
`fit` against the JAX `fit`: the same iteration count and the same
converged/failed/accepted flags after each iteration, J and grad-norm
histories rtol 1e-8, controls atol 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import errorstate as jes
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers import errorstate_ilqr as JE
from trajectory_optimization_matrix_lie_groups_tpu_torch import convert as C
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import errorstate as es
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.errorstate_ilqr import (
    ErrorStateILQR,
    ESConfig,
)

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

N = 40
T = lambda x: torch.as_tensor(np.array(x))
F = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}


def _jax_params(n=N):
    J = jnp.block([[jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
                   [jnp.zeros((3, 3)), jnp.eye(3)]])
    xi0 = jnp.array([0.3, 0.2, 0.5, 1.0, 1.0, 1.0])
    p0 = jes.errorstate_params(J, 0.01, jnp.zeros((n + 1, 4, 4)), jnp.zeros((n + 1, 6)))
    qs, xis = jes.rollout_nominal(p0, jnp.eye(4), xi0, jnp.zeros((n, 6)))
    return jes.reanchor(p0, qs, xis), xi0


@pytest.fixture(scope="module")
def case():
    """(JAX params, port params, numpy draws x (N, 12), u (N, 6), the goal
    pose) from seed 0."""
    jp, xi0 = _jax_params()
    rng = np.random.default_rng(0)
    x = np.concatenate([0.1 * rng.standard_normal((N, 6)),
                        np.asarray(jp.xi_ref[:N]) + 0.2 * rng.standard_normal((N, 6))], axis=-1)
    u = rng.standard_normal((N, 6))
    X_goal = JSE3.exp(jnp.array([0.0, 0.0, jnp.pi / 4, 0.0, 0.0, 0.0])).at[:3, 3].set(
        jnp.array([1.0, 1.0, 1.0]))
    return jp, C.errorstate_params_from_numpy(F(jp)), x, u, np.asarray(X_goal)


def close(a, b, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_params_match_jax(case):
    jp, _, _, _, _ = case
    tp = es.errorstate_params(T(jp.J), 0.01, T(jp.q_ref), T(jp.xi_ref))
    for name in jp._fields:
        close(getattr(tp, name), getattr(jp, name))


@pytest.mark.parametrize("fn", ["fc_errstate", "step_euler", "step_rk4"])
def test_error_state_steps_match_jax(case, fn):
    """Batched over the stages (the stage index a tensor) and at one stage
    (an int), to 1e-12."""
    jp, tp, x, u, _ = case
    idx = np.arange(N)
    close(getattr(es, fn)(tp, T(x), T(u), T(idx)),
          getattr(jes, fn)(jp, jnp.asarray(x), jnp.asarray(u), jnp.asarray(idx)))
    close(getattr(es, fn)(tp, T(x[7]), T(u[7]), 7),
          getattr(jes, fn)(jp, jnp.asarray(x[7]), jnp.asarray(u[7]), 7))


def test_group_step_rollout_and_reanchor_match_jax(case):
    jp, tp, x, u, _ = case
    rng = np.random.default_rng(1)
    q = np.asarray(JSE3.exp(jnp.asarray(rng.standard_normal((N, 6)))))
    close(es.group_step(tp, T(q), T(x[:, 6:]), T(u), 0)[0],
          jes.group_step(jp, jnp.asarray(q), jnp.asarray(x[:, 6:]), jnp.asarray(u), 0)[0])
    close(es.group_step(tp, T(q), T(x[:, 6:]), T(u), 0)[1],
          jes.group_step(jp, jnp.asarray(q), jnp.asarray(x[:, 6:]), jnp.asarray(u), 0)[1])
    qs, xis = es.rollout_nominal(tp, T(q[0]), T(x[0, 6:]), T(0.1 * u))
    jqs, jxis = jes.rollout_nominal(jp, jnp.asarray(q[0]), jnp.asarray(x[0, 6:]),
                                    jnp.asarray(0.1 * u))
    close(qs, jqs)
    close(xis, jxis)
    # batched over leading axes: two starts at once equal each alone
    qs2, _ = es.rollout_nominal(tp, T(q[:2]), T(x[:2, 6:]), T(0.1 * u).expand(2, N, 6))
    close(qs2[1], es.rollout_nominal(tp, T(q[1]), T(x[1, 6:]), T(0.1 * u))[0])
    rp = es.reanchor(tp, qs, xis)
    close(rp.q_ref, jqs)
    close(rp.xi_ref, jxis)
    close(rp.J, jp.J)


def test_costs_match_jax(case):
    """Both costs, stage and terminal, to 1e-12; phi_goal (closed-form Log
    against the port's series) to 1e-8."""
    jp, tp, x, u, X_goal = case
    idx = np.arange(N)
    jtc = jes.ErrorStateTrackingCostParams(Q=jnp.eye(12), R=1e-3 * jnp.eye(6),
                                           P=10.0 * jnp.eye(12), xi_ref=jp.xi_ref)
    ttc = C.es_tracking_cost_from_numpy(F(jtc))
    Q, R, P = np.diag(np.arange(1.0, 7.0)), 0.5 * np.eye(6), 1e3 * np.eye(6)
    jgc = jes.goal_cost_params(Q, R, P, jp.q_ref, X_goal)
    tgc = es.goal_cost_params(T(Q), T(R), T(P), tp.q_ref, T(X_goal))
    close(tgc.phi_goal, jgc.phi_goal, atol=1e-8)
    tgc = C.es_goal_cost_from_numpy(F(jgc))   # the same phi_goal for the costs
    for jf, tf, jc, tc in ((jes.tracking_cost_es, es.tracking_cost_es, jtc, ttc),
                           (jes.goal_cost, es.goal_cost, jgc, tgc)):
        close(tf(tc, T(x), T(u), T(idx)), jf(jc, jnp.asarray(x), jnp.asarray(u),
                                              jnp.asarray(idx)))
        close(tf(tc, T(x[-1]), T(u[0]) * 0, N, terminal=True),
              jf(jc, jnp.asarray(x[-1]), jnp.zeros(6), N, terminal=True))


def test_jacobians(case):
    """`jac_autodiff` (torch.func.jacfwd, vmapped over stages) against the
    JAX one, and the Euler step's autodiff against `jac_analytic` (exact)."""
    jp, tp, x, u, _ = case
    idx = np.arange(N)
    jac = es.jac_autodiff(es.step_euler)
    fx, fu = torch.func.vmap(lambda a, b, i: jac(tp, a, b, i))(T(x), T(u), T(idx))
    jfx, jfu = jax.vmap(lambda a, b, i: jes.jac_autodiff(jes.step_euler)(jp, a, b, i))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(idx))
    close(fx, jfx)
    close(fu, jfu)
    ax, au = es.jac_analytic(tp, T(x), T(u), T(idx))
    close(ax, fx)
    close(au, fu)
    jax_ax, jax_au = jes.jac_analytic(jp, jnp.asarray(x), jnp.asarray(u), jnp.asarray(idx))
    close(ax, jax_ax)
    close(au, jax_au)


def test_derivative_compare(case):
    """The runtime check as the JAX test holds it: Euler exact at and off
    the anchor, RK4 warns; each report equal to the JAX one."""
    jp, tp, _, _, _ = case
    cfg = dict(N=N, mode="tracking", derivative_compare=True)
    xs = np.concatenate([np.zeros((N + 1, 6)), np.asarray(jp.xi_ref)], axis=-1)
    us = np.zeros((N, 6))
    off = xs.copy()
    off[:, 6:] += 0.5
    for step, jstep in ((es.step_euler, jes.step_euler), (es.step_rk4, jes.step_rk4)):
        port = ErrorStateILQR(ESConfig(**cfg), cost=lambda *a, **k: 0.0, step=step)
        jax_s = JE.ErrorStateILQR(JE.ESConfig(**cfg), cost=lambda *a, **k: 0.0, step=jstep)
        for traj in (xs, off):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                rep = port.derivative_compare(tp, T(traj), T(us), tol=1e-9)
                jrep = jax_s.derivative_compare(jp, jnp.asarray(traj), jnp.asarray(us), tol=1e-9)
            assert rep["within_tol"] == jrep["within_tol"] == (step is es.step_euler)
            for dev in ("fx_max_dev", "fu_max_dev"):
                np.testing.assert_allclose(rep[dev], jrep[dev], rtol=1e-6, atol=1e-14)
            if step is es.step_euler:
                assert rep["fx_max_dev"] < 1e-12 and rep["fu_max_dev"] < 1e-12
            else:
                assert rep["fx_max_dev"] > 1e-9
                assert any("derivative_compare" in str(m.message) for m in w)


def _fit_both(cfg, jcost, tcost, jcp, tcp, jp, tp, x0=None, jreanchor=None, treanchor=None):
    """(JAX fit, its flags after each iteration, port fit, its flags)."""
    jflags, tflags = [], []
    flags = lambda s, out: out.append((bool(s.converged), bool(s.failed), bool(s.accepted)))
    jout = JE.ErrorStateILQR(JE.ESConfig(**cfg), jcost, reanchor_cost=jreanchor).fit(
        jcp, jp, jnp.zeros((N, 6)), on_iteration=lambda s: flags(s, jflags),
        x0=None if x0 is None else jnp.asarray(x0))
    tout = ErrorStateILQR(ESConfig(**cfg), tcost, reanchor_cost=treanchor).fit(
        tcp, tp, torch.zeros((N, 6), dtype=torch.float64),
        on_iteration=lambda s: flags(s, tflags), x0=None if x0 is None else T(x0))
    return jout, jflags, tout, tflags


def _check_fit(jout, jflags, tout, tflags):
    assert len(tout[1]) == len(jout[1])
    assert tflags == jflags
    np.testing.assert_allclose(tout[1], jout[1], rtol=1e-8)
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-8)
    close(tout[0].us, jout[0].us, atol=1e-6)
    close(tout[0].qs, jout[0].qs, atol=1e-6)


@pytest.mark.parametrize("rollout", ["linear", "nonlinear"])
def test_tracking_fit_matches_jax(case, rollout):
    """'tracking' from a perturbed error state (`init_state(x0=...)`),
    R = 1e-3 I, 10 step sizes, to grad 1e-6."""
    jp, tp, _, _, _ = case
    jcp = jes.ErrorStateTrackingCostParams(Q=jnp.eye(12), R=1e-3 * jnp.eye(6),
                                           P=10.0 * jnp.eye(12), xi_ref=jp.xi_ref)
    x0 = np.concatenate([[0.05, -0.03, 0.08, 0.2, -0.1, 0.15], np.asarray(jp.xi_ref[0]) + 0.05])
    cfg = dict(N=N, mode="tracking", rollout=rollout, n_alphas=10, tol_grad_norm=1e-6,
               max_iterations=30)
    _check_fit(*_fit_both(cfg, jes.tracking_cost_es, es.tracking_cost_es, jcp,
                          C.es_tracking_cost_from_numpy(F(jcp)), jp, tp, x0=x0))


@pytest.mark.parametrize("mode", ["generation_linear", "generation_nonlinear"])
def test_generation_fit_matches_jax(case, mode):
    """Goal generation, Q = I, P = 1e5 I, R = 1e1 I, 15 step sizes;
    'generation_nonlinear' re-anchors the dynamics and the goal cost after
    each taken step (its phi_goal from each package's own Log)."""
    jp, tp, _, _, X_goal = case
    Q, R, P = np.eye(6), 1e1 * np.eye(6), 1e5 * np.eye(6)
    jcp = jes.goal_cost_params(Q, R, P, jp.q_ref, X_goal)
    tcp = es.goal_cost_params(T(Q), T(R), T(P), tp.q_ref, T(X_goal))
    cfg = dict(N=N, mode=mode, n_alphas=15, tol_grad_norm=1e-3, max_iterations=40)
    jre = tre = None
    if mode == "generation_nonlinear":
        jre = lambda c, qs: jes.goal_cost_params(Q, R, P, qs, X_goal)
        tre = lambda c, qs: es.goal_cost_params(T(Q), T(R), T(P), qs, T(X_goal))
    out = _fit_both(cfg, jes.goal_cost, es.goal_cost, jcp, tcp, jp, tp,
                    jreanchor=jre, treanchor=tre)
    _check_fit(*out)
    if mode == "generation_nonlinear":
        # the returned cost params are the last re-anchor's
        close(out[2][3].phi_goal, out[0][3].phi_goal, atol=1e-6)


def test_init_state_and_one_iteration_from_a_jax_state(case):
    """`init_state(x0=...)` re-logs the rolled-out trajectory (1e-8); one
    iteration from a JAX state (`convert.es_state_from_numpy`) equals the
    JAX iteration (1e-10)."""
    jp, tp, _, _, _ = case
    jcp = jes.ErrorStateTrackingCostParams(Q=jnp.eye(12), R=1e-3 * jnp.eye(6),
                                           P=10.0 * jnp.eye(12), xi_ref=jp.xi_ref)
    tcp = C.es_tracking_cost_from_numpy(F(jcp))
    x0 = np.concatenate([[0.05, -0.03, 0.08, 0.2, -0.1, 0.15], np.asarray(jp.xi_ref[0]) + 0.05])
    cfg = dict(N=N, mode="tracking", n_alphas=10)
    jsolver = JE.ErrorStateILQR(JE.ESConfig(**cfg), jes.tracking_cost_es)
    tsolver = ErrorStateILQR(ESConfig(**cfg), es.tracking_cost_es)
    jst = jsolver.init_state(jp, jnp.zeros((N, 6)), x0=jnp.asarray(x0))
    tst = tsolver.init_state(tp, torch.zeros((N, 6), dtype=torch.float64), x0=T(x0))
    close(tst.xs, jst.xs, atol=1e-8)
    close(tst.qs, jst.qs)
    fields = {k: (F(v) if k == "params" else np.asarray(v)) for k, v in jst._asdict().items()}
    tst = C.es_state_from_numpy(fields)
    jnew, jtook = jsolver._iteration_jit(jcp, jst)
    tnew, ttook = tsolver._iteration(tcp, tst)
    assert bool(ttook) == bool(jtook)
    for name in ("xs", "us", "k", "K", "J_opt", "grad_norm", "mu", "delta", "alpha"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_entry_points_default_to_the_card():
    """Built from numpy without a device, the params go to the card: with
    no card they raise, never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    J = np.eye(6)
    with pytest.raises((RuntimeError, AssertionError)):
        es.errorstate_params(J, 0.01, np.zeros((3, 4, 4)), np.zeros((3, 6)))
    assert es.errorstate_params(J, 0.01, np.zeros((3, 4, 4)), np.zeros((3, 6)),
                                device="cpu").q_ref.device.type == "cpu"
