"""Error-state SE(3) iLQR solvers, 12-d vector state, Lie-anchored
(counterpart of the JAX `solvers/errorstate_ilqr.py`).

Replaces the reference's three error-state controllers
(`traopt_controller.py`):

  - `iLQR_Tracking_ErrorState_Approx:3300`: track a fixed reference with
    the approximate error-state dynamics ('linear' LTV rollout or
    'nonlinear' group rollout that re-logs into the error state).
  - `iLQR_Generation_ErrorState_Approx_LinearRollout:3822`: goal-reaching
    with the linear error-state rollout about a fixed reference.
  - `iLQR_Generation_ErrorState_Approx_NonlinearRollout:4367`: the iterated
    error-state ("Lie-group SQP") scheme: nonlinear group rollout, error
    recovered by Log against the current anchor, and after each accepted
    step the anchor is re-set to the new trajectory
    (`traopt_controller.py:4546-4552`), here a pure params update.

One problem per `fit`, as in the JAX API (no JAX caller maps this solver
over problems).  The linearization differentiates the step and the cost
with `torch.func` (`jacfwd`, `grad`, `hessian`), mapped over all stages at
once with `torch.func.vmap`; the backward pass is a loop over stages with
the per-stage adaptive Levenberg-Marquardt retry (ref :4759-4790): one
positive-definiteness check a stage, read back to the host, and the retry
only where it fails; the line search rolls out every candidate of the
alpha ladder at once (the candidates a leading axis of every rollout
tensor, in place of the JAX vmap over alpha), each rollout a loop over
stages.  The reference's `scipy.linalg.logm` in the rollout (`:4606`) is
the closed-form SE(3) Log.  No kernel: the JAX module is XLA, and on the
card every step is a handful of small PyTorch ops, so the loop is
host-bound.  Entry points run on the device of ``us_init`` when it is a
tensor, else on the card.
"""

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import errorstate as es
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    _T,
    _bmv,
    _is_pd,
    _sym,
    alpha_ladder,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


@dataclasses.dataclass(frozen=True)
class ESConfig:
    N: int
    mode: str = "generation_nonlinear"  # 'tracking' | 'generation_linear' | 'generation_nonlinear'
    rollout: str = "nonlinear"           # for 'tracking': 'linear' | 'nonlinear'
    n_alphas: int = 15                   # ref :4452 (15); tracking/gen-linear use 10 (:3385, :3902)
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    tol_J: float = 1e-6
    tol_grad_norm: float = 1e-3
    max_iterations: int = 100
    # runtime analytic-vs-autodiff Jacobian check (the reference's
    # debug={'derivative_compare': True}, traopt_dynamics.py:1905-1933 /
    # traopt_controller.py:3585-3624): when on, `fit` compares both
    # Jacobian paths along the initial trajectory and stores the report
    # (see ErrorStateILQR.derivative_compare); the reference's failure
    # branch was `pass`, here a warning is emitted above tol
    derivative_compare: bool = False
    derivative_compare_tol: float = 1e-6


class ESState(NamedTuple):
    xs: torch.Tensor       # (N+1, 12) error states
    qs: torch.Tensor       # (N+1, 4, 4) group trajectory
    xis: torch.Tensor      # (N+1, 6)
    us: torch.Tensor       # (N, nu)
    params: NamedTuple     # ErrorStateParams (carries the anchor q_ref/xi_ref)
    k: torch.Tensor
    K: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    J_opt: torch.Tensor
    grad_norm: torch.Tensor
    alpha: torch.Tensor
    iteration: torch.Tensor
    converged: torch.Tensor
    accepted: torch.Tensor
    failed: torch.Tensor


class ErrorStateILQR:
    """iLQR on the SE(3) error state with optional anchor re-initialization.

    cost(cost_params, x, u, i, terminal) -> scalar (autodiff-quadratized,
    ref traopt_cost.py:1365-1372); `reanchor_cost` maps (cost_params,
    qs_new) -> new cost params when the anchor moves (goal cost recomputes
    phi_goal; tracking cost is anchor-independent).
    """

    def __init__(self, config: ESConfig, cost: Callable,
                 reanchor_cost: Optional[Callable] = None,
                 step=es.step_euler):
        self.cfg = config
        self.cost = cost
        self.reanchor_cost = reanchor_cost
        self.step = step

    # -- pieces --------------------------------------------------------------

    def _linearize(self, params, cost_params, xs, us):
        N = self.cfg.N
        idx = torch.arange(N, device=us.device)
        cost = self.cost

        def one(x, u, i):
            fx = jacfwd(lambda xx: self.step(params, xx, u, i))(x)
            fu = jacfwd(lambda uu: self.step(params, x, uu, i))(u)
            l = cost(cost_params, x, u, i, False)
            lx = grad(lambda xx: cost(cost_params, xx, u, i, False))(x)
            lu = grad(lambda uu: cost(cost_params, x, uu, i, False))(u)
            lxx = hessian(lambda xx: cost(cost_params, xx, u, i, False))(x)
            lux = jacfwd(
                lambda xx: grad(lambda uu: cost(cost_params, xx, uu, i, False))(u)
            )(x)
            luu = hessian(lambda uu: cost(cost_params, x, uu, i, False))(u)
            return fx, fu, l, lx, lu, lxx, lux, luu

        Fx, Fu, L, Lx, Lu, Lxx, Lux, Luu = vmap(one)(xs[:-1], us, idx)
        u0 = torch.zeros_like(us[0])
        term = lambda xx: cost(cost_params, xx, u0, N, True)
        lN, lNx, lNxx = term(xs[-1]), grad(term)(xs[-1]), hessian(term)(xs[-1])
        return dict(Fx=Fx, Fu=Fu, L=torch.cat([L, lN[None]]),
                    Lx=torch.cat([Lx, lNx[None]], dim=0), Lu=Lu,
                    Lxx=torch.cat([Lxx, lNxx[None]], dim=0), Lux=Lux, Luu=Luu)

    def _backward(self, lin, mu, delta):
        """Per-step adaptive-mu backward pass (ref :4716-4790).  The schedule
        runs on the host in the state's precision: one PD check a stage,
        read back, and the retry only while it fails."""
        cfg = self.cfg
        Fx = lin["Fx"]
        N, nx = Fx.shape[0], Fx.shape[-1]
        eye = torch.eye(nx, dtype=Fx.dtype, device=Fx.device)
        f = np.float32 if Fx.dtype == torch.float32 else np.float64
        mu_c, delta_c = f(mu.item()), f(delta.item())
        d0, mu_min, mu_max = f(cfg.delta_0), f(cfg.mu_min), f(cfg.mu_max)
        Vx, Vxx = lin["Lx"][-1], lin["Lxx"][-1]
        ks, Ks = [None] * N, [None] * N
        for t in reversed(range(N)):
            fx, fu = Fx[t], lin["Fu"][t]
            lx, lu, lxx = lin["Lx"][t], lin["Lu"][t], lin["Lxx"][t]
            lux, luu = lin["Lux"][t], lin["Luu"][t]
            fxT, fuT = _T(fx), _T(fu)
            # the retry loop of :146-159: mu_dec is computed there but never
            # kept, so a passing mu stays as it is
            mu_q, dlt = mu_c, delta_c
            while True:
                Vreg = Vxx + float(mu_q) * eye
                Quu = luu + fuT @ Vreg @ fu
                if bool(_is_pd(Quu + _T(Quu))):
                    dlt = min(f(1.0), dlt) / d0
                    break
                dlt = max(f(1.0), dlt) * d0
                mu_inc = max(mu_min, mu_q * dlt)
                if mu_inc >= mu_max:
                    break
                mu_q = mu_inc
            # post-success state decrease mirrors the Lie engine
            mu_st = f(0.0) if mu_q <= mu_min else mu_q
            Qx = lx + _bmv(fxT, Vx)
            Qu = lu + _bmv(fuT, Vx)
            Qxx = lxx + fxT @ Vxx @ fx
            Qux = lux + fuT @ Vreg @ fx
            k = -torch.linalg.solve(Quu, Qu)
            K = -torch.linalg.solve(Quu, Qux)
            KT, QuxT = _T(K), _T(Qux)
            Vx = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
            Vxx = _sym(Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K)
            ks[t], Ks[t] = k, K
            mu_c, delta_c = mu_st, dlt
        scalar = lambda v: torch.tensor(v, dtype=Fx.dtype, device=Fx.device)
        return torch.stack(ks), torch.stack(Ks), scalar(mu_c), scalar(delta_c)

    def _grad_norm(self, lin):
        p = lin["Lx"][-1]
        gs = [None] * self.cfg.N
        for t in reversed(range(self.cfg.N)):
            gs[t] = lin["Lu"][t] + _bmv(_T(lin["Fu"][t]), p)
            p = lin["Lx"][t] + _bmv(_T(lin["Fx"][t]), p)
        return torch.linalg.norm(torch.stack(gs), dim=-1).mean()

    def _traj_cost(self, cost_params, xs, us):
        """Over any leading axes: xs (..., N+1, 12), us (..., N, nu)."""
        N = self.cfg.N
        idx = torch.arange(N, device=us.device)
        L = self.cost(cost_params, xs[..., :-1, :], us, idx, False)
        lN = self.cost(cost_params, xs[..., -1, :], torch.zeros_like(us[..., 0, :]), N, True)
        return L.sum(dim=-1) + lN

    # -- rollouts ------------------------------------------------------------
    # ``alpha`` (A,): every candidate at once, outputs (A, ...).

    def _rollout_nonlinear(self, params, state, k, K, alpha):
        """Group rollout + re-log against the anchor (ref `_rollout:4576-4611`)."""
        A = alpha.shape[0]
        a = alpha[:, None]
        x_new = state.xs[0].expand(A, -1)
        q_new = state.qs[0].expand(A, -1, -1)
        xi_new = state.xis[0].expand(A, -1)
        xs_t, qs_t, xis_t, us_t = [], [], [], []
        for i in range(self.cfg.N):
            u = state.us[i] + a * k[i] + _bmv(K[i], x_new - state.xs[i])
            q_new, xi_new = es.group_step(params, q_new, xi_new, u, i)
            psi = se3.log(se3.inverse(params.q_ref[i + 1]) @ q_new)
            x_new = torch.cat([psi, xi_new], dim=-1)
            for lst, v in zip((xs_t, qs_t, xis_t, us_t), (x_new, q_new, xi_new, u)):
                lst.append(v)
        first = lambda x: x[:1].expand((A,) + x[:1].shape)
        st = lambda lst: torch.stack(lst, dim=1)
        return (torch.cat([first(state.xs), st(xs_t)], dim=1),
                torch.cat([first(state.qs), st(qs_t)], dim=1),
                torch.cat([first(state.xis), st(xis_t)], dim=1), st(us_t))

    def _rollout_linear(self, params, state, k, K, alpha):
        """LTV rollout of the error-state dynamics (ref :3516)."""
        A = alpha.shape[0]
        a = alpha[:, None]
        x_new = state.xs[0].expand(A, -1)
        xs_t, us_t = [], []
        for i in range(self.cfg.N):
            u = state.us[i] + a * k[i] + _bmv(K[i], x_new - state.xs[i])
            x_new = self.step(params, x_new, u, i)
            xs_t.append(x_new)
            us_t.append(u)
        xs_new = torch.cat([state.xs[:1].expand(A, 1, -1), torch.stack(xs_t, dim=1)], dim=1)
        # group trajectory reconstructed from the anchor + error state
        qs_new = params.q_ref @ se3.exp(xs_new[..., :6])
        return xs_new, qs_new, xs_new[..., 6:], torch.stack(us_t, dim=1)

    # -- iteration -----------------------------------------------------------

    def _iteration(self, cost_params, state: ESState):
        """One iteration; returns (new state, take_new)."""
        cfg = self.cfg
        params = state.params
        lin = self._linearize(params, cost_params, state.xs, state.us)
        J_opt = lin["L"].sum()
        k, K, mu_new, delta_new = self._backward(lin, state.mu, state.delta)
        grad_norm = self._grad_norm(lin)
        grad_conv = grad_norm < cfg.tol_grad_norm

        alphas = alpha_ladder(cfg.n_alphas, dtype=state.us.dtype, device=state.us.device)
        use_nl = (cfg.mode == "generation_nonlinear") or (
            cfg.mode == "tracking" and cfg.rollout == "nonlinear")
        rollout = self._rollout_nonlinear if use_nl else self._rollout_linear
        xs_a, qs_a, xis_a, us_a = rollout(params, state, k, K, alphas)
        J_a = self._traj_cost(cost_params, xs_a, us_a)
        ok_a = J_a < J_opt
        # the first acceptable alpha (index 0 when none is)
        idx_first = torch.argmax(ok_a.to(torch.int8))
        improved = ok_a.any()
        J_new = J_a[idx_first]
        rel_conv = torch.abs((J_opt - J_new) / J_opt) < cfg.tol_J
        accepted = grad_conv | improved
        converged = grad_conv | (improved & rel_conv)
        take_new = improved | grad_conv  # ref :4510-4517 updates on grad-conv too

        pick = lambda new, old: torch.where(take_new, new[idx_first], old)
        return state._replace(
            xs=pick(xs_a, state.xs), qs=pick(qs_a, state.qs),
            xis=pick(xis_a, state.xis), us=pick(us_a, state.us),
            k=k, K=K, mu=mu_new, delta=delta_new,
            J_opt=torch.where(take_new, J_new, J_opt), grad_norm=grad_norm,
            alpha=alphas[idx_first], iteration=state.iteration + 1,
            converged=converged, accepted=accepted, failed=~accepted,
        ), take_new

    # -- the loop ------------------------------------------------------------

    def init_state(self, params: es.ErrorStateParams, us_init, x0=None):
        """Nominal anchor trajectory = the stored reference; error state 0
        (ref `_linearization:4683-4687`).  With ``x0`` (a 12-d error state,
        the reference tracking solver's perturbed start,
        `iLQR_Tracking_ErrorState_Approx.fit`), the initial trajectory is
        instead the rollout of ``us_init`` from ``x0``.  On ``us_init``'s
        device when it is a tensor, else the card (``params`` must be
        there)."""
        us = torch.as_tensor(us_init, device=solve_device(us_init))
        if x0 is None:
            xs = torch.cat([torch.zeros_like(params.xi_ref), params.xi_ref], dim=-1)
            qs, xis = params.q_ref, params.xi_ref
        else:
            x0 = torch.as_tensor(x0).to(dtype=us.dtype, device=us.device)
            q0 = params.q_ref[0] @ se3.exp(x0[:6])
            qs, xis = es.rollout_nominal(params, q0, x0[6:], us)
            psi = se3.log(se3.inverse(params.q_ref) @ qs)
            xs = torch.cat([psi, xis], dim=-1)
        kw = dict(dtype=us.dtype, device=us.device)
        f = lambda v: torch.tensor(v, **kw)
        no = torch.tensor(False, device=us.device)
        nu = us.shape[-1]
        return ESState(
            xs=xs, qs=qs, xis=xis, us=us, params=params,
            k=torch.zeros((self.cfg.N, nu), **kw),
            K=torch.zeros((self.cfg.N, nu, 12), **kw),
            mu=f(self.cfg.mu_init), delta=f(self.cfg.delta_0),
            J_opt=f(float("inf")), grad_norm=f(float("inf")), alpha=f(1.0),
            iteration=torch.tensor(0, device=us.device), converged=no,
            accepted=no.clone(), failed=no.clone(),
        )

    def derivative_compare(self, params, xs, us, tol=None):
        """Analytic-vs-autodiff Jacobian comparison along a trajectory.

        The runtime twin of the reference's `derivative_compare` debug mode
        (`traopt_dynamics.py:1905-1933`, threshold check at
        `traopt_controller.py:3616-3624`, whose failure branch is `pass`).
        Returns {'fx_max_dev', 'fu_max_dev', 'within_tol'} and warns when
        the deviation exceeds ``tol``.  For the Euler step the analytic
        Jacobian is exact (see `models/errorstate.jac_analytic`), so any
        deviation flags a real regression; with `step_rk4` the analytic
        form stays first-order I + At dt and an O(dt^2) deviation is
        expected."""
        tol = self.cfg.derivative_compare_tol if tol is None else tol
        idx = torch.arange(us.shape[0], device=us.device)
        jac_ad = es.jac_autodiff(self.step)
        fx_d, fu_d = vmap(lambda x, u, i: jac_ad(params, x, u, i))(xs[:-1], us, idx)
        fx_a, fu_a = vmap(lambda x, u, i: es.jac_analytic(params, x, u, i))(xs[:-1], us, idx)
        rep = dict(
            fx_max_dev=float((fx_d - fx_a).abs().max()),
            fu_max_dev=float((fu_d - fu_a).abs().max()),
        )
        rep["within_tol"] = (rep["fx_max_dev"] < tol
                             and rep["fu_max_dev"] < tol)
        if not rep["within_tol"]:
            warnings.warn(
                f"derivative_compare: analytic vs autodiff Jacobians "
                f"deviate by fx={rep['fx_max_dev']:.2e} "
                f"fu={rep['fu_max_dev']:.2e} (> {tol:g}); expected only "
                f"for higher-order integrators (the analytic form is the "
                f"Euler-exact I + At dt, models/errorstate.jac_analytic)")
        return rep

    def fit(self, cost_params, params, us_init, n_iterations=None,
            on_iteration=None, x0=None):
        """At most ``n_iterations`` iterations (default ``max_iterations``),
        stopping on convergence or a failed line search; in
        'generation_nonlinear' every taken step re-anchors the dynamics to
        the new trajectory and the cost through ``reanchor_cost``.  Returns
        (state, J_hist, grad_hist, cost_params)."""
        cfg = self.cfg
        n_iterations = n_iterations or cfg.max_iterations
        state = self.init_state(params, us_init, x0=x0)
        if cfg.derivative_compare:
            self.derivative_compare_report = self.derivative_compare(
                state.params, state.xs, state.us)
        J_hist, grad_hist = [], []
        for _ in range(n_iterations):
            state, took = self._iteration(cost_params, state)
            J_hist.append(float(state.J_opt))
            grad_hist.append(float(state.grad_norm))
            if cfg.mode == "generation_nonlinear" and bool(took):
                # re-anchor the error-state dynamics and the goal cost to
                # the accepted trajectory (ref :4546-4552)
                new_params = es.reanchor(state.params, state.qs, state.xis)
                state = state._replace(
                    params=new_params,
                    xs=torch.cat([torch.zeros_like(state.xis), state.xis], dim=-1),
                )
                if self.reanchor_cost is not None:
                    cost_params = self.reanchor_cost(cost_params, state.qs)
            if on_iteration is not None:
                on_iteration(state)
            if bool(state.converged) or bool(state.failed):
                break
        return state, J_hist, grad_hist, cost_params
