"""Euclidean-state iLQR/DDP (counterpart of the JAX `solvers/ilqr.py`, the
reference's `iLQR`, traopt_controller.py:43-521).

The reference's numerical policy: one Levenberg-Marquardt mu per backward
pass with the delta-doubling schedule applied per iteration (accept:
decrease, reject: increase), the `1.1**(-arange(10)**2)` line search with
the gradient-norm check folded in, optional DDP tensor terms.  Batch-native
as `solvers/lie_ilqr.LieILQR`: every tensor has a leading problem axis B,
mu, delta and the flags are per problem, a converged or failed problem is
frozen while the others iterate, and every candidate of the line search is
rolled out at once.  The model's per-sample functions are mapped over
problems and stages with `torch.func.vmap`; on the card the linearization
and the loops over stages (backward pass, gradient norm, candidate
rollout) are replayed from CUDA graphs (`solvers/graph.py`).  Entry
points run on the device of ``us_init`` when it is a tensor, else on the
card.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.autodiff import (
    EuclideanModel,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.graph import GraphCache
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    _bmv,
    _gains,
    _T,
    _value_update,
    _where,
    alpha_ladder,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    N: int
    n_alphas: int = 10
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    tol_J: float = 1e-6
    tol_grad_norm: float = 1e-3
    max_iterations: int = 100
    use_hessians: bool = False


class ILQRState(NamedTuple):
    """Every field per problem (leading axis B)."""

    xs: torch.Tensor         # (B, N+1, nx)
    us: torch.Tensor         # (B, N, nu)
    k: torch.Tensor          # (B, N, nu)
    K: torch.Tensor          # (B, N, nu, nx)
    mu: torch.Tensor         # (B,)
    delta: torch.Tensor
    J_opt: torch.Tensor
    grad_norm: torch.Tensor
    alpha: torch.Tensor
    iteration: torch.Tensor  # (B,) int64
    converged: torch.Tensor  # (B,) bool
    accepted: torch.Tensor
    failed: torch.Tensor


class ILQR:
    """Euclidean iLQR/DDP with the reference's acceptance rules."""

    def __init__(self, model: EuclideanModel, config: ILQRConfig):
        self.model = model
        self.cfg = config
        self._graphs = GraphCache()

    def _loop(self, name, fn, cuda, *args):
        """``fn(*args)``, a loop over stages: on the card (``cuda``) replayed
        from a CUDA graph (`solvers/graph.GraphCache`; eagerly each op costs
        ~10 µs of launch overhead under `torch.func.vmap`), on the CPU run
        as it is."""
        return self._graphs(name, fn, *args) if cuda else fn(*args)

    def _map(self, fn, *args, i):
        """``fn`` mapped over the leading axis of every tensor in ``args``
        (they share it), with the stage index ``i`` an int or an index
        tensor of the same length."""
        i_dim = 0 if isinstance(i, torch.Tensor) else None
        return vmap(fn, in_dims=(0,) * len(args) + (i_dim,))(*args, i)

    def _stagewise(self, fn, xs, us):
        """``fn`` on every (problem, stage) pair: xs (B, N, nx),
        us (B, N, nu); outputs (B, N, ...)."""
        B, N = us.shape[:2]
        idx = torch.arange(N, device=us.device).repeat(B)
        out = self._map(fn, xs.reshape(B * N, -1), us.reshape(B * N, -1), i=idx)
        unfold = lambda t: t.reshape((B, N) + t.shape[1:])
        return tuple(unfold(t) for t in out) if isinstance(out, tuple) else unfold(out)

    def init_state(self, x0, us_init):
        """x0 (B, nx), us_init (B, N, nu), whose dtype and device (the card
        when it is not a tensor) the solve takes."""
        cfg = self.cfg
        us = torch.as_tensor(us_init, device=solve_device(us_init))
        x0 = torch.as_tensor(x0).to(device=us.device, dtype=us.dtype)
        B = us.shape[0]
        kw = dict(dtype=us.dtype, device=us.device)
        f = lambda v: torch.full((B,), v, **kw)
        no = torch.zeros(B, dtype=torch.bool, device=us.device)
        return ILQRState(
            xs=self._rollout_open(x0, us), us=us,
            k=torch.zeros((B, cfg.N, self.model.nu), **kw),
            K=torch.zeros((B, cfg.N, self.model.nu, self.model.nx), **kw),
            mu=f(cfg.mu_init), delta=f(cfg.delta_0), J_opt=f(float("inf")),
            grad_norm=f(float("inf")), alpha=f(1.0),
            iteration=torch.zeros(B, dtype=torch.int64, device=us.device),
            converged=no, accepted=no.clone(), failed=no.clone())

    def _rollout_open(self, x0, us):
        xs = [x0]
        for i in range(self.cfg.N):
            xs.append(self._map(self.model.step, xs[-1], us[:, i], i=i))
        return torch.stack(xs, dim=1)

    def _linearize(self, xs, us):
        return self._loop("linearize", self._linearize_ops, xs.is_cuda, xs, us)

    def _linearize_ops(self, xs, us):
        cfg, m = self.cfg, self.model
        Fx, Fu = self._stagewise(m.jac, xs[:, :-1], us)
        L, Lx, Lu, Lxx, Lux, Luu = self._stagewise(m.stage_quad, xs[:, :-1], us)
        LN, LNx, LNxx = vmap(m.term_quad, in_dims=(0, None))(xs[:, -1], cfg.N)
        lin = dict(Fx=Fx, Fu=Fu, L=torch.cat([L, LN[:, None]], dim=1),
                   Lx=torch.cat([Lx, LNx[:, None]], dim=1), Lu=Lu,
                   Lxx=torch.cat([Lxx, LNxx[:, None]], dim=1), Lux=Lux, Luu=Luu)
        if cfg.use_hessians and m.has_hessians:
            lin["Fxx"], lin["Fux"], lin["Fuu"] = self._stagewise(m.hess, xs[:, :-1], us)
        return lin

    def _backward(self, lin, mu):
        """Fixed-mu backward pass (ref `_backward_pass:358-432`), mu per
        problem."""
        return self._loop("backward", self._backward_loop, mu.is_cuda, lin, mu)

    def _backward_loop(self, lin, mu):
        nx, N = self.model.nx, self.cfg.N
        eye = torch.eye(nx, dtype=lin["Fx"].dtype, device=lin["Fx"].device)
        use_h = self.cfg.use_hessians and self.model.has_hessians
        mu3 = mu.reshape(-1, 1, 1)
        Vx, Vxx = lin["Lx"][:, -1], lin["Lxx"][:, -1]
        ks, Ks = [None] * N, [None] * N
        for t in reversed(range(N)):
            fx, fu = lin["Fx"][:, t], lin["Fu"][:, t]
            fxT, fuT = _T(fx), _T(fu)
            Qx = lin["Lx"][:, t] + _bmv(fxT, Vx)
            Qu = lin["Lu"][:, t] + _bmv(fuT, Vx)
            Qxx = lin["Lxx"][:, t] + fxT @ Vxx @ fx
            Vreg = Vxx + mu3 * eye
            Qux = lin["Lux"][:, t] + fuT @ Vreg @ fx
            Quu = lin["Luu"][:, t] + fuT @ Vreg @ fu
            if use_h:
                # DDP tensor terms (ref :487-490)
                tdot = lambda T3: torch.einsum("bi,bijk->bjk", Vx, T3[:, t])
                Qxx = Qxx + tdot(lin["Fxx"])
                Qux = Qux + tdot(lin["Fux"])
                Quu = Quu + tdot(lin["Fuu"])
            ks[t], Ks[t] = _gains(Quu, Qu, Qux)
            Vx, Vxx = _value_update(Qx, Qu, Qxx, Qux, Quu, ks[t], Ks[t])
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)

    def _grad_norm(self, lin):
        return self._loop("grad_norm", self._grad_norm_loop, lin["Lx"].is_cuda, lin)

    def _grad_norm_loop(self, lin):
        p = lin["Lx"][:, -1]
        gs = [None] * self.cfg.N
        for t in reversed(range(self.cfg.N)):
            gs[t] = lin["Lu"][:, t] + _bmv(_T(lin["Fu"][:, t]), p)
            p = lin["Lx"][:, t] + _bmv(_T(lin["Fx"][:, t]), p)
        return torch.linalg.norm(torch.stack(gs, dim=1), dim=-1).mean(dim=-1)

    def _control(self, xs, us, k, K, alpha):
        """Closed-loop rollout (ref `_control:224-250`) of every candidate
        alpha (A,) at once, the candidates folded into the problems
        (candidate a of problem b is row a * B + b).  Returns xs
        (A * B, N+1, nx), us (A * B, N, nu)."""
        return self._loop("control", self._control_loop, xs.is_cuda, xs, us, k, K, alpha)

    def _control_loop(self, xs, us, k, K, alpha):
        A = alpha.shape[0]
        fold = lambda t: t.repeat((A,) + (1,) * (t.dim() - 1))
        xs, us, K = fold(xs), fold(us), fold(K)
        ak = (alpha.reshape(A, 1, 1, 1) * k[None]).reshape((-1,) + k.shape[1:])
        x = xs[:, 0]
        xs_t, us_t = [x], []
        for i in range(self.cfg.N):
            u = us[:, i] + ak[:, i] + _bmv(K[:, i], x - xs[:, i])
            x = self._map(self.model.step, x, u, i=i)
            xs_t.append(x)
            us_t.append(u)
        return torch.stack(xs_t, dim=1), torch.stack(us_t, dim=1)

    def _traj_cost(self, xs, us):
        L = self._stagewise(self.model.stage_cost, xs[:, :-1], us)
        return L.sum(dim=-1) + vmap(self.model.term_cost, in_dims=(0, None))(
            xs[:, -1], self.cfg.N)

    def _iteration(self, state: ILQRState) -> ILQRState:
        cfg = self.cfg
        B = state.us.shape[0]
        lin = self._linearize(state.xs, state.us)
        J_opt = lin["L"].sum(dim=-1)
        k, K = self._backward(lin, state.mu)
        grad_norm = self._grad_norm(lin)
        grad_conv = grad_norm < cfg.tol_grad_norm

        alphas = alpha_ladder(cfg.n_alphas, dtype=state.us.dtype, device=state.us.device)
        A = alphas.shape[0]
        xs_a, us_a = self._control(state.xs, state.us, k, K, alphas)
        J_a = self._traj_cost(xs_a, us_a).reshape(A, B)
        ok_a = J_a < J_opt
        first = torch.argmax(ok_a.to(torch.int8), dim=0)
        improved = ok_a.any(dim=0)
        lanes = torch.arange(B, device=state.us.device)
        J_new = J_a[first, lanes]
        rel_conv = torch.abs((J_opt - J_new) / J_opt) < cfg.tol_J

        # reference semantics (ref :160-189): grad-converged accepts without
        # updating the trajectory; otherwise the first improving alpha accepts
        accepted = grad_conv | improved
        converged = grad_conv | (improved & rel_conv)
        take_new = improved & ~grad_conv

        # mu schedule (ref :181-207)
        delta_dec = torch.clamp(state.delta, max=1.0) / cfg.delta_0
        mu_dec = state.mu * delta_dec
        mu_dec = torch.where(mu_dec <= cfg.mu_min, torch.zeros_like(mu_dec), mu_dec)
        delta_inc = torch.clamp(state.delta, min=1.0) * cfg.delta_0
        mu_inc = torch.clamp(state.mu * delta_inc, min=cfg.mu_min)
        mu_new = torch.where(take_new, mu_dec, torch.where(accepted, state.mu, mu_inc))
        delta_new = torch.where(take_new, delta_dec,
                                torch.where(accepted, state.delta, delta_inc))
        sel = first * B + lanes
        return ILQRState(
            xs=_where(take_new, xs_a[sel], state.xs),
            us=_where(take_new, us_a[sel], state.us),
            k=k, K=K, mu=mu_new, delta=delta_new,
            J_opt=torch.where(take_new, J_new, J_opt), grad_norm=grad_norm,
            alpha=alphas[first], iteration=state.iteration + 1,
            converged=converged, accepted=accepted,
            failed=~accepted & (mu_inc >= cfg.mu_max))

    def _step(self, state, active):
        new = self._iteration(state)
        return ILQRState(*(_where(active, n, o) for n, o in zip(new, state)))

    def fit(self, x0, us_init, n_iterations=None, on_iteration=None,
            state: Optional[ILQRState] = None):
        """Host driver with histories (each entry a list of B floats).
        Returns (xs, us, J_hist, grad_hist, state)."""
        n_iterations = n_iterations or self.cfg.max_iterations
        if state is None:
            state = self.init_state(x0, us_init)
        J_hist, grad_hist = [], []
        for _ in range(n_iterations):
            state = self._step(state, ~(state.converged | state.failed))
            J_hist.append(state.J_opt.tolist())
            grad_hist.append(state.grad_norm.tolist())
            if on_iteration is not None:
                on_iteration(state)
            if not bool((~(state.converged | state.failed)).any()):
                break
        return state.xs, state.us, J_hist, grad_hist, state

    def solve(self, x0, us_init):
        """Iterate every problem until it converges, fails or reaches
        ``max_iterations``.  Returns the final `ILQRState`."""
        state = self.init_state(x0, us_init)
        while True:
            active = ((state.iteration < self.cfg.max_iterations) & ~state.converged
                      & ~state.failed)
            if not bool(active.any()):
                return state
            state = self._step(state, active)
