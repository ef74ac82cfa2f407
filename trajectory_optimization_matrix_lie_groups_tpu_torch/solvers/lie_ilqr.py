"""Single- and multiple-shooting iLQR on matrix Lie groups (counterpart of the
JAX `solvers/lie_ilqr.py`): the reference-exact tier.

One engine for the reference's SO(3)/SE(3), SS/MS controllers, batch-native:
every tensor has a leading problem axis B.  B = 1 is the JAX
single-problem solver; B > 1 computes what the JAX package's
`parallel/batch.BatchSolver` computes with `jax.vmap`, problem by problem:

  - the mu/delta schedule, the merit weight and the convergence flags are
    per problem (tensors (B,));
  - a problem that has converged or failed is frozen while the others
    iterate, as the selects of a vmapped `lax.while_loop` freeze it;
  - the line search rolls out every candidate of the alpha ladder at once
    (the candidates a leading axis (A, B, ...) beside the problems, in
    place of the JAX vmap over alpha) and each problem takes its own first
    acceptable alpha (argmax of its acceptance mask).

Per iteration: the linearization and cost quadratization of all stages in
one batched call of the model's functions; the backward pass ('sequential':
the reference's per-stage adaptive Levenberg-Marquardt retry, a loop over
stages that reads one flag back a stage, "any problem's Quu not positive
definite", and loops at that stage until each problem's Quu is;
'sequential_fixed': the same recursion at mu = 0; 'associative': the
doubling-scan Riccati of `solvers/riccati.py` with its whole-sweep retry;
'associative_sharded': that sweep split over the ranks of a time mesh,
`parallel/riccati_sharded.py`);
the gap-closing rollout ('linear': a doubling scan over the affine error
maps; 'nonlinear': a loop over stages on the group).

`fit` is the host driver with histories and a callback (the reference's
observability contract); `solve` runs to convergence or
``max_iterations``.  Both read one flag a iteration ("is any problem still
iterating").  On the card every step is a handful of small batched
PyTorch ops, so the loop is host-bound (no kernel of this tier is a TPU
kernel's port: the JAX module is XLA); the nonlinear rollout's loop over
stages is replayed there from a CUDA graph (`solvers/graph.py`), the
backward pass's is not (its per-stage PD check reads the device).  Entry points run on the device of
``us_init`` when it is a tensor, else on the card.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import LieModel
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.rollout import fast_rollout
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.graph import GraphCache
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.riccati import _solve
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)

BACKWARDS = ("sequential", "sequential_fixed", "associative", "associative_sharded")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver options; the JAX `SolverConfig`'s fields and defaults (the
    reference SE(3) MS controller's, `traopt_controller.py:2386-2412`)."""

    N: int
    multiple_shooting: bool = True
    line_search: bool = False
    rollout: str = "nonlinear"          # 'linear' | 'nonlinear'
    n_alphas: int = 20                   # alpha ladder 1.1**(-arange(n)**2)
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    # multiple-shooting merit function constants (ref :2406-2410)
    defect_mu0: float = 10.0
    defect_rho: float = 0.5
    defect_gamma: float = 0.05
    defect_mu_min: float = 10.0
    defect_kappa: float = 1e-12
    # 'sequential' | 'sequential_fixed' | 'associative' | 'associative_sharded'
    backward: str = "sequential"
    tol_J: float = 1e-6
    tol_grad_norm: float = 1e-6
    tol_d_norm: float = 1e-6
    max_iterations: int = 100


class SolverState(NamedTuple):
    """Solver state, every field per problem (leading axis B)."""

    qs: torch.Tensor        # (B, N+1, m, m)
    xis: torch.Tensor       # (B, N+1, d)
    us: torch.Tensor        # (B, N, nu)
    k: torch.Tensor         # (B, N, nu) feedforward gains
    K: torch.Tensor         # (B, N, nu, nx) feedback gains
    mu: torch.Tensor        # (B,) LM regularization
    delta: torch.Tensor     # (B,) LM schedule factor
    d_weight: torch.Tensor  # (B,) merit-function defect weight carry
    J_opt: torch.Tensor     # (B,)
    grad_norm: torch.Tensor  # (B,)
    d_norm: torch.Tensor    # (B,)
    alpha: torch.Tensor     # (B,)
    iteration: torch.Tensor  # (B,) int64
    converged: torch.Tensor  # (B,) bool
    accepted: torch.Tensor   # (B,) bool
    failed: torch.Tensor     # (B,) bool, line search exhausted (MS+LS / SS)


def alpha_ladder(n, dtype=torch.float64, device=None):
    """Backtracking candidates 1.1**(-arange(n)**2) (ref :118, :605, :2472)."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 1.1 ** (-(i * i))


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


def _T(M):
    return M.transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + _T(M))


def _lane(x, like):
    """A per-problem (B,) tensor shaped to broadcast against ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _is_pd(M):
    """Per problem: the Cholesky factorization of M (B, n, n) succeeds with
    finite entries (ref `is_pos_def`, traopt_utilis.py:320)."""
    L, info = torch.linalg.cholesky_ex(M)
    return (info == 0) & torch.isfinite(L).all(dim=(-1, -2))


def _gains(Quu, Qu, Qux):
    """k = -Quu^-1 Qu, K = -Quu^-1 Qux in one solve."""
    X = _solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    return -X[..., 0], -X[..., 1:]


def _value_update(Qx, Qu, Qxx, Qux, Quu, k, K):
    KT, QuxT = _T(K), _T(Qux)
    Vx = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
    Vxx = _sym(Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K)
    return Vx, Vxx


def _where(mask, new, old):
    return torch.where(_lane(mask, old), new, old)


class LieILQR:
    """iLQR/DDP on a matrix Lie group (SS and MS modes), batch-native.

    ``pallas_rollout_dt``: the time step, to run the multiple-shooting
    nonlinear rollout (every line-search candidate at once) as kernel B14,
    the fast tier's gap-closing rollout; valid only for the SE(3) free body
    (`models/dynamics.se3_dynamics`), whose step the kernel implements (the
    name follows `solvers/batched.FastBatchSolver`'s).  Unset, the rollout
    is the loop over stages of the JAX package."""

    def __init__(self, model: LieModel, config: SolverConfig,
                 pallas_rollout_dt: Optional[float] = None):
        if config.backward not in BACKWARDS:
            raise ValueError(f"backward must be one of {BACKWARDS}, got {config.backward!r}")
        if config.rollout not in ("linear", "nonlinear"):
            raise ValueError(f"rollout must be 'linear' or 'nonlinear', got {config.rollout!r}")
        self.model = model
        self.cfg = config
        self.pallas_rollout_dt = pallas_rollout_dt
        # the time mesh of backward='associative_sharded' (set it after
        # construction; else every rank of the process group, at first use)
        self.backward_mesh = None
        self._graphs = GraphCache()

    # -- state initialisation ------------------------------------------------

    def init_state(self, params, x0, us_init, q_ref=None, xi_ref=None):
        """MS: shooting nodes from the reference (ref `_initial_guess:3123`);
        SS: nonlinear rollout of us_init (ref `_init_rollout:697`).
        x0 = (q0s (B, m, m), xi0s (B, d)); us_init (B, N, nu), whose dtype
        and device (the card when it is not a tensor) the solve takes."""
        us = torch.as_tensor(us_init, device=solve_device(us_init))
        cast = lambda x: torch.as_tensor(x).to(device=us.device, dtype=us.dtype)
        q0, xi0 = cast(x0[0]), cast(x0[1])
        if self.cfg.multiple_shooting:
            if q_ref is None:
                q_ref, xi_ref = params["cost"].q_ref, params["cost"].xi_ref
            return self._init_state_ms(q0, xi0, us, cast(q_ref), cast(xi_ref))
        return self._init_state_ss(params, q0, xi0, us)

    def _blank_state(self, qs, xis, us):
        cfg = self.cfg
        B, N, nu = us.shape
        kw = dict(dtype=us.dtype, device=us.device)
        f = lambda v: torch.full((B,), v, **kw)
        no = torch.zeros(B, dtype=torch.bool, device=us.device)
        return SolverState(
            qs=qs, xis=xis, us=us,
            k=torch.zeros((B, N, nu), **kw),
            K=torch.zeros((B, N, nu, self.model.nx), **kw),
            mu=f(cfg.mu_init), delta=f(cfg.delta_0), d_weight=f(cfg.defect_mu0),
            J_opt=f(float("inf")), grad_norm=f(float("inf")), d_norm=f(float("inf")),
            alpha=f(1.0), iteration=torch.zeros(B, dtype=torch.int64, device=us.device),
            converged=no, accepted=no.clone(), failed=no.clone())

    def _init_state_ms(self, q0, xi0, us, q_ref, xi_ref):
        B = us.shape[0]
        qs = torch.cat([q0[:, None], q_ref[1:].expand((B,) + q_ref[1:].shape)], dim=1)
        xi_t = xi_ref[1:].reshape(q_ref.shape[0] - 1, -1)
        xis = torch.cat([xi0[:, None], xi_t.expand((B,) + xi_t.shape)], dim=1)
        return self._blank_state(qs, xis, us)

    def _init_state_ss(self, params, q0, xi0, us):
        qs, xis = [q0], [xi0]
        for i in range(self.cfg.N):
            q, xi = self.model.step(params, qs[-1], xis[-1], us[:, i], i)
            qs.append(q)
            xis.append(xi)
        return self._blank_state(torch.stack(qs, dim=1), torch.stack(xis, dim=1), us)

    # -- building blocks -----------------------------------------------------

    def _linearize(self, params, qs, xis, us):
        """All-stage dynamics, Jacobians and cost quadratization (batched)."""
        model = self.model
        N = self.cfg.N
        idx = torch.arange(N, device=us.device)
        q_s, xi_s = qs[:, :-1], xis[:, :-1]
        fq, fxi = model.step(params, q_s, xi_s, us, idx)
        Fx, Fu = model.jac(params, q_s, xi_s, us, idx)
        L, Lx, Lu, Lxx, Lux, Luu = model.stage_quad(params, q_s, xi_s, us, idx)
        LN, LNx, LNxx = model.term_quad(params, qs[:, -1], xis[:, -1], N)
        # defect d_i = f(x_i, u_i) (-) x_{i+1}  (manif rminus; ref :1554-1563)
        d = torch.cat([model.group.rminus(fq, qs[:, 1:]), fxi - xis[:, 1:]], dim=-1)
        B = us.shape[0]
        ex = lambda x, shape: x.expand(shape)
        return dict(fq=fq, fxi=fxi, Fx=ex(Fx, (B,) + Fx.shape[-3:]),
                    Fu=ex(Fu, (B,) + Fu.shape[-3:]), d=d,
                    L=torch.cat([L.expand(B, N), LN.expand(B)[:, None]], dim=1),
                    Lx=torch.cat([Lx.expand(B, N, -1), LNx.expand(B, -1)[:, None]], dim=1),
                    Lu=Lu.expand(B, N, -1),
                    Lxx=torch.cat([Lxx.expand(B, N, -1, -1),
                                   LNxx.expand(B, -1, -1)[:, None]], dim=1),
                    Lux=Lux.expand(B, N, -1, -1), Luu=Luu.expand(B, N, -1, -1))

    def _defects(self, lin):
        """The defects the backward pass and the linear rollout see (zero in
        single shooting)."""
        return lin["d"] if self.cfg.multiple_shooting else torch.zeros_like(lin["d"])

    def _backward(self, lin, mu, delta, active):
        cfg = self.cfg
        if cfg.backward == "sequential_fixed":
            return self._backward_sequential_fixed(lin, mu, delta)
        if cfg.backward == "associative":
            # PD-safe O(log N)-depth sweep with the whole-sweep retry
            return riccati.parallel_backward_adaptive(
                lin["Fx"], lin["Fu"], self._defects(lin), lin["Lx"], lin["Lu"],
                lin["Lxx"], lin["Lux"], lin["Luu"], mu, delta, mu_min=cfg.mu_min,
                mu_max=cfg.mu_max, delta_0=cfg.delta_0, active=active)
        if cfg.backward == "associative_sharded":
            # the same sweep with its element scan split over the time mesh's
            # ranks (`parallel/riccati_sharded.py`); its collectives run here,
            # outside every captured graph
            from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import (
                riccati_sharded,
            )

            if self.backward_mesh is None:
                self.backward_mesh = riccati_sharded.default_time_mesh(
                    device=lin["Fx"].device)
            return riccati_sharded.sharded_backward_adaptive(
                lin["Fx"], lin["Fu"], self._defects(lin), lin["Lx"], lin["Lu"],
                lin["Lxx"], lin["Lux"], lin["Luu"], mu, delta, mesh=self.backward_mesh,
                mu_min=cfg.mu_min, mu_max=cfg.mu_max, delta_0=cfg.delta_0, active=active)
        return self._backward_sequential(lin, mu, delta, active)

    @staticmethod
    def _stage_inputs(lin, d, t):
        return (lin["Fx"][:, t], lin["Fu"][:, t], d[:, t], lin["Lx"][:, t], lin["Lu"][:, t],
                lin["Lxx"][:, t], lin["Lux"][:, t], lin["Luu"][:, t])

    def _backward_sequential_fixed(self, lin, mu, delta):
        """The sequential Riccati recursion at mu = 0 (no per-stage retry)."""
        N = self.cfg.N
        d = self._defects(lin)
        Vx, Vxx = lin["Lx"][:, -1], lin["Lxx"][:, -1]
        ks, Ks, Vxs, Vxxs = [None] * N, [None] * N, [None] * N, [None] * N
        for t in reversed(range(N)):
            fx, fu, dd, lx, lu, lxx, lux, luu = self._stage_inputs(lin, d, t)
            fxT, fuT = _T(fx), _T(fu)
            Vmod = Vx + _bmv(Vxx, dd)
            Qx, Qu = lx + _bmv(fxT, Vmod), lu + _bmv(fuT, Vmod)
            Qxx = lxx + fxT @ Vxx @ fx
            Qux = lux + fuT @ Vxx @ fx
            Quu = luu + fuT @ Vxx @ fu
            k, K = _gains(Quu, Qu, Qux)
            ks[t], Ks[t], Vxs[t], Vxxs[t] = k, K, Vx, Vxx
            Vx, Vxx = _value_update(Qx, Qu, Qxx, Qux, Quu, k, K)
        st = lambda xs: torch.stack(xs, dim=1)
        no = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
        return st(ks), st(Ks), st(Vxs), st(Vxxs), mu, delta, no

    def _backward_sequential(self, lin, mu, delta, active):
        """The defect-aware Riccati recursion with the reference's per-stage
        adaptive LM schedule (ref `_backward_pass:1637-1694`), per problem.

        At each stage, each problem tries its current mu: on a positive
        definite Quu its mu de-escalates for the next stage, else it
        escalates and the problem tries again, until every active problem
        has passed or reached mu_max (one host read an attempt)."""
        cfg = self.cfg
        N, nx = cfg.N, self.model.nx
        eye = torch.eye(nx, dtype=lin["Fx"].dtype, device=lin["Fx"].device)
        d = self._defects(lin)
        Vx, Vxx = lin["Lx"][:, -1], lin["Lxx"][:, -1]
        mu_c, delta_c = mu, delta
        exceeded = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
        ks, Ks, Vxs, Vxxs = [None] * N, [None] * N, [None] * N, [None] * N
        for t in reversed(range(N)):
            fx, fu, dd, lx, lu, lxx, lux, luu = self._stage_inputs(lin, d, t)
            fxT, fuT = _T(fx), _T(fu)
            Vmod = Vx + _bmv(Vxx, dd)
            # the retry loop of :1639-1679, per problem; the Quu of each
            # problem's last attempt is its Quu for the gains
            mu_q, mu_st, dlt = mu_c, mu_c, delta_c
            done = ~active
            first = True
            while True:
                Vreg = Vxx + _lane(mu_q, Vxx) * eye
                Quu = luu + fuT @ Vreg @ fu
                ok = _is_pd(Quu + _T(Quu))
                dlt_dec = torch.clamp(dlt, max=1.0) / cfg.delta_0
                mu_dec = mu_q * dlt_dec
                mu_dec = torch.where(mu_dec <= cfg.mu_min, torch.zeros_like(mu_dec), mu_dec)
                if first and bool((ok | done).all()):
                    # every problem passed at once (the common case): each
                    # de-escalates (frozen problems' values are dropped)
                    mu_st, dlt = mu_dec, dlt_dec
                    break
                first = False
                dlt_inc = torch.clamp(dlt, min=1.0) * cfg.delta_0
                mu_inc = torch.clamp(mu_q * dlt_inc, min=cfg.mu_min)
                hit = mu_inc >= cfg.mu_max
                upd = ~done
                mu_st = torch.where(upd, torch.where(ok, mu_dec, mu_inc), mu_st)
                dlt = torch.where(upd, torch.where(ok, dlt_dec, dlt_inc), dlt)
                exceeded = exceeded | (upd & hit & ~ok)
                mu_q = torch.where(upd & ~(ok | hit), mu_inc, mu_q)
                done = done | ok | hit
                if bool(done.all()):
                    # no problem changed its mu in this last pass
                    break
            Qx, Qu = lx + _bmv(fxT, Vmod), lu + _bmv(fuT, Vmod)
            Qxx = lxx + fxT @ Vxx @ fx
            Qux = lux + fuT @ Vreg @ fx
            k, K = _gains(Quu, Qu, Qux)
            ks[t], Ks[t], Vxs[t], Vxxs[t] = k, K, Vx, Vxx
            Vx, Vxx = _value_update(Qx, Qu, Qxx, Qux, Quu, k, K)
            mu_c, delta_c = mu_st, dlt
        st = lambda xs: torch.stack(xs, dim=1)
        # Vxs[t] / Vxxs[t] hold V at stage t+1 (the carry into step t)
        return st(ks), st(Ks), st(Vxs), st(Vxxs), mu_c, delta_c, exceeded

    def _grad_norm_ms(self, lin, Vx_next, Vxx_next):
        """g_t = L_u + F_u^T (V_x[t+1] + V_xx[t+1]^T d_t); mean 2-norm
        (ref `_gradient_wrt_control:1758-1781`)."""
        g = lin["Lu"] + _bmv(_T(lin["Fu"]), Vx_next + _bmv(_T(Vxx_next), lin["d"]))
        return torch.linalg.norm(g, dim=-1).mean(dim=-1)

    def _grad_norm_ss(self, lin):
        """Adjoint recursion gradient (ref `_gradient_wrt_control:1000-1026`)."""
        p = lin["Lx"][:, -1]
        gs = [None] * self.cfg.N
        for t in reversed(range(self.cfg.N)):
            gs[t] = lin["Lu"][:, t] + _bmv(_T(lin["Fu"][:, t]), p)
            p = lin["Lx"][:, t] + _bmv(_T(lin["Fx"][:, t]), p)
        return torch.linalg.norm(torch.stack(gs, dim=1), dim=-1).mean(dim=-1)

    def _traj_cost(self, params, qs, xis, us):
        """Per problem, over any leading axes: qs (..., N+1, m, m),
        xis (..., N+1, d), us (..., N, nu)."""
        idx = torch.arange(self.cfg.N, device=us.device)
        L = self.model.stage_cost(params, qs[..., :-1, :, :], xis[..., :-1, :], us, idx)
        LN = self.model.term_cost(params, qs[..., -1, :, :], xis[..., -1, :], self.cfg.N)
        return L.sum(dim=-1) + LN

    def _defect_norm(self, params, qs, xis, us):
        idx = torch.arange(self.cfg.N, device=us.device)
        fq, fxi = self.model.step(params, qs[..., :-1, :, :], xis[..., :-1, :], us, idx)
        d = torch.cat([self.model.group.rminus(fq, qs[..., 1:, :, :]),
                       fxi - xis[..., 1:, :]], dim=-1)
        return torch.linalg.norm(d.flatten(-2), dim=-1)

    # -- rollouts ------------------------------------------------------------
    # ``alpha`` (A,): the rollout of every candidate at once, outputs with a
    # leading candidate axis (A, B, ...); the state's tensors are (B, ...).

    def _rollout_linear(self, lin, state, alpha):
        """Gap-closing linear rollout: the affine recursion
            dx_{i+1} = (F_x + F_u K_i) dx_i + a (F_u k_i + d_i),  dx_0 = 0
        as a doubling scan over its maps (the JAX associative scan), then
        du_i = a k_i + K_i dx_i (ref `_rollout` 'linear',
        traopt_controller.py:2720-2726)."""
        g = self.model.group
        M = lin["Fx"] + lin["Fu"] @ state.K                 # (B, N, nx, nx)
        c = ((_bmv(lin["Fu"], state.k) + self._defects(lin))[:, :, None]
             * alpha[:, None])                              # (B, N, A, nx)

        def combine(e1, e2):
            (A1, b1), (A2, b2) = e1, e2
            return A2 @ A1, (A2[:, :, None] @ b1[..., None])[..., 0] + b2

        c = riccati.doubling_scan(combine, (M, c))[1].movedim(2, 0)   # (A, B, N, nx)
        a = alpha.reshape(-1, 1, 1, 1)
        dx = torch.cat([torch.zeros_like(c[:, :, :1]), c], dim=2)
        us_err = a * state.k[None] + _bmv(state.K, dx[:, :, :-1])
        dim = g.dim
        qs_new = g.rplus(state.qs, dx[..., :dim])
        return qs_new, state.xis + dx[..., dim:], state.us + us_err, dx, us_err

    def _rollout_nonlinear(self, params, lin, state, alpha):
        """Gap-closing nonlinear rollout (a loop over stages).

        MS: q+ = q_next o Exp(a d_q) o f(x)^-1 o f(x_new)  (ref :2697-2718)
        SS: x+ = f(x_new, u_new)                            (ref :751-758)

        On the card the loop (some 100-500 small ops a stage) is replayed
        from a CUDA graph (`solvers/graph.GraphCache`)."""
        if self.pallas_rollout_dt is not None and self.cfg.multiple_shooting:
            return self._rollout_kernel(params, lin, state, alpha)
        args = (params, lin["d"], lin["fq"], lin["fxi"], state.qs, state.xis, state.us,
                state.k, state.K, alpha)
        if state.us.is_cuda:
            return self._graphs("rollout_nonlinear", self._rollout_loop, *args)
        return self._rollout_loop(*args)

    def _rollout_loop(self, params, d, fq, fxi, qs, xis, us, k, K, alpha):
        g = self.model.group
        ms = self.cfg.multiple_shooting
        dim = g.dim
        A = alpha.shape[0]
        a2 = alpha.reshape(A, 1, 1)
        exp_ad = g.exp(a2[..., None] * d[None, ..., :dim])   # (A, B, N, m, m)
        fq_inv = g.inverse(fq)
        q_new = qs[:, 0].expand((A,) + qs[:, 0].shape)
        xi_new = xis[:, 0].expand((A,) + xis[:, 0].shape)
        out = {n: [] for n in ("q", "xi", "u", "xe", "ue")}
        for i in range(self.cfg.N):
            xs_err = torch.cat([g.rminus(q_new, qs[:, i]), xi_new - xis[:, i]], dim=-1)
            us_err = a2 * k[:, i] + _bmv(K[:, i], xs_err)
            u_new = us[:, i] + us_err
            fq_new, fxi_new = self.model.step(params, q_new, xi_new, u_new, i)
            if ms:
                # normalize mirrors the reference's manif round-trips in this
                # composition chain (traopt_controller.py:2713-2715)
                q_new = g.normalize(qs[:, i + 1] @ exp_ad[:, :, i] @ fq_inv[:, i] @ fq_new)
                xi_new = xis[:, i + 1] + fxi_new - fxi[:, i] + a2 * d[:, i, dim:]
            else:
                q_new, xi_new = fq_new, fxi_new
            for n, v in zip(out, (q_new, xi_new, u_new, xs_err, us_err)):
                out[n].append(v)
        st = lambda n: torch.stack(out[n], dim=2)
        first = lambda x: x[:, :1].expand((A,) + x[:, :1].shape)
        qs_new = torch.cat([first(qs), st("q")], dim=2)
        xis_new = torch.cat([first(xis), st("xi")], dim=2)
        term_err = torch.cat([g.rminus(qs_new[:, :, -1], qs[:, -1]),
                              xis_new[:, :, -1] - xis[:, -1]], dim=-1)
        xs_errs = torch.cat([st("xe"), term_err[:, :, None]], dim=2)
        return qs_new, xis_new, st("u"), xs_errs, st("ue")

    def _rollout_kernel(self, params, lin, state, alpha):
        """The MS nonlinear rollout of the SE(3) free body on kernel B14: the
        candidates folded into the batch (candidate a of problem b is row
        a * B + b), each scaling the feedforward and the defect it closes.
        The deviations are not returned (only the linear probe uses them)."""
        A, B = alpha.shape[0], state.us.shape[0]
        fold = lambda x: x.repeat((A,) + (1,) * (x.dim() - 1))
        scale = lambda x: (alpha.reshape((A, 1) + (1,) * (x.dim() - 1))
                           * x[None]).reshape((A * B,) + x.shape[1:])
        d, k = scale(lin["d"]), scale(state.k)
        dp = params["dyn"]
        out = fast_rollout(fold(state.qs), fold(state.xis), fold(state.us), k, fold(state.K), d,
                           fold(lin["fxi"]), se3.exp(d[..., :6]), se3.inverse(fold(lin["fq"])),
                           dp.J, dp.Jinv, self.pallas_rollout_dt)
        return (*(x.reshape((A, B) + x.shape[1:]) for x in out), None, None)

    def _rollout(self, params, lin, state, alpha, mode=None):
        if (mode or self.cfg.rollout) == "linear":
            return self._rollout_linear(lin, state, alpha)
        return self._rollout_nonlinear(params, lin, state, alpha)

    def _expected_cost_change(self, lin, xs_errs, us_errs):
        """ref `_expected_cost_change:2756-2769` (alpha = 1 probe), per
        problem: xs_errs (B, N+1, nx), us_errs (B, N, nu)."""
        first = (torch.einsum("bni,bni->b", lin["Lx"], xs_errs)
                 + torch.einsum("bni,bni->b", lin["Lu"], us_errs))
        second = (torch.einsum("bni,bnij,bnj->b", xs_errs, lin["Lxx"], xs_errs)
                  + torch.einsum("bni,bnij,bnj->b", us_errs, lin["Luu"], us_errs)
                  + 2.0 * torch.einsum("bni,bnij,bnj->b", us_errs, lin["Lux"],
                                       xs_errs[:, :-1]))
        return first, second

    # -- one iteration -------------------------------------------------------

    def _iteration(self, params, state: SolverState, active=None) -> SolverState:
        """One iteration of every problem; ``active`` (B,) marks the problems
        whose result is kept (a frozen problem triggers no LM retry)."""
        cfg = self.cfg
        B = state.us.shape[0]
        dev, dt = state.us.device, state.us.dtype
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=dev)
        lin = self._linearize(params, state.qs, state.xis, state.us)
        d_norm = torch.linalg.norm(lin["d"].flatten(1), dim=-1)
        J_opt = lin["L"].sum(dim=-1)

        if cfg.multiple_shooting:
            k, K, Vx_n, Vxx_n, mu_new, delta_new, _ = self._backward(
                lin, state.mu, state.delta, active)
            grad_norm = self._grad_norm_ms(lin, Vx_n, Vxx_n)
            converged = (grad_norm < cfg.tol_grad_norm) & (d_norm < cfg.tol_d_norm)
        else:
            # SS checks convergence *before* the backward pass (ref :633-638)
            grad_norm = self._grad_norm_ss(lin)
            converged = grad_norm < cfg.tol_grad_norm
            k, K, Vx_n, Vxx_n, mu_new, delta_new, _ = self._backward(
                lin, state.mu, state.delta, active)

        probe = state._replace(k=k, K=K)
        alphas = alpha_ladder(cfg.n_alphas, dtype=dt, device=dev)
        one = torch.ones(1, dtype=dt, device=dev)
        lanes = torch.arange(B, device=dev)
        yes = torch.ones(B, dtype=torch.bool, device=dev)

        if cfg.multiple_shooting and cfg.line_search:
            # merit-function line search (ref :2549-2590)
            *_, xs_p, us_p = self._rollout(params, lin, probe, one, mode="linear")
            ecc1, ecc2 = self._expected_cost_change(lin, xs_p[0], us_p[0])
            d_weight = torch.where(
                d_norm < cfg.defect_kappa, state.d_weight,
                torch.clamp(cfg.defect_mu0 + torch.abs(ecc1 + 0.5 * ecc2)
                            / ((1.0 - cfg.defect_rho) * d_norm), min=cfg.defect_mu_min))
            merit = J_opt + d_weight * d_norm
            qs_a, xis_a, us_a, _, _ = self._rollout(params, lin, probe, alphas)
            J_a = self._traj_cost(params, qs_a, xis_a, us_a)          # (A, B)
            dn_a = self._defect_norm(params, qs_a, xis_a, us_a)
            al = alphas[:, None]
            J_exp = al * ecc1 + 0.5 * al ** 2 * ecc2
            ok_a = (J_a + d_weight * dn_a - merit) < cfg.defect_gamma * (
                J_exp - al * d_weight * d_norm)
            first = torch.argmax(ok_a.to(torch.int8), dim=0)
            accepted = ok_a.any(dim=0)
            qs_new, xis_new, us_new = (x[first, lanes] for x in (qs_a, xis_a, us_a))
            J_new, dn_new, alpha_used = J_a[first, lanes], dn_a[first, lanes], alphas[first]
            failed_now = ~accepted
        elif cfg.multiple_shooting:
            # no line search: one alpha = 1 rollout, always accepted (ref :2592-2600)
            qs_new, xis_new, us_new = (x[0] for x in self._rollout(params, lin, probe, one)[:3])
            J_new = self._traj_cost(params, qs_new, xis_new, us_new)
            dn_new = self._defect_norm(params, qs_new, xis_new, us_new)
            d_weight = state.d_weight
            alpha_used = one.expand(B)
            accepted, failed_now = yes, ~yes
        else:
            # SS backtracking: the first alpha with J_new < J_opt (ref :654-672)
            qs_a, xis_a, us_a, _, _ = self._rollout(params, lin, probe, alphas)
            J_a = self._traj_cost(params, qs_a, xis_a, us_a)
            ok_a = J_a < J_opt
            first = torch.argmax(ok_a.to(torch.int8), dim=0)
            accepted = ok_a.any(dim=0)
            qs_new, xis_new, us_new = (x[first, lanes] for x in (qs_a, xis_a, us_a))
            J_new = J_a[first, lanes]
            dn_new = torch.zeros(B, dtype=dt, device=dev)
            d_weight = state.d_weight
            alpha_used = alphas[first]
            failed_now = ~accepted

        # On convergence the reference breaks before the rollout: keep the
        # old trajectory; on non-acceptance too.
        take_new = ~converged & accepted
        return SolverState(
            qs=_where(take_new, qs_new, state.qs),
            xis=_where(take_new, xis_new, state.xis),
            us=_where(take_new, us_new, state.us),
            k=k, K=K, mu=mu_new, delta=delta_new, d_weight=d_weight,
            J_opt=torch.where(take_new, J_new, J_opt), grad_norm=grad_norm,
            d_norm=torch.where(take_new, dn_new, d_norm), alpha=alpha_used,
            iteration=state.iteration + 1, converged=converged,
            accepted=accepted & ~converged, failed=failed_now & ~converged)

    def _step(self, params, state, active):
        """One iteration on the active problems; the others keep their state
        (the selects of a vmapped while loop)."""
        new = self._iteration(params, state, active)
        return SolverState(*(_where(active, n, o) for n, o in zip(new, state)))

    # -- drivers -------------------------------------------------------------

    def fit(self, params, x0, us_init, n_iterations=None, on_iteration=None,
            q_ref=None, xi_ref=None, state: Optional[SolverState] = None):
        """Host driver with per-iteration histories and callbacks (the
        reference `fit` contract, `traopt_controller.py:2443-2639`): at most
        ``n_iterations`` iterations, each problem stopping when it converges
        or its line search fails.  Returns ((qs, xis), us, J_hist,
        grad_hist, defect_hist, state); each history entry is a list of B
        floats."""
        n_iterations = n_iterations or self.cfg.max_iterations
        if state is None:
            state = self.init_state(params, x0, us_init, q_ref, xi_ref)
        J_hist, grad_hist, defect_hist = [], [], []
        for _ in range(n_iterations):
            state = self._step(params, state, ~(state.converged | state.failed))
            J_hist.append(state.J_opt.tolist())
            grad_hist.append(state.grad_norm.tolist())
            defect_hist.append(state.d_norm.tolist())
            if on_iteration is not None:
                on_iteration(state)
            if not bool((~(state.converged | state.failed)).any()):
                break
        return (state.qs, state.xis), state.us, J_hist, grad_hist, defect_hist, state

    def _solve_loop(self, params, state: SolverState) -> SolverState:
        """Iterate every problem until it converges, fails or reaches
        ``max_iterations``."""
        cfg = self.cfg
        while True:
            active = (state.iteration < cfg.max_iterations) & ~state.converged & ~state.failed
            if not bool(active.any()):
                return state
            state = self._step(params, state, active)

    def solve(self, params, x0, us_init, q_ref=None, xi_ref=None):
        """Solve from x0 = (q0s (B, m, m), xi0s (B, d)) and us_init
        (B, N, nu) to convergence (the MPC path).  Returns the final
        `SolverState`."""
        return self._solve_loop(params, self.init_state(params, x0, us_init, q_ref, xi_ref))
