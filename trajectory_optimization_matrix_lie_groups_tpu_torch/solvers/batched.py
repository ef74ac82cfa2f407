"""Batch-explicit fast MS-iLQR on any `LieModel` (counterpart of the JAX
`solvers/batched.py`), with kernels B1, B13 and B14.

The problem batch stays explicit end to end (batch first), per iteration:

    linearize  -- the model's functions broadcast over (B, N, ...), or with
                  ``use_pallas_linearize`` kernel B1 (SE(3) free body + GN
                  tracking only)
    backward   -- kernel B13 on the whole batch (``use_pallas``), or a
                  batched loop over stages
    rollout    -- the gap-closing nonlinear rollout (alpha = 1): kernel B14
                  when ``pallas_rollout_dt`` is set (free body only), else a
                  batched loop over stages

Fixed iteration budget, no line search, fixed mu = 0.  ``line_search=True``
adds the per-lane batched merit line search: every candidate of the alpha
ladder is rolled out at once (the ladder folded into the batch) and every
lane takes its own first acceptable step; lanes with none keep their
iterate.  The candidate rollouts take B14 when ``pallas_rollout_dt`` is
set (all 13 candidates of every lane in one launch), else the loop over
stages; the backward pass stays on B13.

``plain=True`` runs the plain versions of B1, B13 and B14 whatever the
device.  A solve given numpy inputs runs on the card.
"""

from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import LieModel
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    linearize,
    linearize_lane,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.riccati import (
    backward_lane,
    backward_lane_any,
    fast_backward,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.rollout import (
    fast_rollout,
    rollout_lane,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import (
    chol_solve_psd,
)

KERNELS = {"B1": linearize_lane, "B13": backward_lane, "B13any": backward_lane_any,
           "B13nuL": backward_lane_any.nuL, "B14": rollout_lane}


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def alpha_ladder(n, dtype=torch.float64, device=None):
    """Backtracking candidates 1.1**(-arange(n)**2)."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 1.1 ** (-(i * i))


class FastBatchState(NamedTuple):
    qs: torch.Tensor         # (B, N+1, m, m)
    xis: torch.Tensor        # (B, N+1, d)
    us: torch.Tensor         # (B, N, nu)
    J_opt: torch.Tensor      # (B,)
    grad_norm: torch.Tensor  # (B,)


class FastBatchSolver:
    """Fixed-budget batched MS-iLQR with the B13 backward pass.

    ``pallas_rollout_dt``: the time step, to run the alpha = 1 rollout as
    kernel B14; ``use_pallas_linearize``: run the stage linearization as
    kernel B1.  Both are valid only for the free SE(3) body (`se3_dynamics`)
    + GN tracking cost, whose math the kernels implement.  The names follow
    the JAX solver's.  ``use_pallas=False`` is the batched loop backward
    (a linear solve in f32, an unrolled Cholesky in f64)."""

    def __init__(self, model: LieModel, N: int, iterations: int,
                 use_pallas: bool = True, pallas_rollout_dt: float = None,
                 use_pallas_linearize: bool = False,
                 line_search: bool = False, n_alphas: int = 13,
                 defect_mu0: float = 10.0, defect_rho: float = 0.5,
                 defect_gamma: float = 0.05, defect_mu_min: float = 10.0,
                 defect_kappa: float = 1e-12, plain: bool = False):
        self.model = model
        self.N = N
        self.iterations = iterations
        self.use_pallas = use_pallas
        self.pallas_rollout_dt = pallas_rollout_dt
        self.pallas_linearize = use_pallas_linearize
        self.line_search = line_search
        self.n_alphas = n_alphas
        self.defect_mu0 = defect_mu0
        self.defect_rho = defect_rho
        self.defect_gamma = defect_gamma
        self.defect_mu_min = defect_mu_min
        self.defect_kappa = defect_kappa
        self.plain = plain

    def _linearize(self, params, qs, xis, us):
        if self.pallas_linearize:
            return self._linearize_pallas(params, qs, xis, us)
        model = self.model
        idx = torch.arange(self.N, device=us.device)
        q_s, xi_s = qs[:, :-1], xis[:, :-1]
        fq, fxi = model.step(params, q_s, xi_s, us, idx)
        Fx, Fu = model.jac(params, q_s, xi_s, us, idx)
        L, Lx, Lu, Lxx, Lux, Luu = model.stage_quad(params, q_s, xi_s, us, idx)
        LN, LNx, LNxx = model.term_quad(params, qs[:, -1], xis[:, -1], self.N)
        d_q = model.group.rminus(fq, qs[:, 1:])
        d = torch.cat([d_q, fxi - xis[:, 1:]], dim=-1)
        return dict(
            fq=fq, fxi=fxi, Fx=Fx, Fu=Fu, d=d,
            L=torch.cat([L, LN[:, None]], dim=1),
            Lx=torch.cat([Lx, LNx[:, None]], dim=1),
            Lu=Lu,
            Lxx=torch.cat([Lxx, LNxx[:, None]], dim=1),
            Lux=Lux, Luu=Luu,
        )

    def _linearize_pallas(self, params, qs, xis, us):
        """Kernel B1 (se3 free body + GN tracking), the control terms and
        the terminal quadratization around it."""
        dp, cp = params["dyn"], params["cost"]
        out = linearize(qs, xis, us, cp.q_ref_inv, cp.Ad_ref, cp.xi_ref, dp.J,
                        dp.Jinv, cp.Q1, cp.Q2, self.pallas_rollout_dt,
                        plain=self.plain)
        B, N, nu = us.shape
        l_u_term = torch.einsum("...i,ij,...j->...", us, cp.R, us)
        Lu = 2.0 * torch.einsum("ij,...j->...i", cp.R, us)
        Luu = (2.0 * cp.R).expand(B, N, nu, nu)
        Lux = torch.zeros((B, N, nu, 12), dtype=us.dtype, device=us.device)
        Fu = torch.cat([torch.zeros_like(dp.Jinv), dp.Jinv], dim=-2) * dp.dt
        LN, LNx, LNxx = self.model.term_quad(params, qs[:, -1], xis[:, -1], N)
        return dict(
            fq=out["fq"], fxi=out["fxi"], Fx=out["Fx"], Fu=Fu.expand(B, N, 12, nu),
            d=out["d"],
            L=torch.cat([out["l"] + l_u_term, LN[:, None]], dim=1),
            Lx=torch.cat([out["lx"], LNx[:, None]], dim=1),
            Lu=Lu,
            Lxx=torch.cat([out["lxx"], LNxx[:, None]], dim=1),
            Lux=Lux, Luu=Luu,
        )

    def _backward(self, lin):
        if self.use_pallas:
            return fast_backward(lin["Fx"], lin["Fu"], lin["d"], lin["Lx"],
                                 lin["Lu"], lin["Lxx"], lin["Lux"], lin["Luu"],
                                 plain=self.plain)
        # loop over stages with a batched carry
        Fx, Fu, d = lin["Fx"], lin["Fu"], lin["d"]
        Vx, Vxx = lin["Lx"][:, -1], lin["Lxx"][:, -1]
        out = {n: [None] * self.N for n in ("k", "K", "Vx1", "Vxx1")}
        for t in reversed(range(self.N)):
            fx, fu, dd = Fx[:, t], Fu[:, t], d[:, t]
            fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
            Vmod = Vx + _bmv(Vxx, dd)
            Qx = lin["Lx"][:, t] + _bmv(fxT, Vmod)
            Qu = lin["Lu"][:, t] + _bmv(fuT, Vmod)
            Qxx = lin["Lxx"][:, t] + fxT @ Vxx @ fx
            Qux = lin["Lux"][:, t] + fuT @ Vxx @ fx
            Quu = lin["Luu"][:, t] + fuT @ Vxx @ fu
            if Quu.dtype == torch.float64:
                k = -chol_solve_psd(Quu, Qu)
                K = -chol_solve_psd(Quu, Qux)
            else:
                k = -torch.linalg.solve(Quu, Qu[..., None])[..., 0]
                K = -torch.linalg.solve(Quu, Qux)
            KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
            out["k"][t], out["K"][t], out["Vx1"][t], out["Vxx1"][t] = k, K, Vx, Vxx
            Vx = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
            Vxx = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        return tuple(torch.stack(out[n], dim=1) for n in ("k", "K", "Vx1", "Vxx1"))

    def _grad_norm(self, lin, Vx1, Vxx1):
        g = lin["Lu"] + _bmv(lin["Fu"].transpose(-1, -2),
                             Vx1 + _bmv(Vxx1.transpose(-1, -2), lin["d"]))
        return torch.mean(torch.linalg.norm(g, dim=-1), dim=-1)

    def _rollout(self, params, lin, qs, xis, us, k, K, alpha=None):
        """Gap-closing nonlinear rollout, batched carry.

        ``alpha=None`` is the alpha = 1 path.  An ``alpha`` tensor (A,) rolls
        out every candidate at once, the ladder folded into the batch
        (candidate a of lane b is lane a * B + b): it scales the feedforward
        and the gap-closing defect (K and the nominal trajectory are
        untouched).  Either runs on kernel B14 when ``pallas_rollout_dt`` is
        set (the free body), else as a loop over stages.  Returns (qs, xis,
        us), batch A * B with an ``alpha``."""
        g = self.model.group
        d, fq, fxi = lin["d"], lin["fq"], lin["fxi"]
        if alpha is not None:
            A = alpha.shape[0]
            fold = lambda x: x.repeat((A,) + (1,) * (x.dim() - 1))
            scale = lambda x: (alpha.reshape((A, 1) + (1,) * (x.dim() - 1))
                               * x[None]).reshape((-1,) + x.shape[1:])
            k, d = scale(k), scale(d)
            qs, xis, us, K, fq, fxi = (fold(x) for x in (qs, xis, us, K, fq, fxi))
        if self.pallas_rollout_dt is not None:
            dp = params["dyn"]
            return fast_rollout(qs, xis, us, k, K, d, fxi, se3.exp(d[..., :6]),
                                se3.inverse(fq), dp.J, dp.Jinv, self.pallas_rollout_dt,
                                plain=self.plain)
        dim = g.dim
        exp_d = g.exp(d[..., :dim])
        fq_inv = g.inverse(fq)
        q_new, xi_new = qs[:, 0], xis[:, 0]
        qs_t, xis_t, us_t = [], [], []
        for i in range(self.N):
            xs_err = torch.cat([g.rminus(q_new, qs[:, i]), xi_new - xis[:, i]], dim=-1)
            u_new = us[:, i] + k[:, i] + _bmv(K[:, i], xs_err)
            fq_new, fxi_new = self.model.step(params, q_new, xi_new, u_new, i)
            q_new = g.normalize(qs[:, i + 1] @ exp_d[:, i] @ fq_inv[:, i] @ fq_new)
            xi_new = xis[:, i + 1] + fxi_new - fxi[:, i] + d[:, i, dim:]
            qs_t.append(q_new)
            xis_t.append(xi_new)
            us_t.append(u_new)
        return (torch.cat([qs[:, :1], torch.stack(qs_t, dim=1)], dim=1),
                torch.cat([xis[:, :1], torch.stack(xis_t, dim=1)], dim=1),
                torch.stack(us_t, dim=1))

    def _iteration(self, params, qs, xis, us):
        lin = self._linearize(params, qs, xis, us)
        k, K, Vx1, Vxx1 = self._backward(lin)
        grad = self._grad_norm(lin, Vx1, Vxx1)
        qs, xis, us = self._rollout(params, lin, qs, xis, us, k, K)
        return qs, xis, us, torch.sum(lin["L"], dim=-1), grad

    # -- batched merit line search (line_search=True) -------------------------

    def _traj_cost_b(self, params, qs, xis, us):
        """Trajectory cost over any leading batch axes: qs (..., N+1, m, m),
        xis (..., N+1, d), us (..., N, nu).  Per-problem cost parameters
        (an AL cost's (B, N+1, c) multipliers) broadcast against the last
        batch axis."""
        idx = torch.arange(self.N, device=us.device)
        L = self.model.stage_cost(params, qs[..., :-1, :, :], xis[..., :-1, :],
                                  us, idx)
        LN = self.model.term_cost(params, qs[..., -1, :, :], xis[..., -1, :],
                                  self.N)
        return torch.sum(L, dim=-1) + LN

    def _defect_norm_b(self, params, qs, xis, us):
        idx = torch.arange(self.N, device=us.device)
        fq, fxi = self.model.step(params, qs[:, :-1], xis[:, :-1], us, idx)
        d_q = self.model.group.rminus(fq, qs[:, 1:])
        d = torch.cat([d_q, fxi - xis[:, 1:]], dim=-1)
        return torch.linalg.norm(d.reshape(qs.shape[0], -1), dim=-1)

    def _probe_errs(self, lin, k, K):
        """alpha = 1 linear gap-closing probe: the per-lane error trajectory
        of the affine maps dx+ = (Fx + Fu K) dx + (Fu k + d) from dx_0 = 0.
        A prefix over stages; it equals the JAX associative scan up to
        roundoff (the scan composes the same maps in another order)."""
        M = lin["Fx"] + lin["Fu"] @ K
        c = _bmv(lin["Fu"], k) + lin["d"]
        b = c[:, 0]
        pref = [b]
        for t in range(1, self.N):
            b = _bmv(M[:, t], b) + c[:, t]
            pref.append(b)
        b_pref = torch.stack(pref, dim=1)
        dx = torch.cat([torch.zeros_like(b_pref[:, :1]), b_pref], dim=1)
        return dx, k + _bmv(K, dx[:, :-1])

    def _ecc_b(self, lin, xs_errs, us_errs):
        """Batched expected cost change: first- and second-order terms."""
        first = (torch.einsum("bni,bni->b", lin["Lx"], xs_errs)
                 + torch.einsum("bni,bni->b", lin["Lu"], us_errs))
        second = (
            torch.einsum("bni,bnij,bnj->b", xs_errs, lin["Lxx"], xs_errs)
            + torch.einsum("bni,bnij,bnj->b", us_errs, lin["Luu"], us_errs)
            + 2.0 * torch.einsum("bni,bnij,bnj->b", us_errs, lin["Lux"],
                                 xs_errs[:, :-1])
        )
        return first, second

    def _iteration_ls(self, params, qs, xis, us, d_weight):
        """One MS iteration with the per-lane batched merit line search: the
        reference's accept rule and d_weight schedule, vectorized over the
        alpha ladder and the problem batch; every lane picks its own first
        acceptable alpha and lanes with none keep their iterate."""
        B = qs.shape[0]
        lin = self._linearize(params, qs, xis, us)
        k, K, Vx1, Vxx1 = self._backward(lin)
        grad = self._grad_norm(lin, Vx1, Vxx1)
        J_opt = torch.sum(lin["L"], dim=-1)
        d_norm = torch.linalg.norm(lin["d"].reshape(B, -1), dim=-1)

        xs_errs_p, us_errs_p = self._probe_errs(lin, k, K)
        ecc1, ecc2 = self._ecc_b(lin, xs_errs_p, us_errs_p)
        d_weight = torch.where(
            d_norm < self.defect_kappa,
            d_weight,
            torch.clamp(
                self.defect_mu0 + torch.abs(ecc1 + 0.5 * ecc2)
                / ((1.0 - self.defect_rho) * torch.clamp(d_norm, min=1e-30)),
                min=self.defect_mu_min),
        )
        merit = J_opt + d_weight * d_norm

        alphas = alpha_ladder(self.n_alphas, dtype=us.dtype, device=us.device)
        A = alphas.shape[0]
        qs_c, xis_c, us_c = self._rollout(params, lin, qs, xis, us, k, K, alpha=alphas)
        # the costs see the candidates as (A, B) so that per-problem cost
        # parameters broadcast against the lanes
        unfold = lambda x: x.reshape((A, B) + x.shape[1:])
        J_a = self._traj_cost_b(params, unfold(qs_c), unfold(xis_c), unfold(us_c))
        dn_a = self._defect_norm_b(params, qs_c, xis_c, us_c).reshape(A, B)
        J_exp = alphas[:, None] * ecc1 + 0.5 * alphas[:, None] ** 2 * ecc2
        merit_a = J_a + d_weight * dn_a
        ok_a = (merit_a - merit) < self.defect_gamma * (
            J_exp - alphas[:, None] * d_weight * d_norm)
        idx_first = torch.argmax(ok_a.to(torch.int8), dim=0)   # first True, (B,)
        accepted = torch.any(ok_a, dim=0)                       # (B,)
        sel = idx_first * B + torch.arange(B, device=us.device)

        def pick(new, old):
            return torch.where(accepted.reshape((B,) + (1,) * (old.dim() - 1)),
                               new[sel], old)

        return (pick(qs_c, qs), pick(xis_c, xis), pick(us_c, us), J_opt, grad,
                d_weight)

    def _solve(self, params, q0s, xi0s, us0, q_ref, xi_ref):
        B = q0s.shape[0]
        qs = torch.cat([q0s[:, None], q_ref[1:].expand((B,) + q_ref[1:].shape)], dim=1)
        xis = torch.cat([xi0s[:, None], xi_ref[1:].expand((B,) + xi_ref[1:].shape)],
                        dim=1)
        us = us0
        J = torch.full((B,), float("inf"), dtype=us.dtype, device=us.device)
        grad = J.clone()
        if self.line_search:
            dw = torch.full((B,), self.defect_mu0, dtype=us.dtype, device=us.device)
            for _ in range(self.iterations):
                qs, xis, us, J, grad, dw = self._iteration_ls(params, qs, xis, us, dw)
        else:
            for _ in range(self.iterations):
                qs, xis, us, J, grad = self._iteration(params, qs, xis, us)
        return FastBatchState(qs=qs, xis=xis, us=us, J_opt=J, grad_norm=grad)

    def solve(self, params, q0s, xi0s, us0, q_ref, xi_ref):
        """params {"dyn", "cost"} (`models.base.make_model`'s); q0s (B, m, m),
        xi0s (B, d), us0 (B, N, nu), whose dtype the solve runs in, on its
        device if it is a tensor, else on the card; q_ref (N+1, m, m),
        xi_ref (N+1, d)."""
        dev = solve_device(us0)
        us0 = torch.as_tensor(us0, device=dev)
        cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=us0.dtype)
        return self._solve(params, cast(q0s), cast(xi0s), us0, cast(q_ref),
                           cast(xi_ref))
