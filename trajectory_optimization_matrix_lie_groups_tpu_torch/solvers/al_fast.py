"""Batched augmented-Lagrangian MS-iLQR on the generic fast tier
(counterpart of the JAX `solvers/al_fast.py`).

The reference's constrained solver (`AL_iLQR_Tracking_SE3_MS`,
traopt_controller.py:3139-3293) solves one problem per process.  This
module runs the same AL outer loop around the batch-explicit
`FastBatchSolver`, so a batch of input-constrained problems solves at once:

    outer k:  inner fixed-budget batched MS-iLQR solve
              -> per-problem constraint evaluation g (B, N+1, c)
              -> per-problem multiplier ascent + active-set penalty rebuild
                 (models.costs.al_update_params)
              -> stop when every problem satisfies max g < tol

The AL state rides in the cost params (`models.costs.ALParams`): after the
first update the multipliers are per problem (B, N+1, c).  On the card the
inner runs its backward pass on kernel B13 and, with ``pallas_rollout_dt``
set on the free SE(3) body, its alpha = 1 rollout on kernel B14: the AL
terms change only the cost, which B14 does not read.  Kernel B1 implements
the plain tracking cost only, so an AL inner linearizes with the model's
batch-first functions.
"""

from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.constraints import (
    ConstraintDef,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


class ALFastResult(NamedTuple):
    qs: torch.Tensor            # (B, N+1, 4, 4)
    xis: torch.Tensor           # (B, N+1, 6)
    us: torch.Tensor            # (B, N, nu)
    J_opt: torch.Tensor         # (B,)
    al_params: costs.ALParams
    constr_eval: torch.Tensor   # (B, N+1, c)
    max_violation: torch.Tensor  # (B,)
    outer_iterations: int
    constr_converged: object    # bool (`solve`) or a bool tensor (`solve_in_graph`)


class ALFastSolver:
    """AL outer loop around a FastBatchSolver built with the al_cost model."""

    def __init__(self, inner: FastBatchSolver, constraint: ConstraintDef,
                 mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        if inner.pallas_linearize:
            raise ValueError("ALFastSolver: kernel B1 computes the plain "
                             "tracking cost only; build the inner without "
                             "use_pallas_linearize")
        self.inner = inner
        self.constraint = constraint
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr
        self._ls_inner = None

    def _ls_solver(self) -> FastBatchSolver:
        """Line-searched twin of the fast inner (built lazily, cached): same
        model, N and kernels, merit line search on, a budget of at least 60
        iterations.  With the inner's ``pallas_rollout_dt`` (the free body)
        the 13 candidate rollouts of an iteration are one B14 launch; the
        JAX twin rolls them out under a vmap, which its rollout kernel
        cannot take."""
        if self._ls_inner is None:
            inner = self.inner
            self._ls_inner = FastBatchSolver(
                inner.model, inner.N, iterations=max(inner.iterations, 60),
                use_pallas=inner.use_pallas,
                pallas_rollout_dt=inner.pallas_rollout_dt, line_search=True,
                plain=inner.plain)
        return self._ls_inner

    def _eval_constraints(self, al: costs.ALParams, qs, xis, us):
        """Batched stage-wise g + terminal (ref :3242-3248)."""
        N = us.shape[-2]
        idx = torch.arange(N, device=us.device)
        g_stage = self.constraint.g(al.constr, qs[:, :-1], xis[:, :-1], us,
                                    idx, False)
        u_term = torch.zeros_like(us[:, 0])
        g_term = self.constraint.g(al.constr, qs[:, -1], xis[:, -1], u_term,
                                   N, True)
        return torch.cat([g_stage, g_term[:, None]], dim=1)

    @staticmethod
    def _inputs(q0s, xi0s, us0, q_ref, xi_ref):
        """The solve's tensors on ``us0``'s device (the card when it is not
        a tensor), in its dtype."""
        us0 = torch.as_tensor(us0, device=solve_device(us0))
        cast = lambda x: torch.as_tensor(x).to(device=us0.device, dtype=us0.dtype)
        return cast(q0s), cast(xi0s), us0, cast(q_ref), cast(xi_ref)

    def solve(self, params, q0s, xi0s, us0, q_ref=None, xi_ref=None,
              n_al_iters=10, rescue=False):
        """params: {'dyn': ..., 'cost': ALParams}; batched initial states.

        Mirrors ref `fit:3218` (inner restarts from `us0` each outer
        iteration, traopt_controller.py:3237).

        ``rescue``: re-solve any still-unconverged problems with the
        line-searched batched inner (`FastBatchSolver(line_search=True)`).
        The fast inner (fixed budget, mu = 0, alpha = 1) can limit-cycle on
        problems whose unconstrained optimum is far outside the box; the
        merit line search converges those, and the re-solve runs all
        failing lanes as one batch."""
        al = params["cost"]
        q_ref = al.cost.q_ref if q_ref is None else q_ref
        xi_ref = al.cost.xi_ref if xi_ref is None else xi_ref
        if n_al_iters < 1:
            raise ValueError("n_al_iters must be >= 1")
        q0s, xi0s, us0, q_ref, xi_ref = self._inputs(q0s, xi0s, us0, q_ref, xi_ref)
        st, al, constr_eval, converged, outer = self._outer_loop(
            self.inner, params["dyn"], al, q0s, xi0s, us0, q_ref, xi_ref,
            n_al_iters)
        qs, xis, us, J_opt = st.qs, st.xis, st.us, st.J_opt
        if rescue and not converged:
            qs, xis, us, J_opt, constr_eval = self._rescue(
                params, q0s, xi0s, us0, qs, xis, us, J_opt, constr_eval,
                q_ref, xi_ref, n_al_iters)
            converged = bool(constr_eval.max() < self.tol_constr)
        return ALFastResult(
            qs=qs, xis=xis, us=us, J_opt=J_opt, al_params=al,
            constr_eval=constr_eval,
            max_violation=torch.amax(constr_eval, dim=(1, 2)),
            outer_iterations=outer + 1, constr_converged=converged)

    def _outer_loop(self, inner, dyn_params, al, q0s, xi0s, us0, q_ref,
                    xi_ref, n_al_iters):
        """The AL outer loop (ref fit:3218) around a given batched inner."""
        st = constr_eval = None
        converged = False
        outer = 0
        for outer in range(n_al_iters):
            st = inner._solve({"dyn": dyn_params, "cost": al}, q0s, xi0s, us0,
                              q_ref, xi_ref)
            constr_eval = self._eval_constraints(al, st.qs, st.xis, st.us)
            max_v = torch.amax(constr_eval, dim=(1, 2))
            converged = bool(max_v.max() < self.tol_constr)
            if converged:
                break
            # per-problem freeze: stop updating problems already satisfying
            # the tolerance (see costs.al_update_params)
            al = costs.al_update_params(al, constr_eval, self.mu_scale,
                                        self.mu_max,
                                        freeze=max_v < self.tol_constr)
        return st, al, constr_eval, converged, outer

    # -- the variant with no host sync -------------------------------------------

    @staticmethod
    def _broadcast_al(al: costs.ALParams, B: int) -> costs.ALParams:
        """Per-problem AL state: (N+1, c) multipliers broadcast to (B, N+1, c)
        (and Imu, mu alike), so every outer iteration sees the same shapes."""
        if al.lmbd.dim() == 2:
            N1, c = al.lmbd.shape
            al = costs.ALParams(
                cost=al.cost, constr=al.constr,
                lmbd=al.lmbd.expand(B, N1, c), Imu=al.Imu.expand(B, N1, c, c),
                mu=al.mu.expand(B))
        return al

    def _outer_loop_graph(self, inner, dyn_params, al, q0s, xi0s, us0, q_ref,
                          xi_ref, n_al_iters):
        """The AL outer loop with a fixed budget and per-problem freeze, and
        no host sync: the same semantics as `_outer_loop` (frozen problems
        re-solve to the same iterate, so running the full budget is
        equivalent to the reference's convergence break,
        traopt_controller.py:3250).
        Returns (al, qs, xis, us, J, constr_eval, max_violation)."""
        B, N = q0s.shape[0], us0.shape[1]
        m = q0s.shape[-1]
        d = self.inner.model.nx // 2
        c = al.lmbd.shape[-1]
        z = lambda *shape: torch.zeros(shape, dtype=us0.dtype, device=us0.device)
        carry = (al, z(B, N + 1, m, m), z(B, N + 1, d),
                 z(B, N, self.inner.model.nu), z(B), z(B, N + 1, c),
                 torch.full((B,), float("inf"), dtype=us0.dtype, device=us0.device))
        for _ in range(n_al_iters):
            al = carry[0]
            st = inner._solve({"dyn": dyn_params, "cost": al}, q0s, xi0s, us0,
                              q_ref, xi_ref)
            ce = self._eval_constraints(al, st.qs, st.xis, st.us)
            mv = torch.amax(ce, dim=(1, 2))
            al = costs.al_update_params(al, ce, self.mu_scale, self.mu_max,
                                        freeze=mv < self.tol_constr)
            carry = (al, st.qs, st.xis, st.us, st.J_opt, ce, mv)
        return carry

    def solve_in_graph(self, params, q0s, xi0s, us0, q_ref=None, xi_ref=None,
                       n_al_iters=10, rescue=False, rescue_outers=None):
        """The AL solve with no host sync, and an optional masked rescue.

        Unlike `solve` (a host-side convergence break and host lane
        patching), the outer loop runs its full budget with per-problem
        freeze, and ``rescue=True`` re-runs the AL loop with the
        line-searched inner on all lanes, keeping its result only for lanes
        the fast pass left above tolerance (`torch.where` on the
        unconverged mask).  The constrained MPC (`solvers/mpc.py`) uses the
        same pattern.

        Returns an `ALFastResult` whose `constr_converged` is a bool tensor
        (call `bool()` to read it)."""
        al0 = params["cost"]
        q_ref = al0.cost.q_ref if q_ref is None else q_ref
        xi_ref = al0.cost.xi_ref if xi_ref is None else xi_ref
        q0s, xi0s, us0, q_ref, xi_ref = self._inputs(q0s, xi0s, us0, q_ref, xi_ref)
        B = q0s.shape[0]
        al0b = self._broadcast_al(al0, B)
        al_f, qs, xis, us, J, ce, mv = self._outer_loop_graph(
            self.inner, params["dyn"], al0b, q0s, xi0s, us0, q_ref, xi_ref,
            n_al_iters)
        if rescue:
            n_r = rescue_outers if rescue_outers is not None else max(n_al_iters, 20)
            al_r, qs_r, xis_r, us_r, J_r, ce_r, mv_r = self._outer_loop_graph(
                self._ls_solver(), params["dyn"], al0b, q0s, xi0s, us0, q_ref,
                xi_ref, n_r)
            bad = mv >= self.tol_constr
            w = lambda r, f: torch.where(bad.reshape((B,) + (1,) * (f.dim() - 1)), r, f)
            qs, xis, us = w(qs_r, qs), w(xis_r, xis), w(us_r, us)
            J, ce = w(J_r, J), w(ce_r, ce)
            mv = torch.where(bad, mv_r, mv)
            al_f = costs.ALParams(
                cost=al_f.cost, constr=al_f.constr, lmbd=w(al_r.lmbd, al_f.lmbd),
                Imu=w(al_r.Imu, al_f.Imu), mu=torch.where(bad, al_r.mu, al_f.mu))
        return ALFastResult(
            qs=qs, xis=xis, us=us, J_opt=J, al_params=al_f, constr_eval=ce,
            max_violation=mv, outer_iterations=n_al_iters,
            constr_converged=torch.all(mv < self.tol_constr))

    def _rescue(self, params, q0s, xi0s, us0, qs, xis, us, J_opt, constr_eval,
                q_ref, xi_ref, n_al_iters):
        """Batched re-solve of unconverged lanes (see ``solve``)."""
        al0 = params["cost"]
        maxv = torch.amax(constr_eval, dim=(1, 2))
        bad = torch.nonzero(maxv >= self.tol_constr)[:, 0]
        st_b, _, ce_b, _, _ = self._outer_loop(
            self._ls_solver(), params["dyn"], al0, q0s[bad], xi0s[bad],
            us0[bad], q_ref, xi_ref, max(n_al_iters, 20))
        qs, xis, us = qs.clone(), xis.clone(), us.clone()
        J_opt, constr_eval = J_opt.clone(), constr_eval.clone()
        qs[bad], xis[bad], us[bad] = st_b.qs, st_b.xis, st_b.us
        J_opt[bad] = st_b.J_opt
        constr_eval[bad] = ce_b
        return qs, xis, us, J_opt, constr_eval
