"""Augmented-Lagrangian constrained MS-iLQR (counterpart of the JAX
`solvers/al_ilqr.py`, ref `AL_iLQR_Tracking_SE3_MS`).

Outer loop (traopt_controller.py:3218-3293): solve the AL-weighted problem
with the inner `LieILQR` to convergence, evaluate the constraints along the
solution, update the multipliers by clipped first-order ascent with the
active-set penalty rebuild, escalate the penalty geometrically, stop when
max g < tol_constr.  The AL state (lmbd, Imu, mu) lives in the cost
params (`models.costs.ALParams`).

Batch-native as `LieILQR`: B problems run the loop together, and a problem
whose constraints are met is frozen (its multipliers, penalty and solution
stay) while the others go on (`costs.al_update_params`' ``freeze``); the
loop ends when every problem is met or after ``n_al_iters`` outers.  For
B = 1 this is the JAX loop.
"""

from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.constraints import (
    ConstraintDef,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR


class ALResult(NamedTuple):
    qs: torch.Tensor             # (B, N+1, m, m)
    xis: torch.Tensor            # (B, N+1, d)
    us: torch.Tensor             # (B, N, nu)
    al_params: costs.ALParams
    constr_eval: torch.Tensor    # (B, N+1, c)
    outer_iterations: int        # outers run (the most any problem took)
    constr_converged: bool       # every problem's max g < tol_constr
    inner_histories: list        # per outer: dict(J, grad, defect) of `LieILQR.fit`


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)), new, old)


class ALILQR:
    """AL outer loop around a `LieILQR` inner solver built with the
    AL-wrapped cost (`models.costs.al_cost`), whose params are `ALParams`."""

    def __init__(self, inner: LieILQR, constraint: ConstraintDef,
                 mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        self.inner = inner
        self.constraint = constraint
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr

    def _eval_constraints(self, al_params, qs, xis, us):
        """Stage-wise g over the trajectory and the terminal g (ref
        :3242-3248): (B, N+1, c)."""
        N = us.shape[1]
        idx = torch.arange(N, device=us.device)
        g_stage = self.constraint.g(al_params.constr, qs[:, :-1], xis[:, :-1], us, idx, False)
        g_term = self.constraint.g(al_params.constr, qs[:, -1], xis[:, -1],
                                   torch.zeros_like(us[:, 0]), N, True)
        return torch.cat([g_stage, g_term[:, None]], dim=1)

    def fit(self, params, x0, us_init, n_al_iters=100, n_ilqr_iters=200,
            on_iteration_al=None, on_iteration_ilqr=None):
        """params: {'dyn': ..., 'cost': ALParams}; x0 = (q0s (B, m, m),
        xi0s (B, d)); us_init (B, N, nu).  Mirrors ref `fit:3218`: the inner
        solve restarts from ``us_init`` every outer
        (traopt_controller.py:3237)."""
        al = params["cost"]
        histories = []
        result = None
        met = None
        for outer in range(n_al_iters):
            p = {"dyn": params["dyn"], "cost": al}
            (qs, xis), us, J_hist, grad_hist, defect_hist, _ = self.inner.fit(
                p, x0, us_init, n_iterations=n_ilqr_iters,
                on_iteration=on_iteration_ilqr,
                q_ref=al.cost.q_ref, xi_ref=al.cost.xi_ref)
            histories.append(dict(J=J_hist, grad=grad_hist, defect=defect_hist))
            constr_eval = self._eval_constraints(al, qs, xis, us)
            if met is not None:
                # problems met at an earlier outer keep that outer's solution
                qs, xis, us, constr_eval = (
                    _where(met, old, new) for old, new in
                    zip((result.qs, result.xis, result.us, result.constr_eval),
                        (qs, xis, us, constr_eval)))
            met = constr_eval.flatten(1).amax(dim=1) < self.tol_constr
            constr_converged = bool(met.all())
            if on_iteration_al is not None:
                on_iteration_al(outer, constr_converged, al, constr_eval)
            result = ALResult(qs, xis, us, al, constr_eval, outer + 1,
                              constr_converged, histories)
            if constr_converged:
                break
            al = costs.al_update_params(al, constr_eval, self.mu_scale, self.mu_max,
                                        freeze=met)
        return result
