"""Gauss-Newton tracking cost and its augmented-Lagrangian wrapper (the JAX
`models/costs.py`).

    l  = ||Log(X Xbar^-1)||^2_Q1 + ||xi - xibar||^2_Q2 + ||u||^2_R
    lN = ||Log(X Xbar^-1)||^2_P1 + ||xi - xibar||^2_P2

`tracking_cost` is the batch-first, group-generic `CostDef` the generic
solver (`solvers/batched.py`) takes; the pipelines use the lane stage math
(`ops/linearize.stage_cost_quad`, `solvers/pipeline_so3.so3_stage_cost_quad`).
``q_ref_inv`` and ``Ad_ref`` depend on the reference only and are computed
once here.

`al_cost` wraps a cost with the input-box AL terms
LA = l + lambda^T g + 1/2 g^T Imu g; `al_update_params` (dense Imu) and
`al_update_diag` (diagonal penalties, the pipelines' form) are the
reference's first-order multiplier ascent with the active-set penalty
rebuild.
"""

import dataclasses
from typing import Any

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import CostDef
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import Group


@dataclasses.dataclass
class TrackingCostParams:
    Q1: torch.Tensor         # (d, d) pose-error weight
    Q2: torch.Tensor         # (d, d) velocity-error weight
    R: torch.Tensor          # (nu, nu)
    P1: torch.Tensor         # (d, d) terminal pose weight
    P2: torch.Tensor         # (d, d) terminal velocity weight
    q_ref: torch.Tensor      # (N+1, m, m)
    q_ref_inv: torch.Tensor  # (N+1, m, m)
    Ad_ref: torch.Tensor     # (N+1, d, d)
    xi_ref: torch.Tensor     # (N+1, d)


def tracking_cost_params(group: Group, Q, R, P, q_ref, xi_ref):
    """Params from the stacked (2d, 2d) Q and P, pose block first."""
    d = group.dim
    Q, P, R, q_ref = map(torch.as_tensor, (Q, P, R, q_ref))
    xi_ref = torch.as_tensor(xi_ref).reshape(q_ref.shape[0], d)
    return TrackingCostParams(
        Q1=Q[:d, :d], Q2=Q[d:, d:], R=R, P1=P[:d, :d], P2=P[d:, d:],
        q_ref=q_ref, q_ref_inv=group.inverse(q_ref), Ad_ref=group.Ad(q_ref),
        xi_ref=xi_ref)


def _quadform(a, W, b):
    return torch.einsum("...i,ij,...j->...", a, W, b)


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def tracking_cost(group: Group, nu: int, ref_so3_terminal_quirk: bool = False) -> CostDef:
    """Gauss-Newton tracking cost as a `CostDef`.

    The pose error is the left difference e = Log(X Xbar^-1), whose
    right-perturbation Jacobian is J_e_x = Jr^-1(e) Ad(Xbar).
    `ref_so3_terminal_quirk` replicates the reference SO(3) cost's terminal
    inconsistency: the terminal value and gradient use the stage weights Q,
    the terminal Hessian P (the SE(3) cost uses P throughout).  The stage
    index ``i`` is an int or an index tensor over the stage axis."""
    d = group.dim

    def _err(p: TrackingCostParams, q, xi, i):
        return group.log(q @ p.q_ref_inv[i]), xi - p.xi_ref[i]

    def stage_cost(p, q, xi, u, i):
        e, ev = _err(p, q, xi, i)
        return _quadform(e, p.Q1, e) + _quadform(ev, p.Q2, ev) + _quadform(u, p.R, u)

    def term_cost(p, q, xi, i):
        e, ev = _err(p, q, xi, i)
        W1, W2 = (p.Q1, p.Q2) if ref_so3_terminal_quirk else (p.P1, p.P2)
        return _quadform(e, W1, e) + _quadform(ev, W2, ev)

    def _quad(p, q, xi, i, W1, W2):
        e, ev = _err(p, q, xi, i)
        J_e_x = group.Jr_inv(e) @ p.Ad_ref[i]
        JT2 = 2.0 * J_e_x.transpose(-1, -2)
        lx = torch.cat([_bmv(JT2 @ W1, e), 2.0 * _bmv(W2, ev)], dim=-1)
        H_e = JT2 @ W1 @ J_e_x
        H_v = (2.0 * W2).expand(H_e.shape)
        Z = torch.zeros_like(H_e)
        lxx = torch.cat([torch.cat([H_e, Z], dim=-1), torch.cat([Z, H_v], dim=-1)],
                        dim=-2)
        return _quadform(e, W1, e) + _quadform(ev, W2, ev), lx, lxx

    def stage_quad(p, q, xi, u, i):
        l, lx, lxx = _quad(p, q, xi, i, p.Q1, p.Q2)
        l = l + _quadform(u, p.R, u)
        lu = 2.0 * _bmv(p.R, u)
        luu = (2.0 * p.R).expand(lu.shape[:-1] + (nu, nu))
        lux = torch.zeros(lu.shape[:-1] + (nu, 2 * d), dtype=lu.dtype, device=lu.device)
        return l, lx, lu, lxx, lux, luu

    def term_quad(p, q, xi, i):
        if not ref_so3_terminal_quirk:
            return _quad(p, q, xi, i, p.P1, p.P2)
        l, lx, _ = _quad(p, q, xi, i, p.Q1, p.Q2)
        _, _, lxx = _quad(p, q, xi, i, p.P1, p.P2)
        return l, lx, lxx

    return CostDef(nx=2 * d, nu=nu, stage_cost=stage_cost, term_cost=term_cost,
                   stage_quad=stage_quad, term_quad=term_quad)


def tracking_error(group: Group, p: TrackingCostParams, q, xi, i):
    """Pose and velocity error against the reference: (Log(q q_ref^-1),
    xi - xi_ref)."""
    return group.log(q @ p.q_ref_inv[i]), xi - p.xi_ref[i]


# ---------------------------------------------------------------------------
# Augmented Lagrangian transformer  (ref ALConstrainedCost, traopt_cost.py:1173)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ALParams:
    cost: TrackingCostParams
    constr: Any           # the constraint's params (`constraints.InputBoxParams`)
    lmbd: torch.Tensor    # (N+1, c), or (B, N+1, c) per problem
    Imu: torch.Tensor     # (N+1, c, c), or (B, N+1, c, c)
    mu: torch.Tensor      # scalar penalty, or (B,)


def _take(x, i, axis):
    """``x``'s entries ``i`` along ``axis`` (an int, or an index tensor)."""
    if isinstance(i, torch.Tensor) and i.dim() > 0:
        return x.index_select(axis, i.to(x.device))
    return x.select(axis, int(i))


def _common(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def al_cost(base: CostDef, constraint) -> CostDef:
    """Wrap a cost with LA = l + lambda^T g + 1/2 g^T Imu g.

    `constraint` is a ConstraintDef (models.constraints).  Derivative
    composition follows traopt_cost.py:1251-1320 exactly."""

    def _terms(p: ALParams, q, xi, u, i, terminal):
        g = constraint.g(p.constr, q, xi, u, i, terminal)
        gx = constraint.g_x(p.constr, q, xi, u, i, terminal)
        gu = constraint.g_u(p.constr, q, xi, u, i, terminal)
        # stage-indexed from the trailing axes so per-problem (batched)
        # multipliers (B, N+1, c) work alongside (N+1, c)
        lam = _take(p.lmbd, i, -2)
        Imu = _take(p.Imu, i, -3)
        g, gx, gu, lam, Imu = _common(g, gx, gu, lam, Imu)
        return g, gx, gu, lam, Imu

    def _value(g, lam, Imu):
        return (lam * g).sum(-1) + 0.5 * (g * _bmv(Imu, g)).sum(-1)

    def stage_cost(p, q, xi, u, i):
        g, _, _, lam, Imu = _terms(p, q, xi, u, i, False)
        return base.stage_cost(p.cost, q, xi, u, i) + _value(g, lam, Imu)

    def term_cost(p, q, xi, i):
        u = torch.zeros(base.nu, dtype=xi.dtype, device=xi.device)
        g, _, _, lam, Imu = _terms(p, q, xi, u, i, True)
        return base.term_cost(p.cost, q, xi, i) + _value(g, lam, Imu)

    def stage_quad(p, q, xi, u, i):
        l0, lx0, lu0, lxx0, lux0, luu0 = base.stage_quad(p.cost, q, xi, u, i)
        g, gx, gu, lam, Imu = _terms(p, q, xi, u, i, False)
        lig = lam + _bmv(Imu, g)
        gxT, guT = gx.transpose(-1, -2), gu.transpose(-1, -2)
        return (l0 + _value(g, lam, Imu), lx0 + _bmv(gxT, lig),
                lu0 + _bmv(guT, lig), lxx0 + gxT @ Imu @ gx,
                lux0 + guT @ Imu @ gx, luu0 + guT @ Imu @ gu)

    def term_quad(p, q, xi, i):
        u = torch.zeros(base.nu, dtype=xi.dtype, device=xi.device)
        l0, lx0, lxx0 = base.term_quad(p.cost, q, xi, i)
        g, gx, gu, lam, Imu = _terms(p, q, xi, u, i, True)
        lig = lam + _bmv(Imu, g)
        gxT = gx.transpose(-1, -2)
        return (l0 + _value(g, lam, Imu), lx0 + _bmv(gxT, lig),
                lxx0 + gxT @ Imu @ gx)

    return CostDef(nx=base.nx, nu=base.nu, stage_cost=stage_cost,
                   term_cost=term_cost, stage_quad=stage_quad,
                   term_quad=term_quad)


def al_init_params(cost_params, constr_params, N, constr_size, mu0=1e-2,
                   dtype=torch.float64, device=None):
    """Initial AL state (ref AL_iLQR_Tracking_SE3_MS:3182-3189), on
    ``device`` (default: the reference's)."""
    if device is None:
        device = cost_params.q_ref.device
    eye = torch.eye(constr_size, dtype=dtype, device=device)
    return ALParams(
        cost=cost_params, constr=constr_params,
        lmbd=torch.zeros((N + 1, constr_size), dtype=dtype, device=device),
        Imu=(mu0 * eye).repeat(N + 1, 1, 1),
        mu=torch.tensor(mu0, dtype=dtype, device=device))


def al_update_diag(lmbd, imu, mu, g, mu_scale=10.0, mu_max=1e8, freeze=None):
    """Diagonal-Imu variant of `al_update_params` for batched engines that
    carry (B, N+1, c) multipliers and (B, N+1, c) diagonal penalties (the
    pipelines and the constrained MPC).  Same rule:
    lmbd <- clip(lmbd + imu g, 0, inf); mu <- min(mu scale, cap);
    imu <- (g < 0 and lmbd == 0) ? 0 : mu -- with the optional per-problem
    ``freeze`` mask (B,) leaving converged problems untouched."""
    lmbd_new = torch.clamp(lmbd + imu * g, min=0.0)
    mu_new = torch.clamp(mu * mu_scale, max=mu_max)
    if freeze is not None:
        frz = freeze[:, None, None]
        lmbd_new = torch.where(frz, lmbd, lmbd_new)
        mu_new = torch.where(freeze, mu, mu_new)
    imu_new = torch.where((g < 0.0) & (lmbd_new == 0.0), 0.0,
                          mu_new[:, None, None])
    if freeze is not None:
        imu_new = torch.where(freeze[:, None, None], imu, imu_new)
    return lmbd_new, imu_new, mu_new


def al_update_params(p: ALParams, constr_eval, mu_scale=10.0, mu_max=1e8,
                     freeze=None):
    """First-order multiplier update + penalty escalation.

    ref `_al_update_param` (traopt_controller.py:3270-3290):
        lmbd <- clip(lmbd + Imu g, 0, inf)
        mu   <- min(mu * scale, mu_max)
        Imu  <- diag(where(g < 0 and lmbd == 0, 0, mu))

    ``freeze``: optional (B,) bool mask of problems whose AL state must not
    change.  The reference solves one problem and stops updating at
    convergence (traopt_controller.py:3250); the batch generalization
    freezes each converged problem on its own -- without it, a batch's
    collective outer loop keeps escalating penalties on problems already on
    the constraint boundary (g ~ 0 keeps Imu = mu growing to mu_max) until
    it destabilizes them.  After the first frozen update the state is per
    problem: lmbd (B, N+1, c), Imu (B, N+1, c, c), mu (B,)."""
    Imu, ce = _common(p.Imu, constr_eval)
    lmbd_new = torch.clamp(p.lmbd + (Imu @ ce[..., None])[..., 0], min=0.0)
    mu_new = torch.clamp(p.mu * mu_scale, max=mu_max)
    if freeze is not None:
        # per-problem mu: broadcast a scalar mu up to (B,) on first use
        mu_b = p.mu.broadcast_to(freeze.shape)
        mu_new = torch.where(freeze, mu_b, torch.clamp(mu_b * mu_scale, max=mu_max))
        lmbd_new = torch.where(freeze[:, None, None], p.lmbd, lmbd_new)
    act_mu = mu_new[..., None, None] if freeze is not None else mu_new
    active = torch.where((ce < 0.0) & (lmbd_new == 0.0), 0.0, act_mu)
    c = ce.shape[-1]
    Imu_new = active[..., :, None] * torch.eye(c, dtype=active.dtype,
                                               device=active.device)
    if freeze is not None:
        Imu_new = torch.where(freeze[:, None, None, None], p.Imu, Imu_new)
    return dataclasses.replace(p, lmbd=lmbd_new, Imu=Imu_new, mu=mu_new)
