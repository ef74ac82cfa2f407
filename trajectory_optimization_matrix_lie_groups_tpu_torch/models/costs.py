"""Gauss-Newton tracking cost (part of the JAX `models/costs.py`).

    l  = ||Log(X Xbar^-1)||^2_Q1 + ||xi - xibar||^2_Q2 + ||u||^2_R
    lN = ||Log(X Xbar^-1)||^2_P1 + ||xi - xibar||^2_P2

`tracking_cost` is the batch-first, group-generic `CostDef` the generic
solver (`solvers/batched.py`) takes; the pipelines use the lane stage math
(`ops/linearize.stage_cost_quad`, `solvers/pipeline_so3.so3_stage_cost_quad`).
``q_ref_inv`` and ``Ad_ref`` depend on the reference only and are computed
once here.
"""

import dataclasses

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
