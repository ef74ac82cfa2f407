"""Gauss-Newton tracking cost parameters (part of the JAX `models/costs.py`).

    l  = ||Log(X Xbar^-1)||^2_Q1 + ||xi - xibar||^2_Q2 + ||u||^2_R
    lN = ||Log(X Xbar^-1)||^2_P1 + ||xi - xibar||^2_P2

The quadratization itself is lane stage math (`ops/linearize.stage_cost_quad`).
``q_ref_inv`` and ``Ad_ref`` depend on the reference only and are computed
once here.
"""

import dataclasses

import torch

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
