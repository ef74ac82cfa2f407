"""Error-state SE(3) dynamics and costs, 12-d vector state (counterpart of
the JAX `models/errorstate.py`).

Replaces the reference's error-state family:

  - `ErrorStateSE3ApproxLinearRolloutDynamics`   (traopt_dynamics.py:1534)
  - `ErrorStateSE3ApproxNonlinearRolloutDynamics` (traopt_dynamics.py:2038)
  - `ErrorStateSE3ApproxTrackingQuadraticAutodiffCost` (traopt_cost.py:1326)
  - `ErrorStateSE3ApproxGenerationQuadraticAutodiffCost` (traopt_cost.py:1577)

State x = [psi (6), xi (6)]: psi = Log(Xref_i^-1 X) is the left-invariant
error w.r.t. a stored reference trajectory, xi the body twist.  The
continuous error-state linearization about (q_ref, xi_ref) is
(ref `_fc_errstate`, traopt_dynamics.py:2235-2281):

    xdot = At x + Bt u + ht,
    At = [[-ad(xi_ref_i), I], [0, Ht(xi)]],  Ht = Jinv (coad(xi) J + G(xi)),
    ht = [-xi_ref_i; -Jinv G(xi) xi],  Bt = [0; Jinv]

At and ht depend on the current x through Ht, so the solver differentiates
the discretized map (`torch.func.jacfwd`, mapped over all stages at once
with `torch.func.vmap`), as the reference and the JAX package do.

Every function broadcasts over leading batch dimensions; the stage index
``i`` is an int or an integer tensor (batched under `torch.func.vmap`).
Re-anchoring is a pure params update with the closed-form SE(3) Log in
place of the reference's scipy `logm` (traopt_controller.py:4546-4552).
"""

from typing import NamedTuple

import torch
from torch.func import jacfwd

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import setup_inv


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _take(x, i):
    """Row ``i`` of a per-stage array ``x`` (N+1, ...): ``i`` an int or an
    integer tensor of any shape.  A tensor index is taken as one gather
    (under `torch.func.vmap` a batched 0-d index, which plain indexing would
    read back with ``.item()``)."""
    if isinstance(i, torch.Tensor):
        return x[i.reshape(-1)].reshape(i.shape + x.shape[1:])
    return x[i]


class ErrorStateParams(NamedTuple):
    J: torch.Tensor        # (6, 6)
    Jinv: torch.Tensor
    Ib: torch.Tensor
    m: torch.Tensor
    dt: torch.Tensor
    q_ref: torch.Tensor    # (N+1, 4, 4) anchor trajectory
    xi_ref: torch.Tensor   # (N+1, 6)


def errorstate_params(J, dt, q_ref, xi_ref, device=None):
    """The params of the error-state dynamics; the mass is read as J[4, 4]
    as the JAX package does.  Tensors stay on ``J``'s device unless
    ``device`` is given; arrays from numpy go to the card by default."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = J.device if isinstance(J, torch.Tensor) else torch.device("cuda")
    J = torch.as_tensor(J, device=dev)
    q_ref = torch.as_tensor(q_ref, dtype=J.dtype, device=dev)
    return ErrorStateParams(
        J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4],
        dt=torch.as_tensor(dt, dtype=J.dtype, device=dev), q_ref=q_ref,
        xi_ref=torch.as_tensor(xi_ref, dtype=J.dtype, device=dev).reshape(q_ref.shape[0], 6),
    )


def _G(p, xi):
    w, v = xi[..., :3], xi[..., 3:]
    Gw = so3.hat(_bmv(p.Ib, w))
    Gv = p.m * so3.hat(v)
    top = torch.cat([Gw, Gv], dim=-1)
    bot = torch.cat([Gv, torch.zeros_like(Gw)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def fc_errstate(p: ErrorStateParams, x, u, i):
    """Continuous linearized error-state dynamics (ref :2235-2281)."""
    psi = x[..., :6]
    xi = x[..., 6:]
    G = _G(p, xi)
    H = p.Jinv @ (se3.coad(xi) @ p.J + G)
    bt = -_bmv(p.Jinv @ G, xi)
    xi_ref_i = _take(p.xi_ref, i)
    psi_dot = -_bmv(se3.ad(xi_ref_i), psi) + xi - xi_ref_i
    xi_dot = _bmv(H, xi) + _bmv(p.Jinv, u) + bt
    return torch.cat([psi_dot, xi_dot], dim=-1)


def step_euler(p: ErrorStateParams, x, u, i):
    """fd_euler of the error-state linearization (ref :2283-2296)."""
    return x + fc_errstate(p, x, u, i) * p.dt


def step_rk4(p: ErrorStateParams, x, u, i):
    """fd_rk4 (ref :2298-2316)."""
    s1 = fc_errstate(p, x, u, i)
    s2 = fc_errstate(p, x + p.dt / 2 * s1, u, i)
    s3 = fc_errstate(p, x + p.dt / 2 * s2, u, i)
    s4 = fc_errstate(p, x + p.dt * s3, u, i)
    return x + p.dt / 6 * (s1 + 2 * s2 + 2 * s3 + s4)


def jac_autodiff(step):
    """Autodiff Jacobians of an error-state step at one sample (ref
    :2113-2114); map it over stages with `torch.func.vmap`."""

    def jac(p, x, u, i):
        fx = jacfwd(lambda xx: step(p, xx, u, i))(x)
        fu = jacfwd(lambda uu: step(p, x, uu, i))(u)
        return fx, fu

    return jac


def jac_analytic(p: ErrorStateParams, x, u, i):
    """The reference's analytic error-state Jacobians (`At`/`Bt`,
    traopt_dynamics.py:1742-1800), Euler-discretized: Fx = I + At dt,
    Fu = Bt dt.  For `step_euler` this is the exact Jacobian at every x (the
    G terms cancel in `fc_errstate`, and coad(xi) J + G(xi) is the
    derivative of coad(xi) J xi); for `step_rk4` it stays first-order and
    misses the O(dt^2) composition terms that autodiff carries."""
    del u
    xi = x[..., 6:]
    H = p.Jinv @ (se3.coad(xi) @ p.J + _G(p, xi))
    Z = torch.zeros_like(H)
    eye6 = torch.eye(6, dtype=x.dtype, device=x.device).expand(H.shape)
    ad_ref = se3.ad(_take(p.xi_ref, i)).expand(H.shape)
    At = torch.cat([
        torch.cat([-ad_ref, eye6], dim=-1),
        torch.cat([Z, H], dim=-1),
    ], dim=-2)
    Bt = torch.cat([torch.zeros_like(p.Jinv), p.Jinv], dim=-2)
    Fx = torch.eye(12, dtype=x.dtype, device=x.device).expand(At.shape) + At * p.dt
    Fu = Bt.expand(x.shape[:-1] + (12, 6)) * p.dt
    return Fx, Fu


def group_step(p: ErrorStateParams, q, xi, u, i):
    """Exact nonlinear group rollout step (`_fd_euler_fc_group`, ref :2371)."""
    del i
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_dot = _bmv(p.Jinv, _bmv(se3.coad(xi), _bmv(p.J, xi)) + u)
    return q_next, xi + xi_dot * p.dt


def rollout_nominal(p: ErrorStateParams, q0, xi0, us):
    """Roll the group trajectory from u (ref `rollout_nominal...`, :2214):
    q0 (..., 4, 4), xi0 (..., 6), us (..., N, 6) -> qs (..., N+1, 4, 4),
    xis (..., N+1, 6), a loop over steps of the batched `group_step`."""
    qs, xis = [q0], [xi0]
    for i in range(us.shape[-2]):
        q, xi = group_step(p, qs[-1], xis[-1], us[..., i, :], i)
        qs.append(q)
        xis.append(xi)
    return torch.stack(qs, dim=-3), torch.stack(xis, dim=-2)


def reanchor(p: ErrorStateParams, qs_new, xis_new):
    """Re-anchor the reference to a new group trajectory (pure update; the
    reference mutates dynamics and cost state, traopt_controller.py:4546-4552)."""
    return p._replace(q_ref=qs_new, xi_ref=xis_new)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

class ErrorStateTrackingCostParams(NamedTuple):
    Q: torch.Tensor      # (12, 12)
    R: torch.Tensor      # (nu, nu)
    P: torch.Tensor      # (12, 12)
    xi_ref: torch.Tensor  # (N+1, 6)


def tracking_cost_es(p: ErrorStateTrackingCostParams, x, u, i, terminal=False):
    """y = Ct x - dt with velocity coupling Ct (ref traopt_cost.py:1436-1445)."""
    psi = x[..., :6]
    xi = x[..., 6:]
    xi_ref_i = _take(p.xi_ref, i)
    y = torch.cat([psi, -_bmv(se3.ad(xi_ref_i), psi) + xi - xi_ref_i], dim=-1)
    W = p.P if terminal else p.Q
    c = torch.einsum("...i,ij,...j->...", y, W, y)
    if not terminal:
        c = c + torch.einsum("...i,ij,...j->...", u, p.R, u)
    return c


class ErrorStateGoalCostParams(NamedTuple):
    Q: torch.Tensor       # (6, 6) pose-error weight
    R: torch.Tensor
    P: torch.Tensor       # (6, 6)
    phi_goal: torch.Tensor  # (N+1, 6): Log(Xref_i^-1 X_goal)


def goal_cost_params(Q, R, P, q_ref, X_goal):
    """phi_goal_i = Log(Xref_i^-1 X_goal), the closed-form Log in place of
    the reference's per-stage scipy `logm` (traopt_cost.py:1624-1638).  On
    ``q_ref``'s device and dtype."""
    q_ref = torch.as_tensor(q_ref)
    t = lambda a: torch.as_tensor(a).to(dtype=q_ref.dtype, device=q_ref.device)
    phi = se3.log(se3.inverse(q_ref) @ t(X_goal))
    return ErrorStateGoalCostParams(Q=t(Q), R=t(R), P=t(P), phi_goal=phi)


def goal_cost(p: ErrorStateGoalCostParams, x, u, i, terminal=False):
    """l = ||psi - phi_goal_i||^2_Q (+ u^T R u)  (ref traopt_cost.py:1717-1761)."""
    y = x[..., :6] - _take(p.phi_goal, i)
    W = p.P if terminal else p.Q
    c = torch.einsum("...i,ij,...j->...", y, W, y)
    if not terminal:
        c = c + torch.einsum("...i,ij,...j->...", u, p.R, u)
    return c
