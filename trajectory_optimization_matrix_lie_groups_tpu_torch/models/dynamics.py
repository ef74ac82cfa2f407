"""Rigid-body dynamics families on SO(3)/SE(3) (part of the JAX
`models/dynamics.py`).

Ported: the parameter containers of the SO(3) free attitude, the 3-D
pendulum actuated at its pivot, the SE(3) free body, the rigid body with
gravity and the drone (a rigid body with a 6x4 input projection); the
semi-implicit Euler `step` functions and the analytic Jacobians (Fx, Fu) of
all five, and their `DynamicsDef` factories (`models/base.py`), which the
generic `solvers/batched.FastBatchSolver` takes.  They are written
batch-first with the group operations of `ops/so3.py` and `ops/se3.py`,
independently of the lane stage math in `ops/linearize.py` and
`solvers/pipeline_so3.py`, which the tests hold against them.

Quirk flags kept from the reference (see the JAX module docstring):
``ref_coad_swap`` selects the reference's coad-swap in the Jacobian's H
block, ``exact_gravity_jacobian`` the m*g factor of its gravity block.  The
lane stage math (`ops/linearize.stage_jacobian`) always applies the swap and
ignores ``ref_coad_swap``, as the JAX lane kernels do.
"""

import dataclasses

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import DynamicsDef
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import setup_inv

_DOWN = (0.0, 0.0, -1.0)


def _down(like):
    """`_DOWN` in ``like``'s dtype, made on its device without a copy from
    the host (a step may run inside a CUDA graph capture, which refuses
    host-to-device copies: `solvers/graph.py`)."""
    down = torch.zeros(3, dtype=like.dtype, device=like.device)
    down[2:].fill_(_DOWN[2])
    return down


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _blk2(A, B, C, D):
    """[[A, B], [C, D]] over leading batch dims."""
    return torch.cat([torch.cat([A, B], dim=-1), torch.cat([C, D], dim=-1)],
                     dim=-2)


# -- SO(3) free attitude ------------------------------------------------------

@dataclasses.dataclass
class SO3Params:
    J: torch.Tensor      # (3, 3) inertia
    Jinv: torch.Tensor
    dt: torch.Tensor     # scalar


def so3_params(J, dt):
    J = torch.as_tensor(J)
    return SO3Params(J=J, Jinv=setup_inv(J),
                     dt=torch.as_tensor(dt, dtype=J.dtype, device=J.device))


def _so3_step(p: SO3Params, q, xi, u, i=None):
    """q+ = normalize(q Exp(xi dt)), xi+ = xi + dt Jinv (hat(xi)^T J xi + u).
    q (..., 3, 3), xi (..., 3)."""
    del i
    q_next = so3.normalize(q @ so3.exp(xi * p.dt))
    torque = _bmv(so3.hat(xi).transpose(-1, -2), _bmv(p.J, xi)) + u
    return q_next, xi + _bmv(p.Jinv, torque) * p.dt


def _so3_H(p, xi):
    """The velocity block H = Jinv (hat(xi)^T J + hat(J xi))."""
    return p.Jinv @ (so3.hat(xi).transpose(-1, -2) @ p.J + so3.hat(_bmv(p.J, xi)))


def _so3_jac(p: SO3Params, q, xi, u, i=None):
    """Fx = [[Exp(-tau), Jr(tau) dt], [0, I + H dt]], tau = xi dt;
    Fu = [0; Jinv] dt.  Returns (Fx (..., 6, 6), Fu (..., 6, 3))."""
    del q, u, i
    tau = xi * p.dt
    H = _so3_H(p, xi)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(H.shape)
    Fx = _blk2(so3.exp(-tau), so3.right_jacobian(tau) * p.dt,
               torch.zeros_like(H), eye3 + H * p.dt)
    Fu = torch.cat([torch.zeros_like(p.Jinv), p.Jinv], dim=-2) * p.dt
    return Fx, Fu.expand(H.shape[:-2] + (6, 3))


# -- 3-D pendulum actuated at the pivot ---------------------------------------

@dataclasses.dataclass
class Pendulum3dParams:
    J: torch.Tensor
    Jinv: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor      # rod length; the mass sits at l / 2 along down
    g: torch.Tensor
    dt: torch.Tensor


def pendulum3d_params(J, m, length, dt, g=9.8):
    J = torch.as_tensor(J)
    scalar = lambda x: torch.as_tensor(x, dtype=J.dtype, device=J.device)
    return Pendulum3dParams(J=J, Jinv=setup_inv(J), m=scalar(m),
                            l=scalar(length), g=scalar(g), dt=scalar(dt))


def _pend_rho(p):
    down = _down(p.J)
    return p.l / 2.0 * down, down


def _pendulum3d_step(p: Pendulum3dParams, q, xi, u, i=None):
    """The free-attitude step with the gravity torque hat(m g rho) R^T down
    and the pivot input's moment hat(m rho) R^T u."""
    del i
    rho, down = _pend_rho(p)
    Rt = q.transpose(-1, -2)
    g_term = _bmv(so3.hat(p.m * p.g * rho), _bmv(Rt, down))
    M = _bmv(so3.hat(p.m * rho), _bmv(Rt, u))
    torque = _bmv(so3.hat(xi).transpose(-1, -2), _bmv(p.J, xi)) + g_term + M
    q_next = so3.normalize(q @ so3.exp(xi * p.dt))
    return q_next, xi + _bmv(p.Jinv, torque) * p.dt


def _pendulum3d_jac(p: Pendulum3dParams, q, xi, u, i=None):
    """Fx = [[Exp(-tau), Jr(tau) dt], [L dt, I + H dt]] with
    L = Jinv (hat(m g rho) R^T hat(down) R + hat(m rho) R^T hat(u) R);
    Fu = [0; Jinv hat(m rho) R^T] dt, per stage.
    Returns (Fx (..., 6, 6), Fu (..., 6, 3))."""
    del i
    rho, down = _pend_rho(p)
    tau = xi * p.dt
    H = _so3_H(p, xi)
    Rt = q.transpose(-1, -2)
    L1 = so3.hat(p.m * p.g * rho) @ Rt @ so3.hat(down) @ q
    L2 = so3.hat(p.m * rho) @ Rt @ so3.hat(u) @ q
    L = p.Jinv @ (L1 + L2)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(H.shape)
    Fx = _blk2(so3.exp(-tau), so3.right_jacobian(tau) * p.dt, L * p.dt,
               eye3 + H * p.dt)
    bt = p.Jinv @ so3.hat(p.m * rho) @ Rt
    return Fx, torch.cat([torch.zeros_like(bt), bt], dim=-2) * p.dt


# -- SE(3) rigid body ---------------------------------------------------------

@dataclasses.dataclass
class SE3Params:
    J: torch.Tensor      # (6, 6) generalized inertia diag(Ib, m I)
    Jinv: torch.Tensor
    Ib: torch.Tensor     # (3, 3)
    m: torch.Tensor      # scalar mass
    dt: torch.Tensor     # scalar
    ref_coad_swap: bool = True


def se3_params(J, dt, ref_coad_swap=True):
    J = torch.as_tensor(J)
    return SE3Params(J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4],
                     dt=torch.as_tensor(dt, dtype=J.dtype, device=J.device),
                     ref_coad_swap=bool(ref_coad_swap))


@dataclasses.dataclass
class RigidBodyParams:
    J: torch.Tensor
    Jinv: torch.Tensor
    Ib: torch.Tensor
    m: torch.Tensor
    g: torch.Tensor
    dt: torch.Tensor
    Pu: torch.Tensor     # (6, nu) input projection (identity for 6 inputs)
    exact_gravity_jacobian: bool = False
    ref_coad_swap: bool = True


def rigid_body_params(J, dt, g=9.8, Pu=None, exact_gravity_jacobian=False,
                      ref_coad_swap=True):
    J = torch.as_tensor(J)
    scalar = lambda x: torch.as_tensor(x, dtype=J.dtype, device=J.device)
    Pu = torch.eye(6, dtype=J.dtype, device=J.device) if Pu is None else \
        torch.as_tensor(Pu, dtype=J.dtype, device=J.device)
    return RigidBodyParams(J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4],
                           g=scalar(g), dt=scalar(dt), Pu=Pu,
                           exact_gravity_jacobian=bool(exact_gravity_jacobian),
                           ref_coad_swap=bool(ref_coad_swap))


def drone_params(J, dt, g=9.8, exact_gravity_jacobian=False, ref_coad_swap=True):
    """Drone = rigid body + 6x4 projection (3 torques + z-thrust)."""
    J = torch.as_tensor(J)
    Pu = torch.zeros((6, 4), dtype=J.dtype, device=J.device)
    Pu[0, 0] = Pu[1, 1] = Pu[2, 2] = Pu[5, 3] = 1.0
    return rigid_body_params(J, dt, g=g, Pu=Pu,
                             exact_gravity_jacobian=exact_gravity_jacobian,
                             ref_coad_swap=ref_coad_swap)


def _se3_step(p: SE3Params, q, xi, u, i=None):
    """Free body: q+ = normalize(q Exp(xi dt)),
    xi+ = xi + dt Jinv (coad(xi) J xi + u).  q (..., 4, 4), xi (..., 6)."""
    del i
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_next = xi + _bmv(p.Jinv, _bmv(se3.coad(xi), _bmv(p.J, xi)) + u) * p.dt
    return q_next, xi_next


def _gravity_wrench(p, q):
    down = _down(q)
    g_lin = p.m * p.g * _bmv(q[..., :3, :3].transpose(-1, -2), down)
    return torch.cat([torch.zeros_like(g_lin), g_lin], dim=-1)


def _rigid_body_step(p: RigidBodyParams, q, xi, u, i=None):
    """Rigid body / drone: the free-body step plus the gravity wrench
    m g R^T down, with the input entering through Pu."""
    del i
    wrench = (_bmv(se3.coad(xi), _bmv(p.J, xi)) + _gravity_wrench(p, q)
              + _bmv(p.Pu, u))
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_next = xi + _bmv(p.Jinv, wrench) * p.dt
    return q_next, xi_next


# -- batch-first SE(3) Jacobians ----------------------------------------------

def _coad_for_jac(p, xi):
    """coad(xi) for the H block, with the reference's omega/v swap quirk
    unless ``p.ref_coad_swap`` is False."""
    if p.ref_coad_swap:
        return se3.coad(torch.cat([xi[..., 3:], xi[..., :3]], dim=-1))
    return se3.coad(xi)


def _se3_G(p, xi):
    """G = [[hat(Ib w), m hat(v)], [m hat(v), 0]]."""
    Gw = so3.hat(_bmv(p.Ib, xi[..., :3]))
    Gv = p.m * so3.hat(xi[..., 3:])
    return _blk2(Gw, Gv, Gv, torch.zeros_like(Gw))


def _se3_pose_blocks(p, xi):
    """(Ad(Exp(tau))^-1, Jr(tau) dt), tau = xi dt."""
    tau = xi * p.dt
    return se3.Ad(se3.exp(-tau)), se3.right_jacobian(tau) * p.dt


def _se3_jac(p: SE3Params, q, xi, u, i=None):
    """Free body: Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [0, I + H dt]] with
    H = Jinv (coad(xi) J + G); Fu = [0; Jinv] dt.
    Returns (Fx (..., 12, 12), Fu (..., 12, 6))."""
    del q, u, i
    J_q_q, J_q_xi = _se3_pose_blocks(p, xi)
    H = p.Jinv @ (_coad_for_jac(p, xi) @ p.J + _se3_G(p, xi))
    eye6 = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(H.shape)
    Fx = _blk2(J_q_q, J_q_xi, torch.zeros_like(H), eye6 + H * p.dt)
    Fu = torch.cat([torch.zeros_like(p.Jinv), p.Jinv], dim=-2) * p.dt
    return Fx, Fu.expand(H.shape[:-2] + (12, 6))


def _rigid_body_jac(p: RigidBodyParams, q, xi, u, i=None):
    """The free-body Jacobian plus the gravity block
    J_xi_q = Jinv [[0, 0], [J_v_R, 0]] dt, J_v_R = hat(R^T down) (times m g
    only with ``exact_gravity_jacobian``: the reference omits it), and
    Fu = [0; Jinv Pu] dt.  Returns (Fx (..., 12, 12), Fu (..., 12, nu))."""
    del u, i
    J_q_q, J_q_xi = _se3_pose_blocks(p, xi)
    H = p.Jinv @ (_coad_for_jac(p, xi) @ p.J + _se3_G(p, xi))
    down = _down(q)
    J_v_R = so3.hat(_bmv(q[..., :3, :3].transpose(-1, -2), down))
    if p.exact_gravity_jacobian:
        J_v_R = p.m * p.g * J_v_R
    Z3 = torch.zeros_like(J_v_R)
    J_xi_q = p.Jinv @ _blk2(Z3, Z3, J_v_R, Z3) * p.dt
    eye6 = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(H.shape)
    Fx = _blk2(J_q_q, J_q_xi, J_xi_q, eye6 + H * p.dt)
    bt = p.Jinv @ p.Pu
    Fu = torch.cat([torch.zeros_like(bt), bt], dim=-2) * p.dt
    return Fx, Fu.expand(H.shape[:-2] + (12, p.Pu.shape[-1]))


# -- DynamicsDef factories ------------------------------------------------------

def so3_dynamics():
    return DynamicsDef(group=SO3, nx=6, nu=3, step=_so3_step, jac=_so3_jac)


def pendulum3d_dynamics():
    return DynamicsDef(group=SO3, nx=6, nu=3, step=_pendulum3d_step,
                       jac=_pendulum3d_jac)


def se3_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=6, step=_se3_step, jac=_se3_jac)


def rigid_body_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=6, step=_rigid_body_step,
                       jac=_rigid_body_jac)


def drone_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=4, step=_rigid_body_step,
                       jac=_rigid_body_jac)
