"""SE(3) rigid-body dynamics families (part of the JAX `models/dynamics.py`).

Ported so far: the parameter containers of the SE(3) free body, the rigid
body with gravity and the drone (a rigid body with a 6x4 input projection),
and their semi-implicit Euler `step` functions.  The steps are written
batch-first with the group operations of `ops/se3.py`, independently of the
lane stage math in `ops/linearize.py`, which the tests hold against them.

Quirk flags kept from the reference (see the JAX module docstring):
``ref_coad_swap`` selects the reference's coad-swap in the Jacobian's H
block, ``exact_gravity_jacobian`` the m*g factor of its gravity block.  The
lane stage math (`ops/linearize.stage_jacobian`) always applies the swap and
ignores ``ref_coad_swap``, as the JAX lane kernels do.
"""

import dataclasses

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import setup_inv

_DOWN = (0.0, 0.0, -1.0)


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


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
    down = torch.tensor(_DOWN, dtype=q.dtype, device=q.device)
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
