"""The SO(3)-family problems the port measures: free-attitude tracking and
the 3-D pendulum swing-up, built without the reference's pickles.

Both use the inertia J = diag(0.5, 0.7, 0.9) of the reference's
`main_pendulum3d_dynamics.py` (the pendulum also its m = 1, l = 0.5), a
constant-twist reference from the identity, the GN tracking cost
Q = diag(10 I3, I3), P = 10 Q with the reference SO(3) cost's terminal
quirk (value and gradient from Q, Hessian from P), and x0 at rest at the
identity:

- ``so3_track249``: free attitude, dt = 0.01, N = 249 (the reference's
  SO(3) tracking horizon), reference twist (0.4, -0.3, 0.8), R = 1e-3 I3;
- ``pendulum_swingup80``: the pivot-actuated pendulum, dt = 0.025, N = 80,
  from hanging (R = I) at pi/2 rad/s about body x, so the reference is
  upright at t = 2 s; R = 1e-2 I3.

Their f64 goldens (`golden/{name}_us.npy`, `golden/{name}_meta.json`) come
from the JAX package's f64 engine (`scripts/gen_torch_port_golden_so3.py`).
"""

import json
import math
import os

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.trajectories import (
    generate_reference,
)

__all__ = ["PROBLEMS", "build_so3_track249", "build_pendulum_swingup80",
           "so3_track249_model", "so3_batch", "load_so3_golden"]

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
INERTIA = (0.5, 0.7, 0.9)

# name: (pendulum, dt, N, reference twist, R weight)
PROBLEMS = {
    "so3_track249": (False, 0.01, 249, (0.4, -0.3, 0.8), 1e-3),
    "pendulum_swingup80": (True, 0.025, 80, (math.pi / 2, 0.0, 0.0), 1e-2),
}


def _build(name, dtype, device, horizon):
    pendulum, dt, N, twist, r = PROBLEMS[name]
    horizon = N if horizon is None else horizon
    f64 = torch.float64
    q_ref, xi_ref = generate_reference(torch.eye(3, dtype=f64),
                                       torch.tensor(twist, dtype=f64), horizon, dt)
    Q = torch.diag(torch.tensor([10.0] * 3 + [1.0] * 3, dtype=f64))
    t = lambda x: torch.as_tensor(x, dtype=f64).to(device=device, dtype=dtype)
    J = t(np.diag(INERTIA))
    dyn = (dynamics.pendulum3d_params(J, 1.0, 0.5, dt) if pendulum
           else dynamics.so3_params(J, dt))
    cost = costs.tracking_cost_params(SO3, t(Q), t(r * np.eye(3)), t(10.0 * Q),
                                      t(q_ref), t(xi_ref))
    return dyn, cost, t(np.eye(3)), t(np.zeros(3))


def build_so3_track249(dtype=torch.float64, device=torch.device("cuda"),
                       horizon=None):
    """The free-attitude tracking problem (``horizon`` cuts N = 249).
    Returns (dyn `SO3Params`, cost, q0 (3, 3), xi0 (3,))."""
    return _build("so3_track249", dtype, device, horizon)


def build_pendulum_swingup80(dtype=torch.float64, device=torch.device("cuda"),
                             horizon=None):
    """The 3-D pendulum swing-up (``horizon`` cuts N = 80).
    Returns (dyn `Pendulum3dParams`, cost, q0 (3, 3), xi0 (3,))."""
    return _build("pendulum_swingup80", dtype, device, horizon)


def so3_track249_model(dtype=torch.float64, device=torch.device("cuda"),
                       horizon=None):
    """`build_so3_track249` as the (model, params) pair of `make_model` that
    the generic `solvers/batched.FastBatchSolver` takes: the free attitude
    with the SO(3) tracking cost and its terminal quirk.
    Returns (model, params, q0, xi0); the reference is params["cost"]'s."""
    dyn, cost, q0, xi0 = build_so3_track249(dtype, device, horizon)
    model, params = make_model(dynamics.so3_dynamics(),
                               costs.tracking_cost(SO3, 3, ref_so3_terminal_quirk=True),
                               dyn, cost)
    return model, params, q0, xi0


def so3_batch(q0, xi0, B, seed, scale=0.05):
    """B perturbed initial attitudes normalize(q0 Exp(scale n)), n normal
    from a ``torch.Generator`` seeded with ``seed``, lane 0 the unperturbed
    q0 (the accuracy anchor), and xi0 for every lane.
    Returns (q0s (B, 3, 3), xi0s (B, 3)) in q0's dtype and device."""
    gen = torch.Generator().manual_seed(seed)
    n = torch.randn((B, 3), generator=gen, dtype=torch.float64)
    q0s = so3.normalize(q0[None] @ so3.exp((scale * n).to(q0)))
    q0s[0] = q0
    return q0s, xi0[None].expand(B, 3).contiguous()


def load_so3_golden(name):
    """(us (N, 3) f64 numpy, meta dict) of the committed f64 golden of
    ``name`` (a key of `PROBLEMS`)."""
    us = np.load(os.path.join(GOLDEN_DIR, f"{name}_us.npy"))
    with open(os.path.join(GOLDEN_DIR, f"{name}_meta.json")) as f:
        return us, json.load(f)
