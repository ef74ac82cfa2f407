"""The reference's N=1400 screw-tracking problem (counterpart of the JAX
`tasks/al_bench.py`), and its N=200 prefix that the port is measured on.

A constant-twist screw reference (w = (0, 0, 1), v = (2, 0, 0.2), dt = 0.01),
GN tracking cost with Q = diag(10, 10, 10, 1, ..., 1), P = 10 Q, R = 0,
input box u in [-10, 10]^6, initial offset p0 = (-1, -1, -0.2) with
xi0 = (0, 0, 0.1, 2, 0, 0.2).

`build_screw200` is the port's main-path problem: the first 200 stages with
R = 1e-3 I (the pipeline's Cholesky needs Quu > 0) and no box.  Its f64
golden (`golden/screw200_us.npy`, `golden/screw200_meta.json`) comes from
the JAX package's f64 engine (`scripts/gen_torch_port_golden.py`).
"""

import json
import os

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

__all__ = ["build_al1400", "build_screw200", "screw_batch", "load_screw200_golden"]

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def build_al1400(dtype=torch.float64, horizon=1400, device=None):
    """Returns (params {dyn, cost}, lb, ub, q0, xi0, q_ref, xi_ref)."""
    dt = 0.01
    m = 1.0
    Ib = np.diag([0.5, 0.7, 0.9])
    J = np.block([[Ib, np.zeros((3, 3))], [np.zeros((3, 3)), m * np.eye(3)]])
    xi0_ref = np.concatenate([np.array([0.0, 0.0, 1.0]),
                              np.array([1.0, 0.0, 0.1]) * 2.0])
    # constant-twist screw reference X_{k+1} = X_k Exp(xi dt), built in f64
    step = SE3.exp(torch.as_tensor(xi0_ref * dt, dtype=torch.float64)).numpy()
    q_ref = np.zeros((horizon + 1, 4, 4))
    q_ref[0] = np.eye(4)
    for i in range(horizon):
        q_ref[i + 1] = q_ref[i] @ step
    xi_ref = np.broadcast_to(xi0_ref, (horizon + 1, 6)).copy()
    Q = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    P = Q * 10.0
    R = np.zeros((6, 6))

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    dp = dynamics.se3_params(t(J), t(dt))
    cp = costs.tracking_cost_params(SE3, t(Q), t(R), t(P), t(q_ref), t(xi_ref))
    q0 = np.eye(4)
    q0[:3, 3] = [-1.0, -1.0, -0.2]
    xi0 = np.array([0.0, 0.0, 0.1, 2.0, 0.0, 0.2])
    return ({"dyn": dp, "cost": cp}, -10.0, 10.0, t(q0), t(xi0), t(q_ref),
            t(xi_ref))


def build_screw200(dtype=torch.float64, device=None, horizon=200, r=1e-3):
    """The main-path problem: `build_al1400`'s first ``horizon`` stages with
    R = r I and no box.  Returns (dyn, cost, q0, xi0)."""
    params, _, _, q0, xi0, _, _ = build_al1400(dtype, horizon, device)
    cost = params["cost"]
    cost.R = r * torch.eye(6, dtype=dtype, device=device)
    return params["dyn"], cost, q0, xi0


def screw_batch(q0, xi0, B, seed, scale=0.05):
    """A batch of B perturbed initial poses normalize(q0 Exp(scale n)), n
    from ``numpy.random.default_rng(seed)``, with lane 0 the unperturbed q0
    (the accuracy anchor), and xi0 for every lane.
    Returns (q0s (B, 4, 4), xi0s (B, 6)) in q0's dtype and device."""
    n = np.random.default_rng(seed).standard_normal((B, 6))
    dq = torch.as_tensor(scale * n, dtype=q0.dtype).to(q0.device)
    q0s = SE3.normalize(q0[None] @ SE3.exp(dq))
    q0s[0] = q0
    return q0s, xi0[None].expand(B, 6).contiguous()


def load_screw200_golden():
    """(us (200, 6) f64 numpy, meta dict) of the committed f64 golden."""
    us = np.load(os.path.join(GOLDEN_DIR, "screw200_us.npy"))
    with open(os.path.join(GOLDEN_DIR, "screw200_meta.json")) as f:
        return us, json.load(f)
