"""A small SE(3) tracking problem, the flagship model family at N = 16
(counterpart of `__graft_entry__._toy_problem`): the problem of the
multi-device checks (`parallel/`), small enough for any number of ranks.

A reference path q_ref[i+1] = q_ref[i] Exp(0.01 xi_path[i]) from
xi_path = 0.1 n, J = diag(0.5, 0.7, 0.9, 1, 1, 1), Q = diag(25 I3, 10 I3,
I6), R = 1e-3 I, P = 1.5 Q, dt = 0.01, a start q0 = Exp(0.1 n), xi0 = 0.
The JAX function draws n with `jax.random`, which the port cannot
reproduce; here n comes from ``numpy.random.default_rng(seed)``
(`toy_arrays`), so that both packages can build the problem from the same
numbers (`convert.toy_from_numpy` takes the JAX package's build across).
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

DT = 0.01


def toy_arrays(N=16, seed=0):
    """The numbers that define the toy problem, as float64 numpy arrays:
    xi_path (N+1, 6), q0_twist (6,), J, Q, R, P and dt."""
    rng = np.random.default_rng(seed)
    xi_path = 0.1 * rng.standard_normal((N + 1, 6))
    q0_twist = 0.1 * rng.standard_normal(6)
    J = np.diag([0.5, 0.7, 0.9, 1.0, 1.0, 1.0])
    Q = np.diag(np.concatenate([np.full(3, 25.0), np.full(3, 10.0), np.ones(6)]))
    return dict(xi_path=xi_path, q0_twist=q0_twist, J=J, Q=Q, R=1e-3 * np.eye(6),
                P=1.5 * Q, dt=DT)


def toy_problem(N=16, dtype=torch.float32, device=torch.device("cuda"), seed=0):
    """(model, params, q0 (4, 4), xi0 (6,), q_ref (N+1, 4, 4), xi_path (N+1, 6),
    N) in ``dtype`` on ``device`` (the card unless asked for another), the
    tuple of `__graft_entry__._toy_problem`."""
    a = toy_arrays(N, seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)
    xi_path = t(a["xi_path"])
    q_ref = [torch.eye(4, dtype=dtype, device=device)]
    for i in range(N):
        q_ref.append(q_ref[-1] @ SE3.exp(xi_path[i] * DT))
    q_ref = torch.stack(q_ref)
    dp = dynamics.se3_params(t(a["J"]), t(DT))
    cp = costs.tracking_cost_params(SE3, t(a["Q"]), t(a["R"]), t(a["P"]), q_ref, xi_path)
    model, params = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6), dp, cp)
    q0 = SE3.exp(t(a["q0_twist"]))
    xi0 = torch.zeros(6, dtype=dtype, device=device)
    return model, params, q0, xi0, q_ref, xi_path, N
