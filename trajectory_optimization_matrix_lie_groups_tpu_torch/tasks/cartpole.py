"""Cartpole swing-up with autodiff dynamics and cost, on the Euclidean
iLQR/DDP (counterpart of the JAX `tasks/cartpole.py`).

Replicates the reference task `main_ddp.py`: the RK4-discretized
underactuated cartpole (`main_ddp.py:37-66`), the quadratic goal cost
(`:71-86`), N = 400, dt = 0.01, x0 = [9, 0, 0, 0], goal = [10, 0, pi, 0]
(`:104-117`).  No pickle is needed.
"""

import math

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.autodiff import (
    autodiff_model,
    rk4,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.ilqr import (
    ILQR,
    ILQRConfig,
)


def cartpole_fc(x, u):
    mc, mp, l, g = 1.0, 1.0, 1.0, 9.8
    x2, x3, x4 = x[1], x[2], x[3]
    uu = u[0]
    s, c = torch.sin(x3), torch.cos(x3)
    dx2 = (uu + mp * s * (l * x4 ** 2 + g * c)) / (mc + mp * s ** 2)
    dx4 = (-uu * c - mp * l * x4 ** 2 * c * s - (mc + mp) * g * s) / (
        l * mc + l * mp * s ** 2)
    return torch.stack([x2, dx2, x4, dx4])


def build(N=400, dt=0.01, x_goal=None, hessians=False, dtype=torch.float64,
          device=torch.device("cuda")):
    """The cartpole `ILQR` (its constants on ``device``, the card unless
    asked for another)."""
    kw = dict(dtype=dtype, device=device)
    x_goal = (torch.tensor([10.0, 0.0, math.pi, 0.0], **kw) if x_goal is None
              else torch.as_tensor(x_goal).to(**kw))
    Q = torch.diag(torch.tensor([100.0, 100.0, 10000.0, 100.0], **kw))
    R = 200.0

    def l(x, u, i):
        xd = x - x_goal
        return 0.5 * u[0] * R * u[0] + 0.5 * xd @ Q @ xd

    def l_terminal(x, i):
        xd = x - x_goal
        return 0.5 * xd @ Q @ xd

    model = autodiff_model(rk4(cartpole_fc, dt), l, l_terminal, 4, 1, hessians=hessians)
    cfg = ILQRConfig(N=N, use_hessians=hessians, tol_grad_norm=1e-3, max_iterations=200)
    return ILQR(model, cfg)


def run(n_iterations=200, dtype=torch.float64, device=torch.device("cuda")):
    """The reference task: one cartpole from x0 = [9, 0, 0, 0]."""
    solver = build(dtype=dtype, device=device)
    x0 = torch.tensor([[9.0, 0.0, 0.0, 0.0]], dtype=dtype, device=device)
    us0 = torch.zeros((1, solver.cfg.N, 1), dtype=dtype, device=device)
    return solver.fit(x0, us0, n_iterations=n_iterations)
