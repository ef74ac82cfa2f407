"""High-precision solves: the f32 pipeline, then f64 polish iterations
(counterpart of the JAX `solvers/polish.py`).

The f32 pipeline converges to a ~1e-3 neighbourhood of the f64 fixed
point: f32 rounding noise is amplified through the near-flat directions of
the trajectory Hessian (sigma_min(Quu) ~ 2R).  iLQR is locally contractive,
so a short polish rerun entirely in f64 from the f32 iterate re-converges
into the flat valley of the true optimum; 2 polish iterations are the knee
of the accuracy curve (the JAX module's docstring has the numbers).

The f32 phase is `PipelineSolver` (kernels B1, B2, B3 on the card); the
polish is `FastBatchSolver(use_pallas=False)` in f64, as the JAX class
builds it: the model's batched functions, the loop backward pass and the
loop rollout (the JAX package's XLA path, no kernel).
"""

from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import LieModel
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    cast_params,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
    solve_device,
)


class PolishedState(NamedTuple):
    qs: torch.Tensor         # (B, N+1, 4, 4) float64
    xis: torch.Tensor        # (B, N+1, 6)    float64
    us: torch.Tensor         # (B, N, nu)     float64
    J_opt: torch.Tensor      # (B,)
    grad_norm: torch.Tensor  # (B,)


class HighPrecisionSolver:
    """f32 pipeline + f64 polish.

    model: the (dynamics, cost) `LieModel` the f64 polish iterates (a family
    the pipeline supports: the SE(3) free body, or the rigid body / drone
    with ``gravity=True`` in ``pipeline_kwargs``); N, iterations, dt: the
    f32 `PipelineSolver`'s; polish_iters: f64 iterations from its result;
    pipeline_kwargs: further `PipelineSolver` options."""

    def __init__(self, model: LieModel, N: int, iterations: int, dt: float,
                 polish_iters: int = 2, **pipeline_kwargs):
        self.pipeline = PipelineSolver(N, iterations, dt, **pipeline_kwargs)
        self.fast = FastBatchSolver(model, N, polish_iters, use_pallas=False)
        self.polish_iters = polish_iters

    def _polish(self, params64, qs, xis, us):
        B = us.shape[0]
        J = torch.full((B,), float("inf"), dtype=torch.float64, device=us.device)
        g = J.clone()
        for _ in range(self.polish_iters):
            qs, xis, us, J, g = self.fast._iteration(params64, qs, xis, us)
        return PolishedState(qs=qs, xis=xis, us=us, J_opt=J, grad_norm=g)

    def solve(self, params, q0s, xi0s, us0):
        """params {'dyn', 'cost'} in any float dtype; q0s (B, 4, 4),
        xi0s (B, 6), us0 (B, N, nu), on the device the solve runs on (the
        card when they are not tensors)."""
        dev = solve_device(us0)
        cast = lambda p, dt: {k: cast_params(v, dev, dt) for k, v in p.items()}
        f32 = lambda x: torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        p32 = cast(params, torch.float32)
        out = self.pipeline.solve(p32["dyn"], p32["cost"], f32(q0s), f32(xi0s), f32(us0))
        f64 = lambda x: x.to(torch.float64)
        return self._polish(cast(params, torch.float64), f64(out.qs), f64(out.xis),
                            f64(out.us))
