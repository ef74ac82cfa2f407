"""Benchmark metrics mirroring the reference's correctness oracles
(counterpart of the JAX `utils/metrics.py`).

- manifold-constraint violation ||R^T R - I|| per stage
  (`benchmark_SE3_tracking.py:414-418`)
- dynamics violation via one-step re-simulation (`err_dyn`, `:95-103,453-457`)
- tracking error via the cost's `_err` (`:832-848`)
- quaternion norm violation (the embedded baselines' drift)

Every function broadcasts over leading batch dims and runs on its input's
device.
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.costs import tracking_error


def orthogonality_violation(qs):
    """||R^T R - I||_F per stage for (..., m, m) group matrices."""
    qs = torch.as_tensor(qs)
    R = qs[..., :3, :3]
    eye = torch.eye(3, dtype=qs.dtype, device=qs.device)
    return torch.linalg.matrix_norm(R.transpose(-1, -2) @ R - eye)


def dynamics_violation(model, params, qs, xis, us):
    """||f(x_k, u_k) (-) x_{k+1}|| per stage (one-step re-simulation);
    qs (..., N+1, m, m), xis (..., N+1, d), us (..., N, nu)."""
    idx = torch.arange(us.shape[-2], device=us.device)
    fq, fxi = model.step(params, qs[..., :-1, :, :], xis[..., :-1, :], us, idx)
    d_q = model.group.rminus(fq, qs[..., 1:, :, :])
    d_xi = fxi - xis[..., 1:, :]
    return torch.linalg.norm(torch.cat([d_q, d_xi], dim=-1), dim=-1)


def tracking_errors(group, cost_params, qs, xis):
    """(pose-error norm, velocity-error norm) per stage vs the reference;
    qs (..., K, m, m) against the reference's first K entries."""
    idx = torch.arange(qs.shape[-3], device=qs.device)
    e, ev = tracking_error(group, cost_params, qs, xis, idx)
    return torch.linalg.norm(e, dim=-1), torch.linalg.norm(ev, dim=-1)


def quat_norm_violation(xs_embedded):
    """|1 - ||q||| per stage for embedded R^13 states (..., 13)."""
    xs_embedded = torch.as_tensor(xs_embedded)
    return torch.abs(1.0 - torch.linalg.norm(xs_embedded[..., :4], dim=-1))
