"""Reference trajectories by twist integration (counterpart of
`generate_reference` in the JAX `utils/trajectories.py`)."""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3


def generate_reference(q0, xi_of_i, N, dt):
    """q_{i+1} = normalize(q_i Exp(xi_i dt)).

    Args:
      q0: (4, 4) or (3, 3) initial pose tensor.
      xi_of_i: callable i -> twist tensor, or a constant twist tensor.
      N: number of steps (returns N+1 poses).
      dt: step.

    Returns (q_ref (N+1, m, m), xi_ref (N+1, d)) in ``q0``'s dtype and device.
    """
    group = se3 if q0.shape[-1] == 4 else so3
    xis = [torch.as_tensor(xi_of_i(i) if callable(xi_of_i) else xi_of_i,
                           dtype=q0.dtype, device=q0.device)
           for i in range(N + 1)]
    qs = [q0]
    for i in range(N):
        qs.append(group.normalize(qs[-1] @ group.exp(xis[i] * dt)))
    return torch.stack(qs), torch.stack(xis)
