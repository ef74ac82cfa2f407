"""Batched trajectory optimization on one device (counterpart of the JAX
`parallel/batch.py`).

The JAX `BatchSolver` is a `jax.vmap` of one `LieILQR` solve over the
problem batch, optionally sharded over a device mesh.  The port's `LieILQR`
is batch-native (every tensor has a leading problem axis, and each problem
keeps its own schedule, flags and iteration count, as the vmapped
while-loop's selects keep them), so `BatchSolver` is a thin wrapper that
keeps the JAX signature.  The mesh waits for ROADMAP.md A.5 (multi-GPU).
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)

_NO_MESH = ("a device mesh (the JAX NamedSharding over the batch axis) is not "
            "ported yet: ROADMAP.md A.5 (multi-GPU)")


def make_batch_mesh(n_devices=None, axis="batch"):
    """The JAX package's batch mesh; not ported yet (ROADMAP.md A.5)."""
    raise NotImplementedError(f"make_batch_mesh: {_NO_MESH}")


class BatchSolver:
    """Problem-batch front end for a `LieILQR` solver.

    `solve_batch(params, q0s, xi0s, us_inits)` runs B independent solves to
    the solver's convergence/iteration budget (each problem stops when it
    converges, fails or reaches ``max_iterations``; the others go on).
    """

    def __init__(self, solver: LieILQR, mesh=None):
        if mesh is not None:
            raise NotImplementedError(f"BatchSolver(mesh=...): {_NO_MESH}")
        self.solver = solver

    def solve_batch(self, params, q0s, xi0s, us_inits, q_ref=None, xi_ref=None):
        """q0s (B, m, m), xi0s (B, d), us_inits (B, N, nu); the reference
        defaults to params["cost"]'s (multiple shooting's initial nodes).
        On ``us_inits``' device when it is a tensor, else the card.  Returns
        the final `SolverState`, every field per problem."""
        solver = self.solver
        if q_ref is None:
            q_ref = params["cost"].q_ref
            xi_ref = params["cost"].xi_ref
        us = torch.as_tensor(us_inits, device=solve_device(us_inits))
        cast = lambda x: torch.as_tensor(x).to(device=us.device, dtype=us.dtype)
        q0s, xi0s = cast(q0s), cast(xi0s)
        if solver.cfg.multiple_shooting:
            state = solver._init_state_ms(q0s, xi0s, us, cast(q_ref), cast(xi_ref))
        else:
            state = solver._init_state_ss(params, q0s, xi0s, us)
        return solver._solve_loop(params, state)
