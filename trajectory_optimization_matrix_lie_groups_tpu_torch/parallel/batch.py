"""Batched trajectory optimization, on one device or split over a device mesh
(counterpart of the JAX `parallel/batch.py`).

The JAX `BatchSolver` is a `jax.vmap` of one `LieILQR` solve over the
problem batch, optionally sharded over a device mesh.  The port's `LieILQR`
is batch-native (every tensor has a leading problem axis, and each problem
keeps its own schedule, flags and iteration count, as the vmapped
while-loop's selects keep them), so `BatchSolver` is a thin wrapper that
keeps the JAX signature.  With a mesh (`make_batch_mesh`), each rank solves
its contiguous rows of the batch on its own device, with no collective
inside the solve, and the final state comes back sharded on the problem
axis (`DTensor`, `Shard(0)`; `multihost.gather_to_all` collects it).
"""

from typing import Optional

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


def make_batch_mesh(n_devices: Optional[int] = None, axis: str = "batch", device=None):
    """A 1-d mesh named ``axis`` over the processes of the job, one device
    each (`multihost.world_mesh`): every rank under ``torchrun``, or a
    one-process group on ``device`` (the card unless 'cpu') in a plain
    process, JAX's one-device mesh."""
    return multihost.world_mesh(axis, n_devices, device)


class BatchSolver:
    """Problem-batch front end for a `LieILQR` solver, mesh-shardable.

    `solve_batch(params, q0s, xi0s, us_inits)` runs B independent solves to
    the solver's convergence/iteration budget (each problem stops when it
    converges, fails or reaches ``max_iterations``; the others go on).
    """

    def __init__(self, solver: LieILQR, mesh=None, axis: str = "batch"):
        self.solver = solver
        self.mesh = mesh
        self.axis = axis

    def solve_batch(self, params, q0s, xi0s, us_inits, q_ref=None, xi_ref=None):
        """q0s (B, m, m), xi0s (B, d), us_inits (B, N, nu); the reference
        defaults to params["cost"]'s (multiple shooting's initial nodes).
        On ``us_inits``' device when it is a tensor, else the card.  Returns
        the final `SolverState`, every field per problem.

        With a mesh, each input is the whole batch (the same on every rank)
        or a `DTensor` sharded `Shard(0)` on the mesh; B must divide by the
        mesh size; each rank solves its rows on its device and every field
        of the state comes back a `DTensor` sharded `Shard(0)`."""
        solver = self.solver
        if q_ref is None:
            q_ref = params["cost"].q_ref
            xi_ref = params["cost"].xi_ref
        if self.mesh is not None:
            q0s, xi0s, us_inits = (multihost.shard_rows(x, self.mesh, self.axis)
                                   for x in (q0s, xi0s, us_inits))
        us = torch.as_tensor(us_inits, device=solve_device(us_inits))
        cast = lambda x: torch.as_tensor(x).to(device=us.device, dtype=us.dtype)
        q0s, xi0s = cast(q0s), cast(xi0s)
        if solver.cfg.multiple_shooting:
            state = solver._init_state_ms(q0s, xi0s, us, cast(q_ref), cast(xi_ref))
        else:
            state = solver._init_state_ss(params, q0s, xi0s, us)
        state = solver._solve_loop(params, state)
        return state if self.mesh is None else multihost.sharded(state, self.mesh)
