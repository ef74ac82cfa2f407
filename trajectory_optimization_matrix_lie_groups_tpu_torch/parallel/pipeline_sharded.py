"""Mesh-sharded front end for the lane-layout pipeline solver (counterpart of
the JAX `parallel/pipeline_sharded.py`).

The headline engine (`solvers/pipeline.PipelineSolver`, kernels B1-B3 on
the card) solves one batch on one device.  This wrapper splits the batch
over the ranks of a device mesh: each rank runs the whole iteration loop on
its contiguous rows, on its own device.  Problems are independent (the
reference's `joblib` sweep semantics,
`visualization/perturb_all_compute.py:245`), so no collective runs inside
the solve: the inputs are this rank's rows, and the per-problem outputs
come back sharded on the problem axis (`DTensor`, `Shard(0)`), for
`multihost.gather_to_all` to collect.
"""

from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)


class ShardedPipelineSolver:
    """`PipelineSolver.solve` over a device mesh.

    The global batch B must divide by the mesh size.  The dynamics and cost
    parameters are the same on every rank; the problem inputs are the whole
    batch (the same on every rank) or `DTensor`s sharded `Shard(0)` on the
    mesh (`multihost.distribute_batch`); every output is sharded on
    ``axis``."""

    def __init__(self, solver: PipelineSolver, mesh, axis: str = "batch"):
        self.solver = solver
        self.mesh = mesh
        self.axis = axis

    def solve(self, dyn, cost, q0s, xi0s, us0):
        """`PipelineSolver.solve` on this rank's rows: a `PipelineState` whose
        fields are `DTensor`s sharded `Shard(0)`."""
        rows = lambda x: multihost.shard_rows(x, self.mesh, self.axis)
        out = self.solver.solve(dyn, cost, rows(q0s), rows(xi0s), rows(us0))
        return multihost.sharded(out, self.mesh)


def make_sharded_pipeline(N: int, iterations: int, dt: float, mesh=None,
                          axis: str = "batch", **solver_kwargs) -> ShardedPipelineSolver:
    """Build a `PipelineSolver` and wrap it over ``mesh`` (default: every rank
    of the job on a 1-d batch mesh, `batch.make_batch_mesh`)."""
    if mesh is None:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.batch import (
            make_batch_mesh,
        )

        mesh = make_batch_mesh(axis=axis)
    return ShardedPipelineSolver(PipelineSolver(N=N, iterations=iterations, dt=dt,
                                                **solver_kwargs), mesh, axis=axis)
