"""Batch solving over a device mesh, the framework's primary scaling axis
(counterpart of the JAX `parallel/`): the `BatchSolver` front end and its
mesh (`batch.py`), the perturbation and rollout sweeps (`sweep.py`), the
batch-sharded pipeline (`pipeline_sharded.py`), the time-sharded Riccati
sweep (`riccati_sharded.py`) and the multi-process runtime
(`multihost.py`: one process a device, `torch.distributed`)."""

from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.batch import (  # noqa: F401
    BatchSolver,
    make_batch_mesh,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.multihost import (  # noqa: F401
    distribute_batch,
    gather_to_all,
    global_batch_mesh,
    initialize_multihost,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.pipeline_sharded import (  # noqa: F401
    ShardedPipelineSolver,
    make_sharded_pipeline,
)
