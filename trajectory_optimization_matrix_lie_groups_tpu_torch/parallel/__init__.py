"""Batch solving on one device (counterpart of the JAX `parallel/`): the
`BatchSolver` front end (`batch.py`) and the perturbation and rollout
sweeps (`sweep.py`).  The device-mesh parts (`make_batch_mesh`, the sharded
pipeline, multi-host) wait for ROADMAP.md A.5 (multi-GPU)."""

from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.batch import (  # noqa: F401
    BatchSolver,
)
