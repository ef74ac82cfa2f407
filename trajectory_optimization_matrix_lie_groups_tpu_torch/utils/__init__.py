"""Shared utilities: artifact IO, small-matrix algebra, metrics, rotations,
checkpoints, profiling and performance records."""

from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.trajectories import (  # noqa: F401
    load_benchmark_pickle,
    load_reference_triple,
    save_benchmark_pickle,
)
