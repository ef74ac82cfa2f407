"""The task CLI's batch, constrained and sweep tasks through the port's
`main([..., "--cpu", "--x64"])` against the JAX CLI's lines
(`torch_cli_cases`), at the JAX CLI's CPU sizes: `al_batch` (B = 32,
H = 60, `ALFastSolver` on `FastBatchSolver(use_pallas=False)` with the
rescue), `mpc_batch` and `mpc_batch_constrained` (B, H, T = 4, 10, 5, f32,
the pipeline's plain versions against the JAX pipeline in interpret mode),
`se3_al_ms` and `dynamics_sim`; the perturbations are the JAX draws."""

import pytest

from torch_cli_cases import check_task, standins  # noqa: F401

pytestmark = pytest.mark.usefixtures("standins")


@pytest.mark.parametrize("task", ["al_batch", "mpc_batch", "mpc_batch_constrained",
                                  "se3_al_ms", "dynamics_sim"])
def test_cli_task_matches_jax(task):
    port, ref = check_task(task)
    if task == "al_batch":
        assert port["constr_converged"] and port["max_violation"] < 1e-2
    if task == "dynamics_sim":
        # tests/test_task_cli.py's gates
        assert port["vel_divergence_max"] < 1e-10 and port["pose_divergence_max"] < 0.05
        assert port["pendulum_swings"]
