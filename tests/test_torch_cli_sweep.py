"""The task CLI's sweeps through the port's `main([..., "--cpu", "--x64"])`
against the JAX CLI's lines (`torch_cli_cases`): `sweep` (160 `LieILQR`
solves on the stand-in screw-200, 10 iterations at mu = 0, one device) and
`rollout_sweep` (112 open-loop rollouts of 1400 steps)."""

import pytest

from torch_cli_cases import check_task, standins  # noqa: F401

pytestmark = pytest.mark.usefixtures("standins")


@pytest.mark.parametrize("task", ["sweep", "rollout_sweep"])
def test_cli_task_matches_jax(task):
    port, _ = check_task(task)
    if task == "rollout_sweep":
        assert all(p["all_finite"] for p in port["params"].values())
