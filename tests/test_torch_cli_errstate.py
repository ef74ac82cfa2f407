"""The task CLI's error-state tasks and `so3_tracking` (SS, 50 iterations)
through the port's `main([..., "--cpu", "--x64"])` against the JAX CLI's
lines (`torch_cli_cases`), and the CLI's refusal to run without a card
unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import run

from torch_cli_cases import check_task, standins  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.usefixtures("standins")
@pytest.mark.parametrize("task", ["errstate_tracking", "errstate_generate",
                                  "errstate_generate_linear", "so3_tracking"])
def test_cli_task_matches_jax(task):
    check_task(task)


def test_cli_has_the_jax_cli_tasks():
    from trajectory_optimization_matrix_lie_groups_tpu.tasks import run as jrun

    assert sorted(run.TASKS) == sorted(jrun.TASKS) and len(run.TASKS) == 25


def test_cli_without_a_card_exits_with_a_message(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the no-CUDA path")
    with pytest.raises(SystemExit) as e:
        run.main(["dynamics_sim"])
    assert e.value.code not in (0, None) and "--cpu" in str(e.value.code)
    assert capsys.readouterr().out == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", f"{run.PKG}.tasks.run", "cost_landscape"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and r.stdout == ""
