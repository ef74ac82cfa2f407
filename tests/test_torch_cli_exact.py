"""The task CLI's reference-exact tasks through the port's
`main([..., "--cpu", "--x64"])` against the JAX CLI's lines
(`torch_cli_cases`): the benchmark tasks on the stand-in pickles
(`run_benchmark_task`: `LieILQR` with `parity.build_from_prob`'s
configuration, the controls against the pickle's JAX solution) and
`rigid_body_ms`; `--plot` writes the convergence and trajectory figures."""

import pytest

from torch_cli_cases import check_task, port_line, standins  # noqa: F401

pytestmark = pytest.mark.usefixtures("standins")


@pytest.mark.parametrize("task", ["so3_tracking_ms", "pendulum3d_ms", "se3_tracking",
                                  "drone_ms", "rigid_body_ms"])
def test_cli_exact_task_matches_jax(task):
    port, ref = check_task(task)
    if task.endswith("_ms"):
        # tests/test_task_cli.py's gate on the reference pickles
        assert port["converged"]
    if "us_vs_reference_max_err" in port:
        assert port["us_vs_reference_max_err"] < 1e-9


def test_cli_se3_tracking_ms_with_plots(tmp_path):
    port, ref = check_task("se3_tracking_ms")
    assert port["converged"] and port["us_vs_reference_max_err"] < 1e-9
    again = port_line("se3_tracking_ms", "--plot", str(tmp_path))
    assert again["iterations"] == port["iterations"]
    for f in ("se3_tracking_ms_convergence.png", "se3_tracking_ms_trajectory.png"):
        assert (tmp_path / f).stat().st_size > 1000, f
