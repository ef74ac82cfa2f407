"""The task CLI's cross-solver and baseline tasks through the port's
`main([..., "--cpu", "--x64"])` against the JAX CLI's lines
(`torch_cli_cases`): `benchmark_compare` (with ``--plot``: its
reference-schema result pickle loads with the JAX package's
`load_benchmark_pickle`), `benchmark_compare_so3`, `baseline_su2`,
`baseline_embedded` and `cost_landscape` (with ``--plot``)."""

import pytest

from trajectory_optimization_matrix_lie_groups_tpu.utils import load_benchmark_pickle

from torch_cli_cases import assert_lines_match, check_task, jax_line, port_line, standins  # noqa: F401,E501

pytestmark = pytest.mark.usefixtures("standins")


@pytest.mark.parametrize("task", ["benchmark_compare_so3", "baseline_su2",
                                  "baseline_embedded"])
def test_cli_task_matches_jax(task):
    check_task(task)


def test_cli_benchmark_compare_matches_jax_and_writes_the_pickle(tmp_path):
    ref = jax_line("benchmark_compare")
    port = port_line("benchmark_compare", "--plot", str(tmp_path))
    assert_lines_match(port, ref, "benchmark_compare")
    s = port["solvers"]
    data = load_benchmark_pickle(s["pickle"])
    assert "prob" in data and "ms_ilqr" in data and "stabilized_euc" in data
    assert data["ms_ilqr"]["us"].shape == (port["horizon"], 6)
    assert data["prob"]["q_ref"].shape[0] == port["horizon"] + 1
    assert data["ms_ilqr"]["xs"]["qs"].shape == (port["horizon"] + 1, 4, 4)
    # tests/test_task_cli.py's gates
    assert s["ms_ss_J_gap"] < 1.0
    for name in ("ms_ilqr", "ss_ilqr"):
        assert s[name]["orthogonality_violation_max"] < 1e-5
        assert s[name]["dynamics_violation_max"] < 1e-5


def test_cli_cost_landscape_matches_jax_with_plots(tmp_path):
    ref = jax_line("cost_landscape")
    port = port_line("cost_landscape", "--plot", str(tmp_path))
    assert_lines_match(port, ref, "cost_landscape")
    for name in ("left", "right"):
        assert (tmp_path / f"cost_landscape_{name}.png").stat().st_size > 1000
