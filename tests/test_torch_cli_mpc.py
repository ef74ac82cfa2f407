"""The task CLI's closed-loop MPC tasks through the port's
`main([..., "--cpu", "--x64"])` against the JAX CLI's lines
(`torch_cli_cases`): `mpc` (`make_closed_loop` over `LieILQR`, H = 40,
T = 150, 4 iterations a step, on the stand-in screw-200) and `mpc_native`
(the same loop on the port's native C++ runtime)."""

import pytest

from trajectory_optimization_matrix_lie_groups_tpu import native as jnative

from torch_cli_cases import check_task, standins  # noqa: F401

pytestmark = pytest.mark.usefixtures("standins")


def test_cli_mpc_matches_jax():
    port, _ = check_task("mpc")
    assert port["steps"] == 150 and port["tracking_err_shrink_ratio"] < 0.8


@pytest.mark.skipif(jnative.LIB is None, reason="no native toolchain")
def test_cli_mpc_native_matches_jax():
    port, _ = check_task("mpc_native")
    assert "error" not in port and port["tracking_err_shrink_ratio"] < 0.8
