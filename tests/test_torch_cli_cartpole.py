"""The task CLI's `cartpole` task (`main_ddp.py`: the RK4 cartpole on the
Euclidean iLQR, N = 400, 200 iterations at most) through the port's
`main([..., "--cpu", "--x64"])` against the JAX CLI's line
(`torch_cli_cases`).  Its own file: the port's Euclidean iLQR maps the
autodiff model over 400 stages with `torch.func.vmap`, ~0.7 s an
iteration on one CPU thread, 187 iterations."""

import pytest

from torch_cli_cases import check_task, standins  # noqa: F401

pytestmark = pytest.mark.usefixtures("standins")


def test_cli_cartpole_matches_jax():
    port, ref = check_task("cartpole")
    assert port["converged"] and port["iterations"] == ref["iterations"]
