"""The SE(3) pipeline at nu = 12 (the 12-thruster layout
`al_bench.rcs12_pu`), the port's plain path against the JAX package's on the
same numpy inputs, as tests/test_torch_pipeline_nu.py does it at nu = 3 (a
file of its own for the JAX compiles' time)."""

import jax.numpy as jnp
import pytest

from test_torch_pipeline_nu import check_pipeline, jax_solves  # noqa: F401
from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

NUS = [pytest.param(12, id="nu12_rcs")]


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_pipeline_matches_jax(dtype, nu, jax_solves):
    """`check_pipeline` at nu = 12."""
    check_pipeline(dtype, nu, jax_solves)
