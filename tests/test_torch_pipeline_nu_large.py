"""The SE(3) pipeline and the constrained pipeline at nu = 16 (the Apollo
Service Module's pattern of four quads, `al_bench.rcs16_pu`), past the
runtime-nu instances' nu = 12, where the kernels take their large-nu
instances (csrc/nu_large.cuh): the port's plain path against the JAX
package's on the same numpy inputs, as tests/test_torch_pipeline_nu.py does
it at nu = 3 (horizon 20, two problems: the JAX interpret solves' compile
grows with nu).  One JAX f64 pipeline solve for both of the port's scalars,
at `check_pipeline`'s tolerances; the constrained pipeline at
`check_al_pipeline`'s.  The full-width problems' goldens at nu = 16 and 24:
tests/test_torch_nu_goldens.py."""

import numpy as np
import pytest
import jax.numpy as jnp

from test_torch_pipeline_nu import check_al_pipeline, check_pipeline, jax_solves  # noqa: F401
from torch_port_cases import one_cpu_thread  # noqa: F401
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B = 20, 2
NUS = [pytest.param(16, id="nu16_rcs")]


def test_nu_pu_past_12_is_rcs24_after_the_identity():
    """`nu_pu(nu)` past 12: I6, then the first nu - 6 thrusters of
    `rcs24_pu`, repeated from the first past 30; both layouts rank 6, each
    column a thruster [r x d; d] of unit direction d along an axis, its
    torque r x d normal to d."""
    for nu in (13, 16, 24, 30, 31, 40):
        pu = al_bench.nu_pu(nu)
        np.testing.assert_array_equal(pu[:, :6], np.eye(6))
        np.testing.assert_array_equal(pu[:, 6:], al_bench.rcs24_pu()[:, np.arange(nu - 6) % 24])
    for pu in (al_bench.rcs16_pu(), al_bench.rcs24_pu()):
        assert np.linalg.matrix_rank(pu) == 6
        assert (np.abs(pu[3:]).sum(axis=0) == 1).all()
        assert (np.einsum("ic,ic->c", pu[:3], pu[3:]) == 0).all()
    assert al_bench.rcs16_pu().shape == (6, 16) and al_bench.rcs24_pu().shape == (6, 24)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_pipeline_matches_jax(dtype, nu, jax_solves):
    """`check_pipeline` at nu = 16."""
    check_pipeline(dtype, nu, jax_solves, H=H, B=B)


def test_al_pipeline_nu16_matches_jax():
    """`check_al_pipeline` at nu = 16."""
    check_al_pipeline(16, H=H)
