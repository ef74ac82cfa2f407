"""The port's `PipelineSolver` against the JAX `PallasPipelineSolver`
(interpret mode) on the screw-tracking problem, H=16, B=3, 4 iterations,
fused and unfused.  The drone and AL variants are in
test_torch_pipeline_variants.py.

Tolerances: f64 us atol 1e-6 and J rtol 1e-7; f32 at
tests/test_pipeline.py's atol 5e-4 / rtol 1e-4 on us and rtol 1e-4 on J.
"""

import pytest

import jax.numpy as jnp

from torch_port_cases import check_solves, solve_both

H, B, ITERS = 16, 3, 4


@pytest.mark.parametrize("dtype,fused", [(jnp.float64, True), (jnp.float32, True),
                                         (jnp.float64, False)],
                         ids=["f64-fused", "f32-fused", "f64-unfused"])
def test_pipeline_solver_matches_pallas_pipeline(dtype, fused):
    check_solves(*solve_both(H, B, ITERS, dtype, fused=fused), dtype)
