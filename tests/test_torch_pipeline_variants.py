"""The port's `PipelineSolver` against the JAX `PallasPipelineSolver`
(interpret mode) on the drone (gravity, nu = 4) and with the input-box AL
terms (``al=``, built as in tests/test_pipeline.py), f64, fused, at the
tolerances of test_torch_pipeline.py.  Also: the port's f64 solve at the
full horizon reaches the committed screw-200 golden."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    load_screw200_golden,
)

from torch_port_cases import check_solves, solve_both


@pytest.mark.parametrize("drone,al", [(True, False), (False, True)],
                         ids=["drone", "al"])
def test_pipeline_solver_variants_match_pallas_pipeline(drone, al):
    check_solves(*solve_both(16, 3, 4, jnp.float64, drone=drone, al=al, seed=5),
                 jnp.float64)


def test_screw200_f64_solve_reaches_the_golden():
    """Lane 0 of the plain f64 solve (13 iterations, as the golden's JAX
    f64 run) against the committed golden: controls to 1e-6, J to 1e-9."""
    us_gold, meta = load_screw200_golden()
    dyn, cost, q0, xi0 = build_screw200(torch.float64)
    out = PipelineSolver(200, meta["iterations_f64"], float(dyn.dt)).solve(
        dyn, cost, q0[None], xi0[None], torch.zeros((1, 200, 6), dtype=torch.float64))
    assert np.abs(out.us[0].numpy() - us_gold).max() <= 1e-6
    assert abs(out.J_opt[0].item() - meta["J_f64"]) <= 1e-9 * meta["J_f64"]
    assert out.grad_norm[0].item() < meta["grad_tol"]
