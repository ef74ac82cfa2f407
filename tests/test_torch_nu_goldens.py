"""The goldens of the two full-width problems at input dimensions other
than 6 and 4 (`tasks/al_bench.NU_PROBLEMS`: screw200_torques3, nu = 3, and
screw200_rcs12, nu = 12; `tasks/golden/{name}_{us.npy,meta.json}` from
`scripts/gen_torch_port_golden_nu.py`, the JAX package's f64 engine): the
port's plain f64 `PipelineSolver` reaches each to 1e-6, and each meta holds
the schedules `chip_smoke.py`'s kernels_nu phase runs.
"""

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("name", list(al_bench.NU_PROBLEMS))
def test_plain_f64_solve_reaches_the_golden(name):
    """The port's plain f64 `PipelineSolver` on lane 0 of the full-width
    problem (N = 200), for the golden's own iteration count, lands within
    1e-6 of the golden (the JAX f64 engine's optimum); the meta's
    projection is `build_screw200_nu`'s, and its schedules met their gates
    on the JAX side."""
    us_gold, meta = al_bench.load_nu_golden(name)
    nu = us_gold.shape[1]
    assert meta["grad_norm_f64"] < meta["grad_tol"] and meta["nu"] == nu
    for key, gate in (("polish_schedule", 1e-4), ("refine_schedule", 1e-6)):
        assert meta[key]["gate"] == gate and meta[key]["lane0_us_max_abs_err"] <= gate
    dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.NU_PROBLEMS[name](),
                                                    torch.float64, "cpu")
    np.testing.assert_array_equal(dyn.Pu.numpy(), np.asarray(meta["Pu"]))
    out = PipelineSolver(200, meta["iterations_f64"], float(dyn.dt), gravity=True,
                         exact_gravity_jacobian=True).solve(
        dyn, cost, q0[None], xi0[None], torch.zeros((1, 200, nu), dtype=torch.float64))
    assert float(np.abs(out.us[0].numpy() - us_gold).max()) <= 1e-6
