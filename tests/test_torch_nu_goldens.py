"""The goldens of the full-width problems at input dimensions other than 6
and 4 (`tasks/al_bench.NU_PROBLEMS`: screw200_torques3, nu = 3,
screw200_rcs12, nu = 12, screw200_rcs16, nu = 16, and screw200_rcs24,
nu = 24; `tasks/golden/{name}_{us.npy,meta.json}` from
`scripts/gen_torch_port_golden_nu.py`, the JAX package's f64 engine): the
port's plain f64 `PipelineSolver` reaches each to 1e-6 (up to nu = 12) or
holds it as a fixed point (past 12, where its ~20 iterations take over a
minute on one CPU thread), and each meta holds the schedules
`chip_smoke.py`'s kernels_nu phase runs.
"""

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    stage_dynamics_eval,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _golden_problem(name):
    """(us_gold (200, nu), meta, dyn, cost, q0, xi0) with the meta's
    projection checked against `build_screw200_nu`'s and its schedules'
    gates met on the JAX side."""
    us_gold, meta = al_bench.load_nu_golden(name)
    nu = us_gold.shape[1]
    assert meta["grad_norm_f64"] < meta["grad_tol"] and meta["nu"] == nu
    for key, gate in (("polish_schedule", 1e-4), ("refine_schedule", 1e-6)):
        assert meta[key]["gate"] == gate and meta[key]["lane0_us_max_abs_err"] <= gate
    dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.NU_PROBLEMS[name](),
                                                    torch.float64, "cpu")
    np.testing.assert_array_equal(dyn.Pu.numpy(), np.asarray(meta["Pu"]))
    return us_gold, meta, dyn, cost, q0, xi0


@pytest.mark.parametrize("name", [n for n in al_bench.NU_PROBLEMS
                                  if al_bench.NU_PROBLEMS[n]().shape[1] <= 12])
def test_plain_f64_solve_reaches_the_golden(name):
    """The port's plain f64 `PipelineSolver` on lane 0 of the full-width
    problem (N = 200), for the golden's own iteration count, lands within
    1e-6 of the golden (the JAX f64 engine's optimum)."""
    us_gold, meta, dyn, cost, q0, xi0 = _golden_problem(name)
    nu = us_gold.shape[1]
    out = PipelineSolver(200, meta["iterations_f64"], float(dyn.dt), gravity=True,
                         exact_gravity_jacobian=True).solve(
        dyn, cost, q0[None], xi0[None], torch.zeros((1, 200, nu), dtype=torch.float64))
    assert float(np.abs(out.us[0].numpy() - us_gold).max()) <= 1e-6


@pytest.mark.parametrize("name", [n for n in al_bench.NU_PROBLEMS
                                  if al_bench.NU_PROBLEMS[n]().shape[1] > 12])
def test_golden_is_a_fixed_point_of_the_plain_f64_iteration(name):
    """Past nu = 12: from the golden's controls and the trajectory they roll
    out to from x0 (the port's plain dynamics), one plain f64 iteration of
    `PipelineSolver` moves the controls by less than 1e-9, and the gradient
    norm of its backward pass is at most the golden's (the JAX f64 engine's
    final one)."""
    us_gold, meta, dyn, cost, q0, xi0 = _golden_problem(name)
    N, nu = us_gold.shape
    us = torch.as_tensor(us_gold)[..., None].contiguous()
    f64 = dict(dtype=torch.float64)
    qR, qp, xi = (torch.empty(N + 1, *shape, 1, **f64) for shape in ((3, 3), (3,), (6,)))
    qR[0], qp[0], xi[0] = q0[:3, :3, None], q0[:3, 3, None], xi0[:, None]
    for t in range(N):
        qR[t + 1], qp[t + 1], xi[t + 1] = stage_dynamics_eval(
            qR[t], qp[t], xi[t], us[t], dyn.J, dyn.Jinv, dyn.Pu, float(dyn.m * dyn.g),
            dt=float(dyn.dt), gravity=True)
    s = PipelineSolver(N, 1, float(dyn.dt), gravity=True, exact_gravity_jacobian=True
                       ).solve_lane(dyn, cost, None, None, None, init=(qR, qp, xi, us))
    assert (s["us"] - us).abs().max().item() < 1e-9
    assert s["g"].item() <= meta["grad_norm_f64"]
