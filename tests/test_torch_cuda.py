"""The port's CUDA kernels B1-B4 against their plain versions on the card.

Marked ``cuda``; each test skips without a CUDA device (the kernels are
built by nvcc at first use and run only on the card).  This file imports no
JAX, so on a machine with the card it runs without the JAX test setup:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    GATES,
    compare,
    kernel_inputs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    drone_params,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    screw_batch,
)

pytestmark = pytest.mark.cuda

H, B = 16, 130  # B crosses a 128-thread block boundary


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _problem(dtype, device, drone):
    dyn, cost, q0, xi0 = build_screw200(dtype, device, horizon=H)
    nu = 6
    if drone:
        dyn = drone_params(dyn.J, dyn.dt)
        cost.R = 1e-2 * torch.eye(4, dtype=dtype, device=device)
        nu = 4
    q0s, xi0s = screw_batch(q0, xi0, B, seed=1)
    us0 = torch.zeros((B, H, nu), dtype=dtype, device=device)
    return dyn, cost, q0s, xi0s, us0


def _al_state(nu, dtype, device, seed=2):
    """Input-box AL state (lb, ub, lmbd, imu) in solver layout."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return (t(np.full(nu, -5.0)), t(np.full(nu, 5.0)),
            t(np.abs(rng.normal(size=(B, H + 1, 2 * nu)))),
            t(np.full((B, H + 1, 2 * nu), 0.5)))


@pytest.mark.parametrize("al", [False, True], ids=["plain_quu", "al_quu"])
@pytest.mark.parametrize("drone", [False, True], ids=["free_body", "drone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernels_match_plain(cuda, dtype, drone, al):
    dyn, cost, q0s, xi0s, us0 = _problem(dtype, cuda, drone)
    solver = P.PipelineSolver(H, 2, float(dyn.dt), gravity=drone,
                              exact_gravity_jacobian=drone)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=al)
    errs = compare(s, dt=solver.dt, gravity=drone, exact_grav=drone)
    torch.cuda.synchronize()
    assert ("B2_al" in errs) == al
    for name, e in errs.items():
        assert e["max_rel"] <= GATES[dtype][name], (name, e["per_output"])


@pytest.mark.parametrize("al", [False, True], ids=["no_al", "al"])
def test_kernel_solve_matches_plain_solve(cuda, al):
    """Fused and unfused kernel solves against the plain solve (f64), with
    and without the AL terms."""
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    al_arg = _al_state(6, torch.float64, cuda) if al else None
    ref = P.PipelineSolver(H, 3, float(dyn.dt), plain=True).solve(
        dyn, cost, q0s, xi0s, us0, al=al_arg)
    for fused in (True, False):
        out = P.PipelineSolver(H, 3, float(dyn.dt), fused=fused).solve(
            dyn, cost, q0s, xi0s, us0, al=al_arg)
        torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
        torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-12, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    solver = P.PipelineSolver(H, 1, float(dyn.dt))
    qR, qp, xi, us, refs, consts = solver._prepare(dyn, cost, q0s, xi0s, us0)
    with pytest.raises(TypeError):
        P.linearize_lane(qR.half(), qp.half(), xi.half(), us.half(), refs,
                         consts, dt=solver.dt)
    with pytest.raises(ValueError):
        P.linearize_lane(qR, qp, xi, us[:-1], refs, consts, dt=solver.dt)
