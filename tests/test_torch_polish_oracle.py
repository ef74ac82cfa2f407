"""The port's mixed-precision polish (`solvers/df_mixed.py`) against the
port's own f64 `PipelineSolver` run to convergence: the polish's fixed
point, its `fx_mode`s and its AL path.  Port only (no JAX): the JAX
comparisons are in test_torch_df_mixed.py.
"""

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as dm
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    join_us,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    screw_batch,
)

def _oracle_case(al=False, reference=True):
    """The screw problem at H = 30, B = 3 (tests/test_df_mixed.py's
    test_df_mixed_hits_f64_fixed_point sizes), and (``reference``) the
    port's f64 `PipelineSolver` run to convergence on it."""
    Hs, Bs, nu = 30, 3, 6
    dyn, cost, q0, xi0 = build_screw200(torch.float64, device="cpu", horizon=Hs)
    q0s, xi0s = screw_batch(q0, xi0, Bs, seed=5)
    us0 = torch.zeros((Bs, Hs, nu), dtype=torch.float64)
    al_arg = None
    if al:
        rng = np.random.default_rng(6)
        # f32-representable multipliers: both solvers then see the same ones
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), dtype=torch.float64)
        al_arg = (torch.full((nu,), -5.0, dtype=torch.float64),
                  torch.full((nu,), 5.0, dtype=torch.float64),
                  f32(np.abs(rng.normal(size=(Bs, Hs + 1, 2 * nu)))),
                  torch.full((Bs, Hs + 1, 2 * nu), 0.5, dtype=torch.float64))
    ref = PipelineSolver(Hs, 30, float(dyn.dt)).solve(
        dyn, cost, q0s, xi0s, us0, al=al_arg) if reference else None
    return dyn, cost, (q0s, xi0s, us0), al_arg, ref


@pytest.fixture(scope="module")
def solves():
    """The f64 reference and one mixed solve (10 f32 + 3 polish iterations)
    per fx_mode, shared by the tests below."""
    dyn, cost, inputs, _, ref = _oracle_case()
    out = {mode: dm.MixedDFPipelineSolver(30, float(dyn.dt), 10, 3, fx_mode=mode
                                          ).solve(dyn, cost, *inputs)
           for mode in ("df", "f32", "hybrid")}
    return ref, out


@pytest.mark.parametrize("fx_mode", ["df", "hybrid"])
def test_mixed_solve_hits_the_f64_fixed_point(solves, fx_mode):
    """10 f32 + 3 mixed iterations land within 1e-4 of the converged f64
    solve with a gradient below 1e-6 (the gate of
    tests/test_df_mixed.py::test_df_mixed_hits_f64_fixed_point); 'hybrid'
    (f32 Jacobian but on the last polish iteration) as 'df'."""
    ref, outs = solves
    out = outs[fx_mode]
    assert (join_us(out) - ref.us).abs().max().item() < 1e-4
    assert out.grad_norm.max().item() < 1e-6
    np.testing.assert_allclose(out.J_opt.numpy(), ref.J_opt.numpy(), rtol=1e-6)


def test_fx_mode_f32_keeps_its_bias_and_hybrid_erases_it(solves):
    """The f32 Jacobian's rounding is a persistent gradient bias: with it on
    every polish iteration the solve converges (gradient < 1e-8) to a point
    farther from the f64 optimum than 'df' reaches (the JAX package's
    documented 2x at H = 30; the port measures 2.0e-5 against 3.6e-7 on its
    H = 30 case), while 'hybrid' lands where 'df' does."""
    ref, outs = solves
    err, us = {}, {}
    for mode, out in outs.items():
        us[mode] = join_us(out)
        err[mode] = (us[mode] - ref.us).abs().max().item()
        # the gradient is one polish step stale: in 'hybrid' that step used
        # the f32 Jacobian, in 'f32' every step measures the biased gradient
        assert out.grad_norm.max().item() < (1e-6 if mode == "hybrid" else 1e-8), mode
    assert err["f32"] > 5 * err["df"], err
    assert (us["hybrid"] - us["df"]).abs().max().item() < 1e-5


def test_mixed_al_polish_hits_the_f64_al_fixed_point():
    """With a fixed input-box AL state (the multipliers and penalties of
    tests/torch_port_cases.py's AL case), the polish minimizes the same
    augmented Lagrangian as the f64 pipeline: its u gradient in the fp64
    lu, its diagonal in the f32 Q_uu."""
    dyn, cost, inputs, al_arg, ref = _oracle_case(al=True)
    out = dm.MixedDFPipelineSolver(30, float(dyn.dt), 10, 3).solve(
        dyn, cost, *inputs, al=al_arg)
    assert (join_us(out) - ref.us).abs().max().item() < 1e-6
    assert out.grad_norm.max().item() < 1e-8
    np.testing.assert_allclose(out.J_opt.numpy(), ref.J_opt.numpy(), rtol=1e-6)


def test_zero_polish_iterations_report_the_handoff():
    """df_iterations = 0 returns the f32 handoff with its fp64 gradient."""
    dyn, cost, inputs, _, _ = _oracle_case(reference=False)
    mx = dm.MixedDFPipelineSolver(30, float(dyn.dt), 10, 0)
    out = mx.solve(dyn, cost, *inputs)
    hand = mx._solve_f32(dyn, cost, *inputs)[3]
    assert torch.equal(out.us_hi, hand.movedim(-1, 0))
    assert (out.grad_norm > 1e-8).all()
