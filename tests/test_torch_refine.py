"""The port's full-precision refiners and single-plant MPC against the JAX
package on the screw-tracking problem (R = 1e-3 I).

- `DFPipelineSolver` (10 f32 + 3 fp64 iterations) against the JAX f64
  oracle at the same budget (`FastBatchSolver(use_pallas=False)`, 13
  iterations): every control within 1e-4, as tests/test_df_pipeline.py:94
  gates the JAX solver (H = 30, B = 3).  Its fp64 phase is
  `PipelineSolver.solve_lane` warm-started from the f32 handoff, which
  equals the fp64 pipeline iterated from the same trajectory (1e-12).
- `HighPrecisionSolver` (8 f32 + 2 f64 polish iterations) against the JAX
  one (the f32 phase in interpret mode): controls within 1e-6 (the two f32
  phases differ at f32 roundoff, ~1e-4, and two f64 iterations contract
  that), J rtol 1e-9.
- `make_closed_loop` against the JAX one (H = 8, T = 4, to convergence at
  tol_grad_norm 1e-8 each step): the plant trajectory and the applied
  controls to 1e-8; a batch of three plants equals each plant's own loop
  (1e-12).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jd
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
from trajectory_optimization_matrix_lie_groups_tpu.solvers import mpc as jmpc
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver as JFast,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.polish import (
    HighPrecisionSolver as JHigh,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    DFPipelineSolver,
    join_us,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.polish import (
    HighPrecisionSolver,
)

from torch_port_cases import initial_batch, mpc_setup, one_cpu_thread, problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B = 30, 3
F32_ITERS, DF_ITERS = 10, 3


@pytest.fixture(scope="module")
def case():
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H)
    jm, jp = jmm(jd.se3_dynamics(), jc.tracking_cost(JSE3, 6), dp, cp)
    tm, tp = make_model(td.se3_dynamics(), tc.tracking_cost(SE3, 6), tdp, tcp)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=1, dtype=jnp.float64)
    return jm, jp, tm, tp, q0s, xi0s, us0


def test_df_pipeline_hits_f64_fixed_point(case):
    jm, jp, _, tp, q0s, xi0s, us0 = case
    cp = jp["cost"]
    ref = JFast(jm, N=H, iterations=F32_ITERS + DF_ITERS, use_pallas=False).solve(
        jp, jnp.asarray(q0s), jnp.asarray(xi0s), jnp.asarray(us0), cp.q_ref, cp.xi_ref)
    t = torch.as_tensor
    dfp = DFPipelineSolver(H, 0.01, f32_iterations=F32_ITERS, df_iterations=DF_ITERS)
    out = dfp.solve(tp["dyn"], tp["cost"], t(q0s), t(xi0s), t(us0))
    us = join_us(out)
    assert us.dtype == torch.float64 and tuple(us.shape) == (B, H, 6)
    err = np.abs(us.numpy() - np.asarray(ref.us)).max()
    assert err < 1e-4, err
    # the refinement is the fp64 pipeline iterated from the handoff
    handoff = dfp._solve_f32(tp["dyn"], tp["cost"], t(q0s), t(xi0s), t(us0))
    warm = PipelineSolver(H, DF_ITERS, 0.01).solve_lane(
        tp["dyn"], tp["cost"], None, None, None, init=tuple(x.double() for x in handoff))
    np.testing.assert_allclose(warm["us"].movedim(-1, 0).numpy(), us.numpy(), rtol=0,
                               atol=1e-12)
    assert np.all(np.isfinite(out.grad_norm.numpy())) and float(out.grad_norm.max()) < 1e-4


def test_high_precision_matches_jax(case):
    jm, jp, tm, tp, q0s, xi0s, us0 = case
    jout = JHigh(jm, N=H, iterations=8, dt=0.01, polish_iters=2, interpret=True).solve(
        jp, jnp.asarray(q0s), jnp.asarray(xi0s), jnp.asarray(us0))
    t = torch.as_tensor
    tout = HighPrecisionSolver(tm, H, 8, 0.01, polish_iters=2).solve(
        tp, t(q0s), t(xi0s), t(us0))
    assert tout.us.dtype == torch.float64
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), rtol=1e-9)


def test_closed_loop_matches_jax():
    T, HM = 4, 8
    dp, cp, jmodel, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(jnp.float64, T, HM, 3)
    cfg = dict(N=HM, tol_grad_norm=1e-8, max_iterations=20)
    jres = jmpc.make_closed_loop(JL.LieILQR(jmodel, JL.SolverConfig(**cfg)), T)(
        {"dyn": dp, "cost": cp}, jnp.asarray(q0s[1]), jnp.asarray(xi0s[1]))
    run = mpc.make_closed_loop(LieILQR(tmodel, SolverConfig(**cfg)), T)
    params = {"dyn": tdp, "cost": tcp}
    t = torch.as_tensor
    res = run(params, t(q0s[1:2]), t(xi0s[1:2]))
    for f in ("qs", "xis", "us", "J_pred"):
        assert tuple(getattr(res, f).shape) == (1,) + np.shape(getattr(jres, f)), f
    np.testing.assert_allclose(res.qs[0].numpy(), np.asarray(jres.qs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.us[0].numpy(), np.asarray(jres.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.J_pred[0].numpy(), np.asarray(jres.J_pred), rtol=1e-9)
    batch = run(params, t(q0s), t(xi0s))
    for b in range(3):
        one = res if b == 1 else run(params, t(q0s[b:b + 1]), t(xi0s[b:b + 1]))
        np.testing.assert_allclose(batch.qs[b].numpy(), one.qs[0].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(batch.us[b].numpy(), one.us[0].numpy(), rtol=0, atol=1e-12)
