"""The constrained polish: the port's `al_polish` (fp64 dual ascent on the
host) and `al_polish_device` (f32 dual ascent on the device) against the
JAX package's, from the same f32 `ALPipelineResult` (the JAX loop's,
carried across by `convert.al_pipeline_result_from_numpy`), on the
reference's AL problem cut to H = 16 with R = 1e-2 I (a well-conditioned R
makes the constrained optimum unique, tests/test_al_pipeline.py:258-262)
and the box at 0.15 x the unconstrained optimum's peak, where it binds.

Tolerances: the polished fp64 controls at atol 1e-6 (the two mixed
polishes round their f32 preconditioners in other orders,
tests/test_torch_df_mixed.py); the multipliers at relative 1e-6 (the
device ascent's box residuals are the fp64 join rounded to f32 in the
port, a compensated f32 sum of the double-f32 controls in the JAX package:
within 1 ulp of each other); the fallback mask equal.  The JAX package's
own gates (tests/test_al_pipeline.py:225-351): against an f64
`ALFastSolver` solution with converged duals, each polish lands within
1e-4 and within a third of the f32 loop's error, and stays inside the box
to 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import al_pipeline as jap
from trajectory_optimization_matrix_lie_groups_tpu.solvers.df_mixed import (
    MixedDFPipelineSolver as JMixed,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    al_pipeline_result_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import al_pipeline as ap
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_mixed import (
    MixedDFPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    join_us,
)

from torch_port_cases import al_problem, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B, ITERS, R = 16, 2, 8, 1e-2


@pytest.fixture(scope="module")
def case():
    """The problem, the f64 oracle, the JAX f32 AL loop's result, and the
    JAX polishes of it (compiled once for the module)."""
    jp, tp, q0s, xi0s, us0 = al_problem(H, jnp.float64, seed=3, B=B)
    jp = {"dyn": jp["dyn"], "cost": jp["cost"]._replace(R=R * jnp.eye(6))}
    tp["cost"].R = R * torch.eye(6, dtype=torch.float64)
    dyn, cost = tp["dyn"], tp["cost"]
    T = torch.as_tensor
    # the box from the unconstrained f64 optimum, so that it binds
    model_u, _ = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6), dyn, cost)
    unc = FastBatchSolver(model_u, H, ITERS).solve(tp, T(q0s), T(xi0s), T(us0), cost.q_ref,
                                                   cost.xi_ref)
    box = 0.15 * float(unc.us.abs().max())
    # the f64 AL oracle with converged duals (a tiny tolerance and extra
    # outers: a feasibility-tolerance break leaves the duals ascent-inaccurate)
    constr = cs.input_box(12, 6)
    model_c, _ = make_model(dynamics.se3_dynamics(),
                            costs.al_cost(costs.tracking_cost(SE3, 6), constr), dyn, None)
    alp = costs.al_init_params(cost, cs.input_box_params(-box, box, 6), H, 12)
    ref = ALFastSolver(FastBatchSolver(model_c, H, ITERS), constr, tol_constr=1e-9).solve(
        {"dyn": dyn, "cost": alp}, T(q0s), T(xi0s), T(us0), n_al_iters=20)
    oracle = ref.us.numpy()
    assert (np.abs(oracle) >= box - 1e-6).sum() >= 10, "the box does not bind"
    # the JAX f32 AL loop (the production constrained path)
    f32 = lambda t: {k: type(v)(*[np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f"
                                  else x for x in v]) for k, v in t.items()}
    jp32 = f32(jp)
    q32, x32, u32 = (np.asarray(a, np.float32) for a in (q0s, xi0s, us0))
    jres = jap.ALPipelineSolver(
        PallasPipelineSolver(N=H, iterations=ITERS, dt=0.01, interpret=True),
        np.full(6, -box), np.full(6, box), tol_constr=1e-3).solve(
            jp32["dyn"], jp32["cost"], q32, x32, u32, n_al_iters=12)
    np64 = {k: type(v)(*[np.asarray(x) for x in v]) for k, v in jp.items()}
    mx = JMixed(N=H, dt=0.01, f32_iterations=ITERS, df_iterations=2, interpret=True)
    j_host = jap.al_polish(mx, np64, -box, box, jres, q32, x32, n_outers=2)
    j_dev = jap.al_polish_device(mx, np64, -box, box, jres, q32, x32, n_outers=2)
    res = al_pipeline_result_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in jres._asdict().items()})
    return dict(box=box, oracle=oracle, jres=jres, res=res, j_host=j_host, j_dev=j_dev,
                params64={"dyn": dyn, "cost": cost}, inputs=(T(q32), T(x32)),
                err_f32=float(np.abs(np.asarray(jres.us, np.float64) - oracle).max()))


def _gates(us, c):
    err = float(np.abs(us - c["oracle"]).max())
    assert err < 1e-4, (err, c["err_f32"])
    assert err < c["err_f32"] / 3, (err, c["err_f32"])
    assert float(np.abs(us).max()) <= c["box"] * (1 + 1e-3)


def _fallback(us, jres_us, box):
    viol = lambda u: np.maximum(np.maximum(-box - u, u - box).max(axis=(1, 2)), 0.0)
    return viol(us) > viol(np.asarray(jres_us, np.float64)) + 1e-5


def _mx():
    return MixedDFPipelineSolver(H, 0.01, f32_iterations=ITERS, df_iterations=2)


def test_al_polish_matches_jax(case):
    c = case
    timings = {}
    us, out, lam, imu = ap.al_polish(_mx(), c["params64"], -c["box"], c["box"], c["res"],
                                     *c["inputs"], n_outers=2, timings=timings)
    j_us, j_out, j_lam, j_imu = c["j_host"]
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lam, j_lam, rtol=1e-6, atol=1e-6 * np.abs(j_lam).max())
    np.testing.assert_allclose(imu, j_imu, rtol=1e-6)
    assert us.dtype == lam.dtype == imu.dtype == np.float64
    assert set(timings) == {"solve_s", "readback_s", "host_s"}
    assert all(len(v) == 2 for v in timings.values())
    np.testing.assert_array_equal((us == c["res"].us.double().numpy()).all(axis=(1, 2)),
                                  (j_us == np.asarray(c["jres"].us, np.float64)).all(axis=(1, 2)))
    _gates(us, c)


def test_al_polish_device_matches_jax(case):
    c = case
    out, lam, imu = ap.al_polish_device(_mx(), c["params64"], -c["box"], c["box"], c["res"],
                                        *c["inputs"], n_outers=2)
    j_out, j_lam, j_imu = c["j_dev"]
    us = join_us(out).numpy()
    j_us = np.asarray(j_out.us_hi, np.float64) + np.asarray(j_out.us_lo, np.float64)
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lam.numpy(), np.asarray(j_lam), rtol=1e-6,
                               atol=1e-6 * float(np.abs(np.asarray(j_lam)).max()))
    np.testing.assert_allclose(imu.numpy(), np.asarray(j_imu), rtol=1e-6)
    assert lam.dtype == imu.dtype == torch.float32
    # the same lanes fell back (none here: the fallback keeps the f32
    # controls where a lane's polished violation grew)
    np.testing.assert_array_equal(_fallback(us, c["res"].us, c["box"]),
                                  _fallback(j_us, c["jres"].us, c["box"]))
    _gates(us, c)


def test_dual_fallback_takes_back_a_lane_that_left_the_box():
    """A lane whose polished violation exceeds the f32 solution's by more
    than 1e-5 takes the f32 controls back with a zero remainder."""
    us_f32 = torch.zeros((2, 3, 6))
    us_hi = us_f32.clone()
    us_hi[1, 0, 0] = 2.0            # lane 1 leaves the box [-1, 1]
    us_lo = torch.full((2, 3, 6), 1e-9, dtype=torch.float64)
    box = torch.ones(6)
    hi, lo = ap._dual_fallback(us_hi, us_lo, us_f32, -box, box)
    assert torch.equal(hi[1], us_f32[1]) and torch.equal(hi[0], us_hi[0])
    assert float(lo[1].abs().max()) == 0.0 and float(lo[0].min()) == 1e-9


def test_polishes_refuse_a_result_without_penalties(case):
    bad = case["res"]._replace(imu=None)
    for fn in (ap.al_polish, ap.al_polish_device):
        with pytest.raises(ValueError):
            fn(_mx(), case["params64"], -1.0, 1.0, bad, *case["inputs"])
