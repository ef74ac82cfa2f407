"""The port's one-device batch and sweeps (`parallel/batch.py`,
`parallel/sweep.py`, the sweep problems of `tasks/errstate_bench.py`)
against the JAX package's on the same numpy inputs, f64.

`build_x0_batch` on all 12 parameters to 1e-12; the open-loop rollout sweep
at N = 50 to 1e-10; `BatchSolver` (both shooting modes) and `run_sweep`
against the JAX `BatchSolver(mesh=None)` on screw-200 cut to H = 20 (the
sweep task's solver: MS, 10 iterations at mu = 0; its rollout on B14's
plain version here), 2 ranges of 4 values, at `torch_port_cases.check_fits`'
tolerances for `LieILQR` (J rtol 1e-8, grad norm rtol 1e-8 / atol 1e-13,
controls atol 1e-8).  The device meshes: test_torch_riccati_sharded.py (one
rank) and test_torch_multidevice.py (two ranks).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.parallel.batch import (
    BatchSolver as JaxBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.parallel import sweep as jsweep
from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import BatchSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep as tsweep
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

from torch_port_cases import one_cpu_thread, problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H = 20
RANGES = {"w_z": np.linspace(0.5, 1.5, 4), "p_x": np.linspace(-1.0, 1.0, 4)}
T = lambda x: torch.as_tensor(np.array(x))


@pytest.mark.parametrize("param", tsweep.PARAM_NAMES)
def test_build_x0_batch_matches_jax(param):
    """Every parameter from a perturbed base pose and twist, to 1e-12."""
    rng = np.random.default_rng(0)
    base_q0 = np.asarray(JSE3.exp(jnp.asarray(rng.standard_normal(6))))
    base_xi0 = rng.standard_normal(6)
    values = np.linspace(-30.0, 45.0, 5) if param.startswith("th_") else rng.standard_normal(5)
    jq, jxi = jsweep.build_x0_batch(param, values, base_q0, base_xi0)
    tq, txi = tsweep.build_x0_batch(param, values, T(base_q0), T(base_xi0))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-12)
    np.testing.assert_allclose(txi.numpy(), np.asarray(jxi), rtol=0, atol=1e-12)


def test_build_x0_batch_rejects_an_unknown_parameter():
    with pytest.raises(ValueError, match="q_x"):
        tsweep.build_x0_batch("q_x", np.zeros(2), torch.eye(4, dtype=torch.float64),
                              torch.zeros(6, dtype=torch.float64))


def test_rollout_sweep_matches_jax():
    """`run_rollout_sweep_task`'s dynamics and base state, two ranges at
    N = 50: every lane's poses and twists to 1e-10, and the middle lane
    against a serial loop of the port's step to 1e-12."""
    dyn, dp, base_q0, base_xi0, _ = EB.build_rollout_sweep(device="cpu")
    ranges = {"w_z": np.asarray([0.5, 1.0, 1.5]), "th_z": np.asarray([-40.0, 0.0, 60.0])}
    out = tsweep.run_rollout_sweep(dyn, dp, ranges, base_q0, base_xi0, N=50)
    jdp = jdyn.se3_params(jnp.asarray(dp.J.numpy()), jnp.asarray(0.01))
    jout = jsweep.run_rollout_sweep(jdyn.se3_dynamics(), jdp, ranges,
                                    jnp.asarray(base_q0.numpy()),
                                    jnp.asarray(base_xi0.numpy()), N=50)
    for name in ranges:
        assert out[name].qs.shape == (3, 51, 4, 4) and out[name].xis.shape == (3, 51, 6)
        np.testing.assert_allclose(out[name].qs, jout[name].qs, rtol=0, atol=1e-10)
        np.testing.assert_allclose(out[name].xis, jout[name].xis, rtol=0, atol=1e-10)
    q, xi = base_q0, base_xi0.clone()
    xi[2] = 1.0
    for i in range(50):
        q, xi = dyn.step(dp, q, xi, torch.zeros(6, dtype=torch.float64), i)
    np.testing.assert_allclose(out["w_z"].qs[1, -1], q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["w_z"].xis[1, -1], xi.numpy(), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def sweep_case():
    """The port's sweep problem on screw-200 cut to H (rollout on B14's
    plain version) and the JAX solver and params of the same problem."""
    bs, params, base_q0, base_xi0 = EB.build_sweep(torch.float64, "cpu", N=H)
    dp, cp = problem(H)[:2]
    jm, jp = jmake(jdyn.se3_dynamics(), jcosts.tracking_cost(JSE3, 6), dp, cp)
    jcfg = JL.SolverConfig(**dataclasses.asdict(EB.sweep_config(H)))
    return bs, params, base_q0, base_xi0, jm, jp, jcfg


def _check_states(ts, js, rtol=1e-8, grad_atol=1e-13, us_atol=1e-8):
    np.testing.assert_allclose(ts.J_opt.numpy(), np.asarray(js.J_opt), rtol=rtol)
    np.testing.assert_allclose(ts.grad_norm.numpy(), np.asarray(js.grad_norm), rtol=rtol,
                               atol=grad_atol)
    np.testing.assert_allclose(ts.us.numpy(), np.asarray(js.us), rtol=0, atol=us_atol)
    for f in ("iteration", "converged", "failed"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)


def test_sweep_config_is_the_tasks(sweep_case):
    cfg = sweep_case[0].solver.cfg
    assert (cfg.N, cfg.max_iterations, cfg.tol_grad_norm, cfg.tol_d_norm, cfg.backward,
            cfg.multiple_shooting, cfg.n_alphas) == (H, 10, 0.0, 0.0, "sequential_fixed",
                                                     True, 20)
    assert sweep_case[0].solver.pallas_rollout_dt == 0.01
    assert sum(len(v) for v in EB.SWEEP_RANGES.values()) == 160
    assert sum(len(v) for v in EB.ROLLOUT_RANGES.values()) == 112


@pytest.mark.parametrize("ms", [True, False], ids=["ms", "ss"])
def test_batch_solver_matches_jax(sweep_case, ms):
    """`solve_batch` on three perturbed starts (q_ref from params["cost"]),
    multiple shooting (10 iterations, no convergence test) and single
    shooting (the per-stage LM backward, to grad 1e-3)."""
    bs, params, base_q0, base_xi0, jm, jp, jcfg = sweep_case
    q0s, xi0s = tsweep.build_x0_batch("v_x", np.asarray([1.5, 2.0, 2.5]), base_q0, base_xi0)
    us0 = np.zeros((3, H, 6))
    if not ms:
        # to grad 1e-3: on this problem single shooting's line search
        # stalls on roundoff near grad 1e-4 in both packages, at an
        # iteration that is then roundoff too
        ss = dict(multiple_shooting=False, backward="sequential", tol_grad_norm=1e-3)
        bs = BatchSolver(type(bs.solver)(bs.solver.model,
                                         dataclasses.replace(bs.solver.cfg, **ss)))
        jcfg = dataclasses.replace(jcfg, **ss)
    ts = bs.solve_batch(params, q0s, xi0s, T(us0))
    js = JaxBatchSolver(JL.LieILQR(jm, jcfg)).solve_batch(
        jp, jnp.asarray(q0s.numpy()), jnp.asarray(xi0s.numpy()), jnp.asarray(us0))
    _check_states(ts, js)


def test_run_sweep_matches_jax(sweep_case):
    """Two ranges of four values, each one batched solve."""
    bs, params, base_q0, base_xi0, jm, jp, jcfg = sweep_case
    out = tsweep.run_sweep(bs, params, RANGES, base_q0, base_xi0)
    jout = jsweep.run_sweep(JaxBatchSolver(JL.LieILQR(jm, jcfg)), jp, RANGES,
                            jp["cost"].q_ref[0], jp["cost"].xi_ref[0])
    for name in RANGES:
        r, jr = out[name], jout[name]
        assert r.param == name and r.us.shape == (4, H, 6)
        np.testing.assert_array_equal(r.values, jr.values)
        np.testing.assert_allclose(r.J_opt, jr.J_opt, rtol=1e-8)
        np.testing.assert_allclose(r.grad_norm, jr.grad_norm, rtol=1e-8, atol=1e-13)
        np.testing.assert_array_equal(r.converged, jr.converged)
        np.testing.assert_allclose(r.us, jr.us, rtol=0, atol=1e-8)


def test_entry_points_default_to_the_card():
    """From numpy, without a device, the sweep's states and the problems go
    to the card: with no card they raise, never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises((RuntimeError, AssertionError)):
        tsweep.build_x0_batch("w_z", np.ones(2), np.eye(4), np.zeros(6))
    with pytest.raises((RuntimeError, AssertionError)):
        EB.build_rollout_sweep()
    with pytest.raises((RuntimeError, AssertionError)):
        EB.build_errstate_tracking(N=4)
