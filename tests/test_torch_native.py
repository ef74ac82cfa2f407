"""The port's native C++ runtime (`native/`: its own copy of `src/ilqr.cpp`
and `src/lie.hpp`, its own ctypes loader) against the JAX package's native
runtime on the same inputs (the same C++: 1e-12), and against the port's
own engines as `tests/test_native.py` holds the JAX runtime against the
JAX engines: `FastBatchSolver(use_pallas=False)` (free body, drone, both
SO(3) families), `make_closed_loop` (`NativeMPC`) and `ALFastSolver`
(`solve_al`), f64 on the CPU, on the stand-in problems
(`tasks/golden/standin/`).  Skipped exactly where the JAX tests skip: when
the JAX package's native library cannot be built.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu import native as jnative
from trajectory_optimization_matrix_lie_groups_tpu_torch import native
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import (
    constraints as cs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.mpc import make_closed_loop
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import load_benchmark_pickle

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = [pytest.mark.skipif(jnative.LIB is None, reason="no native toolchain"),
              pytest.mark.usefixtures("one_cpu_thread")]

CPU = torch.device("cpu")
RNG = np.random.default_rng(5)


def _bench(name, H, ms=True):
    """(prob, solver, params cut to H, q_ref (H+1), xi_ref) of a stand-in,
    f64 on the CPU."""
    spec = parity.BENCHMARKS[name]
    prob = load_benchmark_pickle(os.path.join(parity.STANDIN_DIR, spec["pkl"]))["prob"]
    solver, params, _, _, _ = parity.build_from_prob(prob, spec["family"], ms, device=CPU)
    params = parity.cut_reference(params, H)
    cp = params["cost"]
    return prob, solver, params, cp.q_ref, cp.xi_ref


def _starts(group, q_ref, xi_ref, B, scale):
    dq = torch.as_tensor(scale * RNG.standard_normal((B, group.dim)))
    q0s = group.normalize(q_ref[0][None] @ group.exp(dq))
    return q0s, xi_ref[0].expand(B, group.dim).contiguous()


def test_native_library_is_the_port_own_build():
    assert native.LIB is not None
    assert native.BUILD_DIR.endswith(os.path.join("build", "native"))
    assert os.path.dirname(native._SRC).startswith(os.path.dirname(native.__file__))


@pytest.mark.parametrize("name", ["se3_tracking", "drone_racing"])
def test_native_se3_families_match_jax_native_and_fast_batch(name):
    H, ITERS, B = 30, 5, 3
    prob, solver, params, q_ref, xi_ref = _bench(name, H)
    dp = params["dyn"]
    q0s, xi0s = _starts(SE3, q_ref, xi_ref, B, 0.03)
    kw = {} if name == "se3_tracking" else dict(g=float(dp.g), Pu=dp.Pu.numpy())
    args = (prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"])
    s = native.NativeSE3Solver(*args, q_ref, xi_ref, iterations=ITERS, **kw)
    js = jnative.NativeSE3Solver(*args, q_ref.numpy(), xi_ref.numpy(), iterations=ITERS,
                                 **kw)
    us, J, g = s.solve_batch(q0s, xi0s)
    jus, jJ, jg = js.solve_batch(q0s.numpy(), xi0s.numpy())
    assert isinstance(us, torch.Tensor) and us.dtype == torch.float64
    assert us.shape == (B, H, s.nu)
    np.testing.assert_allclose(us.numpy(), jus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(J.numpy(), jJ, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-15)
    # the plant step
    u = torch.as_tensor(RNG.standard_normal(s.nu))
    q1, xi1 = s.step(q0s[0], xi0s[0], u)
    jq1, jxi1 = js.step(q0s[0].numpy(), xi0s[0].numpy(), u.numpy())
    np.testing.assert_allclose(q1.numpy(), jq1, rtol=0, atol=1e-15)
    np.testing.assert_allclose(xi1.numpy(), jxi1, rtol=0, atol=1e-15)
    # against the port's own engine, f64 (tests/test_native.py's gates)
    ref = FastBatchSolver(solver.model, N=H, iterations=ITERS, use_pallas=False).solve(
        params, q0s, xi0s, torch.zeros((B, H, s.nu), dtype=torch.float64), q_ref, xi_ref)
    np.testing.assert_allclose(us.numpy(), ref.us.numpy(), atol=1e-8)
    np.testing.assert_allclose(J.numpy(), ref.J_opt.numpy(), rtol=1e-10)


@pytest.mark.parametrize("name,pendulum", [("so3_tracking", False),
                                           ("pendulum_swingup", True)])
def test_native_so3_families_match_jax_native_and_fast_batch(name, pendulum):
    H, ITERS, B = 30, 6, 2
    prob, solver, params, q_ref, xi_ref = _bench(name, H)
    q0s, xi0s = _starts(SO3, q_ref, xi_ref, B, 0.05)
    kw = (dict(pendulum=True, m=float(prob["m"]), length=float(prob["length"]), g=9.8)
          if pendulum else {})
    args = (prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"])
    s = native.NativeSO3Solver(*args, q_ref, xi_ref, iterations=ITERS, **kw)
    js = jnative.NativeSO3Solver(*args, q_ref.numpy(), xi_ref.numpy(), iterations=ITERS,
                                 **kw)
    us, J, g = s.solve_batch(q0s, xi0s)
    jus, jJ, jg = js.solve_batch(q0s.numpy(), xi0s.numpy())
    np.testing.assert_allclose(us.numpy(), jus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(J.numpy(), jJ, rtol=1e-12)
    us1, J1, g1 = s.solve(q0s[0], xi0s[0])
    np.testing.assert_allclose(us1.numpy(), us[0].numpy(), atol=1e-12)
    q1, xi1 = s.step(q0s[0], xi0s[0], us1[0])
    jq1, jxi1 = js.step(q0s[0].numpy(), xi0s[0].numpy(), us1[0].numpy())
    np.testing.assert_allclose(q1.numpy(), jq1, rtol=0, atol=1e-15)
    np.testing.assert_allclose(xi1.numpy(), jxi1, rtol=0, atol=1e-15)
    ref = FastBatchSolver(solver.model, N=H, iterations=ITERS, use_pallas=False).solve(
        params, q0s, xi0s, torch.zeros((B, H, 3), dtype=torch.float64), q_ref, xi_ref)
    np.testing.assert_allclose(us.numpy(), ref.us.numpy(), atol=1e-8)
    np.testing.assert_allclose(J.numpy(), ref.J_opt.numpy(), rtol=1e-10)


def test_native_mpc_matches_jax_native_and_closed_loop():
    """NativeMPC == the JAX NativeMPC, and == make_closed_loop
    (backward='sequential_fixed') at f64, as tests/test_native.py."""
    H, T, ITERS = 20, 12, 4
    prob, solver, params, _, _ = _bench("se3_tracking", 200)
    cp = params["cost"]
    q0 = cp.q_ref[0]
    xi0 = cp.xi_ref[0] + 0.05 * torch.arange(6, dtype=torch.float64)
    args = (prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"])
    s = native.NativeSE3Solver(*args, cp.q_ref, cp.xi_ref, iterations=ITERS)
    js = jnative.NativeSE3Solver(*args, cp.q_ref.numpy(), cp.xi_ref.numpy(),
                                 iterations=ITERS)
    qs, xis, us, J_pred = native.NativeMPC(s, H).run(q0, xi0, T)
    jqs, jxis, jus, jJ = jnative.NativeMPC(js, H).run(q0.numpy(), xi0.numpy(), T)
    for a, b in ((qs, jqs), (xis, jxis), (us, jus), (J_pred, jJ)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS, tol_grad_norm=0.0,
                              tol_d_norm=0.0, backward="sequential_fixed")
    ref = make_closed_loop(LieILQR(solver.model, cfg), T)(params, q0[None], xi0[None])
    np.testing.assert_allclose(us.numpy(), ref.us[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(qs.numpy(), ref.qs[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(xis.numpy(), ref.xis[0].numpy(), atol=1e-9)
    # J conventions differ by one rollout (post-rollout vs linearization point)
    np.testing.assert_allclose(J_pred.numpy(), ref.J_pred[0].numpy(), rtol=1e-4)
    # the box: the JAX runtime's constrained loop, step for step
    lb, ub = -300.0, 300.0
    qc, _, uc, _ = native.NativeMPC(s, H, lb=lb, ub=ub).run(q0, xi0, T)
    jqc, _, juc, _ = jnative.NativeMPC(js, H, lb=lb, ub=ub).run(q0.numpy(), xi0.numpy(), T)
    np.testing.assert_allclose(uc.numpy(), juc, rtol=0, atol=1e-12)
    assert uc.max() <= ub + 1e-2 and uc.min() >= lb - 1e-2


def test_native_al_matches_jax_native_and_al_fast():
    """Native AL outer loop (input box) == the JAX runtime's and
    ALFastSolver at f64."""
    H, B, ITERS = 40, 2, 20
    prob, _, params, q_ref, xi_ref = _bench("se3_tracking", H)
    q0s, xi0s = _starts(SE3, q_ref, xi_ref, B, 0.03)
    xi0s = xi0s + 0.05
    lb, ub = -100.0, 100.0
    dp, cp = params["dyn"], params["cost"]
    constr = cs.input_box(12, 6)
    model_c, _ = make_model(dynamics.se3_dynamics(),
                            costs.al_cost(costs.tracking_cost(SE3, 6), constr), dp, None)
    alp = costs.al_init_params(cp, cs.input_box_params(lb, ub, 6), H, constr.constr_size,
                               mu0=1e-2)
    inner = FastBatchSolver(model_c, N=H, iterations=ITERS, use_pallas=False)
    ref = ALFastSolver(inner, constr, tol_constr=1e-2).solve(
        {"dyn": dp, "cost": alp}, q0s, xi0s, torch.zeros((B, H, 6), dtype=torch.float64),
        q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15)
    args = (prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"])
    s = native.NativeSE3Solver(*args, q_ref, xi_ref, iterations=ITERS)
    js = jnative.NativeSE3Solver(*args, q_ref.numpy(), xi_ref.numpy(), iterations=ITERS)
    us, J, g, maxv, outer = s.solve_al(q0s, xi0s, lb, ub, n_al_iters=15)
    jus, jJ, jg, jmaxv, jouter = js.solve_al(q0s.numpy(), xi0s.numpy(), lb, ub,
                                             n_al_iters=15)
    assert outer == jouter
    np.testing.assert_allclose(us.numpy(), jus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(maxv.numpy(), jmaxv, rtol=0, atol=1e-12)
    assert outer == ref.outer_iterations
    np.testing.assert_allclose(us.numpy(), ref.us.numpy(), atol=1e-8)
    np.testing.assert_allclose(maxv.numpy(), ref.max_violation.numpy(), atol=1e-9)


def test_native_refuses_bad_shapes_and_windows():
    prob, _, _, q_ref, xi_ref = _bench("se3_tracking", 10)
    with pytest.raises(ValueError, match="R must be"):
        native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], np.eye(4), prob["P"],
                               q_ref, xi_ref, iterations=2)
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"],
                               q_ref, xi_ref, iterations=2)
    with pytest.raises(ValueError, match="exceeds reference"):
        s.solve_window(q_ref[0], xi_ref[0], 5, 10)
    with pytest.raises(ValueError, match="shorter than one MPC window"):
        native.NativeMPC(s, 10)
