"""Problems shared by the test_torch_*.py files: the same inputs, made from a
seed with numpy, for the JAX package and its PyTorch port.

The problem is the screw-tracking problem of `tasks/al_bench.build_al1400`
cut to a short horizon, with R = 1e-3 I (the pipeline's Cholesky needs
Quu > 0) and no input box; the drone variant swaps in `drone_params`
(gravity, a 6x4 input projection) with R = 1e-2 I on its 4 inputs.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _to(tree, dtype):
    return jax.tree.map(
        lambda x: jnp.asarray(x, dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        tree)


def problem(H, dtype=jnp.float64, drone=False):
    """(jax dyn, jax cost, torch dyn, torch cost, q0 (4, 4), xi0 (6,), nu)
    in ``dtype``; the torch containers come through `convert.py`."""
    params, _, _, q0, xi0, _, _ = build_al1400(jnp.float64, H)
    dp, cp = params["dyn"], params["cost"]
    nu = 6
    if drone:
        dp = dynamics.drone_params(dp.J, dp.dt)
        nu = 4
    cp = cp._replace(R=(1e-2 if drone else 1e-3) * jnp.eye(nu, dtype=jnp.float64))
    dp, cp = _to(dp, dtype), _to(cp, dtype)
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    tdt = TORCH_DTYPE[dtype]
    return (dp, cp, dyn_from_numpy(fields(dp), dtype=tdt),
            cost_from_numpy(fields(cp), dtype=tdt), np.asarray(q0),
            np.asarray(xi0), nu)


def initial_batch(q0, xi0, B, H, nu, seed, dtype, u_scale=0.0):
    """Perturbed initial poses q0 Exp(0.05 n) (f64 numpy, cast to ``dtype``),
    xi0 for all, controls u_scale * N(0, 1)."""
    rng = np.random.default_rng(seed)
    dq = 0.05 * rng.standard_normal((B, 6))
    q0s = np.asarray(SE3.normalize(jnp.asarray(q0)[None] @ SE3.exp(jnp.asarray(dq))))
    xi0s = np.broadcast_to(xi0, (B, 6)).copy()
    us0 = u_scale * rng.standard_normal((B, H, nu))
    np_dt = np.float32 if dtype == jnp.float32 else np.float64
    return q0s.astype(np_dt), xi0s.astype(np_dt), us0.astype(np_dt)


def solve_both(H, B, ITERS, dtype, fused=True, drone=False, al=False, seed=0):
    """(jax PipelineState, port PipelineState) of the JAX
    `PallasPipelineSolver` (interpret mode) and the port's `PipelineSolver`
    on the same inputs: horizon H, B lanes, ITERS iterations."""
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, dtype, drone=drone)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed, dtype)
    al_arg = None
    if al:
        rng = np.random.default_rng(0)
        np_dt = np.asarray(us0).dtype
        lmbd = np.abs(rng.normal(size=(B, H + 1, 2 * nu))).astype(np_dt)
        imu = np.full((B, H + 1, 2 * nu), 0.5, np_dt)
        al_arg = (np.full(nu, -5.0), np.full(nu, 5.0), lmbd, imu)
    jout = PallasPipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt),
                                interpret=True, gravity=drone, fused=fused
                                ).solve(dp, cp, q0s, xi0s, us0,
                                        al=None if al_arg is None else
                                        tuple(jnp.asarray(a) for a in al_arg))
    tout = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt), gravity=drone,
                          fused=fused).solve(tdp, tcp, torch.as_tensor(q0s),
                                             torch.as_tensor(xi0s),
                                             torch.as_tensor(us0), al=al_arg)
    return jout, tout


def check_solves(jout, tout, dtype):
    """f64: us atol 1e-6, J rtol 1e-7; f32: tests/test_pipeline.py's
    atol 5e-4 / rtol 1e-4 on us and rtol 1e-4 on J."""
    if dtype == jnp.float64:
        us_tol, J_tol = dict(atol=1e-6, rtol=0), dict(rtol=1e-7)
    else:
        us_tol, J_tol = dict(atol=5e-4, rtol=1e-4), dict(rtol=1e-4)
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), **us_tol)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), **J_tol)
    np.testing.assert_allclose(tout.grad_norm.numpy(), np.asarray(jout.grad_norm),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tout.qs.numpy(), np.asarray(jout.qs), atol=1e-5)
    np.testing.assert_allclose(tout.xis.numpy(), np.asarray(jout.xis), atol=1e-4)
    for f in ("qs", "xis", "us", "J_opt", "grad_norm"):
        assert getattr(tout, f).shape == np.shape(getattr(jout, f)), f
