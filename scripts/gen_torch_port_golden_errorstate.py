"""Generate the f64 goldens of the error-state tier's three CLI problems for
the PyTorch port.

The problems are those of the JAX `tasks/run.py` tasks `errstate_tracking`
(`_errstate_circle_reference`, `run_errstate_tracking`),
`errstate_generate` (`run_errstate`) and `errstate_generate_linear`
(`run_errstate_linear`), each built here as the task builds it (N = 400,
dt = 0.01); they need no benchmark pickle.  Each is solved by the JAX
package's `ErrorStateILQR.fit` with the task's config, in f64 on the CPU,
and its final controls, histories and flags are recorded.  The port
rebuilds the same problems (`tasks/errstate_bench.py`) and `chip_smoke.py`
holds its solves on the card against these goldens.

Writes `trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
{name}_us.npy` (N, 6) and `{name}_meta.json` for each name.

Run from the repository root:
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_errorstate.py
"""
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import errorstate as es
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.errorstate_ilqr import (
    ErrorStateILQR,
    ESConfig,
)

N, DT = 400, 0.01
OUT = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch", "tasks", "golden")
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_errorstate.py"


def _inertia():
    return jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])


def _anchor(xi0):
    p0 = es.errorstate_params(_inertia(), DT, jnp.zeros((N + 1, 4, 4)), jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, jnp.eye(4), xi0, jnp.zeros((N, 6)))
    return es.reanchor(p0, qs, xis)


def _goal():
    R_goal = SE3.exp(jnp.array([0.0, 0.0, jnp.pi / 4, 0.0, 0.0, 0.0]))
    return R_goal.at[:3, 3].set(jnp.array([10.0, 10.0, 10.0]))


def generation(mode, w, P, R):
    """`run_errstate` ('generation_nonlinear') and `run_errstate_linear`."""
    xi0 = jnp.concatenate([jnp.array(w) / (N * DT), jnp.array([11.0, 11.0, 9.0]) / (N * DT)])
    params = _anchor(xi0)
    X_goal = _goal()
    Q, Pm, Rm = jnp.eye(6), P * jnp.eye(6), R * jnp.eye(6)
    cp = es.goal_cost_params(Q, Rm, Pm, params.q_ref, X_goal)
    cfg = ESConfig(N=N, mode=mode, n_alphas=15, tol_grad_norm=1e-3, max_iterations=100)
    reanchor = None
    if mode == "generation_nonlinear":
        reanchor = lambda c, qs_new: es.goal_cost_params(Q, Rm, Pm, qs_new, X_goal)
    solver = ErrorStateILQR(cfg, es.goal_cost, reanchor_cost=reanchor)
    state, J_hist, grad_hist, _ = solver.fit(cp, params, jnp.zeros((N, 6)))
    err = se3.log(se3.inverse(state.qs[-1]) @ X_goal)
    return state, J_hist, grad_hist, {"final_goal_err_norm": float(jnp.linalg.norm(err))}


def tracking():
    """`run_errstate_tracking` on `_errstate_circle_reference`."""
    xi0 = jnp.concatenate([jnp.array([jnp.pi / 4, jnp.pi / 4, jnp.pi / 2]) / (N * DT),
                           jnp.array([10.0, 10.0, 10.0]) / (N * DT)])
    params = _anchor(xi0)
    cp = es.ErrorStateTrackingCostParams(Q=jnp.eye(12), R=1e-5 * jnp.eye(6),
                                         P=10.0 * jnp.eye(12), xi_ref=params.xi_ref)
    cfg = ESConfig(N=N, mode="tracking", rollout="nonlinear", n_alphas=13,
                   tol_grad_norm=1e-3, max_iterations=50)
    x_err0 = jnp.concatenate([jnp.array([0.05, -0.03, 0.08, 0.2, -0.1, 0.15]), xi0 + 0.05])
    state, J_hist, grad_hist, _ = ErrorStateILQR(cfg, es.tracking_cost_es).fit(
        cp, params, jnp.zeros((N, 6)), x0=x_err0)
    return state, J_hist, grad_hist, {
        "final_err_norm": float(jnp.linalg.norm(state.xs[-1][:6]))}


PROBLEMS = {
    "errstate_tracking": ("run_errstate_tracking: mode tracking, rollout nonlinear, "
                          "Q = I, P = 10 I, R = 1e-5 I, 13 step sizes", tracking),
    "errstate_generate": ("run_errstate: mode generation_nonlinear, goal yaw pi/4 at "
                          "(10, 10, 10), Q = I, P = 1e7 I, R = 1e3 I, 15 step sizes",
                          lambda: generation("generation_nonlinear",
                                             [jnp.pi / 4, jnp.pi / 4, jnp.pi / 2], 1e7, 1e3)),
    "errstate_generate_linear": ("run_errstate_linear: mode generation_linear, goal yaw "
                                 "pi/4 at (10, 10, 10), Q = I, P = 1e5 I, R = 1e1 I, "
                                 "15 step sizes",
                                 lambda: generation("generation_linear",
                                                    [jnp.pi / 4 + 0.1, jnp.pi / 4 - 0.1,
                                                     jnp.pi / 2], 1e5, 1e1)),
}


def main():
    for name, (what, solve) in PROBLEMS.items():
        t0 = time.perf_counter()
        state, J_hist, grad_hist, extra = solve()
        sec = time.perf_counter() - t0
        us = np.asarray(state.us, dtype=np.float64)
        np.save(os.path.join(OUT, f"{name}_us.npy"), us)
        meta = {"problem": what, "N": N, "dt": DT, "iterations": len(J_hist),
                "converged": bool(state.converged), "failed": bool(state.failed),
                "J_final": J_hist[-1], "grad_final": grad_hist[-1],
                "J_hist": J_hist, "grad_hist": grad_hist, **extra,
                "solver": "JAX ErrorStateILQR.fit, f64, CPU", "cpu_seconds": sec,
                "command": COMMAND}
        with open(os.path.join(OUT, f"{name}_meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        print(name, {k: v for k, v in meta.items() if k not in ("J_hist", "grad_hist")},
              flush=True)


if __name__ == "__main__":
    main()
