"""Pickle-free problems of the error-state tier and of the one-device sweeps
(counterpart of the problem setup inside the JAX `tasks/run.py`).

The three error-state CLI problems, at their sizes (N = 400, dt = 0.01,
J = diag(0.5, 0.7, 0.9) + I, the anchor the nominal rollout of zero
controls from the identity with a constant twist):

  - ``errstate_generate`` (`run_errstate`): iterated error-state goal
    generation ('generation_nonlinear', re-anchored each taken step) to the
    pose yaw pi/4 at (10, 10, 10), Q = I, P = 1e7 I, R = 1e3 I;
  - ``errstate_tracking`` (`_errstate_circle_reference`,
    `run_errstate_tracking`): tracking of that twist-integrated reference
    from a perturbed error state, nonlinear rollout, Q = I, P = 10 I,
    R = 1e-5 I;
  - ``errstate_generate_linear`` (`run_errstate_linear`): goal generation
    with the LTV rollout about a deviated reference, P = 1e5 I, R = 1e1 I.

Their f64 goldens (`golden/errstate_*`) come from the JAX package's engine
on the CPU (`scripts/gen_torch_port_golden_errorstate.py`).

The sweeps: `run_sweep_task`'s perturbation sweep (`LieILQR` MS, N = 200,
10 iterations at mu = 0, four ranges, 160 solves) on the pickle-free
screw-200 (`al_bench.screw200_model`) in place of the absent
`se3_tracking` pickle, its rollout on kernel B14; and
`run_rollout_sweep_task`'s open-loop rollout sweep (Nsim = 1400, four
ranges, 112 rollouts).  Every function here puts its tensors on ``device``, the
card unless asked for another.
"""

import json
import math
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import errorstate as es
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.batch import BatchSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.errorstate_ilqr import (
    ErrorStateILQR,
    ESConfig,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    GOLDEN_DIR,
    screw200_model,
)

CUDA = torch.device("cuda")
ERRSTATE_TASKS = ("errstate_tracking", "errstate_generate", "errstate_generate_linear")


class ErrstateProblem(NamedTuple):
    """One error-state problem: ``solver.fit(cost_params, params, us0,
    x0=x0)`` solves it; ``X_goal`` is the goal pose of the generation
    problems (None for tracking)."""

    solver: ErrorStateILQR
    cost_params: Any
    params: es.ErrorStateParams
    us0: torch.Tensor
    x0: Optional[torch.Tensor]
    X_goal: Optional[torch.Tensor]


def _inertia(t):
    return t(np.block([[np.diag([0.5, 0.7, 0.9]), np.zeros((3, 3))],
                       [np.zeros((3, 3)), np.eye(3)]]))


def _anchor(J, dt, xi0, N, t):
    """The nominal rollout of zero controls from the identity with the
    constant twist xi0, as the anchor (`reanchor` of blank params)."""
    p0 = es.errorstate_params(J, dt, t(np.zeros((N + 1, 4, 4))), t(np.zeros((N + 1, 6))))
    qs, xis = es.rollout_nominal(p0, t(np.eye(4)), t(xi0), t(np.zeros((N, 6))))
    return es.reanchor(p0, qs, xis)


def _goal(t):
    """Yaw pi/4 at (10, 10, 10)."""
    X = SE3.exp(t(np.array([0.0, 0.0, math.pi / 4, 0.0, 0.0, 0.0]))).clone()
    X[:3, 3] = t(np.array([10.0, 10.0, 10.0]))
    return X


def _generation(mode, w, P, R, dtype, device, N, dt=0.01):
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    J = _inertia(t)
    xi0 = np.concatenate([np.asarray(w) / (N * dt), np.array([11.0, 11.0, 9.0]) / (N * dt)])
    params = _anchor(J, dt, xi0, N, t)
    X_goal = _goal(t)
    Q, Pm, Rm = t(np.eye(6)), t(P * np.eye(6)), t(R * np.eye(6))
    cp = es.goal_cost_params(Q, Rm, Pm, params.q_ref, X_goal)
    cfg = ESConfig(N=N, mode=mode, n_alphas=15, tol_grad_norm=1e-3, max_iterations=100)
    reanchor_cost = None
    if mode == "generation_nonlinear":
        reanchor_cost = lambda c, qs_new: es.goal_cost_params(Q, Rm, Pm, qs_new, X_goal)
    solver = ErrorStateILQR(cfg, es.goal_cost, reanchor_cost=reanchor_cost)
    return ErrstateProblem(solver, cp, params, t(np.zeros((N, 6))), None, X_goal)


def build_errstate_generate(dtype=torch.float64, device=CUDA, N=400):
    """`run_errstate`: 'generation_nonlinear' to the goal pose, Q = I,
    P = 1e7 I, R = 1e3 I, 15 step sizes, at most 100 iterations."""
    return _generation("generation_nonlinear", [math.pi / 4, math.pi / 4, math.pi / 2],
                       1e7, 1e3, dtype, device, N)


def build_errstate_linear(dtype=torch.float64, device=CUDA, N=400):
    """`run_errstate_linear`: 'generation_linear' about a deviated reference
    (the twist 0.1 off in roll and pitch), P = 1e5 I, R = 1e1 I."""
    return _generation("generation_linear",
                       [math.pi / 4 + 0.1, math.pi / 4 - 0.1, math.pi / 2],
                       1e5, 1e1, dtype, device, N)


def build_errstate_tracking(dtype=torch.float64, device=CUDA, N=400, dt=0.01):
    """`run_errstate_tracking` on `_errstate_circle_reference`: 'tracking'
    with the nonlinear rollout, 13 step sizes, at most 50 iterations, from
    the error state [0.05, -0.03, 0.08, 0.2, -0.1, 0.15; xi0 + 0.05]."""
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    J = _inertia(t)
    xi0 = np.concatenate([np.array([math.pi / 4, math.pi / 4, math.pi / 2]) / (N * dt),
                          np.array([10.0, 10.0, 10.0]) / (N * dt)])
    params = _anchor(J, dt, xi0, N, t)
    cp = es.ErrorStateTrackingCostParams(Q=t(np.eye(12)), R=t(1e-5 * np.eye(6)),
                                         P=t(10.0 * np.eye(12)), xi_ref=params.xi_ref)
    cfg = ESConfig(N=N, mode="tracking", rollout="nonlinear", n_alphas=13,
                   tol_grad_norm=1e-3, max_iterations=50)
    x0 = t(np.concatenate([np.array([0.05, -0.03, 0.08, 0.2, -0.1, 0.15]), xi0 + 0.05]))
    return ErrstateProblem(ErrorStateILQR(cfg, es.tracking_cost_es), cp, params,
                           t(np.zeros((N, 6))), x0, None)


PROBLEMS = {"errstate_tracking": build_errstate_tracking,
            "errstate_generate": build_errstate_generate,
            "errstate_generate_linear": build_errstate_linear}


def final_error(prob: ErrstateProblem, state):
    """The CLI task's accuracy number: the norm of Log(X_N^-1 X_goal) for
    the generation problems, of the final pose error psi_N for tracking."""
    if prob.X_goal is None:
        return float(torch.linalg.norm(state.xs[-1][:6]))
    return float(torch.linalg.norm(se3.log(se3.inverse(state.qs[-1]) @ prob.X_goal)))


def load_errstate_golden(name):
    """(us (N, 6) f64 numpy, meta dict) of the committed JAX f64 golden of
    error-state problem ``name`` (a key of `PROBLEMS`)."""
    us = np.load(os.path.join(GOLDEN_DIR, f"{name}_us.npy"))
    with open(os.path.join(GOLDEN_DIR, f"{name}_meta.json")) as f:
        return us, json.load(f)


# -- sweeps ----------------------------------------------------------------------

SWEEP_RANGES = {
    "w_z": np.arange(-1.0, 1.0, 0.05) + 1.0,
    "p_x": np.arange(-8.0, 8.0, 0.4),
    "v_x": np.arange(-4.0, 4.0, 0.2),
    "th_z": np.arange(-30.0, 30.0, 1.5),
}

ROLLOUT_RANGES = {
    "th_z": np.arange(-180.0, 180.0, 10.0),
    "w_z": np.arange(-1.0, 1.0, 0.1) + 1.0,
    "p_z": np.arange(-6.0, 6.0, 0.5),
    "v_x": np.arange(-4.0, 4.0, 0.25),
}


def sweep_config(N=200):
    """`run_sweep_task`'s solver: the se3_tracking MS config (no line
    search, nonlinear rollout, 20 step sizes, defect_kappa 1e-12) with its
    overrides: 10 iterations, no convergence test, the backward at mu = 0."""
    return SolverConfig(N=N, multiple_shooting=True, line_search=False, rollout="nonlinear",
                        n_alphas=20, defect_kappa=1e-12, tol_grad_norm=0.0, tol_d_norm=0.0,
                        max_iterations=10, backward="sequential_fixed")


def build_sweep(dtype=torch.float64, device=CUDA, N=200):
    """The perturbation sweep on screw-200 cut to N stages: returns
    (BatchSolver, params, base_q0, base_xi0); the base state is the
    reference's first node, as the task's.  The solver's nonlinear rollout
    runs as kernel B14."""
    model, params, _, _ = screw200_model(dtype, device, horizon=N)
    solver = LieILQR(model, sweep_config(N), pallas_rollout_dt=float(params["dyn"].dt))
    cp = params["cost"]
    return BatchSolver(solver), params, cp.q_ref[0], cp.xi_ref[0]


def build_rollout_sweep(dtype=torch.float64, device=CUDA):
    """`run_rollout_sweep_task`'s open-loop sweep (ref
    `visualization/rollout_all_compute.py:40-52, 100-101`): returns
    (dyn, dyn params, base_q0, base_xi0, Nsim): the free body with
    J = diag(0.5, 0.7, 0.9) + I, dt = 0.01, Nsim = 1400, from
    p = (1, 1, -1), xi = (0, 0, 1, 0.2, 0, 2)."""
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    dp = dynamics.se3_params(_inertia(t), t(0.01))
    base_q0 = se3.from_rotation_translation(t(np.eye(3)), t(np.array([1.0, 1.0, -1.0])))
    base_xi0 = t(np.array([0.0, 0.0, 1.0, 0.2, 0.0, 2.0]))
    return dynamics.se3_dynamics(), dp, base_q0, base_xi0, 1400
