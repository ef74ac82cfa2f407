"""Builders reconstructing the reference benchmark problems from their pickles
(counterpart of the JAX `tasks/parity.py`).

Each reference benchmark pickle (`visualization/results_benchmark_2nd_draft/`)
stores the complete problem spec in its `prob` dict (writer:
`benchmark_SE3_tracking.py:272-345`).  These builders rebuild the identical
problem on the port's stack so the converged controls can be diffed against
the stored solutions.

Solver options per benchmark script (the JAX module's):
  - SO3 tracking:      tol 1e-8,  50 iters  (benchmark_SO3_tracking.py:84-87)
  - pendulum swing-up: tol 1e-12, 100 iters (benchmark_pendulum_swingup.py:73-76)
  - SE3 tracking:      tol 1e-12, 200 iters (benchmark_SE3_tracking.py:88-91)
  - drone racing:      tol 1e-12, 200 iters (benchmark_drone_racing_tracking.py:81-84)
  all with line_search=False, rollout='nonlinear'; alpha ladders: 13 (SO3
  MS/SS, SE3 SS), 20 (SE3 MS).

The port's `LieILQR` is batch-native: the builders return x0 and us0 with a
problem axis of 1.  The SE(3) free body's solver runs its multiple-shooting
nonlinear rollout on kernel B14 (`LieILQR`'s ``pallas_rollout_dt``; on a
CPU tensor its plain version).  Tensors go to ``device``, the card unless
the caller asks for another.

`RESULTS_DIR` defaults to `tasks/golden/reference/` in this package, where
the reference's own pickles go once they are in the repository (until then
it is empty, and `build_benchmark` names the missing pickle).  It is read
when `build_benchmark` is called, so a caller can point it elsewhere: at
`STANDIN_DIR`, the stand-ins in the reference's schema under
`tasks/golden/standin/` (`scripts/gen_torch_port_standin_pickles.py`).
"""

import dataclasses
import os

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
RESULTS_DIR = os.path.join(_GOLDEN, "reference", "")
STANDIN_DIR = os.path.join(_GOLDEN, "standin")

BENCHMARKS = {
    "se3_tracking": dict(pkl="results_se3_tracking_benchmark.pkl", family="se3",
                         tol=1e-12, iters=200),
    "se3_generate": dict(pkl="results_se3_tracking_generate_benchmark.pkl",
                         family="se3", tol=1e-12, iters=200),
    "se3_drone_path": dict(pkl="results_se3_tracking_drone_benchmark.pkl",
                           family="se3", tol=1e-12, iters=200),
    "drone_racing": dict(pkl="results_drone_racing_tracking_benchmark.pkl",
                         family="drone", tol=1e-12, iters=200),
    "so3_tracking": dict(pkl="results_so3_tracking_benchmark.pkl", family="so3",
                         tol=1e-8, iters=50),
    "pendulum_swingup": dict(pkl="results_pendulum_swingup_benchmark.pkl",
                             family="pendulum3d", tol=1e-12, iters=100),
}


def build_from_prob(prob, family, ms, tol=1e-12, iters=200, dtype=torch.float64,
                    device=torch.device("cuda")):
    """Build (solver, params, x0, us0, solution_key) from a pickle `prob`;
    x0 = (q0 (1, m, m), xi0 (1, d)), us0 (1, N, nu)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)
    q_ref = t(prob["q_ref"])
    N = q_ref.shape[0] - 1
    J, dt = t(prob["J"]), t(float(prob["dt"]))
    kernel_dt = None

    if family == "so3":
        dyn = dynamics.so3_dynamics()
        dp = dynamics.so3_params(J, dt)
        group, nu, sol = SO3, 3, ("ms_so3" if ms else "ss_so3")
    elif family == "pendulum3d":
        dyn = dynamics.pendulum3d_dynamics()
        dp = dynamics.pendulum3d_params(J, float(prob["m"]), float(prob["length"]), dt)
        group, nu, sol = SO3, 3, ("ms_so3" if ms else "ss_so3")
    elif family == "se3":
        dyn = dynamics.se3_dynamics()
        dp = dynamics.se3_params(J, dt)
        group, nu, sol = SE3, 6, ("ms_se3" if ms else "ss_se3")
        kernel_dt = float(prob["dt"])
    elif family == "drone":
        dyn = dynamics.drone_dynamics()
        dp = dynamics.drone_params(J, dt)
        group, nu, sol = SE3, 4, ("ms_se3" if ms else "ss_se3")
    else:
        raise ValueError(family)

    xi_ref = t(np.asarray(prob["xi_ref"]).reshape(N + 1, group.dim))
    cd = costs.tracking_cost(group, nu, ref_so3_terminal_quirk=(group is SO3))
    cp = costs.tracking_cost_params(group, t(prob["Q"]), t(prob["R"]), t(prob["P"]),
                                    q_ref, xi_ref)
    model, params = make_model(dyn, cd, dp, cp)

    cfg = SolverConfig(
        N=N, multiple_shooting=ms, line_search=False, rollout="nonlinear",
        n_alphas=(20 if (group is SE3 and ms) else 13),
        defect_kappa=(1e-12 if group is SE3 else 1e-14),
        tol_grad_norm=tol, tol_d_norm=1e-6, max_iterations=iters,
    )
    solver = LieILQR(model, cfg, pallas_rollout_dt=kernel_dt)
    q0 = t(prob["x0"][0])[None]
    xi0 = t(np.asarray(prob["x0"][1]).reshape(group.dim))[None]
    us0 = torch.zeros((1, N, nu), dtype=dtype, device=device)
    return solver, params, (q0, xi0), us0, sol


def build_benchmark(name, ms, dtype=torch.float64, device=torch.device("cuda")):
    """(data, solver, params, x0, us0, solution_key) of benchmark ``name``
    from its pickle in `RESULTS_DIR` (read now)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import (
        load_benchmark_pickle,
    )

    spec = BENCHMARKS[name]
    path = os.path.join(RESULTS_DIR, spec["pkl"])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"reference pickle {path} is absent; point tasks.parity.RESULTS_DIR at the "
            f"reference's pickles, or at the stand-ins in {STANDIN_DIR}")
    data = load_benchmark_pickle(path)
    out = build_from_prob(data["prob"], spec["family"], ms, tol=spec["tol"],
                          iters=spec["iters"], dtype=dtype, device=device)
    return data, *out


def cut_reference(params, H):
    """Truncate a params dict's cost reference to the first H+1 entries.

    Shared by tests and scripts that cross-check engines on a short
    horizon slice of a benchmark problem.
    """
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    return {**params, "cost": dataclasses.replace(
        cp, q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
        Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))}
