"""Generate stand-in benchmark pickles for the task CLI, and the JAX CLI's
JSON lines of its slow tasks.

19 of the CLI's 25 tasks (`tasks/run.py` of both packages) rebuild their
problem from a reference benchmark pickle through `tasks/parity.
build_benchmark`.  The reference's pickles are not in this repository, so
this script writes four stand-ins in the reference's schema (the JAX
`utils.save_benchmark_pickle`), under the file names of
`parity.BENCHMARKS`, built from the pickle-free problems the port already
has:

  se3_tracking      screw-200 (`tasks/al_bench.build_screw200`, lane 0)
  so3_tracking      so3_track249 (`tasks/so3_bench.py`)
  pendulum_swingup  pendulum_swingup80 (`tasks/so3_bench.py`)
  drone_racing      the drone (`al_bench.screw200_model(drone=True)`'s constants:
                    J, dt, Q, P, gravity, nu = 4, R = 1e-2 I4, N = 200) on a
                    slower helix than the screw's: reference twist
                    `DRONE_TWIST`, x0 a tenth of screw-200's position offset

The drone on screw-200 itself does not converge: the JAX f64 `LieILQR`
(MS, no line search, the parity configuration) oscillates for all 200
iterations (J between 1.9e3 and 6.9e3, gradient norm 0.1-1.5), also from
x0 on the reference: the screw's 2 m/s along body x at 1 rad/s of yaw asks
for a centripetal force the drone's z-thrust can give only by tilting off
the reference.  At `DRONE_TWIST` the MS solve converges (56 iterations).

Each pickle's solutions (`ms_*`, `ss_*`) are the JAX package's f64
`LieILQR` fits with `parity.build_from_prob`'s per-family configuration
(the CLI's `run_benchmark_task`), run on the CPU.  `_meta.json` records
the JAX version, each configuration, and each solve's iterations, flags and
final gradient norm.

Then, with `parity.RESULTS_DIR` pointed at the stand-ins, the JAX CLI
(`tasks.run.main`) runs each task of `SLOW_TASKS` (those that take too long
to run live in the CPU tests) at its CPU sizes, and its JSON line is
written to `jax_cli/{task}.json` beside the pickles.

Run from the repository root (a few minutes on the CPU):
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_standin_pickles.py [--only-cli]
"""
import argparse
import contextlib
import io
import json
import os
import sys
import time
import types

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu.tasks import parity
from trajectory_optimization_matrix_lie_groups_tpu.utils import save_benchmark_pickle
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.trajectories import (
    generate_reference,
)

OUT = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch", "tasks",
                   "golden", "standin")
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_standin_pickles.py"
# the CLI tasks whose JAX run takes over ~30 s on the CPU, too long for a live
# run in the CPU tests
SLOW_TASKS = ("mpc_batch_constrained", "benchmark_compare", "benchmark_compare_so3")
# the drone's stand-in: the screw's shape at a quarter of its forward speed
# and half its yaw rate, from a tenth of screw-200's position offset
DRONE_TWIST = (0.0, 0.0, 0.5, 0.5, 0.0, 0.2)
DRONE_OFFSET = (-0.1, -0.1, -0.02)

cpu = torch.device("cpu")
f64 = torch.float64
n = lambda t: t.numpy().copy()


def weights(cost):
    """(Q, P, R) of a port `TrackingCostParams`: the pose and velocity
    blocks joined back into one matrix."""
    return (n(torch.block_diag(cost.Q1, cost.Q2)), n(torch.block_diag(cost.P1, cost.P2)),
            n(cost.R))


def screw_prob(drone):
    """The screw-200 problem, or the drone's stand-in problem, as a `prob`
    dict."""
    model, params, q0, xi0 = al_bench.screw200_model(f64, cpu, drone=drone)
    dyn, cost = params["dyn"], params["cost"]
    Q, P, R = weights(cost)
    if drone:
        q_ref, xi_ref = generate_reference(torch.eye(4, dtype=f64),
                                           torch.tensor(DRONE_TWIST, dtype=f64),
                                           cost.q_ref.shape[0] - 1, float(dyn.dt))
        cost = types.SimpleNamespace(q_ref=q_ref, xi_ref=xi_ref)
        q0 = q_ref[0].clone()
        q0[:3, 3] = torch.tensor(DRONE_OFFSET, dtype=f64)
        xi0 = xi_ref[0]
    return dict(J=n(dyn.J), dt=float(dyn.dt), q_ref=n(cost.q_ref), xi_ref=n(cost.xi_ref),
                x0=[n(q0), n(xi0)], Q=Q, P=P, R=R)


def so3_prob(name):
    """An SO(3)-family problem of `so3_bench.PROBLEMS` as a `prob` dict."""
    pendulum, dt, N, twist, r = so3_bench.PROBLEMS[name]
    dyn, cost, q0, xi0 = so3_bench._build(name, f64, cpu, None)
    Q, P, R = weights(cost)
    prob = dict(J=n(dyn.J), dt=float(dt), q_ref=n(cost.q_ref), xi_ref=n(cost.xi_ref),
                x0=[n(q0), n(xi0)], Q=Q, P=P, R=R)
    if pendulum:
        prob.update(m=float(dyn.m), length=float(dyn.l), g=float(dyn.g))
    return prob


PROBLEMS = {
    "se3_tracking": ("screw-200 (tasks/al_bench.build_screw200, R = 1e-3 I6)",
                     lambda: screw_prob(False)),
    "so3_tracking": ("so3_track249 (tasks/so3_bench.py)", lambda: so3_prob("so3_track249")),
    "pendulum_swingup": ("pendulum_swingup80 (tasks/so3_bench.py)",
                         lambda: so3_prob("pendulum_swingup80")),
    "drone_racing": ("the drone (tasks/al_bench.screw200_model(drone=True)'s constants, "
                     f"R = 1e-2 I4) on the helix of twist {list(DRONE_TWIST)} from "
                     f"p0 = {list(DRONE_OFFSET)}", lambda: screw_prob(True)),
}


def solve(prob, spec, ms):
    solver, params, x0, us0, key = parity.build_from_prob(
        prob, spec["family"], ms, tol=spec["tol"], iters=spec["iters"])
    t0 = time.perf_counter()
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(params, x0, us0)
    sec = time.perf_counter() - t0
    rec = dict(xs=dict(qs=qs, xis=xis), us=us, J_hist=np.asarray(J_hist),
               grad_hist=np.asarray(grad_hist), defect_hist=np.asarray(defect_hist))
    cfg = solver.cfg
    meta = dict(iterations=len(J_hist), converged=bool(state.converged),
                failed=bool(state.failed),
                J_final=float(J_hist[-1]), grad_norm_final=float(grad_hist[-1]),
                defect_final=float(defect_hist[-1]), tol_grad_norm=cfg.tol_grad_norm,
                cpu_seconds=sec,
                config=dict(N=cfg.N, multiple_shooting=cfg.multiple_shooting,
                            line_search=cfg.line_search, rollout=cfg.rollout,
                            n_alphas=cfg.n_alphas, defect_kappa=cfg.defect_kappa,
                            tol_grad_norm=cfg.tol_grad_norm, tol_d_norm=cfg.tol_d_norm,
                            max_iterations=cfg.max_iterations))
    return key, rec, meta


def pickles():
    os.makedirs(OUT, exist_ok=True)
    meta = dict(command=COMMAND, jax=jax.__version__, numpy=np.__version__,
                benchmarks={})
    for name, (what, build) in PROBLEMS.items():
        spec = parity.BENCHMARKS[name]
        prob = build()
        solvers, m = {}, {}
        for ms in (True, False):
            key, rec, mt = solve(prob, spec, ms)
            solvers[key] = rec
            m[key] = mt
            print(json.dumps({"benchmark": name, "solution": key,
                              **{k: v for k, v in mt.items() if k != "config"}}), flush=True)
        save_benchmark_pickle(os.path.join(OUT, spec["pkl"]), prob, solvers)
        meta["benchmarks"][name] = dict(pkl=spec["pkl"], problem=what, family=spec["family"],
                                        tol=spec["tol"], iters=spec["iters"], solutions=m)
    with open(os.path.join(OUT, "_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def cli_goldens(tasks):
    from trajectory_optimization_matrix_lie_groups_tpu.tasks import run

    parity.RESULTS_DIR = OUT
    gd = os.path.join(OUT, "jax_cli")
    os.makedirs(gd, exist_ok=True)
    for task in tasks:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run.main([task])
        sec = time.perf_counter() - t0
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        with open(os.path.join(gd, f"{task}.json"), "w") as f:
            json.dump(dict(task=task, command=f"{COMMAND} (tasks.run.main([{task!r}]))",
                           jax=jax.__version__, cpu_seconds=sec, line=line), f, indent=1)
            f.write("\n")
        print(json.dumps({"cli": task, "cpu_seconds": sec}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only-cli", action="store_true",
                    help="keep the pickles, rewrite the JAX CLI lines only")
    ap.add_argument("--tasks", nargs="*", default=list(SLOW_TASKS),
                    help="the tasks whose JAX CLI line to write")
    args = ap.parse_args()
    if not args.only_cli:
        pickles()
    cli_goldens(args.tasks)
