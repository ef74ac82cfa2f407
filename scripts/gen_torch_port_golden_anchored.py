"""Record the JAX anchored tier's own accuracy on the screw-200 problem, the
reference the PyTorch port's anchored solver is gated against.

The problem is `tasks/al_bench.build_al1400(horizon=200)` with R = 1e-3 I
and no input box (the port's screw-200, whose f64 golden is
`trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
screw200_us.npy`).  Steps (JAX on the CPU, x64):
  1. the JAX `AnchoredFastSolver` in f32 with its Pallas backward in
     interpret mode (`use_pallas=True, interpret=True`), 14 iterations, on
     lane 0 (the unperturbed x0): its control error against the golden,
     its J and gradient norm;
  2. the same solver in f64 on its plain path (`use_pallas=False`), for
     the record.

Writes `trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
screw200_anchored_meta.json`.

Run from the repository root:
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_anchored.py
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

from trajectory_optimization_matrix_lie_groups_tpu.solvers.anchored import (
    AnchoredFastSolver,
    build_anchored,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400

H = 200
R_WEIGHT = 1e-3
ITERATIONS = 14
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_anchored.py"
GOLDEN = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch", "tasks",
                      "golden")


def solve(dtype, use_pallas):
    params, _, _, q0, xi0, q_ref, xi_ref = build_al1400(jnp.float64, H)
    cp, dp = params["cost"], params["dyn"]
    Q = np.block([[np.asarray(cp.Q1), np.zeros((6, 6))], [np.zeros((6, 6)), np.asarray(cp.Q2)]])
    P = np.block([[np.asarray(cp.P1), np.zeros((6, 6))], [np.zeros((6, 6)), np.asarray(cp.P2)]])
    prob = build_anchored(np.asarray(dp.J), float(dp.dt), Q, R_WEIGHT * np.eye(6), P,
                          np.asarray(q_ref), np.asarray(xi_ref), dtype=dtype)
    q0_loc = np.linalg.inv(np.asarray(q_ref[0])) @ np.asarray(q0)
    solver = AnchoredFastSolver(prob, N=H, iterations=ITERATIONS, use_pallas=use_pallas,
                                interpret=True)
    t0 = time.perf_counter()
    _, _, us, J, g = solver.solve(jnp.asarray(q0_loc, dtype)[None],
                                  jnp.asarray(xi0, dtype)[None], jnp.zeros((1, H, 6), dtype))
    return np.asarray(us[0], np.float64), float(J[0]), float(g[0]), time.perf_counter() - t0


def main():
    us_golden = np.load(os.path.join(GOLDEN, "screw200_us.npy"))
    us32, J32, g32, t32 = solve(jnp.float32, True)
    us64, J64, g64, t64 = solve(jnp.float64, False)
    meta = dict(
        problem=("tasks/al_bench.build_al1400(horizon=200) with R = 1e-3 I, no input box "
                 "(screw200_us.npy's problem), anchored representation"),
        H=H, R_weight=R_WEIGHT, iterations=ITERATIONS,
        jax_anchored_f32=dict(
            lane0_us_max_abs_err=float(np.max(np.abs(us32 - us_golden))), J=J32,
            grad_norm=g32, solver="AnchoredFastSolver(use_pallas=True, interpret=True), "
                                  "f32, B=1", cpu_seconds=t32),
        jax_anchored_f64=dict(
            lane0_us_max_abs_err=float(np.max(np.abs(us64 - us_golden))), J=J64,
            grad_norm=g64, solver="AnchoredFastSolver(use_pallas=False), f64, B=1",
            cpu_seconds=t64),
        command=COMMAND,
    )
    with open(os.path.join(GOLDEN, "screw200_anchored_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
