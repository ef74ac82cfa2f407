"""Generate the f64 golden for the screw-200 problem of the PyTorch port.

The problem is the N=200 prefix of the reference's screw-tracking problem
(`tasks/al_bench.build_al1400(horizon=200)`) with R = 1e-3 I in place of its
R = 0 (the pipeline's Cholesky needs Quu > 0) and no input box.  It needs no
benchmark pickle, so the port's tests and `chip_smoke.py` can build it
anywhere.

Steps (JAX on the CPU, x64):
  1. solve lane 0 (the unperturbed x0) with the XLA f64 engine
     (`FastBatchSolver(use_pallas=False)`), one jitted iteration at a time,
     until the gradient norm falls below 1e-10, then two more iterations;
  2. run the JAX f32 pipeline (`PallasPipelineSolver(interpret=True)`) on the
     same problem for 12 iterations and record its lane-0 control error
     against step 1 (the f32 error the port's f32 solve is gated against).

Writes `trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
screw200_us.npy` (N, 6) and `screw200_meta.json`.

Run from the repository root:
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden.py
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

from trajectory_optimization_matrix_lie_groups_tpu.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import (
    build_al1400,
)

H = 200
R_WEIGHT = 1e-3
GRAD_TOL = 1e-10
MAX_ITERS = 60
F32_ITERS = 12
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden.py"


def main():
    params, _, _, q0, xi0, q_ref, xi_ref = build_al1400(jnp.float64, H)
    cp = params["cost"]._replace(R=R_WEIGHT * jnp.eye(6, dtype=jnp.float64))
    dp = params["dyn"]
    model, mp = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6),
                           dp, cp)

    # 1. f64 golden: one jitted MS-iLQR iteration at a time, x0 + ref tail
    fast = FastBatchSolver(model, N=H, iterations=1, use_pallas=False)
    step = jax.jit(fast._iteration)
    qs = jnp.concatenate([q0[None, None], q_ref[None, 1:]], axis=1)
    xis = jnp.concatenate([xi0[None, None], xi_ref[None, 1:]], axis=1)
    us = jnp.zeros((1, H, 6), jnp.float64)
    hist = []
    extra = None
    for it in range(1, MAX_ITERS + 1):
        qs, xis, us, J, g = step(mp, qs, xis, us)
        hist.append((float(J[0]), float(g[0])))
        if extra is None and hist[-1][1] < GRAD_TOL:
            extra = it + 2
        if extra is not None and it >= extra:
            break
    n_iters = len(hist)
    J64, g64 = hist[-1]
    assert g64 < GRAD_TOL, hist
    us_golden = np.asarray(us[0], np.float64)
    first_below = next(i + 1 for i, (_, g) in enumerate(hist) if g < GRAD_TOL)

    # 2. the JAX f32 pipeline's own lane-0 error at the bench's budget
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
    dp32, cp32 = to32(dp), to32(cp)
    pipe = PallasPipelineSolver(N=H, iterations=F32_ITERS, dt=float(dp.dt),
                                interpret=True)
    t0 = time.perf_counter()
    out = pipe.solve(dp32, cp32, jnp.asarray(q0, jnp.float32)[None],
                     jnp.asarray(xi0, jnp.float32)[None],
                     jnp.zeros((1, H, 6), jnp.float32))
    us32 = np.asarray(out.us[0], np.float64)
    t32 = time.perf_counter() - t0
    err32 = float(np.max(np.abs(us32 - us_golden)))

    meta = dict(
        problem=("tasks/al_bench.build_al1400(horizon=200) with R = 1e-3 I, "
                 "no input box"),
        H=H, R_weight=R_WEIGHT,
        J_f64=J64, grad_norm_f64=g64,
        iterations_f64=n_iters, first_iteration_below_tol=first_below,
        grad_tol=GRAD_TOL,
        J_hist_f64=[j for j, _ in hist], grad_hist_f64=[g for _, g in hist],
        q0=np.asarray(q0).tolist(), xi0=np.asarray(xi0).tolist(),
        jax_f32_pipeline=dict(
            iterations=F32_ITERS, lane0_us_max_abs_err=err32,
            J=float(out.J_opt[0]), grad_norm=float(out.grad_norm[0]),
            solver="PallasPipelineSolver(interpret=True), f32, B=1",
            cpu_seconds=t32),
        command=COMMAND,
    )
    gd = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch",
                      "tasks", "golden")
    os.makedirs(gd, exist_ok=True)
    np.save(os.path.join(gd, "screw200_us.npy"), us_golden)
    with open(os.path.join(gd, "screw200_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in meta.items()
                      if k not in ("J_hist_f64", "grad_hist_f64")}))


if __name__ == "__main__":
    main()
