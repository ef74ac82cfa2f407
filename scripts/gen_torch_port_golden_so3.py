"""Generate the f64 goldens of the PyTorch port's SO(3)-family problems.

The problems are `tasks/so3_bench.py`'s ``so3_track249`` (free attitude,
N = 249) and ``pendulum_swingup80`` (3-D pendulum swing-up, N = 80): the
port builds them in f64 on the CPU, and this script hands their numbers to
the JAX package as numpy arrays, so both solve the same problem.  They need
no benchmark pickle.

Steps for each problem (JAX on the CPU, x64):
  1. solve lane 0 (x0 at rest at the identity) with the XLA f64 engine
     (`FastBatchSolver(use_pallas=False)`), one jitted iteration at a time,
     until the gradient norm falls below 1e-10, then two more iterations;
  2. run the JAX f32 pipeline (`SO3PipelineSolver(interpret=True)`) on the
     same problem for 30 iterations and record its lane-0 control error
     against step 1 (the f32 error the port's f32 solve is gated against).

Writes `trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
{name}_us.npy` (N, 3) and `{name}_meta.json`.

Run from the repository root:
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_so3.py
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
import torch

from trajectory_optimization_matrix_lie_groups_tpu.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SO3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline_so3 import (
    SO3PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench

GRAD_TOL = 1e-10
MAX_ITERS = 100
F32_ITERS = 30
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_so3.py"


def jax_problem(name):
    """The JAX (dyn params, cost params, model, q0, xi0) of ``name``, f64,
    from the port's f64 build of it."""
    pendulum, dt, N, twist, r = so3_bench.PROBLEMS[name]
    build = (so3_bench.build_pendulum_swingup80 if pendulum
             else so3_bench.build_so3_track249)
    tdyn, tcost, q0, xi0 = build(torch.float64, device="cpu")
    J = jnp.asarray(tdyn.J.numpy())
    dp = (dynamics.pendulum3d_params(J, 1.0, 0.5, dt) if pendulum
          else dynamics.so3_params(J, dt))
    Q = jnp.diag(jnp.asarray([10.0] * 3 + [1.0] * 3))
    cp = costs.tracking_cost_params(SO3, Q, r * jnp.eye(3), 10.0 * Q,
                                    tcost.q_ref.numpy(), tcost.xi_ref.numpy())
    dyn_def = (dynamics.pendulum3d_dynamics() if pendulum
               else dynamics.so3_dynamics())
    model, mp = make_model(dyn_def, costs.tracking_cost(
        SO3, 3, ref_so3_terminal_quirk=True), dp, cp)
    return dp, cp, model, mp, jnp.asarray(q0.numpy()), jnp.asarray(xi0.numpy())


def golden(name):
    pendulum, dt, N, twist, r = so3_bench.PROBLEMS[name]
    dp, cp, model, mp, q0, xi0 = jax_problem(name)

    # 1. f64 golden: one jitted MS-iLQR iteration at a time, x0 + ref tail
    step = jax.jit(FastBatchSolver(model, N=N, iterations=1,
                                   use_pallas=False)._iteration)
    qs = jnp.concatenate([q0[None, None], cp.q_ref[None, 1:]], axis=1)
    xis = jnp.concatenate([xi0[None, None], cp.xi_ref[None, 1:]], axis=1)
    us = jnp.zeros((1, N, 3), jnp.float64)
    hist = []
    extra = None
    for it in range(1, MAX_ITERS + 1):
        qs, xis, us, J, g = step(mp, qs, xis, us)
        hist.append((float(J[0]), float(g[0])))
        if extra is None and hist[-1][1] < GRAD_TOL:
            extra = it + 2
        if extra is not None and it >= extra:
            break
    J64, g64 = hist[-1]
    assert g64 < GRAD_TOL, hist
    us_golden = np.asarray(us[0], np.float64)
    first_below = next(i + 1 for i, (_, g) in enumerate(hist) if g < GRAD_TOL)

    # 2. the JAX f32 pipeline's own lane-0 error at the port's budget
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
    pipe = SO3PipelineSolver(N=N, iterations=F32_ITERS, dt=dt,
                             pendulum=pendulum, interpret=True)
    t0 = time.perf_counter()
    out = pipe.solve(to32(dp), to32(cp), jnp.asarray(q0, jnp.float32)[None],
                     jnp.asarray(xi0, jnp.float32)[None],
                     jnp.zeros((1, N, 3), jnp.float32))
    us32 = np.asarray(out.us[0], np.float64)
    t32 = time.perf_counter() - t0

    meta = dict(
        problem=f"tasks/so3_bench.py {name}: pendulum={pendulum}, dt={dt}, "
                f"N={N}, reference twist {list(twist)}, R = {r} I3, "
                "Q = diag(10 I3, I3), P = 10 Q, terminal quirk",
        N=N, dt=dt, pendulum=pendulum,
        J_f64=J64, grad_norm_f64=g64,
        iterations_f64=len(hist), first_iteration_below_tol=first_below,
        grad_tol=GRAD_TOL, max_abs_u=float(np.abs(us_golden).max()),
        J_hist_f64=[j for j, _ in hist], grad_hist_f64=[g for _, g in hist],
        jax_f32_pipeline=dict(
            iterations=F32_ITERS,
            lane0_us_max_abs_err=float(np.max(np.abs(us32 - us_golden))),
            J=float(out.J_opt[0]), grad_norm=float(out.grad_norm[0]),
            solver="SO3PipelineSolver(interpret=True), f32, B=1",
            cpu_seconds=t32),
        command=COMMAND,
    )
    gd = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch",
                      "tasks", "golden")
    os.makedirs(gd, exist_ok=True)
    np.save(os.path.join(gd, f"{name}_us.npy"), us_golden)
    with open(os.path.join(gd, f"{name}_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in meta.items()
                      if k not in ("J_hist_f64", "grad_hist_f64")}))


if __name__ == "__main__":
    for problem in so3_bench.PROBLEMS:
        golden(problem)
