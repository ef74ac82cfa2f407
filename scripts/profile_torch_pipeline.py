#!/usr/bin/env python3
"""Where the time of one solve goes on the card: torch.profiler over one of
the PyTorch port's paths, device time by kernel, the device's busy and idle
share of the wall time.  On screw-200: ``--path f32``, the fused f32
pipeline (B=8192, 12 iterations); ``--path polish``, the f32 pipeline and
the mixed-precision polish (B=16384, 7 + 2 iterations), with the wall time
of each phase.  ``--path so3_track249`` or ``pendulum_swingup80``: the SO(3)
pipeline on that problem (`tasks/so3_bench.py`; B=8192, 30 f32 iterations).
``--path fast``: the generic fast tier on screw-200, the free body through
`solvers/batched.FastBatchSolver` on kernels B1, B13 and B14 (B=8192, 12
iterations).  ``--path al_fast``: one inner solve of `ALFastSolver`, the
fast tier on the augmented-Lagrangian cost (the first 200 stages of the
N=1400 AL problem, box +-10, its initial multipliers; B13 and B14, the
linearization batch-first; B=8192, 3 iterations).

    python3 scripts/profile_torch_pipeline.py [--path f32|polish|fast|al_fast|so3_track249|pendulum_swingup80]
        [--batch B] [--iterations I] [--trace PATH]

Prints one JSON line; ``--trace`` also writes the Chrome trace.  Needs a
CUDA device and the toolkit (the kernels are built at first use).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (  # noqa: E402
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_mixed import (  # noqa: E402
    MixedDFPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (  # noqa: E402
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline_so3 import (  # noqa: E402
    SO3PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import (  # noqa: E402
    constraints,
    costs,
    dynamics,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (  # noqa: E402
    build_al1400,
    build_screw200,
    screw200_model,
    screw_batch,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("f32", "polish", "fast", "al_fast", *so3_bench.PROBLEMS),
                    default="f32")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8192 (f32), 16384 (polish)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="f32 iterations: default 12 (f32), 7 (polish), 30 (SO(3))")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_pipeline: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    polish = args.path == "polish"
    so3 = args.path in so3_bench.PROBLEMS
    B = args.batch or (16384 if polish else 8192)
    iters = args.iterations or (7 if polish else 30 if so3 else
                                3 if args.path == "al_fast" else 12)
    dtype = torch.float64 if polish else torch.float32
    if so3:
        pendulum, dt, N = so3_bench.PROBLEMS[args.path][:3]
        build = (so3_bench.build_pendulum_swingup80 if pendulum
                 else so3_bench.build_so3_track249)
        dyn, cost, q0, xi0 = build(dtype, dev)
        solver = SO3PipelineSolver(N, iters, dt, pendulum=pendulum)
        batch, nu = so3_bench.so3_batch, 3
    else:
        N, nu, batch = 200, 6, screw_batch
        dyn, cost, q0, xi0 = build_screw200(dtype, dev)
        if polish:
            solver = MixedDFPipelineSolver(N, float(dyn.dt), iters, 2)
        elif args.path == "fast":
            model, params, _, _ = screw200_model(dtype, dev)
            solver = FastBatchSolver(model, N, iters, pallas_rollout_dt=float(dyn.dt),
                                     use_pallas_linearize=True)
        elif args.path == "al_fast":
            p, lb, ub, q0, xi0 = build_al1400(dtype, N, dev)[:5]
            dyn, cost = p["dyn"], p["cost"]
            box = constraints.input_box(12, 6)
            model, _ = make_model(dynamics.se3_dynamics(),
                                  costs.al_cost(costs.tracking_cost(SE3, 6), box), dyn, None)
            bounds = constraints.input_box_params(torch.tensor(lb, dtype=dtype, device=dev),
                                                  torch.tensor(ub, dtype=dtype, device=dev), 6)
            params = {"dyn": dyn, "cost": costs.al_init_params(cost, bounds, N, 12,
                                                               dtype=dtype)}
            solver = FastBatchSolver(model, N, iters, pallas_rollout_dt=float(dyn.dt))
        else:
            solver = PipelineSolver(N, iters, float(dyn.dt))

    def inputs(seed):
        q0s, xi0s = batch(q0, xi0, B, seed)
        us0 = torch.zeros((B, N, nu), dtype=dtype, device=dev)
        if args.path in ("fast", "al_fast"):
            return params, q0s, xi0s, us0, cost.q_ref, cost.xi_ref
        return dyn, cost, q0s, xi0s, us0

    solver.solve(*inputs(0))  # build, load, warm up
    a = inputs(1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    phases = {}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if polish:
            handoff = solver.f32_phase(*a)
            torch.cuda.synchronize()
            phases["f32_phase_ms"] = (time.perf_counter() - t0) * 1e3
            solver.polish(a[0], a[1], *handoff)
        else:
            solver.solve(*a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if polish:
        phases["polish_ms"] = wall * 1e3 - phases["f32_phase_ms"]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    # device-side events only (kernels, memcpy/memset): the CPU ops that
    # launch them carry the same time again
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "path": args.path, "batch": B, "f32_iterations": iters,
        "wall_ms": wall * 1e3, **phases, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms else None,
        "kernels": [{"name": k[:90], "count": c, "device_ms": ms,
                     "share_of_busy": ms / busy_ms} for k, c, ms in rows[:25]],
    }))


if __name__ == "__main__":
    main()
