#!/usr/bin/env python3
"""Where the time of one fused f32 solve goes on the card: torch.profiler
over the PyTorch port's main path (screw-200, B=8192, 12 iterations), device
time by kernel, the device's busy and idle share of the wall time.

    python3 scripts/profile_torch_pipeline.py [--batch 8192] [--trace PATH]

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

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (  # noqa: E402
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (  # noqa: E402
    build_screw200,
    screw_batch,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_pipeline: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dyn, cost, q0, xi0 = build_screw200(torch.float32, dev)
    solver = PipelineSolver(200, args.iterations, float(dyn.dt))

    def inputs(seed):
        q0s, xi0s = screw_batch(q0, xi0, args.batch, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((args.batch, 200, 6), device=dev)

    solver.solve(*inputs(0))  # build, load, warm up
    a = inputs(1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.solve(*a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        "card": card, "batch": args.batch, "iterations": args.iterations,
        "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms else None,
        "kernels": [{"name": k[:90], "count": c, "device_ms": ms,
                     "share_of_busy": ms / busy_ms} for k, c, ms in rows[:25]],
    }))


if __name__ == "__main__":
    main()
