#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the f32 multiple-shooting iLQR pipeline
(`solvers/pipeline.PipelineSolver`, fused layout) on the screw-200 problem
(the N=200 prefix of the reference's screw-tracking problem, R = 1e-3 I, no
box) for B = 8192 perturbed initial poses, 12 iterations.  Phases, each
printed as one JSON line:

  device     the card (nvidia-smi), torch/CUDA versions, the kernels' build
             time and ptxas registers/spills;
  kernels    B1-B4 against their plain versions on the same real iterate, at
             N=200, B=256 in f32 and f64, gated per output; B2 also with an
             AL diagonal on Quu (B2_al);
  solve_f32  the main path: counters reset, one fused solve at B=8192
             (B1 = 1, B2 = B3 = 12 launches); counters reset again, one
             unfused solve at B=256 (B1 = B2 = B4 = 12); lane 0 against the
             committed f64 golden, lanes 0..255 against the plain path's
             solve of the same batch;
  solve_f64  the kernel path in f64 on lanes 0..255, 20 iterations, lane 0's
             controls against the golden;
  timing     kernel path (median of 7 reps, a new batch each), plain path
             (one rep), and each kernel against its plain version at B=8192.

Then the kernels summary line (launches of B1-B3 from the fused run, of B4
from the unfused run, each named in "run"), the card's name and power limit as
nvidia-smi prints them, and the result line.  Any failed check raises:
the script exits non-zero and prints no result.  Without a CUDA device it
exits with status 2 before doing anything.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 200
BATCH = 8192
CHECK_BATCH = 256
ITERS = 12
F64_ITERS = 20
TIMING_REPS = 7
SEED = 0

KERNELS = {
    "B1": ("linearize", "csrc/linearize.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_linearize.py:123"),
    "B2": ("riccati backward", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:189"),
    "B3": ("rollout + linearize", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:304"),
    "B4": ("rollout", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:274"),
}
PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn, sync=True):
    """(result, seconds) on the host clock around fn, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    build_s = _build.build()
    ptxas = _build.ptxas_report()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas})

    us_gold, meta = al_bench.load_screw200_golden()
    problems = {dt: al_bench.build_screw200(dt, dev, horizon=N)
                for dt in (torch.float32, torch.float64)}

    def batch(dtype, B, seed):
        dyn, cost, q0, xi0 = problems[dtype]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, N, 6), dtype=dtype, device=dev)

    # -- kernels: each kernel against its plain version -----------------------
    # B2_al is B2 with a positive AL diagonal on Quu (the `al=` solve's path)
    kerr = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        args = batch(dtype, CHECK_BATCH, SEED)
        solver = P.PipelineSolver(N, 2, float(args[0].dt))
        s = kernel_check.kernel_inputs(solver, *args, luu_al=True, seed=SEED)
        errs = kernel_check.compare(s, dt=solver.dt)
        torch.cuda.synchronize()
        kerr[tag] = {k: {**v, "gate": kernel_check.GATES[dtype][k]}
                     for k, v in errs.items()}
    emit({"phase": "kernels", "N": N, "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **kerr})
    for tag, per in kerr.items():
        for k, v in per.items():
            require(v["max_rel"] <= v["gate"], f"{k} {tag} error {v['max_rel']} > {v['gate']}")

    # -- solve_f32: the main path ----------------------------------------------
    # The counters are reset just before each run and read just after it: the
    # fused solve at B=8192 (the main path: B1, B2, B3) and the solver's
    # unfused layout at B=256 (B1, B2, B4).
    def counted(fn):
        for w in P.KERNELS.values():
            w.launches = 0
        out, sec = timed(fn)
        return out, sec, {k: w.launches for k, w in P.KERNELS.items()}

    args = batch(torch.float32, BATCH, SEED)
    dyn = args[0]
    fused = P.PipelineSolver(N, ITERS, float(dyn.dt))
    unfused = P.PipelineSolver(N, ITERS, float(dyn.dt), fused=False)
    out, fused_s, per_fused = counted(lambda: fused.solve(*args))
    small = (args[0], args[1], args[2][:CHECK_BATCH], args[3][:CHECK_BATCH],
             args[4][:CHECK_BATCH])
    out_u, _, per_unfused = counted(lambda: unfused.solve(*small))

    plain_solver = P.PipelineSolver(N, ITERS, float(dyn.dt), plain=True)
    out_p, plain_s = timed(lambda: plain_solver.solve(*args))
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_gold).max())
    J0 = out.J_opt[0].item()
    J_rel = abs(J0 - meta["J_f64"]) / abs(meta["J_f64"])
    us_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    Jp_rel = ((out.J_opt[:CHECK_BATCH] - out_p.J_opt[:CHECK_BATCH]).abs()
              / out_p.J_opt[:CHECK_BATCH].abs()).max().item()
    Ju_rel = ((out.J_opt[:CHECK_BATCH] - out_u.J_opt).abs()
              / out_u.J_opt.abs()).max().item()
    finite = all(torch.isfinite(t).all().item()
                 for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))
    emit({"phase": "solve_f32", "B": BATCH, "N": N, "iterations": ITERS,
          "launches_fused": per_fused, "launches_unfused_B256": per_unfused,
          "all_finite": finite, "lane0_J": J0, "golden_J": meta["J_f64"],
          "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err,
          "lane0_us_gate": us_gate,
          "lane0_grad_norm": out.grad_norm[0].item(),
          "grad_norm_p50": out.grad_norm.median().item(),
          "grad_norm_max": out.grad_norm.max().item(),
          "plain_vs_kernel_J_rel_err_lanes0_255": Jp_rel,
          "unfused_vs_fused_J_rel_err_lanes0_255": Ju_rel,
          "fused_solve_s_first_call": fused_s, "plain_solve_s": plain_s})
    require(per_fused == {"B1": 1, "B2": ITERS, "B3": ITERS, "B4": 0},
            f"fused launch counts {per_fused}")
    require(per_unfused == {"B1": ITERS, "B2": ITERS, "B3": 0, "B4": ITERS},
            f"unfused launch counts {per_unfused}")
    require(finite, "non-finite lanes in the f32 solve")
    require(J_rel <= 1e-4, f"lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"lane-0 us err {us0_err} > {us_gate}")
    require(Jp_rel <= 1e-4, f"kernel vs plain J rel err {Jp_rel}")
    require(Ju_rel <= 1e-4, f"unfused vs fused J rel err {Ju_rel}")
    del out_p, out_u

    # -- solve_f64 --------------------------------------------------------------
    args64 = batch(torch.float64, CHECK_BATCH, SEED)
    out64 = P.PipelineSolver(N, F64_ITERS, float(args64[0].dt)).solve(*args64)
    us64_err = float(np.abs(out64.us[0].cpu().numpy() - us_gold).max())
    emit({"phase": "solve_f64", "B": CHECK_BATCH, "iterations": F64_ITERS,
          "lane0_us_max_abs_err": us64_err, "gate": 1e-6,
          "lane0_J": out64.J_opt[0].item(), "lane0_grad_norm": out64.grad_norm[0].item(),
          "all_finite": bool(torch.isfinite(out64.us).all().item())})
    require(us64_err <= 1e-6, f"f64 lane-0 us err {us64_err}")
    del out64

    # -- timing -----------------------------------------------------------------
    fused.solve(*batch(torch.float32, BATCH, 100))  # warm-up
    reps = []
    for r in range(TIMING_REPS):
        a = batch(torch.float32, BATCH, 101 + r)
        torch.cuda.synchronize()
        _, sec = timed(lambda: fused.solve(*a))
        reps.append(sec)
    med = statistics.median(reps)

    # each kernel against its plain version at the main path's shapes
    s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, float(dyn.dt)),
                                   *batch(torch.float32, BATCH, 200))
    errs = kernel_check.compare(s, dt=fused.dt)
    per_kernel = {}
    for k, (kern, plain) in kernel_check.calls(s, dt=fused.dt).items():
        per_kernel[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                         "gate": kernel_check.GATES[torch.float32][k]}
    emit({"phase": "timing", "card": card, "B": BATCH, "N": N, "iterations": ITERS,
          "kernel_path_rep_s": reps, "kernel_path_median_s": med,
          "kernel_path_solves_per_s": BATCH / med,
          "kernel_path_ms_per_iteration": med * 1e3 / ITERS,
          "plain_path_B": BATCH, "plain_path_s": plain_s,
          "plain_path_solves_per_s": BATCH / plain_s,
          "plain_path_ms_per_iteration": plain_s * 1e3 / ITERS,
          "per_kernel": per_kernel,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for k, v in per_kernel.items():
        require(v["max_err"] <= v["gate"], f"{k} at B={BATCH}: {v['max_err']}")

    # launches: B1-B3 from the fused main-path solve, B4 from the unfused one
    runs = {k: ("fused B=8192", per_fused) for k in ("B1", "B2", "B3")}
    runs["B4"] = ("unfused B=256", per_unfused)
    emit({"kernels": [
        {"name": f"{k} {KERNELS[k][0]}", "route": "cuda",
         "source": f"{PKG}/{KERNELS[k][1]}", "replaces": KERNELS[k][2],
         "launches": runs[k][1][k], "run": runs[k][0],
         "max_abs_err": per_kernel[k]["max_abs_err"],
         "ms": per_kernel[k]["ms"], "plain_ms": per_kernel[k]["plain_ms"]}
        for k in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
