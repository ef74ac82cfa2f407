#!/usr/bin/env python3
"""Drive the PyTorch port's three paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

The first two run on the screw-200 problem (the N=200 prefix of the
reference's screw-tracking problem, R = 1e-3 I, no box) for a batch of
perturbed initial poses, lane 0 unperturbed.  The f32 path is the
multiple-shooting iLQR pipeline (`solvers/pipeline.PipelineSolver`, fused
layout), B = 8192, 12 iterations.  The polish path is
`solvers/df_mixed.MixedDFPipelineSolver`: 7 f32 iterations, then 2
mixed-precision polish iterations (fp64 residuals, f32 preconditioner),
B = 16384, the system's gate-passing headline (lane-0 controls within 1e-4
of the f64 golden).  The SO(3) path is `solvers/pipeline_so3.SO3PipelineSolver`
on both SO(3) families (`tasks/so3_bench.py`: free-attitude tracking,
N = 249, and the 3-D pendulum swing-up, N = 80), B = 8192, 30 f32
iterations.  Phases, each printed as one JSON line:

  device        the card (nvidia-smi), torch/CUDA versions, the kernels'
                build time and ptxas registers/spills;
  kernels       B1-B4 against their plain versions on the same real
                iterate, at N=200, B=256 in f32 and f64, gated per output;
                B2 also with an AL diagonal on Quu (B2_al);
  solve_f32     the f32 path: counters reset, one fused solve at B=8192
                (B1 = 1, B2 = B3 = 12 launches); counters reset again, one
                unfused solve at B=256 (B1 = B2 = B4 = 12); lane 0 against
                the committed f64 golden, lanes 0..255 against the plain
                path's solve of the same batch;
  solve_f64     the f32 pipeline's kernels in f64 on lanes 0..255, 20
                iterations, lane 0's controls against the golden;
  timing        the f32 path (median of 7 reps, a new batch each), its
                plain path (one rep) and B1-B4 against their plain versions
                at B=8192, each with its bound;
  kernels_polish  B5-B9 against their plain versions on the polish's real
                handoff iterate at N=200, B=256, gated per output, B5 also
                with an AL diagonal (B5_al);
  solve_polish  the polish path: counters reset, one solve at B=16384
                (B1 = 1, B2 = B3 = 7, B5 = B6 = B7 = B8 = B9 = 2); lane 0
                against the golden; the kernel polish against the plain
                polish of one handoff on lanes 0..255; one fx_mode='hybrid'
                solve at B=256;
  timing_polish the polish path (median of 5 reps, a new batch each, split
                into f32 phase and polish), its plain polish (one rep) and
                B5, B6 and B7-B9 against their plain versions at B=16384;
  kernels_so3   B10-B12 against their plain versions on a real iterate of
                each SO(3) family at its N, B=256, in f32 and f64;
  solve_so3     for each family: counters reset, one solve at B=8192
                (B10 = 1, B11 = B12 = 30, every other kernel 0); lane 0
                against the family's committed f64 golden, lanes 0..255
                against the plain solve of the same lanes on the host, an
                f64 solve of lanes 0..255 with the golden's iteration count;
  timing_so3    each family (median of 7 reps, a new batch each) and B10-B12
                against their plain versions at B=8192.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each array it reads once, each output
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32) or
34 TFLOP/s (fp64), counted on this run's inputs (`kernel_check.work`).
Then the kernels summary line (launches of B1-B3 from the fused f32 run,
of B4 from the unfused run, of B5-B9 from the
polish run, of B10-B12 from the free-attitude run, each named in "run"),
the card's name and power limit as nvidia-smi prints them, and the result
line.  The f32 path is timed before any polish or SO(3) work, after the
same phases as when it was the script's only path, so that its time
compares with the records (an earlier process state moves B2's time by up
to 2%, PERF.md).  Any failed check raises: the script exits non-zero and
prints no result.  Without a CUDA device it exits with status 2 before
doing anything.
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
# the polish path: bench.py's shapes and schedule (and its fallback of a
# full 12-iteration f32 phase if 7 + 2 misses the gate)
POLISH_BATCH = 16384
POLISH_F32_ITERS, POLISH_FALLBACK_F32_ITERS, POLISH_ITERS = 7, 12, 2
POLISH_REPS = 5
POLISH_GATE = 1e-4
# kernel vs plain polish of one handoff: a tenth of the accuracy gate (both
# contract the same start toward the same fixed point; only the f32
# preconditioner's rounding differs)
POLISH_AGREE = 1e-5
# the SO(3) path: both families at B = 8192 and 30 f32 iterations
SO3_ITERS = 30
SO3_PROBLEMS = ("so3_track249", "pendulum_swingup80")

KERNELS = {
    "B1": ("linearize", "csrc/linearize.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_linearize.py:123"),
    "B2": ("riccati backward", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:189"),
    "B3": ("rollout + linearize", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:304"),
    "B4": ("rollout", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:274"),
    "B5": ("mixed riccati backward", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:285"),
    "B6": ("mixed rollout", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:391"),
    "B7": ("mixed defect (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:335"),
    "B8": ("mixed jacobian (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:354"),
    "B9": ("mixed cost quad (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:371"),
    "B10": ("SO(3) linearize", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:152"),
    "B11": ("SO(3) riccati backward", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:181"),
    "B12": ("SO(3) rollout + linearize", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:211"),
}
PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"


T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase line also gets the script's elapsed
    seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
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


def bound(name, s, out):
    """{"bound_ms", "bound_by", "bytes", "ops"} of kernel ``name`` on the
    inputs ``s`` with the outputs ``out`` (`kernel_check.work`)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check

    wk = kernel_check.work(name, s, out)
    ms, by = kernel_check.bound_ms(wk)
    return {"bound_ms": ms, "bound_by": by, "bytes": wk["bytes"],
            "ops": {str(dt).replace("torch.", ""): n for dt, n in wk["ops"].items()}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

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
    for tag in ("f32", "f64"):
        for k, v in kerr[tag].items():
            require(v["max_rel"] <= v["gate"], f"{k} {tag} error {v['max_rel']} > {v['gate']}")

    # -- solve_f32: the main path ----------------------------------------------
    # The counters are reset just before each run and read just after it: the
    # fused solve at B=8192 (the main path: B1, B2, B3) and the solver's
    # unfused layout at B=256 (B1, B2, B4).
    counters = {**P.KERNELS, **DM.KERNELS, **S.KERNELS}

    def counted(fn):
        for w in counters.values():
            w.launches = 0
        out, sec = timed(fn)
        return out, sec, {k: w.launches for k, w in counters.items()}

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
    no_polish = {k: 0 for k in (*DM.KERNELS, *S.KERNELS)}
    require(per_fused == {"B1": 1, "B2": ITERS, "B3": ITERS, "B4": 0, **no_polish},
            f"fused launch counts {per_fused}")
    require(per_unfused == {"B1": ITERS, "B2": ITERS, "B3": 0, "B4": ITERS, **no_polish},
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
                         "gate": kernel_check.GATES[torch.float32][k],
                         **bound(k, s, kern()),
                         "library_ms": None}
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
    del s

    # -- kernels_polish: B5-B9 on the polish's handoff iterate (7 f32
    # iterations), fp64 problem ---------------------------------------------------
    dyn64, cost64 = problems[torch.float64][:2]
    dt64 = float(dyn64.dt)
    pol_check = DM.MixedDFPipelineSolver(N, dt64, POLISH_F32_ITERS, POLISH_ITERS)
    s = kernel_check.polish_inputs(pol_check, *batch(torch.float64, CHECK_BATCH, SEED),
                                   luu_al=True, seed=SEED)
    perr = kernel_check.polish_compare(s, pol_check)
    torch.cuda.synchronize()
    del s
    perr = {k: {**v, "gate": kernel_check.GATES["mixed"][k]} for k, v in perr.items()}
    emit({"phase": "kernels_polish", "N": N, "B": CHECK_BATCH, "metric":
          "max|kernel - plain| / max(1, max|plain|) per output", "mixed": perr})
    for k, v in perr.items():
        for o, e in v["per_output"].items():
            require(e <= v["gate"][o], f"{k} output {o} error {e} > {v['gate'][o]}")

    # -- solve_polish: the polish path --------------------------------------------
    mixed = lambda f32_it, **kw: DM.MixedDFPipelineSolver(N, dt64, f32_it, POLISH_ITERS, **kw)
    pargs = batch(torch.float64, POLISH_BATCH, SEED)
    torch.cuda.reset_peak_memory_stats()
    f32_it = POLISH_F32_ITERS
    mx = mixed(f32_it)
    outp, polish_s, per_polish = counted(lambda: mx.solve(*pargs))
    usp = join_us(outp)
    err0 = float(np.abs(usp[0].cpu().numpy() - us_gold).max())
    fallback = err0 > POLISH_GATE
    if fallback:
        # bench.py's fallback: the full f32 budget
        f32_it = POLISH_FALLBACK_F32_ITERS
        mx = mixed(f32_it)
        outp, polish_s, per_polish = counted(lambda: mx.solve(*pargs))
        usp = join_us(outp)
        err0 = float(np.abs(usp[0].cpu().numpy() - us_gold).max())
    Jp0 = outp.J_opt[0].item()
    Jp_rel = abs(Jp0 - meta["J_f64"]) / abs(meta["J_f64"])
    gn = outp.grad_norm.double()
    finite_p = all(torch.isfinite(t).all().item() for t in
                   (usp, outp.qs, outp.xis, outp.J_opt, outp.grad_norm))
    peak_polish = torch.cuda.max_memory_allocated() / 1e9
    # kernel and plain polish of one handoff (lanes 0..255 of the batch)
    small_p = tuple(x[:CHECK_BATCH] for x in pargs[2:])
    handoff = mx.f32_phase(dyn64, cost64, *small_p)
    kern_small = mx.polish(dyn64, cost64, *handoff)
    plain_small, plain_polish_small_s = timed(
        lambda: mixed(f32_it, plain=True).polish(dyn64, cost64, *handoff))
    agree = (join_us(kern_small) - join_us(plain_small)).abs().max().item()
    agree_J = ((kern_small.J_opt - plain_small.J_opt).abs()
               / plain_small.J_opt.abs()).max().item()
    # fx_mode='hybrid' at B=256
    hyb = mixed(f32_it, fx_mode="hybrid").solve(dyn64, cost64, *small_p)
    hyb_err = float(np.abs(join_us(hyb)[0].cpu().numpy() - us_gold).max())
    emit({"phase": "solve_polish", "B": POLISH_BATCH, "N": N,
          "f32_iterations": f32_it, "polish_iterations": POLISH_ITERS,
          "fx_mode": "df", "fallback_to_12_f32_iterations": fallback,
          "launches": per_polish, "all_finite": finite_p,
          "lane0_us_max_abs_err": err0, "gate": POLISH_GATE,
          "lane0_J": Jp0, "golden_J": meta["J_f64"], "lane0_J_rel_err": Jp_rel,
          "grad_norm_p50": gn.quantile(0.5).item(), "grad_norm_p95": gn.quantile(0.95).item(),
          "grad_norm_max": gn.max().item(),
          "kernel_vs_plain_polish_lanes0_255_us_max_abs": agree,
          "kernel_vs_plain_polish_lanes0_255_J_rel": agree_J,
          "agreement_gate": POLISH_AGREE,
          "plain_polish_lanes0_255_s": plain_polish_small_s,
          "hybrid_B256_lane0_us_max_abs_err": hyb_err,
          "solve_s_first_call": polish_s, "peak_mem_gb": peak_polish})
    require(per_polish == {"B1": 1, "B2": f32_it, "B3": f32_it, "B4": 0,
                           "B5": POLISH_ITERS, "B6": POLISH_ITERS, "B7": POLISH_ITERS,
                           "B8": POLISH_ITERS, "B9": POLISH_ITERS,
                           **{k: 0 for k in S.KERNELS}},
            f"polish launch counts {per_polish}")
    require(finite_p, "non-finite lanes in the polish solve")
    require(err0 <= POLISH_GATE, f"polish lane-0 us err {err0} > {POLISH_GATE}")
    require(Jp_rel <= 1e-4, f"polish lane-0 J rel err {Jp_rel}")
    require(agree <= POLISH_AGREE, f"kernel vs plain polish us {agree} > {POLISH_AGREE}")
    require(agree_J <= 1e-6, f"kernel vs plain polish J rel {agree_J}")
    require(hyb_err <= POLISH_GATE, f"hybrid lane-0 us err {hyb_err} > {POLISH_GATE}")
    del outp, usp, kern_small, plain_small, hyb, handoff

    # the polish path: a new batch each rep, the two phases timed apart
    mx.solve(*batch(torch.float64, POLISH_BATCH, 300))  # warm-up
    f32_reps, pol_reps = [], []
    for r in range(POLISH_REPS):
        a = batch(torch.float64, POLISH_BATCH, 301 + r)
        handoff, t_f32 = timed(lambda: mx.f32_phase(*a))
        _, t_pol = timed(lambda: mx.polish(a[0], a[1], *handoff))
        f32_reps.append(t_f32)
        pol_reps.append(t_pol)
    del handoff
    tot = [x + y for x, y in zip(f32_reps, pol_reps)]
    med_p = statistics.median(tot)
    # B5, B6 and the B7-B9 tail against their plain versions at B=16384
    s = kernel_check.polish_inputs(mx, *batch(torch.float64, POLISH_BATCH, 400))
    perr = kernel_check.polish_compare(s, mx)
    pol_kernel = {}
    for k, (kern, plain) in kernel_check.polish_calls(s, mx).items():
        pol_kernel[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         **bound(k, s, kern()), "library_ms": None}
    hand = tuple(s[n] for n in ("qR", "qp", "xi", "us"))
    del s
    _, plain_polish_s = timed(lambda: mixed(f32_it, plain=True).polish(dyn64, cost64, *hand))
    del hand
    for k in ("B5", "B6", "B7", "B8", "B9"):
        src = pol_kernel["tail" if k in kernel_check.TAIL else k]
        per_kernel[k] = {**src, "max_err": perr[k]["max_rel"], "max_abs_err": perr[k]["max_abs"],
                         "per_output": perr[k]["per_output"]}
    emit({"phase": "timing_polish", "card": card, "B": POLISH_BATCH, "N": N,
          "f32_iterations": f32_it, "polish_iterations": POLISH_ITERS,
          "rep_s": tot, "f32_phase_rep_s": f32_reps, "polish_rep_s": pol_reps,
          "median_s": med_p, "f32_phase_median_ms": statistics.median(f32_reps) * 1e3,
          "polish_median_ms": statistics.median(pol_reps) * 1e3,
          "gate_passing_solves_per_s": POLISH_BATCH / med_p,
          "plain_polish_s": plain_polish_s,
          "per_kernel": {k: per_kernel[k] for k in ("B5", "B6", "B7", "B8", "B9")},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for k in ("B5", "B6", "B7", "B8", "B9"):
        for o, e in per_kernel[k]["per_output"].items():
            gate = kernel_check.GATES["mixed"][k][o]
            require(e <= gate, f"{k} output {o} at B={POLISH_BATCH}: {e} > {gate}")

    # -- kernels_so3: B10-B12 on a real iterate of each family ------------------
    so3 = {}
    for name in SO3_PROBLEMS:
        pendulum, dt_p, n_p = so3_bench.PROBLEMS[name][:3]
        build = (so3_bench.build_pendulum_swingup80 if pendulum
                 else so3_bench.build_so3_track249)
        so3[name] = dict(pendulum=pendulum, dt=dt_p, N=n_p, gold=so3_bench.load_so3_golden(name),
                         problem={dt: build(dt, dev) for dt in (torch.float32, torch.float64)},
                         host=build(torch.float32, "cpu")[:2])

    def so3_batch(name, dtype, B, seed):
        dyn, cost, q0, xi0 = so3[name]["problem"][dtype]
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, so3[name]["N"], 3), dtype=dtype, device=dev)

    def so3_solver(name, iterations, **kw):
        p = so3[name]
        return S.SO3PipelineSolver(p["N"], iterations, p["dt"], pendulum=p["pendulum"], **kw)

    serr = {}
    for name in SO3_PROBLEMS:
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            s = kernel_check.so3_inputs(so3_solver(name, 2), *so3_batch(name, dtype, CHECK_BATCH, SEED))
            e = kernel_check.so3_compare(s, dt=so3[name]["dt"], pendulum=so3[name]["pendulum"])
            torch.cuda.synchronize()
            serr[f"{name} {tag}"] = {k: {**v, "gate": kernel_check.GATES["so3"][dtype][k]}
                                     for k, v in e.items()}
    del s
    emit({"phase": "kernels_so3", "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **serr})
    for run, errs in serr.items():
        for k, v in errs.items():
            require(v["max_rel"] <= v["gate"], f"{k} {run} error {v['max_rel']} > {v['gate']}")

    # -- solve_so3: the SO(3) path, each family ------------------------------------
    per_so3 = {}
    for name in SO3_PROBLEMS:
        us_g, meta_g = so3[name]["gold"]
        args = so3_batch(name, torch.float32, BATCH, SEED)
        out, sec, per_so3[name] = counted(lambda: so3_solver(name, SO3_ITERS).solve(*args))
        # the plain solve of lanes 0..255 runs on the host's copy of them:
        # the plain versions are bound by per-op overhead, which is ~3x
        # the host's on the card (96 s there for the free attitude)
        small = so3[name]["host"] + tuple(x[:CHECK_BATCH].cpu() for x in args[2:])
        out_p, plain_s = timed(lambda: so3_solver(name, SO3_ITERS, plain=True).solve(*small))
        us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_g).max())
        J_rel = abs(out.J_opt[0].item() - meta_g["J_f64"]) / abs(meta_g["J_f64"])
        us_gate = 10 * meta_g["jax_f32_pipeline"]["lane0_us_max_abs_err"]
        Jp_rel = ((out.J_opt[:CHECK_BATCH].cpu() - out_p.J_opt).abs()
                  / out_p.J_opt.abs()).max().item()
        finite = all(torch.isfinite(t).all().item()
                     for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))
        a64 = so3_batch(name, torch.float64, CHECK_BATCH, SEED)
        out64 = so3_solver(name, meta_g["iterations_f64"]).solve(*a64)
        us64_err = float(np.abs(out64.us[0].cpu().numpy() - us_g).max())
        finite64 = bool(torch.isfinite(out64.us).all().item())
        emit({"phase": "solve_so3", "problem": name, "B": BATCH, "N": so3[name]["N"],
              "iterations": SO3_ITERS, "launches": per_so3[name], "all_finite": finite,
              "lane0_J": out.J_opt[0].item(), "golden_J": meta_g["J_f64"],
              "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err,
              "lane0_us_gate": us_gate, "lane0_grad_norm": out.grad_norm[0].item(),
              "grad_norm_p50": out.grad_norm.median().item(),
              "grad_norm_max": out.grad_norm.max().item(),
              "plain_vs_kernel_J_rel_err_lanes0_255": Jp_rel,
              "host_plain_solve_lanes0_255_s": plain_s, "solve_s_first_call": sec,
              "f64_iterations": meta_g["iterations_f64"],
              "f64_lane0_us_max_abs_err": us64_err, "f64_gate": 1e-6,
              "f64_all_finite": finite64})
        others = {k: 0 for k in counters if k not in S.KERNELS}
        require(per_so3[name] == {**others, "B10": 1, "B11": SO3_ITERS, "B12": SO3_ITERS},
                f"{name} launch counts {per_so3[name]}")
        require(finite and finite64, f"non-finite lanes in the {name} solves")
        require(J_rel <= 1e-4, f"{name} lane-0 J rel err {J_rel}")
        require(us0_err <= us_gate, f"{name} lane-0 us err {us0_err} > {us_gate}")
        require(Jp_rel <= 1e-4, f"{name} kernel vs plain J rel err {Jp_rel}")
        require(us64_err <= 1e-6, f"{name} f64 lane-0 us err {us64_err}")
        del out, out_p, out64

    # -- timing_so3: each family, then B10-B12 against their plain versions -----
    so3_kernel = {}
    for name in SO3_PROBLEMS:
        solver = so3_solver(name, SO3_ITERS)
        solver.solve(*so3_batch(name, torch.float32, BATCH, 500))  # warm-up
        reps = []
        for r in range(TIMING_REPS):
            a = so3_batch(name, torch.float32, BATCH, 501 + r)
            _, sec = timed(lambda: solver.solve(*a))
            reps.append(sec)
        med_s = statistics.median(reps)
        s = kernel_check.so3_inputs(so3_solver(name, 2), *so3_batch(name, torch.float32, BATCH, 600))
        kw = dict(dt=so3[name]["dt"], pendulum=so3[name]["pendulum"])
        errs = kernel_check.so3_compare(s, **kw)
        kern_t = {}
        for k, (kern, plain) in kernel_check.so3_calls(s, **kw).items():
            kern_t[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                         "gate": kernel_check.GATES["so3"][torch.float32][k],
                         **bound(k, s, kern()), "library_ms": None}
        del s
        so3_kernel[name] = kern_t
        emit({"phase": "timing_so3", "problem": name, "card": card, "B": BATCH,
              "N": so3[name]["N"], "iterations": SO3_ITERS, "rep_s": reps, "median_s": med_s,
              "solves_per_s": BATCH / med_s, "ms_per_iteration": med_s * 1e3 / SO3_ITERS,
              "per_kernel": kern_t, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        for k, v in kern_t.items():
            require(v["max_err"] <= v["gate"], f"{k} {name} at B={BATCH}: {v['max_err']}")
    per_kernel.update(so3_kernel[SO3_PROBLEMS[0]])

    # launches: B1-B3 from the fused f32 solve, B4 from the unfused one,
    # B5-B9 from the polish solve, B10-B12 from the free-attitude solve (the
    # pendulum's read the same, solve_so3)
    runs = {k: ("fused B=8192", per_fused) for k in ("B1", "B2", "B3")}
    runs["B4"] = ("unfused B=256", per_unfused)
    runs.update({k: (f"polish B={POLISH_BATCH}", per_polish) for k in DM.KERNELS})
    runs.update({k: (f"{SO3_PROBLEMS[0]} B={BATCH}", per_so3[SO3_PROBLEMS[0]])
                 for k in S.KERNELS})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": f"{k} {KERNELS[k][0]}", "route": "cuda",
         "source": f"{PKG}/{KERNELS[k][1]}", "replaces": KERNELS[k][2],
         "launches": runs[k][1][k], "run": runs[k][0],
         **{key: per_kernel[k][key] for key in keys}}
        for k in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
