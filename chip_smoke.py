#!/usr/bin/env python3
"""Drive the PyTorch port's four paths once on one NVIDIA GPU and check them.

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
iterations.  The generic fast tier is `solvers/batched.FastBatchSolver` on
any `LieModel`: the screw-200 free body on kernels B1, B13 and B14, the
drone (nu = 4) on screw-200 and the free attitude (so3_track249) on B13,
B = 8192, 12 (30) f32 iterations.  Phases, each printed as one JSON line:

  device        the card (nvidia-smi), torch/CUDA versions, the kernels'
                build time and ptxas registers/spills (B2 f32, B5, B11 f32,
                B13 f32 and B14 f32 must not spill: their carry lives in
                registers);
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
                at B=8192, each with its bound, and B3's yardstick: the sum
                of B4's and B1's times (B3 computes B4's trajectory and B1's
                linearization of it);
  kernels_polish  B5-B9 against their plain versions on the polish's real
                handoff iterate at N=200, B=256, gated per output, B5 also
                with an AL diagonal (B5_al);
  solve_polish  the polish path: counters reset, one solve at B=16384
                (B1 = 1, B2 = B3 = 7, B5 = B6 = B7 = B8 = B9 = 2); lane 0
                against the golden; the kernel polish against the plain
                polish of one handoff on lanes 0..255; one fx_mode='hybrid'
                solve at B=256;
  timing_polish the polish path (median of 5 reps, a new batch each, split
                into f32 phase and polish), its plain polish (one rep), B2
                at B=16384 (the shape at which the polish path's f32 phase
                launches it 7 times) and B5, B6 and B7-B9 against their
                plain versions at B=16384, each with its bound;
  kernels_so3   B10-B12 against their plain versions on a real iterate of
                each SO(3) family at its N, B=256, in f32 and f64;
  solve_so3     for each family: counters reset, one solve at B=8192
                (B10 = 1, B11 = B12 = 30, every other kernel 0); lane 0
                against the family's committed f64 golden, lanes 0..63
                against the plain solve of the same lanes on the host, an
                f64 solve of lanes 0..255 with the golden's iteration count;
  timing_so3    each family (median of 7 reps, a new batch each) and B10-B12
                against their plain versions at B=8192, and B12's yardstick:
                its rollout phase alone plus B10, each by CUDA events (B12
                computes that rollout's trajectory and B10's linearization
                of it);
  kernels_fast  B13 at (nx, nu) = (12, 6), (12, 4), (6, 3) and B14 against
                their plain versions on a real iterate of each fast path,
                B=256, in f32 and f64;
  solve_fast    counters reset before each solve: the free body at B=8192
                (B1 = B13 = B14 = 12, every other kernel 0), lane 0 against
                the screw-200 golden, lanes 0..255 against the port's
                PipelineSolver, lanes 0..63 against the plain solve on the
                host; the drone (B13 = 12) against the plain solve of lanes
                0..63 on the host; the free attitude (B13 = 30) against its
                golden;
                one f64 line-search solve at B=1024 (poses perturbed by
                Exp(0.4 n)) against the plain one of lanes 0..63;
  timing_fast   the free body (median of 7 reps), the drone and the free
                attitude (one rep each), and B13 at each shape and B14
                against their plain versions at B=8192.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each array it reads once, each output
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32) or
34 TFLOP/s (fp64), counted on this run's inputs (`kernel_check.work`).
Then the kernels summary line, one entry for each of B1-B14 (B2's times
at B=8192; launches of B1-B3 from the fused f32 run,
of B4 from the unfused run, of B5-B9 from the polish run, of B10-B12 from
the free-attitude run, of B13 and B14 from the free-body fast run, each
named in "run"),
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
# the plain reference solves on the host take lanes 0..63 of the batch (on
# the host their time grows with the lanes: 64 take ~1/3 of 256's)
HOST_LANES = 64
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
# the generic fast tier: its three paths, and the line search (f64, from
# poses perturbed by Exp(0.4 n), so that short steps get chosen)
FAST_KINDS = ("free_body", "drone", "so3_track249")
LS_BATCH, LS_ITERS, LS_SCALE = 1024, 6, 0.4

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
    "B13": ("generic riccati backward", "csrc/fast.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_riccati.py:104"),
    "B14": ("gap-closing rollout", "csrc/fast.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_rollout.py:42"),
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
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
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
    # the Riccati kernels keep their carry in registers: B2 f32, B5, B13 f32
    # (the group kernels at nx = 12 and the one-thread kernel at (6, 3)) and
    # B11 f32 must not spill, nor B14 f32 (its carry and the stage's
    # carry-independent compositions)
    carry = {k: v for k, v in ptxas.items()
             if "traopt::riccati_kernel<float," in k or "traopt::riccati_mx_kernel<" in k
             or "traopt::fast_riccati_kernel<float," in k
             or "traopt::fast_riccati_thread_kernel<float," in k
             or "traopt::fast_rollout_kernel<float>" in k
             or "traopt::riccati_so3_kernel<float>" in k}
    require(len(carry) == 9 and all(v.get("spill_stores") == 0 and v.get("spill_loads") == 0
                                    for v in carry.values()),
            f"B2 f32 / B5 / B11 f32 / B13 f32 / B14 f32 spill: {carry}")

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
    counters = {**P.KERNELS, **DM.KERNELS, **S.KERNELS, **F.KERNELS}

    def counted(fn):
        for w in counters.values():
            w.launches = 0
        out, sec = timed(fn)
        return out, sec, {k: w.launches for k, w in counters.items()}

    def expect(**launches):
        """Every kernel's launch count: those named, every other kernel 0."""
        return {k: launches.get(k, 0) for k in counters}

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
    require(per_fused == expect(B1=1, B2=ITERS, B3=ITERS),
            f"fused launch counts {per_fused}")
    require(per_unfused == expect(B1=ITERS, B2=ITERS, B4=ITERS),
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
          "B3_ms": per_kernel["B3"]["ms"],
          "B4_plus_B1_ms": per_kernel["B4"]["ms"] + per_kernel["B1"]["ms"],
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
    require(per_polish == expect(B1=1, B2=f32_it, B3=f32_it, B5=POLISH_ITERS,
                                 B6=POLISH_ITERS, B7=POLISH_ITERS, B8=POLISH_ITERS,
                                 B9=POLISH_ITERS),
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
    # B2 at B=16384, the shape at which the polish path's f32 phase launches
    # it, on a real f32 iterate of that batch
    s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, float(dyn.dt)),
                                   *batch(torch.float32, POLISH_BATCH, 400))
    kern, plain = kernel_check.calls(s, dt=fused.dt)["B2"]
    err2 = kernel_check.compare(s, dt=fused.dt)["B2"]
    b2_polish = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                 "max_err": err2["max_rel"], "max_abs_err": err2["max_abs"],
                 "gate": kernel_check.GATES[torch.float32]["B2"],
                 "launches": per_polish["B2"], **bound("B2", s, kern()), "library_ms": None}
    del s
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
          "per_kernel": {f"B2 B={POLISH_BATCH} f32 phase": b2_polish,
                         **{k: per_kernel[k] for k in ("B5", "B6", "B7", "B8", "B9")}},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    require(b2_polish["max_err"] <= b2_polish["gate"],
            f"B2 at B={POLISH_BATCH}: {b2_polish['max_err']}")
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
        # the plain solve of lanes 0..63 runs on the host's copy of them:
        # the plain versions are bound by per-op overhead, which is ~3x
        # the host's on the card (96 s there for the free attitude)
        small = so3[name]["host"] + tuple(x[:HOST_LANES].cpu() for x in args[2:])
        out_p, plain_s = timed(lambda: so3_solver(name, SO3_ITERS, plain=True).solve(*small))
        us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_g).max())
        J_rel = abs(out.J_opt[0].item() - meta_g["J_f64"]) / abs(meta_g["J_f64"])
        us_gate = 10 * meta_g["jax_f32_pipeline"]["lane0_us_max_abs_err"]
        Jp_rel = ((out.J_opt[:HOST_LANES].cpu() - out_p.J_opt).abs()
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
              f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
              f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": sec,
              "f64_iterations": meta_g["iterations_f64"],
              "f64_lane0_us_max_abs_err": us64_err, "f64_gate": 1e-6,
              "f64_all_finite": finite64})
        require(per_so3[name] == expect(B10=1, B11=SO3_ITERS, B12=SO3_ITERS),
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
        # B12's first phase alone: the rollout, without B10 on its trajectory
        fn = S._launch("rollout_so3", s["us"])
        rargs = (s["qR"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"], s["consts"])
        rollout_ms = event_ms(lambda: S._rollout_so3_kernel(*fn, *rargs, linearize=False,
                                                            **kw), 5)
        del s
        so3_kernel[name] = kern_t
        emit({"phase": "timing_so3", "problem": name, "card": card, "B": BATCH,
              "N": so3[name]["N"], "iterations": SO3_ITERS, "rep_s": reps, "median_s": med_s,
              "solves_per_s": BATCH / med_s, "ms_per_iteration": med_s * 1e3 / SO3_ITERS,
              "per_kernel": kern_t, "B12_ms": kern_t["B12"]["ms"],
              "B12_rollout_phase_ms": rollout_ms,
              "B12_rollout_phase_plus_B10_ms": rollout_ms + kern_t["B10"]["ms"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        for k, v in kern_t.items():
            require(v["max_err"] <= v["gate"], f"{k} {name} at B={BATCH}: {v['max_err']}")
    per_kernel.update(so3_kernel[SO3_PROBLEMS[0]])

    # -- kernels_fast: B13 at each (nx, nu) and B14 on a real iterate ----------
    # the generic fast tier: the free body on B1, B13 and B14 (screw-200), the
    # drone (screw-200, nu = 4) and the free attitude (so3_track249) on B13
    fast = {}
    for kind in FAST_KINDS:
        if kind == "so3_track249":
            make = lambda dtype, device: so3_bench.so3_track249_model(dtype, device)
            fbatch, n_k, it_k = so3_bench.so3_batch, so3["so3_track249"]["N"], SO3_ITERS
        else:
            make = lambda dtype, device, kind=kind: al_bench.screw200_model(
                dtype, device, horizon=N, drone=kind == "drone")
            fbatch, n_k, it_k = al_bench.screw_batch, N, ITERS
        fast[kind] = dict(problem={dt: make(dt, dev) for dt in (torch.float32, torch.float64)},
                          host={dt: make(dt, "cpu")[:2] for dt in (torch.float32, torch.float64)},
                          batch=fbatch, N=n_k, iterations=it_k)

    def fast_args(kind, dtype, B, seed, scale=0.05):
        model, params, q0, xi0 = fast[kind]["problem"][dtype]
        q0s, xi0s = fast[kind]["batch"](q0, xi0, B, seed, scale=scale)
        cp = params["cost"]
        return (params, q0s, xi0s, torch.zeros((B, fast[kind]["N"], model.nu), dtype=dtype,
                                               device=dev), cp.q_ref, cp.xi_ref)

    def fast_solver(kind, iterations, dtype=torch.float32, host=False, **kw):
        model, params = (fast[kind]["host"][dtype] if host
                         else fast[kind]["problem"][dtype][:2])
        if kind == "free_body":
            kw = dict(pallas_rollout_dt=float(params["dyn"].dt), use_pallas_linearize=True,
                      **kw)
        return F.FastBatchSolver(model, fast[kind]["N"], iterations, **kw)

    ferr = {}
    for kind in FAST_KINDS:
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            s = kernel_check.fast_inputs(fast_solver(kind, 2, dtype),
                                         *fast_args(kind, dtype, CHECK_BATCH, SEED)[:4])
            e = kernel_check.fast_compare(s)
            torch.cuda.synchronize()
            ferr[f"{kind} {tag}"] = {k: {**v, "gate": kernel_check.GATES["fast"][dtype][k]}
                                     for k, v in e.items()}
    del s
    emit({"phase": "kernels_fast", "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **ferr})
    require(all(set(v) == ({"B13", "B14"} if run.startswith("free_body") else {"B13"})
                for run, v in ferr.items()), "kernels_fast: a kernel was not checked")
    for run, errs in ferr.items():
        for k, v in errs.items():
            require(v["max_rel"] <= v["gate"], f"{k} {run} error {v['max_rel']} > {v['gate']}")

    # -- solve_fast: the generic fast tier, each path ------------------------------
    def host_plain(kind, args, iterations, dtype=torch.float32, **kw):
        """The plain solve of lanes 0..63 on the host's copy of them."""
        small = tuple(x[:HOST_LANES].cpu() for x in args[1:4])
        params = fast[kind]["host"][dtype][1]
        return timed(lambda: fast_solver(kind, iterations, dtype, host=True, plain=True,
                                         **kw).solve(params, *small, params["cost"].q_ref,
                                                     params["cost"].xi_ref))

    def j_rel(a, b):
        return ((a.cpu() - b.cpu()).abs() / b.cpu().abs()).max().item()

    def finite(out):
        return all(torch.isfinite(t).all().item()
                   for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))

    per_fast = {}
    # the free body: the main path of the generic tier
    fargs = fast_args("free_body", torch.float32, BATCH, SEED)
    out, fast_s, per_fast["free_body"] = counted(
        lambda: fast_solver("free_body", ITERS).solve(*fargs))
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_gold).max())
    J_rel = abs(out.J_opt[0].item() - meta["J_f64"]) / abs(meta["J_f64"])
    us_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    dyn, cost = problems[torch.float32][:2]
    pipe = P.PipelineSolver(N, ITERS, float(dyn.dt)).solve(
        dyn, cost, fargs[1][:CHECK_BATCH], fargs[2][:CHECK_BATCH], fargs[3][:CHECK_BATCH])
    Jpipe_rel = j_rel(out.J_opt[:CHECK_BATCH], pipe.J_opt)
    out_p, plain_s = host_plain("free_body", fargs, ITERS)
    Jp_rel = j_rel(out.J_opt[:HOST_LANES], out_p.J_opt)
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "free_body", "B": BATCH, "N": N,
          "iterations": ITERS, "launches": per_fast["free_body"], "all_finite": fin,
          "lane0_J": out.J_opt[0].item(), "golden_J": meta["J_f64"], "lane0_J_rel_err": J_rel,
          "lane0_us_max_abs_err": us0_err, "lane0_us_gate": us_gate,
          "grad_norm_p50": out.grad_norm.median().item(),
          "pipeline_vs_fast_J_rel_err_lanes0_255": Jpipe_rel,
          f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": fast_s})
    require(per_fast["free_body"] == expect(B1=ITERS, B13=ITERS, B14=ITERS),
            f"free-body fast launch counts {per_fast['free_body']}")
    require(fin, "non-finite lanes in the free-body fast solve")
    require(J_rel <= 1e-4, f"fast lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"fast lane-0 us err {us0_err} > {us_gate}")
    require(Jpipe_rel <= 1e-4, f"fast vs pipeline J rel err {Jpipe_rel}")
    require(Jp_rel <= 1e-4, f"fast kernel vs plain J rel err {Jp_rel}")
    del out, pipe, out_p

    # the drone (nu = 4) on B13
    dargs = fast_args("drone", torch.float32, BATCH, SEED)
    out, drone_s, per_fast["drone"] = counted(lambda: fast_solver("drone", ITERS).solve(*dargs))
    out_p, plain_s = host_plain("drone", dargs, ITERS)
    Jp_rel = j_rel(out.J_opt[:HOST_LANES], out_p.J_opt)
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "drone", "B": BATCH, "N": N, "iterations": ITERS,
          "launches": per_fast["drone"], "all_finite": fin, "lane0_J": out.J_opt[0].item(),
          "grad_norm_p50": out.grad_norm.median().item(),
          f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": drone_s})
    require(per_fast["drone"] == expect(B13=ITERS), f"drone launch counts {per_fast['drone']}")
    require(fin, "non-finite lanes in the drone fast solve")
    require(Jp_rel <= 1e-4, f"drone kernel vs plain J rel err {Jp_rel}")
    del out, out_p

    # the free attitude (nx = 6, nu = 3) on B13
    us_g, meta_g = so3["so3_track249"]["gold"]
    sargs = fast_args("so3_track249", torch.float32, BATCH, SEED)
    out, so3f_s, per_fast["so3_track249"] = counted(
        lambda: fast_solver("so3_track249", SO3_ITERS).solve(*sargs))
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_g).max())
    J_rel = abs(out.J_opt[0].item() - meta_g["J_f64"]) / abs(meta_g["J_f64"])
    us_gate = 10 * meta_g["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "so3_track249", "B": BATCH,
          "N": fast["so3_track249"]["N"], "iterations": SO3_ITERS,
          "launches": per_fast["so3_track249"], "all_finite": fin,
          "lane0_J": out.J_opt[0].item(), "golden_J": meta_g["J_f64"],
          "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err, "lane0_us_gate": us_gate,
          "solve_s_first_call": so3f_s})
    require(per_fast["so3_track249"] == expect(B13=SO3_ITERS),
            f"so3_track249 fast launch counts {per_fast['so3_track249']}")
    require(fin, "non-finite lanes in the so3_track249 fast solve")
    require(J_rel <= 1e-4, f"so3_track249 fast lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"so3_track249 fast lane-0 us err {us0_err} > {us_gate}")
    del out

    # the per-lane merit line search, f64, from poses perturbed by Exp(0.4 n)
    largs = fast_args("free_body", torch.float64, LS_BATCH, SEED, scale=LS_SCALE)
    out, ls_s, per_ls = counted(lambda: fast_solver(
        "free_body", LS_ITERS, torch.float64, line_search=True).solve(*largs))
    out_p, ls_plain_s = host_plain("free_body", largs, LS_ITERS, torch.float64,
                                   line_search=True)
    ls_agree = (out.us[:HOST_LANES].cpu() - out_p.us).abs().max().item()
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "line_search", "dtype": "float64", "B": LS_BATCH,
          "N": N, "iterations": LS_ITERS, "pose_perturbation": LS_SCALE,
          "launches": per_ls, "all_finite": fin,
          f"kernel_vs_plain_us_max_abs_lanes0_{HOST_LANES - 1}": ls_agree, "gate": 1e-9,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": ls_plain_s, "solve_s_first_call": ls_s})
    require(per_ls == expect(B1=LS_ITERS, B13=LS_ITERS), f"line-search launch counts {per_ls}")
    require(fin, "non-finite lanes in the line-search solve")
    require(ls_agree <= 1e-9, f"line search kernel vs plain us {ls_agree} > 1e-9")
    del out, out_p

    # -- timing_fast: each path, then B13 at each shape and B14 against plain -----
    solver = fast_solver("free_body", ITERS)
    solver.solve(*fast_args("free_body", torch.float32, BATCH, 700))  # warm-up
    reps = []
    for r in range(TIMING_REPS):
        a = fast_args("free_body", torch.float32, BATCH, 701 + r)
        _, sec = timed(lambda: solver.solve(*a))
        reps.append(sec)
    med_f = statistics.median(reps)
    _, drone_rep = timed(lambda: fast_solver("drone", ITERS).solve(
        *fast_args("drone", torch.float32, BATCH, 710)))
    _, so3_rep = timed(lambda: fast_solver("so3_track249", SO3_ITERS).solve(
        *fast_args("so3_track249", torch.float32, BATCH, 711)))
    fast_kernel = {}
    for kind in FAST_KINDS:
        s = kernel_check.fast_inputs(fast_solver(kind, 2),
                                     *fast_args(kind, torch.float32, BATCH, 720)[:4])
        errs = kernel_check.fast_compare(s)
        for k, (kern, plain) in kernel_check.fast_calls(s).items():
            fast_kernel[f"{k} {kind}"] = {
                "ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                "gate": kernel_check.GATES["fast"][torch.float32][k],
                **bound(k, s, kern()), "library_ms": None}
        del s
    emit({"phase": "timing_fast", "card": card, "B": BATCH, "N": N, "iterations": ITERS,
          "free_body_rep_s": reps, "free_body_median_s": med_f,
          "free_body_solves_per_s": BATCH / med_f,
          "free_body_ms_per_iteration": med_f * 1e3 / ITERS,
          "drone_rep_s": drone_rep, "drone_solves_per_s": BATCH / drone_rep,
          "drone_ms_per_iteration": drone_rep * 1e3 / ITERS,
          "so3_track249_rep_s": so3_rep, "so3_track249_solves_per_s": BATCH / so3_rep,
          "so3_track249_ms_per_iteration": so3_rep * 1e3 / SO3_ITERS,
          "per_kernel": {"B1": {**per_kernel["B1"], "launches": per_fast["free_body"]["B1"],
                                "run": "free_body fast B=8192"}, **fast_kernel},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for k, v in fast_kernel.items():
        require(v["max_err"] <= v["gate"], f"{k} at B={BATCH}: {v['max_err']}")
    per_kernel["B13"] = fast_kernel["B13 free_body"]
    per_kernel["B14"] = fast_kernel["B14 free_body"]

    # launches: B1-B3 from the fused f32 solve, B4 from the unfused one,
    # B5-B9 from the polish solve, B10-B12 from the free-attitude solve (the
    # pendulum's read the same, solve_so3)
    runs = {k: ("fused B=8192", per_fused) for k in ("B1", "B2", "B3")}
    runs["B4"] = ("unfused B=256", per_unfused)
    runs.update({k: (f"polish B={POLISH_BATCH}", per_polish) for k in DM.KERNELS})
    runs.update({k: (f"{SO3_PROBLEMS[0]} B={BATCH}", per_so3[SO3_PROBLEMS[0]])
                 for k in S.KERNELS})
    runs.update({k: (f"free_body fast B={BATCH}", per_fast["free_body"])
                 for k in ("B13", "B14")})
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
