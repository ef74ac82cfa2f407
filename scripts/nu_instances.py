#!/usr/bin/env python3
"""B1-B6's runtime-nu instances (`csrc/nu.cuh`) against their tuned twins
(nu = 6 and 4), and their large-nu instances (`csrc/nu_large.cuh`) against
the runtime-nu ones at nu = 12, on one card.  Prints one JSON line.

    python3 scripts/nu_instances.py [--root DIR] [--large12]

``--root``: the checkout whose package is measured (default: the one this
script lies in).  Three measurements, ~3 minutes with the build
(``--large12``: the third alone, ~1 minute):

gvec   B5's Q_u (gvec) from the tuned instance and from the runtime-nu one
       (called through its C entry, which takes nu = 4 and 6 too), each
       against the plain version, and the two against each other, on the
       same fp64 iterates: the handoff of `MixedDFPipelineSolver`'s f32
       phase after 2 and after 7 iterations, N = 200, B = 1024, on the
       rigid body driven through the first 4 or 6 thrusters of
       `al_bench.rcs12_pu` (under-actuated) or the first 4 or 6 columns of
       I6; the runtime-nu instance alone on the first 1, 5 and 8
       thrusters.  Error: max|a - b| / max(1, max|b|) (`kernel_check.rel_err`).
pad    screw200_torques3 (nu = 3) on the runtime-nu instances against the
       same problem padded to nu = 6 (Pu = [I3 0; 0 0], R = 1e-2 I6: the
       three added inputs act on nothing, cost only, and stay exactly 0)
       on the tuned instances: the f32 path (`PipelineSolver`, B = 8192,
       12 iterations, median of 5 after a warm-up), the polish
       (`MixedDFPipelineSolver`, B = 16384, the golden's schedule, median
       of 3) and the refiner (`DFPipelineSolver`, B = 16384, the golden's
       schedule, median of 3), a new batch each rep, in turns native,
       padded, padded, native; lane 0 of each against the golden, and the
       padded inputs' largest |u|.
large12  at nu = 12 (`al_bench.rcs12_pu`), N = 200, B = 1024 and 16384, the
       large-nu instances of B2 (f32, fp64), B5, B4 (f32, fp64) and B6,
       launched through their direct C entries (`riccati_large`,
       `rollout_large`), against the runtime-nu instances that the
       wrappers launch there (B2, B5, B6: the instances of maximum 12; B4:
       the same large-nu rollout, after `g_kernel`'s pass at B = 1024): ms
       by CUDA events (mean of 5 after a
       warm-up call), in turns nu, large, large, nu, on a real iterate (two
       f32 iterations; the polish's after 12 and one polish iteration),
       and the largest error of each output of the large-nu call against
       the runtime-nu one.  Routing at nu <= 12 does not depend on it.
g_pass   (``--g-pass``: this measurement alone, ~1 minute) the rollout at
       nu <= 12 with `g_kernel`'s pass before it and without (the direct
       entries `rollout_nu_pass`, `rollout_nu_no_pass`), B3 and B4 on
       screw200_torques3 (nu = 3) and screw200_rcs12 (nu = 12), f32 and
       fp64, N = 200, at B = G_PASS_BATCHES (the paths' 8192 and 16384
       among them): ms by CUDA events (mean of 5 after a warm-up call), in
       turns pass, none, none, pass, on a real iterate (two f32
       iterations), the largest error of the two calls' outputs against
       each other, and the instance that the wrappers' entry takes there
       (`pipeline.rollout_nu_instances`); the threshold of
       `rollout_nu_g` is set where the two cross.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N, B_GVEC, B_F32, B_POLISH, ITERS, SEED = 200, 1024, 8192, 16384, 12, 0
LARGE12_BATCHES, LARGE12_REPS = (1024, 16384), 5
G_PASS_BATCHES = (2048, 4096, 8192, 12288, 16384)
GVEC_ITERS = (2, 7)
F32_REPS, POLISH_REPS = 5, 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--large12", action="store_true", help="the large12 measurement alone")
    ap.add_argument("--g-pass", action="store_true", help="the g_pass measurement alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("nu_instances: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    dev = torch.device("cuda", 0)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "build_s": _build.build()}
    if args.g_pass:
        out["g_pass"] = g_pass_rows(dev)
        print(json.dumps(out), flush=True)
        return
    if not args.large12:
        out["gvec"] = gvec_rows(dev)
        out["pad"] = pad_rates(dev)
    out["large12"] = large12_rows(dev)
    print(json.dumps(out), flush=True)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def gvec_rows(dev):
    """{case: {iterations: errors}} of the ``gvec`` measurement."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
    from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
        polish_inputs,
        rel_err,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    eye, rcs = np.eye(6), al_bench.rcs12_pu()
    cases = {"rcs4": rcs[:, :4], "rcs6": rcs[:, :6], "id4": eye[:, :4], "id6": eye,
             "rcs1": rcs[:, :1], "rcs5": rcs[:, :5], "rcs8": rcs[:, :8]}
    tuned = _build.function("polish", "riccati", "mx", DM._RICCATI_ARGS)
    nu_fn = _build.function("polish_nu", "riccati_nu", "mx", DM._RICCATI_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for name, pu in cases.items():
        nu = pu.shape[1]
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, torch.float64, dev)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B_GVEC, SEED)
        us0 = torch.zeros((B_GVEC, N, nu), dtype=torch.float64, device=dev)
        rows[name] = {}
        for its in GVEC_ITERS:
            mx = DM.MixedDFPipelineSolver(N, float(dyn.dt), its, 1, gravity=True,
                                          exact_gravity_jacobian=True)
            s = polish_inputs(mx, dyn, cost, q0s, xi0s, us0)
            bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
            plain = DM.backward_mx_plain(*bargs, glow=True)[2]
            g_nu = DM._backward_mx_kernel(nu_fn, stream, *bargs, glow=True, luu_al=None)[2]
            r = {"nu_vs_plain": rel_err(g_nu, plain), "max_abs_gvec": plain.abs().max().item()}
            if nu in _build.TUNED_NU:
                g_t = DM._backward_mx_kernel(tuned, stream, *bargs, glow=True, luu_al=None)[2]
                r.update(tuned_vs_plain=rel_err(g_t, plain), tuned_vs_nu=rel_err(g_t, g_nu))
            rows[name][its] = r
            del s, bargs, plain
    return rows


def event_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls by CUDA events, after
    a warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def large12_rows(dev):
    """{kernel B: {"ms_nu", "ms_large" (in turns), "large_vs_nu"}} of the
    ``large12`` measurement."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
    from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
        kernel_inputs,
        polish_inputs,
        rel_err,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    grav = dict(gravity=True, exact_gravity_jacobian=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flat = lambda out: [t for x in out for t in (x if isinstance(x, tuple) else (x,))]
    rows = {}

    def pair(name, calls):
        """calls: {"nu": fn, "large": fn}; ms in turns and the errors."""
        ms = {"nu": [], "large": []}
        for which in ("nu", "large", "large", "nu"):
            ms[which].append(event_ms(calls[which], LARGE12_REPS))
        a, b = flat(calls["large"]()), flat(calls["nu"]())
        rows[name] = {"ms_nu": ms["nu"], "ms_large": ms["large"],
                      "large_vs_nu": max(rel_err(x.double(), y.double()) for x, y in zip(a, b))}

    for B in LARGE12_BATCHES:
        for dtype in (torch.float32, torch.float64):
            tag = "f32" if dtype == torch.float32 else "f64"
            dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.rcs12_pu(), dtype, dev)
            q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED)
            us0 = torch.zeros((B, N, 12), dtype=dtype, device=dev)
            solver = P.PipelineSolver(N, 2, float(dyn.dt), **grav)
            s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, kernel_gains=True)
            bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
            fns = {w: _build.function("pipeline_nu", f"riccati_{e}", tag, P._RICCATI_NU_ARGS)
                   for w, e in (("nu", "nu"), ("large", "large"))}
            pair(f"B2 {tag} B={B}", {w: (lambda f=f: P._backward_kernel(
                f, stream, *bargs, glow=True, luu_al=None, hand=True)) for w, f in fns.items()})
            rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"])
            fns = {w: _build.function("pipeline_nu", f"rollout_{e}", tag, P._ROLLOUT_ARGS)
                   for w, e in (("nu", "nu"), ("large", "large"))}
            pair(f"B4 {tag} B={B}", {w: (lambda f=f: P._rollout_kernel(
                f, stream, *rargs, None, s["consts"], dt=solver.dt, gravity=True,
                exact_grav=True, fused=False)[:4]) for w, f in fns.items()})
            del s, bargs, rargs
            if dtype == torch.float64:
                mx = DM.MixedDFPipelineSolver(N, float(dyn.dt), ITERS, 1, **grav)
                s = polish_inputs(mx, dyn, cost, q0s, xi0s, us0, kernel_gains=True,
                                  polished=True)
                bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
                fns = {w: _build.function("polish_nu", f"riccati_{e}", "mx", DM._RICCATI_ARGS)
                       for w, e in (("nu", "nu"), ("large", "large"))}
                pair(f"B5 B={B}", {w: (lambda f=f: DM._backward_mx_kernel(
                    f, stream, *bargs, glow=True, luu_al=None)) for w, f in fns.items()})
                rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"],
                         s["consts"])
                fns = {w: _build.function("polish_nu", f"rollout_{e}", "mx", DM._ROLLOUT_ARGS)
                       for w, e in (("nu", "nu"), ("large", "large"))}
                pair(f"B6 B={B}", {w: (lambda f=f: DM._rollout_mx_kernel(
                    f, stream, *rargs, dt=mx.dt, gravity=True)) for w, f in fns.items()})
                del s, bargs, rargs
    return rows


def g_pass_rows(dev):
    """{"B3/B4 problem tag B=...": {"ms_pass", "ms_none" (in turns),
    "pass_vs_none", "auto"}} of the ``g_pass`` measurement."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
    from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
        _flat,
        kernel_inputs,
        rel_err,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    grav = dict(gravity=True, exact_gravity_jacobian=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for name in ("screw200_torques3", "screw200_rcs12"):
        pu = al_bench.NU_PROBLEMS[name]()
        for dtype in (torch.float32, torch.float64):
            tag = _build.suffix(dtype)
            fns = {w: _build.function("pipeline_nu", f"rollout_{e}", tag, P._ROLLOUT_ARGS)
                   for w, e in (("pass", "nu_pass"), ("none", "nu_no_pass"), ("auto", "nu"))}
            for B in G_PASS_BATCHES:
                dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, dtype, dev)
                q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED)
                us0 = torch.zeros((B, N, pu.shape[1]), dtype=dtype, device=dev)
                solver = P.PipelineSolver(N, 2, float(dyn.dt), **grav)
                s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, kernel_gains=True)
                rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"])
                for k, fused in (("B3", True), ("B4", False)):
                    call = lambda f, fused=fused: P._rollout_kernel(
                        f, stream, *rargs, s["refs"], s["consts"], dt=solver.dt,
                        gravity=True, exact_grav=True, fused=fused)[:5 if fused else 4]
                    ms = {"pass": [], "none": []}
                    for which in ("pass", "none", "none", "pass"):
                        ms[which].append(event_ms(lambda: call(fns[which]), LARGE12_REPS))
                    a, b = _flat(call(fns["pass"])), _flat(call(fns["none"]))
                    i0 = P.rollout_nu_instances(dtype)
                    call(fns["auto"])
                    i1 = P.rollout_nu_instances(dtype)
                    rows[f"{k} {name} {tag} B={B}"] = {
                        "ms_pass": ms["pass"], "ms_none": ms["none"],
                        "pass_vs_none": max(rel_err(x.double(), y.double())
                                            for x, y in zip(a, b, strict=True)),
                        "auto": [i for i in i1 if i1[i] != i0[i]]}
                    del a, b
                del s, rargs
    return rows


def pad_rates(dev):
    """{run: rates} of the ``pad`` measurement, in the order run."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    us_gold, meta = al_bench.load_nu_golden("screw200_torques3")
    pol, ref = meta["polish_schedule"], meta["refine_schedule"]
    pu3 = al_bench.torques3_pu()
    variants = {"native": pu3, "padded": np.hstack([pu3, np.zeros((6, 3))])}
    grav = dict(gravity=True, exact_gravity_jacobian=True)

    def batch(pu, dtype, B, seed):
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, dtype, dev)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, N, pu.shape[1]), dtype=dtype, device=dev)

    def rate(solver, pu, dtype, B, reps, us_of):
        a = batch(pu, dtype, B, SEED)
        us = us_of(solver.solve(*a))  # warm-up, and lane 0 checked
        lane0 = us[0].double().cpu().numpy()
        r = {"lane0_us_max_abs_err": float(np.abs(lane0[:, :3] - us_gold).max()),
             "max_abs_u_padded": float(np.abs(lane0[:, 3:]).max()) if lane0.shape[1] > 3 else None,
             "all_finite": bool(torch.isfinite(us).all().item())}
        del a, us
        secs = []
        for rep in range(reps):
            a = batch(pu, dtype, B, SEED + 1 + rep)
            secs.append(timed(lambda: solver.solve(*a))[1])
            del a
        return {**r, "rep_s": secs, "solves_per_s": B / statistics.median(secs)}

    dt = float(batch(pu3, torch.float64, 1, SEED)[0].dt)
    runs = []
    for name in ("native", "padded", "padded", "native"):
        pu = variants[name]
        runs.append({"variant": name, "nu": pu.shape[1],
                     "f32": rate(P.PipelineSolver(N, ITERS, dt, **grav), pu, torch.float32,
                                 B_F32, F32_REPS, lambda st: st.us),
                     "polish": rate(DM.MixedDFPipelineSolver(
                         N, dt, pol["f32_iterations"], pol["inner_iterations"], **grav),
                         pu, torch.float64, B_POLISH, POLISH_REPS, join_us),
                     "refine": rate(DFPipelineSolver(
                         N, dt, ref["f32_iterations"], ref["inner_iterations"], **grav),
                         pu, torch.float64, B_POLISH, POLISH_REPS, join_us)})
    return runs


if __name__ == "__main__":
    main()
