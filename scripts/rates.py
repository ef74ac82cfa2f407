#!/usr/bin/env python3
"""The end-to-end rates of the PyTorch port's paths and the times of its
kernels B1-B5 and B10-B14, for one checkout on one card: the numbers on
which two commits are compared.  Prints one JSON line.

    python3 scripts/rates.py [--root DIR]

``--root``: the checkout whose package is measured (default: the one this
script lies in), so that two trees compare in one call on one card, e.g.
the parent unpacked into ``build/parent``: parent, change, change, parent.
It measures what `chip_smoke.py`'s timing phases measure, with the same
shapes, schedules and repetitions, in ~3 minutes a tree; `chip_smoke.py`
(~10 minutes) also checks every kernel and path, mostly against plain
solves on the host.

Measured, in this order (the f32 path first: earlier work in a process
moves B2's time by up to 2%):
  f32           the fused f32 pipeline on screw-200, B=8192, 12 iterations:
                median of 7 reps after a warm-up, a new batch each;
  B1-B4         kernel ms (CUDA events, mean of 5 launches after one) on a
                real f32 iterate at B=8192, and B2 and B3 at B=16384; B3's
                yardstick, the sum of B4's and B1's times at B=8192;
  polish        the f32 phase (7 iterations) and the mixed polish (2),
                B=16384: median of 5 reps of the two phases' sum; the
                warm-up's lane 0 against the screw-200 golden;
  B5            kernel ms on the polish's real iterate at B=16384;
  so3           both SO(3) families, B=8192, 30 iterations, median of 7;
                B10-B12 at each family's N on a real iterate at B=8192,
                and B12's yardstick, its rollout phase alone plus B10
                (null for a tree whose B12 has no separate rollout phase);
  fast          the fast tier's free body (B1/B13/B14), B=8192, 12
                iterations, median of 7; the drone and the free attitude one
                rep each (host-bound: their rollouts are stage loops of small
                PyTorch ops); B13 at each path's (nx, nu), (12, 6), (12, 4)
                and (6, 3), and B14 on the free body, on a real iterate at
                B=8192.

    python3 scripts/rates.py [--root DIR] --b13-any

measures B13 alone (the kernel `chip_smoke.py --b13-any` checks): the ms
(CUDA events, mean of 3 launches after one) of its runtime-shape instance
(`ops/riccati.backward_lane_any`) on `kernel_check.riccati_inputs` at
(6, 2), (9, 3), (12, 3) and (12, 12), of its tuned instances
(`backward_lane`) at (12, 6), (12, 4) and (6, 3), and of its large-nu
instance at (12, 16) and (12, 34) (null for a tree without it), N = 200,
f32 at B = 8192 and f64 at B = 1024 (the large-nu instance also f32 at
B = 1024, the rcs16 solve's batch); the plain version's ms (host clock,
one call) at (12, 3), (12, 6), (12, 12) and (12, 16), f32, B = 8192; the
(12, 3) rigid body's `FastBatchSolver` solve (f32, B = 1024, 4 iterations;
median of 3 after a warm-up) and screw200_rcs16's (f32, B = 1024, 12
iterations, one rep after a warm-up; null without the large-nu
instance), ~2 minutes a tree with the build.

    python3 scripts/rates.py [--root DIR] --large-nu

measures B2-B5 past nu = 12 (the large-nu Riccati step,
`csrc/riccati_large.cuh`, and the large-nu rollout, `csrc/nu_large.cuh`)
and the paths that run them: B2, B3 and B4 in f32 and fp64 and B5 (CUDA
events, mean of 5 launches after one), launched through their direct C
entries (`riccati_large`, `rollout_large`, which take the large-nu instance
at any nu, 12 included), on the rigid body driven through
`al_bench.nu_pu(nu)` at nu = 12, 13, 16, 24 and 34, N = 200, B = 1024, on
`kernel_check`'s real iterates (two iterations; the polish's after 12 f32
and one polish iteration); at the paths' own shapes on screw200_rcs16 and
screw200_rcs24: f32 B2 and B3 at B = 8192 (the f32 path), f32 B2 and B3 and
B5 at B = 16384 (the polish), fp64 B2 and B3 at B = 16384 (the refiner);
then both problems' f32 path (B = 8192,
12 iterations), polish and refiner (B = 16384, each golden's schedule):
median solves/s of 3 reps after a warm-up, a new batch each, and the
warm-up's lane 0 against the golden with its gate (`chip_smoke.py`'s
kernels_nu gates), ~4 minutes a tree with the build.

    python3 scripts/rates.py [--root DIR] --refine

measures the refiner's fp64 phase alone (the kernels `chip_smoke.py
--refine` checks): B1-B4 in fp64 (CUDA events, mean of 5 launches after
one) on a real fp64 iterate at B = 16384, N = 200 of the screw-200 free
body (nu = 6) and of the drone (nu = 4, gravity), and the refined solve
(`DFPipelineSolver`, 10 f32 + 3 fp64 iterations, B = 16384; median of 3
after a warm-up, a new batch each), ~1.5 minutes a tree with the build.
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

N, B_F32, B_POLISH, ITERS, SO3_ITERS = 200, 8192, 16384, 12, 30
# B13's runtime-shape instance (--b13-any): the shapes, the batch of each
# scalar type, the (12, 3) solve's batch and iterations
ANY_SHAPES = ((6, 2), (9, 3), (12, 3), (12, 12))
ANY_BATCH = {torch.float32: 8192, torch.float64: 1024}
ANY_SOLVE_BATCH, ANY_SOLVE_ITERS = 1024, 4
# B13's tuned and large-nu instances, its plain version's shapes (f32), and
# the rcs16 solve's iterations (--b13-any)
TUNED_SHAPES, LARGE_SHAPES = ((12, 6), (12, 4), (6, 3)), ((12, 16), (12, 34))
PLAIN_SHAPES, RCS16_ITERS = ((12, 3), (12, 6), (12, 12), (12, 16)), 12
# the refiner (--refine): its batch, f32 and fp64 iterations, repetitions;
# its fp64 kernels on the free body (nu = 6) and the drone (nu = 4)
REFINE_BATCH, REFINE_F32_ITERS, REFINE_DF_ITERS, REFINE_REPS = 16384, 10, 3, 3
REFINE_MODELS = ("free_body", "drone")
# the large-nu Riccati step (--large-nu): the kernel rows' nu and batch, the
# paths' batches (f32 path; polish and refiner), repetitions, and the lane-0
# gates of the polish and the refiner (the f32 path's is 10 x the JAX f32
# pipeline's error, from each golden's meta)
LARGE_NUS, LARGE_BATCH = (12, 13, 16, 24, 34), 1024
LARGE_F32_BATCH, LARGE_POLISH_BATCH, LARGE_REPS = 8192, 16384, 3
LARGE_PROBLEMS = ("screw200_rcs16", "screw200_rcs24")
LARGE_POLISH_GATE, LARGE_REFINE_GATE = 1e-4, 1e-6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--b13-any", action="store_true",
                    help="measure B13 alone (every instance, the plain version)")
    ap.add_argument("--refine", action="store_true",
                    help="measure the refiner's fp64 phase alone")
    ap.add_argument("--large-nu", action="store_true",
                    help="measure B2-B5 past nu = 12 and the rcs16/rcs24 paths alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rates: needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import join_us
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(P.__file__))))
    assert pkg_root == root, f"measured {P.__file__}, not the package under {root}"
    dev = torch.device("cuda", 0)
    out = {"root": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "build_s": _build.build()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def event_ms(fn, reps=5):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def median_rate(solve, batch, B, reps, seed):
        solve(*batch(seed))  # warm-up
        secs = []
        for r in range(reps):
            a = batch(seed + 1 + r)
            secs.append(timed(lambda: solve(*a))[1])
        return B / statistics.median(secs)

    if args.b13_any:
        out.update(b13_any_rates(dev, event_ms, timed))
        print(json.dumps(out), flush=True)
        return
    if args.refine:
        out.update(refine_rates(dev, event_ms, timed))
        print(json.dumps(out), flush=True)
        return
    if args.large_nu:
        out.update(large_nu_rates(dev, event_ms, timed))
        print(json.dumps(out), flush=True)
        return

    problems = {dt: al_bench.build_screw200(dt, dev, horizon=N)
                for dt in (torch.float32, torch.float64)}

    def screw(dtype, B, seed):
        dyn, cost, q0, xi0 = problems[dtype]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, N, 6), dtype=dtype, device=dev)

    dt = float(problems[torch.float32][0].dt)
    fused = P.PipelineSolver(N, ITERS, dt)
    out["f32_solves_per_s"] = median_rate(
        fused.solve, lambda s: screw(torch.float32, B_F32, s), B_F32, 7, 100)
    for B in (B_F32, B_POLISH):
        s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, dt), *screw(torch.float32, B, 200))
        calls = kernel_check.calls(s, dt=dt)
        for k in ("B2", "B3") if B == B_POLISH else ("B1", "B2", "B3", "B4"):
            out[f"{k}_B{B}_ms"] = event_ms(calls[k][0])
        del s, calls
    out[f"B4_plus_B1_B{B_F32}_ms"] = out[f"B4_B{B_F32}_ms"] + out[f"B1_B{B_F32}_ms"]

    dt64 = float(problems[torch.float64][0].dt)
    mx = DM.MixedDFPipelineSolver(N, dt64, 7, 2)
    us_gold, _ = al_bench.load_screw200_golden()
    warm = mx.solve(*screw(torch.float64, B_POLISH, 0))
    out["polish_lane0_us_max_abs_err"] = float(
        np.abs(join_us(warm)[0].cpu().numpy() - us_gold).max())
    del warm
    tot = []
    for r in range(5):
        a = screw(torch.float64, B_POLISH, 301 + r)
        handoff, t_f32 = timed(lambda: mx.f32_phase(*a))
        _, t_pol = timed(lambda: mx.polish(a[0], a[1], *handoff))
        tot.append(t_f32 + t_pol)
        del handoff
    out["gate_passing_solves_per_s"] = B_POLISH / statistics.median(tot)
    s = kernel_check.polish_inputs(mx, *screw(torch.float64, B_POLISH, 400))
    out["B5_B16384_ms"] = event_ms(kernel_check.polish_calls(s, mx)["B5"][0])
    del s

    for name in ("so3_track249", "pendulum_swingup80"):
        pendulum, dt_p, n_p = so3_bench.PROBLEMS[name][:3]
        build = (so3_bench.build_pendulum_swingup80 if pendulum
                 else so3_bench.build_so3_track249)
        dyn, cost, q0, xi0 = build(torch.float32, dev)

        def so3_batch(seed, dyn=dyn, cost=cost, q0=q0, xi0=xi0, n_p=n_p):
            q0s, xi0s = so3_bench.so3_batch(q0, xi0, B_F32, seed)
            return dyn, cost, q0s, xi0s, torch.zeros((B_F32, n_p, 3), device=dev)

        solver = S.SO3PipelineSolver(n_p, SO3_ITERS, dt_p, pendulum=pendulum)
        out[f"{name}_solves_per_s"] = median_rate(solver.solve, so3_batch, B_F32, 7, 500)
        s = kernel_check.so3_inputs(S.SO3PipelineSolver(n_p, 2, dt_p, pendulum=pendulum),
                                    *so3_batch(600))
        kw = dict(dt=dt_p, pendulum=pendulum)
        for k, (kern, _) in kernel_check.so3_calls(s, **kw).items():
            out[f"{k}_{name}_ms"] = event_ms(kern)
        out[f"B12_rollout_phase_plus_B10_{name}_ms"] = None
        if hasattr(S, "_rollout_so3_kernel"):
            fn = S._launch("rollout_so3", s["us"])
            args = (s["qR"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"], s["consts"])
            out[f"B12_rollout_phase_plus_B10_{name}_ms"] = event_ms(
                lambda: S._rollout_so3_kernel(*fn, *args, linearize=False, **kw)) + \
                out[f"B10_{name}_ms"]
        del s

    for kind in ("free_body", "drone", "so3_track249"):
        if kind == "so3_track249":
            model, params, q0, xi0 = so3_bench.so3_track249_model(torch.float32, dev)
            fbatch, n_k, it_k, kw = so3_bench.so3_batch, 249, SO3_ITERS, {}
        else:
            model, params, q0, xi0 = al_bench.screw200_model(torch.float32, dev, horizon=N,
                                                            drone=kind == "drone")
            fbatch, n_k, it_k = al_bench.screw_batch, N, ITERS
            kw = ({} if kind == "drone" else dict(pallas_rollout_dt=float(params["dyn"].dt),
                                                  use_pallas_linearize=True))
        cp = params["cost"]

        def fargs(seed, model=model, params=params, q0=q0, xi0=xi0, fbatch=fbatch, n_k=n_k,
                  cp=cp):
            q0s, xi0s = fbatch(q0, xi0, B_F32, seed)
            return (params, q0s, xi0s, torch.zeros((B_F32, n_k, model.nu), device=dev),
                    cp.q_ref, cp.xi_ref)

        solver = F.FastBatchSolver(model, n_k, it_k, **kw)
        if kind == "free_body":
            out["fast_free_body_solves_per_s"] = median_rate(solver.solve, fargs, B_F32, 7, 700)
        else:
            out[f"fast_{kind}_solves_per_s"] = B_F32 / timed(
                lambda: solver.solve(*fargs(710)))[1]
        # B13 at this path's (nx, nu), and B14 on the free body, on a real
        # iterate
        s = kernel_check.fast_inputs(F.FastBatchSolver(model, n_k, 2, **kw), *fargs(720)[:4])
        calls = kernel_check.fast_calls(s)
        out[f"B13_{model.nx}x{model.nu}_B{B_F32}_ms"] = event_ms(calls["B13"][0])
        if "B14" in calls:
            out[f"B14_B{B_F32}_ms"] = event_ms(calls["B14"][0])
        del s, calls
    print(json.dumps(out), flush=True)


def b13_any_rates(dev, event_ms, timed):
    """``--b13-any`` (module docstring): {row: ms} of B13's runtime-shape
    instance and the (12, 3) solve's seconds."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    out = {}
    large = hasattr(RC.backward_lane_any, "nuL")
    for dtype, B in ANY_BATCH.items():
        for kind, shapes, fn in (("B13any", ANY_SHAPES, RC.backward_lane_any),
                                 ("B13", TUNED_SHAPES, RC.backward_lane),
                                 ("B13nuL", LARGE_SHAPES, RC.backward_lane_any)):
            for nx, nu in shapes:
                name = f"{kind}_{nx}x{nu}_{str(dtype).replace('torch.', '')}_B{B}_ms"
                if kind == "B13nuL" and not large:
                    out[name] = None
                    continue
                s = kernel_check.riccati_inputs(nx, nu, B, N, dtype, dev, seed=0)
                args = tuple(s[n] for n in kernel_check.READS["B13"])
                out[name] = event_ms(lambda: fn(*args), 3)
                del s, args
    # the large-nu instance at the rcs16 solve's own batch too (f32)
    for nx, nu in LARGE_SHAPES:
        name = f"B13nuL_{nx}x{nu}_float32_B{ANY_SOLVE_BATCH}_ms"
        out[name] = None
        if large:
            s = kernel_check.riccati_inputs(nx, nu, ANY_SOLVE_BATCH, N, torch.float32, dev, seed=0)
            args = tuple(s[n] for n in kernel_check.READS["B13"])
            out[name] = event_ms(lambda: RC.backward_lane_any(*args), 3)
            del s, args
    B = ANY_BATCH[torch.float32]
    for nx, nu in PLAIN_SHAPES:
        s = kernel_check.riccati_inputs(nx, nu, B, N, torch.float32, dev, seed=0)
        args = tuple(s[n] for n in kernel_check.READS["B13"])
        out[f"plain_B13_{nx}x{nu}_float32_B{B}_ms"] = timed(
            lambda: RC.backward_plain(*args))[1] * 1e3
        del s, args
    # the rigid body driven by three torques, no gravity (chip_smoke.py's
    # kernels_b13_any solve)
    f32 = torch.float32
    dyn, cost, q0, xi0 = al_bench.build_screw200(f32, dev, horizon=N)
    Pu = torch.zeros((6, 3), dtype=f32, device=dev)
    Pu[0, 0] = Pu[1, 1] = Pu[2, 2] = 1.0
    cost.R = 1e-2 * torch.eye(3, dtype=f32, device=dev)
    model, params = make_model(dynamics.rigid_body_dynamics()._replace(nu=3),
                               costs.tracking_cost(SE3, 3),
                               dynamics.rigid_body_params(dyn.J, dyn.dt, g=0.0, Pu=Pu), cost)
    q0s, xi0s = al_bench.screw_batch(q0, xi0, ANY_SOLVE_BATCH, 0)
    args = (params, q0s, xi0s, torch.zeros((ANY_SOLVE_BATCH, N, 3), dtype=f32, device=dev),
            cost.q_ref, cost.xi_ref)
    solver = F.FastBatchSolver(model, N, ANY_SOLVE_ITERS)
    solver.solve(*args)
    out[f"solve_12x3_B{ANY_SOLVE_BATCH}_s"] = statistics.median(
        timed(lambda: solver.solve(*args))[1] for _ in range(3))
    out[f"solve_rcs16_B{ANY_SOLVE_BATCH}_s"] = None
    if large:
        model, params, q0, xi0 = al_bench.screw200_nu_model(al_bench.rcs16_pu(), f32, dev,
                                                            horizon=N)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, ANY_SOLVE_BATCH, 0)
        args = (params, q0s, xi0s, torch.zeros((ANY_SOLVE_BATCH, N, 16), dtype=f32, device=dev),
                params["cost"].q_ref, params["cost"].xi_ref)
        solver = F.FastBatchSolver(model, N, RCS16_ITERS)
        solver.solve(*args)
        out[f"solve_rcs16_B{ANY_SOLVE_BATCH}_s"] = timed(lambda: solver.solve(*args))[1]
    return out


def refine_rates(dev, event_ms, timed):
    """``--refine`` (module docstring): {row: ms} of B1-B4 in fp64 on each
    model and the refined solve's median seconds and rate."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    f64, B, out = torch.float64, REFINE_BATCH, {}
    for kind in REFINE_MODELS:
        drone = kind == "drone"
        dyn, cost, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
        if drone:
            dyn = dynamics.drone_params(dyn.J, dyn.dt)
            cost.R = 1e-2 * torch.eye(4, dtype=f64, device=dev)
        nu = cost.R.shape[0]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, 200)
        solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=drone,
                                  exact_gravity_jacobian=drone)
        s = kernel_check.kernel_inputs(solver, dyn, cost, q0s, xi0s,
                                       torch.zeros((B, N, nu), dtype=f64, device=dev),
                                       kernel_gains=True)
        calls = kernel_check.calls(s, dt=solver.dt, gravity=drone, exact_grav=drone)
        for k in ("B1", "B2", "B3", "B4"):
            out[f"{k}_f64_nu{nu}_B{B}_ms"] = event_ms(calls[k][0])
        del s, calls
    dyn, cost, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
    dfp = DFPipelineSolver(N, float(dyn.dt), REFINE_F32_ITERS, REFINE_DF_ITERS)
    us0 = torch.zeros((B, N, 6), dtype=f64, device=dev)

    def solve(seed):
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return timed(lambda: dfp.solve(dyn, cost, q0s, xi0s, us0))[1]

    solve(900)  # warm-up
    med = statistics.median(solve(901 + r) for r in range(REFINE_REPS))
    out[f"refine_B{B}_median_s"] = med
    out["refine_solves_per_s"] = B / med
    return out


def large_nu_rates(dev, event_ms, timed):
    """``--large-nu`` (module docstring): {row: ms} of B2 (f32, fp64) and B5
    past nu = 12 and at the rcs paths' shapes, and {path: solves/s, lane-0
    error, gate} of the rcs16 and rcs24 f32 path, polish and refiner."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    grav = dict(gravity=True, exact_gravity_jacobian=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    f64, out = torch.float64, {}

    def inputs(pu, dtype, B, seed=0):
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, dtype, dev, horizon=N)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, N, pu.shape[1]), dtype=dtype, device=dev)

    def b234_ms(pu, dtype, B, kernels=("B2", "B3", "B4")):
        """{kernel: ms} of B2, B3 and B4 through their direct large-nu entries
        on one real iterate."""
        args = inputs(pu, dtype, B)
        solver = P.PipelineSolver(N, 2, float(args[0].dt), **grav)
        s = kernel_check.kernel_inputs(solver, *args, kernel_gains=True)
        tag = "f32" if dtype == torch.float32 else "f64"
        fn = _build.function("pipeline_nu", "riccati_large", tag, P._RICCATI_NU_ARGS)
        bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
        rfn = _build.function("pipeline_nu", "rollout_large", tag, P._ROLLOUT_ARGS)
        rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"],
                 s["consts"])
        rkw = dict(dt=solver.dt, gravity=True, exact_grav=True)
        run = {"B2": lambda: P._backward_kernel(fn, stream, *bargs, glow=True, luu_al=None,
                                                hand=True),
               "B3": lambda: P._rollout_kernel(rfn, stream, *rargs, fused=True, **rkw),
               "B4": lambda: P._rollout_kernel(rfn, stream, *rargs, fused=False, **rkw)}
        return {k: event_ms(run[k]) for k in kernels}

    def b5_ms(pu, B):
        args = inputs(pu, f64, B)
        mx = DM.MixedDFPipelineSolver(N, float(args[0].dt), ITERS, 1, **grav)
        s = kernel_check.polish_inputs(mx, *args, kernel_gains=True, polished=True)
        fn = _build.function("polish_nu", "riccati_large", "mx", DM._RICCATI_ARGS)
        bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
        return event_ms(lambda: DM._backward_mx_kernel(fn, stream, *bargs, glow=True,
                                                       luu_al=None))

    for nu in LARGE_NUS:
        pu = al_bench.nu_pu(nu)
        for dtype, tag in ((torch.float32, "f32"), (f64, "f64")):
            for k, ms in b234_ms(pu, dtype, LARGE_BATCH).items():
                out[f"{k}nuL_{tag}_nu{nu}_B{LARGE_BATCH}_ms"] = ms
        out[f"B5nuL_nu{nu}_B{LARGE_BATCH}_ms"] = b5_ms(pu, LARGE_BATCH)
    pus = {name: al_bench.NU_PROBLEMS[name]() for name in LARGE_PROBLEMS}
    for name, pu in pus.items():
        # the f32 path's batch; the polish's f32 phase, B5 and the refiner's
        # fp64 phase at theirs
        for dtype, tag, B in ((torch.float32, "f32", LARGE_F32_BATCH),
                              (torch.float32, "f32", LARGE_POLISH_BATCH),
                              (f64, "f64", LARGE_POLISH_BATCH)):
            for k, ms in b234_ms(pu, dtype, B, ("B2", "B3")).items():
                out[f"{k}nuL_{tag}_{name}_B{B}_ms"] = ms
        out[f"B5nuL_{name}_B{LARGE_POLISH_BATCH}_ms"] = b5_ms(pu, LARGE_POLISH_BATCH)
    for name, pu in pus.items():
        us_gold, meta = al_bench.load_nu_golden(name)
        pol, ref = meta["polish_schedule"], meta["refine_schedule"]
        dt = float(inputs(pu, f64, 1)[0].dt)
        paths = {
            "f32": (P.PipelineSolver(N, ITERS, dt, **grav), torch.float32, LARGE_F32_BATCH,
                    lambda st: st.us, 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]),
            "polish": (DM.MixedDFPipelineSolver(N, dt, pol["f32_iterations"],
                                                pol["inner_iterations"], **grav),
                       f64, LARGE_POLISH_BATCH, join_us, LARGE_POLISH_GATE),
            "refine": (DFPipelineSolver(N, dt, ref["f32_iterations"], ref["inner_iterations"],
                                        **grav), f64, LARGE_POLISH_BATCH, join_us,
                       LARGE_REFINE_GATE)}
        for path, (solver, dtype, B, us_of, gate) in paths.items():
            a = inputs(pu, dtype, B, 0)
            st = solver.solve(*a)
            us = us_of(st)
            err = float(np.abs(us[0].double().cpu().numpy() - us_gold).max())
            fin = bool(torch.isfinite(us).all().item())
            del st, us, a
            secs = []
            for r in range(LARGE_REPS):
                a = inputs(pu, dtype, B, 1 + r)
                secs.append(timed(lambda: solver.solve(*a))[1])
                del a
            out[f"{name}_{path}"] = {"B": B, "solves_per_s": B / statistics.median(secs),
                                     "s": secs, "lane0_us_max_abs_err": err, "gate": gate,
                                     "gate_met": err <= gate, "all_finite": fin}
    return out


if __name__ == "__main__":
    main()
