#!/usr/bin/env python3
"""Where a stage of the runtime-nu B2 step and of the runtime-nu rollout
(B3's first phase, B4: `csrc/nu.cuh`, nu <= 12) spends its cycles, on one
card.  Prints one JSON line per (kernel, scalar, nu).

    python3 scripts/nu_phases.py [--root DIR] [--nus 3,12]

It copies the package under ``--root`` (default: the one this script lies
in) to ``build/nu_phases/`` there, adds `clock64()` reads at the phase
boundaries of the step and of the rollout's stage loop (the markers of
`DESIGNS`, found by their text in the tree's sources), builds the copy's
`pipeline_nu` libraries alone, and runs B2 and B4 through their wrappers on
`kernel_check`'s real iterate (two iterations on the rigid body driven
through `al_bench.nu_pu(nu)`), N = 200, B = 1024, f32 and fp64.  Thread 0 of
each block accumulates each phase's cycles over the stages in shared
memory; block 0 writes the sums, divided by N, to a device array that the
script reads back.  A phase's cycles include its waits (on shared memory,
on the warp's barriers and, for the first use of a value, on the phase that
made it), and the compiler moves arithmetic across the reads of the clock:
the instrumented kernel runs slower than the package's own, and its shares,
not its total, are the reading.
"""

import argparse
import ctypes
import json
import os
import shutil
import sys

PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"

# The instrumentation, appended to group.cuh (every unit includes it).
PROBE = r"""
namespace traopt {
__shared__ long long prof_acc[16];
__shared__ long long prof_t0;
__device__ float prof_out[16];
__device__ __forceinline__ void prof_start() {
  if (threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) prof_acc[k] = 0;
    prof_t0 = clock64();
  }
}
__device__ __forceinline__ void prof_tick(int k) {
  if (threadIdx.x == 0) {
    const long long t1 = clock64();
    prof_acc[k] += t1 - prof_t0;
    prof_t0 = t1;
  }
}
__device__ __forceinline__ void prof_dump(int N) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int k = 0; k < 16; ++k) prof_out[k] = float(prof_acc[k]) / N;
}
}  // namespace traopt
"""
READ = r"""
extern "C" int prof_read(float* host) {
  return (int)cudaMemcpyFromSymbol(host, traopt::prof_out, 16 * sizeof(float));
}
"""

# Each design: its kernels' phases and {file: [(text, what)]}, what a
# (kind, k) of `patch`: "tick" a clock read closing phase k before the text;
# "end" one before the function's last brace; "loop" (B2) and "wait" (the
# rollout) the start before the stage loop and phase 0 (the wait) closed
# after the text; "rend" the rollout's last phase closed at its loop's end,
# then the dump; "dump" the dump before the text.  A design applies when
# all its texts are found.
_B2_LOOP = ("    cp_async_wait_all();\n    __syncthreads();\n", ("loop", 0))
# the phases of the group step (f32) and the fp64 step (C split after the
# factor and after the solves: the line that closes them)
_GROUP_MARKS = [
    ("  // ---- B ----\n", ("tick", 2)), ("  // ---- C ----\n", ("tick", 3)),
    ("  Tp kc[NU];  // column r of K", ("tick", 4)), ("  Tp kq[NU];\n  if (own) {", ("tick", 5)),
    ("  // ---- D ----\n", ("tick", 6)), ("  // ---- E ----\n", ("tick", 7)),
    ("      V[j] = (h + mrow[j]) + mcol[j];\n    }\n  }\n}", ("end", 8))]


def _f64_marks(solved):
    return [("  // ---- B ----\n", ("tick", 2)), ("  // ---- C ----\n", ("tick", 3)),
            ("    T Y[NU], X[NU];\n", ("tick", 4)), (solved, ("tick", 5)),
            ("  // ---- D ----\n", ("tick", 6)), ("  // ---- E ----\n", ("tick", 7)),
            ("      for (int jj = 0; jj < 3; ++jj) g.VS[(bi + ii) * NX + bj + jj] = "
             "vb[ii * 3 + jj];\n  }\n}", ("end", 8))]


def _b2_loops(f32_step, f64_step):
    """B2's stage loops in nu.cuh (f32, fp64): the wait and barrier, the
    copy and store issue (the step's call), the dump."""
    return [
        ("  for (int t = N - 1; t >= 0; --t) {\n    const int cur = (N - 1 - t) & 1;\n"
         + _B2_LOOP[0], _B2_LOOP[1]),
        (f32_step, ("tick", 1)),
        ("  __syncthreads();\n  riccati_store_nu<Tp, Tr, MU>(K, k, gvec, outb, nu, 0",
         ("dump", None)),
        ("  for (int t = N - 1; t >= 0; --t) {\n    // every address derived anew each "
         "stage (opaque_zero)\n    const int z = opaque_zero(), cur = (N - 1 - t) & 1;\n"
         "    unsigned char* sm = smem + z;\n" + _B2_LOOP[0], _B2_LOOP[1]),
        (f64_step, ("tick", 1)),
        ("  __syncthreads();\n  riccati_store_nu<double, double, MU>(K, k, gvec, smem + "
         "L::oout, nu, 0", ("dump", None))]
DESIGNS = {
    "MU = 4, 6, 12 instances, the large-nu rollout with G_t precomputed": {
        "phases": {
            "B2": ("wait_and_barrier", "copy_store_issue", "A", "B", "C_factor", "C_solves",
                   "C_rest", "D", "E"),  # C_rest: K^T Q_uu, the stores (fp64: Q_xx too)
            "B4": ("wait", "copy_issue", "deviation_and_log", "feedback_and_refill",
                   "dynamics", "G_and_compose", "normalize_xi", "stores")},
        "files": {
            "riccati_group.cuh": _GROUP_MARKS,
            "riccati_f64.cuh": _f64_marks("    for (int a = 0; a < NU; ++a) kc[a] = -X[a];\n"),
            "nu.cuh": _b2_loops("    riccati_group_step<Tp, Tr, MU, kLean>(\n",
                                "    riccati_f64_step<MU, L::kAside>(\n"),
            "nu_large.cuh": [
                ("    col = col0 + z;\n    cp_async_wait_all();\n", ("wait", 0)),
                ("    const T* st = slot(t);\n    const T* xt = xslot(t);", ("tick", 1)),
                ("    // the feedback: entry e of u_t, k_t at fu[e fs]", ("tick", 2)),
                ("    T fqR[9], fqp[3], fxi[6];\n    stage_dynamics_eval_with<FramelessTrig>(",
                 ("tick", 3)),
                ("    if constexpr (kG) {\n      T GR[9], Gp[3];", ("tick", 4)),
                ("    so3_normalize(R);\n    {\n      const Lane<const T> xin", ("tick", 5)),
                ("    if (live) {\n      store<9>(lane<9>(a.oR, t + 1, B, b), R);", ("tick", 6)),
                ("      store<6>(lane<6>(a.oxi, t + 1, B, b), xi);\n    }\n  }\n", ("rend", 7))],
        },
    },
    "MU = 6, 12 instances, the rollout with u on its chain": {
        "phases": {
            "B2": ("wait_and_barrier", "copy_store_issue", "A", "B", "C_factor", "C_solves",
                   "C_rest", "D", "E"),  # C_rest: K^T Q_uu, the stores (fp64: Q_xx too)
            "B4": ("wait", "copy_issue", "off_chain_compositions", "deviation_and_log",
                   "feedback", "dynamics", "compose_normalize_xi", "stores")},
        "files": {
            "riccati_group.cuh": _GROUP_MARKS,
            "riccati_f64.cuh": _f64_marks("    for (int a = 0; a < NU; ++a) kc[a] = -X[a];\n"),
            "nu.cuh": _b2_loops("    riccati_group_step<Tp, Tr, MU>(\n",
                                "    riccati_f64_step<MU>(l, Vx, in, F, KT, dr") + [
                # the rollout's stage loop
                ("    T* const Kc = col + C::K * P;\n    cp_async_wait_all();\n", ("wait", 0)),
                ("    const T* st = slot(t);\n    const T* xt = xslot(t);", ("tick", 1)),
                ("    // the chain: the deviation, the feedback", ("tick", 2)),
                ("    T u[MU];\n", ("tick", 3)),
                ("    T fqR[9], fqp[3], fxi[6];\n    stage_dynamics_eval<T, MU>", ("tick", 4)),
                ("    se3_compose(R, p, GR, Gp, fqR, fqp);\n    so3_normalize(R);", ("tick", 5)),
                ("    if (live) {\n      store<9>(lane<9>(a.oR, t + 1, B, b), R);", ("tick", 6)),
                ("      store_nu<MU>(a.ou, u, t, nu, B, b);\n    }\n  }\n", ("rend", 7))],
        },
    },
}


def patch(text, marks):
    """``text`` with the clock reads of ``marks`` in place; None if a mark
    is missing."""
    for mark, (kind, k) in marks:
        if mark not in text:
            return None
        if kind == "tick":
            text = text.replace(mark, f"prof_tick({k});\n" + mark, 1)
        elif kind == "end":  # a tick before the function's last brace
            text = text.replace(mark, mark[:-1] + f"  prof_tick({k});\n}}", 1)
        elif kind == "loop":  # the stage loop: start before it, tick 0 after the wait
            text = text.replace(mark, "prof_start();\n" + mark + f"prof_tick({k});\n", 1)
        elif kind == "wait":  # the rollout's: start before its loop, tick 0 after the wait
            i = text.index(mark)
            j = text.rindex("  for (int t = 0; t < N; ++t) {", 0, i)
            text = text[:j] + "prof_start();\n" + text[j:i] + mark + f"prof_tick({k});\n" \
                + text[i + len(mark):]
        elif kind == "rend":  # the rollout's stores, its loop's end, the dump
            text = text.replace(mark, mark[:-len("  }\n")] + f"    prof_tick({k});\n  }}\n"
                                "  prof_dump(N);\n", 1)
        elif kind == "dump":
            text = text.replace(mark, "prof_dump(N);\n" + mark, 1)
    return text


def instrument(copy):
    """Patch the copy's sources with the first design of `DESIGNS` whose
    marks are all found; returns its name."""
    csrc = os.path.join(copy, PKG, "csrc")
    for name, design in DESIGNS.items():
        texts = {}
        for f, marks in design["files"].items():
            with open(os.path.join(csrc, f)) as h:
                texts[f] = patch(h.read(), marks)
        if all(t is not None for t in texts.values()):
            for f, t in texts.items():
                with open(os.path.join(csrc, f), "w") as h:
                    h.write(t)
            with open(os.path.join(csrc, "group.cuh"), "a") as h:
                h.write(PROBE)
            with open(os.path.join(csrc, "pipeline_nu.cu"), "a") as h:
                h.write(READ)
            return name
    sys.exit("nu_phases: no design of DESIGNS matches the tree's sources")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--nus", default="3,12")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("nu_phases: needs a CUDA device")
    root = os.path.abspath(args.root)
    copy = os.path.join(root, "build", "nu_phases")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(root, PKG), os.path.join(copy, PKG),
                    ignore=shutil.ignore_patterns("__pycache__", "golden"))
    design = instrument(copy)
    with open(os.path.join(copy, PKG, "_build.py")) as f:
        text = f.read()
    libs = 'LIBS = (("linearize", "f32", "float")'
    assert libs in text
    text = text.replace(libs, 'LIBS = (("pipeline_nu", "f32", "float"), '
                        '("pipeline_nu", "f64", "double"))\n_ALL = ' + libs[7:], 1)
    with open(os.path.join(copy, PKG, "_build.py"), "w") as f:
        f.write(text)

    sys.path.insert(0, copy)
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    dev, N, B = torch.device("cuda", 0), 200, 1024
    _build.build()
    card = torch.cuda.get_device_name(0)
    for dtype in (torch.float32, torch.float64):
        tag = _build.suffix(dtype)
        read = _build.library("pipeline_nu", tag).prof_read
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        for nu in map(int, args.nus.split(",")):
            dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.nu_pu(nu), dtype, dev,
                                                            horizon=N)
            q0s, xi0s = al_bench.screw_batch(q0, xi0, B, 0)
            solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=True,
                                      exact_gravity_jacobian=True)
            s = kernel_check.kernel_inputs(solver, dyn, cost, q0s, xi0s,
                                           torch.zeros((B, N, nu), dtype=dtype, device=dev),
                                           kernel_gains=True)
            calls = kernel_check.calls(s, dt=solver.dt, gravity=True, exact_grav=True)
            for kernel in ("B2", "B4"):
                calls[kernel][0]()
                torch.cuda.synchronize()
                buf = (ctypes.c_float * 16)()
                assert read(buf) == 0
                cyc = dict(zip(DESIGNS[design]["phases"][kernel], list(buf)))
                total = sum(cyc.values())
                print(json.dumps({"kernel": kernel, "dtype": tag, "nu": nu, "N": N, "B": B,
                                  "design": design, "card": card, "cycles_per_stage": cyc,
                                  "total": total,
                                  "share": {k: v / total for k, v in cyc.items()}}),
                      flush=True)


if __name__ == "__main__":
    main()
