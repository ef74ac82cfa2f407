#!/usr/bin/env python3
"""Where a stage of the large-nu Riccati step (B2 past nu = 12,
`csrc/riccati_large.cuh`) spends its cycles, on one card.  Prints one JSON
line per nu.

    python3 scripts/riccati_large_phases.py [--root DIR] [--nus 12,16,34]

It copies the package under ``--root`` (default: the one this script lies
in) to ``build/phases/`` there, adds `clock64()` reads at the step's phase
comments (A, B, C's factorization with the forward solve and the back
substitution (`large_factor_solve`), K^T Q_uu, D, E) and around the stage loop's copies, stores
and barrier, builds the copy's f32 `pipeline_nu` library alone, and runs
its B2 through the direct entry `riccati_large` on `kernel_check`'s real
iterate (two f32 iterations on the rigid body driven through
`al_bench.nu_pu(nu)`), N = 200, B = 1024.  Lane 0 of block 0's first group
accumulates each phase's cycles over the stages and writes the sums,
divided by N, over lN[8:17] of its output (a phase's cycles include its
waits at the warp's barriers).  The instrumented kernel runs slower than
the package's own; its shares, not its total, are the reading.
"""

import argparse
import json
import os
import shutil
import sys

PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"
PHASES = ("A", "B", "unused", "C_factor_solve", "KTQuu", "D", "E", "unused", "stage_loop")
# the step's phase comments, each a tick of the clock (the tick's index
# closes the phase before it); the factorization and both solves are one
# phase (large_factor_solve, a function of its own, has no clock)
MARKS = (("  // ---- A ----\n", 0), ("  // ---- B ----\n", 1), ("  // ---- C ----\n", 2),
         ("  // rows a of (K^T Q_uu)^T", 4), ("  // ---- D ----\n", 5),
         ("  // ---- E ----\n", 6))


def patch(s):
    """riccati_large.cuh's text with the clock reads."""
    for mark, k in MARKS:
        assert mark in s, mark
        s = s.replace(mark, f"  tick({k});\n" + mark, 1)
    step = "const LargeOut<Tp, Tr>& out) {\n  constexpr bool kMixed"
    assert step in s
    s = s.replace(step, "const LargeOut<Tp, Tr>& out, long long (&acc)[9], long long& t0) {\n"
                  "  const auto tick = [&](int k) {\n    const long long t1 = clock64();\n"
                  "    acc[k > 0 ? k - 1 : 8] += t1 - t0;\n    t0 = t1;\n  };\n"
                  "  constexpr bool kMixed", 1)
    i = s.index("// The block's constants at nu")
    j = s.rindex("}\n", 0, i)
    s = s[:j] + "  tick(7);\n" + s[j:]
    loop = "  copy(stage, N - 1);\n  for (int t = N - 1; t >= 0; --t) {"
    assert loop in s
    s = s.replace(loop, "  long long acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, t0 = clock64();\n" + loop
                  + "\n    t0 = clock64();", 1)
    call = "reinterpret_cast<const Tp*>(smem + L.oLuu), glow, gs, o);"
    assert call in s
    s = s.replace(call, "reinterpret_cast<const Tp*>(smem + L.oLuu), glow, gs, o, acc, t0);", 1)
    end = "  __syncthreads();\n  store(outb, 0);\n}"
    assert end in s
    s = s.replace(end, "  __syncthreads();\n  store(outb, 0);\n"
                  "  if (blockIdx.x == 0 && tid == 0)\n"
                  "    for (int k = 0; k < 9; ++k) prof[k] = float(acc[k]) / N;\n}", 1)
    sig = "bool glow,\n                                                    Tp* K, Tp* k, Tr* gvec) {"
    assert sig in s
    s = s.replace(sig, sig.replace("Tr* gvec) {", "Tr* gvec, float* prof) {"), 1)
    run = "Tp* K, Tp* k, Tr* gvec) {\n  static_assert"
    assert run in s
    s = s.replace(run, "Tp* K, Tp* k, Tr* gvec, float* prof) {\n  static_assert", 1)
    return s.replace("glow, K, k,\n                                      gvec);",
                     "glow, K, k,\n                                      gvec, prof);")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--nus", default="12,16,34")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("riccati_large_phases: needs a CUDA device")
    root = os.path.abspath(args.root)
    copy = os.path.join(root, "build", "phases")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(root, PKG), os.path.join(copy, PKG),
                    ignore=shutil.ignore_patterns("__pycache__", "golden"))
    csrc = os.path.join(copy, PKG, "csrc")
    with open(os.path.join(csrc, "riccati_large.cuh")) as f:
        text = patch(f.read())
    with open(os.path.join(csrc, "riccati_large.cuh"), "w") as f:
        f.write(text)
    with open(os.path.join(csrc, "nu_large.cuh")) as f:
        text = f.read()
    # B2's kernel (both of its sweeps' calls)
    i, j = text.index("    riccati_large_kernel(RiccatiLargeArgs<T> x) {"), text.index("// B2 at a large nu")
    assert text.count("a.K, a.k, a.gvec);", i, j) >= 1
    text = text[:i] + text[i:j].replace("a.K, a.k, a.gvec);",
                                        "a.K, a.k, a.gvec, (float*)a.lN + 8);") + text[j:]
    b5 = "a.luual, a.glow != 0, a.K, a.k, a.gvec);\n}"
    assert b5 in text
    text = text.replace(b5, b5.replace("a.gvec);", "a.gvec, (float*)a.gvec);"), 1)
    with open(os.path.join(csrc, "nu_large.cuh"), "w") as f:
        f.write(text)
    with open(os.path.join(copy, PKG, "_build.py")) as f:
        text = f.read()
    libs = 'LIBS = (("linearize", "f32", "float")'
    assert libs in text
    text = text.replace(libs, 'LIBS = (("pipeline_nu", "f32", "float"),)\n_ALL = ' + libs[7:], 1)
    with open(os.path.join(copy, PKG, "_build.py"), "w") as f:
        f.write(text)

    sys.path.insert(0, copy)
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    dev, N, B = torch.device("cuda", 0), 200, 1024
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.build()
    fn = _build.function("pipeline_nu", "riccati_large", "f32", P._RICCATI_NU_ARGS)
    for nu in map(int, args.nus.split(",")):
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.nu_pu(nu), torch.float32, dev,
                                                        horizon=N)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, 0)
        solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
        s = kernel_check.kernel_inputs(solver, dyn, cost, q0s, xi0s,
                                       torch.zeros((B, N, nu), device=dev), kernel_gains=True)
        bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
        out = P._backward_kernel(fn, stream, *bargs, glow=True, luu_al=None, hand=True)
        torch.cuda.synchronize()
        cyc = dict(zip(PHASES, out[3][8:17].tolist()))
        cyc = {k: v for k, v in cyc.items() if k != "unused"}
        total = sum(cyc.values())
        print(json.dumps({"nu": nu, "card": torch.cuda.get_device_name(0),
                          "cycles_per_stage": cyc, "total": total,
                          "share": {k: v / total for k, v in cyc.items()}}), flush=True)


if __name__ == "__main__":
    main()
