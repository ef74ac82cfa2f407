#!/usr/bin/env python3
"""Time variants of the port's fp64 pipeline kernels (B2, B3, B4) against the
package's own, in one process on one card.  Prints one JSON line of ptxas
lines, then one JSON line per variant and model.

    python3 scripts/kernel_variants.py DIR [DIR ...]

Each DIR is a copy of the package's `csrc/` with some change (a design under
trial: its `pipeline.cu` and headers).  Every DIR's `pipeline.cu` is compiled
for fp64 with the package's nvcc flags, all at once, into DIR.so; its ptxas
lines (registers, stack frame, spills) are printed.  Then, on a real fp64
iterate at B = 16384, N = 200 of the screw-200 free body (nu = 6) and of
the drone (nu = 4, gravity), each variant's B2, B3 and B4 (the package's
wrappers with the variant's library in place of the package's
`pipeline_f64`) are timed by CUDA events (mean of 5 launches after one) and
compared with the plain versions (max relative error), in turns with the
package's own kernels (package, the variants, package), with the blocks an
SM holds of B2's and the rollout's kernels where the variant exports
`occupancy_f64`.  ~1 minute with the build.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench  # noqa: E402

B, N = 16384, 200
# the fp64 kernels whose ptxas lines are printed
F64 = ("riccati_f64_kernel", "rollout_f64_kernel", "terminal_kernel<double",
       "riccati_kernel<double", "rollout_kernel<double")


def compile_variants(dirs):
    """{variant: ptxas lines of its fp64 kernels}, each DIR/pipeline.cu built
    into DIR.so (the package's own libraries built meanwhile)."""
    nvcc = str(_build.nvcc_path())
    procs = {}
    for d in dirs:
        cmd = [nvcc, *_build.NVCC_FLAGS, "-DTRAOPT_SUFFIX=f64", "-DTRAOPT_SCALAR=double",
               "-I", str(d), "-o", f"{d}.so", str(d / "pipeline.cu")]
        procs[d] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    _build.build()
    keep = lambda rows: {k: v for k, v in rows.items() if any(n in k for n in F64)}
    ptxas = {"package": keep(_build.ptxas_report())}
    for d, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {d}:\n{out[-4000:]}")
        rows = _build.parse_ptxas(out)
        names = _build._demangle([n for n, _ in rows])
        ptxas[d.name] = keep(dict(zip(names, (r for _, r in rows))))
    return ptxas


def event_ms(fn, reps=5):
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA device")
    dirs = [Path(a).resolve() for a in sys.argv[1:]]
    t0 = time.perf_counter()
    ptxas = compile_variants(dirs)
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "build_s": time.perf_counter() - t0, "ptxas": ptxas}), flush=True)
    dev, f64 = torch.device("cuda", 0), torch.float64
    package = _build.library
    libs = {d.name: ctypes.CDLL(f"{d}.so") for d in dirs}

    def use(name):
        """The package's wrappers on the library of variant ``name``."""
        _build.library = package if name == "package" else (
            lambda unit, sfx: libs[name] if (unit, sfx) == ("pipeline", "f64")
            else package(unit, sfx))

    for kind in ("free_body", "drone"):
        drone = kind == "drone"
        dyn, cost, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
        if drone:
            dyn = dynamics.drone_params(dyn.J, dyn.dt)
            cost.R = 1e-2 * torch.eye(4, dtype=f64, device=dev)
        nu = cost.R.shape[0]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, 200)
        solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=drone,
                                  exact_gravity_jacobian=drone)
        use("package")
        s = kernel_check.kernel_inputs(solver, dyn, cost, q0s, xi0s,
                                       torch.zeros((B, N, nu), dtype=f64, device=dev),
                                       kernel_gains=True)
        calls = kernel_check.calls(s, dt=solver.dt, gravity=drone, exact_grav=drone)
        plain = {k: kernel_check._flat(calls[k][1]()) for k in ("B2", "B3", "B4")}
        for name in ["package", *libs, "package"]:
            use(name)
            row = {"variant": name, "model": kind, "nu": nu}
            for k in ("B2", "B3", "B4"):
                got = kernel_check._flat(calls[k][0]())
                row[f"{k}_max_rel_err"] = max(kernel_check.rel_err(a, b)
                                              for a, b in zip(got, plain[k]))
                row[f"{k}_ms"] = event_ms(calls[k][0])
            lib = package("pipeline", "f64") if name == "package" else libs[name]
            if hasattr(lib, "occupancy_f64"):
                occ = lib.occupancy_f64
                occ.argtypes = [ctypes.c_int] * 3
                row["blocks_per_sm"] = {"B2": occ(0, nu, 0), "rollout": occ(1, nu, 0)}
            print(json.dumps(row), flush=True)
        del s, calls, plain
    use("package")


if __name__ == "__main__":
    main()
