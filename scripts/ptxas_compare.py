#!/usr/bin/env python3
"""Build the CUDA kernels of two checkouts of the PyTorch port, one after
the other, and compare their ptxas reports.  Prints one JSON line.

    python3 scripts/ptxas_compare.py --parent DIR [--change DIR]

For each checkout (``--change`` defaults to the one this script lies in):
the first-run build's wall seconds (`_build.build()` into an empty
``build/torch_kernels/``, every library of its `_build.LIBS` compiled at
once, as at first use); then, for each library the parent has, whether the
``-Xptxas -v`` report of the change's library of the same name is the same
text line for line (but the "Compile time" lines, which vary from run to
run), and the entry functions whose lines differ, with both reports'
lines; and the
change's entry functions that the parent's libraries lack (registers,
stack frame, spill stores and loads, from `_build.parse_ptxas`).  Each
build runs in a process of its own (a package is imported from its root).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

BUILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
t0 = time.perf_counter()
_build.build()
logs = {{f"{{u}}_{{s}}": _build._lib_path(u, s).with_suffix(".ptxas.txt").read_text()
         for u, s, _ in _build.LIBS}}
print(json.dumps({{"wall_s": time.perf_counter() - t0, "logs": logs}}))
"""


def build(root):
    """(wall seconds, {library: ptxas log}) of a fresh build of ``root``."""
    shutil.rmtree(os.path.join(root, "build", "torch_kernels"), ignore_errors=True)
    out = subprocess.run([sys.executable, "-c", BUILD.format(root=root)], check=True,
                         capture_output=True, text=True).stdout
    r = json.loads(out.strip().splitlines()[-1])
    return r["wall_s"], r["logs"]


def lines(log):
    """A ptxas log's lines but its "Compile time" ones, which vary run to
    run."""
    return [line for line in log.splitlines() if "Compile time" not in line]


def entries(log):
    """{mangled entry: the lines of its report} of one ptxas log."""
    out, cur = {}, None
    for line in lines(log):
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = []
        if cur is not None:
            out[cur].append(line)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                     ".."))
    a = ap.parse_args()
    parent, change = os.path.abspath(a.parent), os.path.abspath(a.change)
    t0 = time.perf_counter()
    p_wall, p_logs = build(parent)
    c_wall, c_logs = build(change)
    sys.path.insert(0, change)
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    same, differ = {}, {}
    for lib, log in p_logs.items():
        same[lib] = lines(c_logs.get(lib, "")) == lines(log)
        pe, ce = entries(log), entries(c_logs.get(lib, ""))
        bad = sorted(k for k in pe if pe[k] != ce.get(k))
        if bad:
            differ[lib] = {k: {"parent": pe[k], "change": ce.get(k)} for k in bad}
    old = {k for log in p_logs.values() for k in entries(log)}
    new = {}
    for lib, log in c_logs.items():
        for name, row in _build.parse_ptxas(log):
            if name not in old:
                new[name] = {"library": lib, **row}
    names = dict(zip(new, _build._demangle(list(new))))
    print(json.dumps({"parent_build_wall_s": p_wall, "change_build_wall_s": c_wall,
                      "parent_libraries": len(p_logs), "change_libraries": len(c_logs),
                      "parent_logs_identical": same, "entries_that_differ": differ,
                      "new_entries": {names[k]: v for k, v in new.items()},
                      "total_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
