"""The host rehearsal of the port's CUDA units: a unit of `csrc/` compiled by
the host C++ compiler against `tests/cuda_host/cuda_runtime.h`, where every
thread of a block is an OS thread and ``__syncthreads``/``__syncwarp`` are
real barriers, so a kernel that exchanges through shared memory between
barriers (B2, B5) runs its own code on CPU tensors.

Two rewrites make a unit and the headers it includes host code: ``kernel<<<grid, block, bytes,
stream>>>(args)`` becomes ``traopt_emu::launch(kernel, grid, block, bytes,
args)`` and ``extern __shared__ ... smem[]`` the block's buffer.  No FMA
contraction on the host and the host's libm: the results agree with the
card's to rounding, not bit for bit.  The unit's C entry points take host
pointers (CPU tensors) in place of device pointers.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "trajectory_optimization_matrix_lie_groups_tpu_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_host"


def compiler():
    """The host C++ compiler (g++ or c++ on PATH), or None."""
    return shutil.which("g++") or shutil.which("c++")


def _split_top(s):
    """``s`` split at the commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def host_source(src):
    """A `csrc` unit's text rewritten for the host rehearsal."""
    src = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                 r"unsigned char* \1 = traopt_emu::smem();", src)

    def launch(m):
        grid, block, nbytes, _stream = _split_top(m.group(2))
        return f"traopt_emu::launch({m.group(1)}, {grid}, {block}, {nbytes}, {m.group(3)});"

    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.+?)>>>\((.*?)\);", launch, src, flags=re.S)


def build(unit, suffix, scalar, out_dir):
    """Start compiling ``unit`` (with -DTRAOPT_SUFFIX / -DTRAOPT_SCALAR as
    `_build.LIBS` names them) into ``out_dir``; returns (library path,
    process).  The headers of `csrc` are rewritten too (kernels and launches
    live in some of them), once per ``out_dir``, into its ``include``."""
    out_dir = Path(out_dir)
    inc = out_dir / "include"
    inc.mkdir(exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        if not (inc / h.name).is_file():
            tmp = inc / f"{h.name}.tmp"
            tmp.write_text(host_source(h.read_text()))
            tmp.replace(inc / h.name)
    cpp = out_dir / f"{unit}_{suffix}.cpp"
    cpp.write_text(host_source((CSRC / f"{unit}.cu").read_text()))
    lib = out_dir / f"{unit}_{suffix}.so"
    defs = ([f"-DTRAOPT_SUFFIX={suffix}", f"-DTRAOPT_MAX_NU={_build.MAX_NU}"]
            + ([f"-DTRAOPT_SCALAR={scalar}"] if scalar else []))
    cmd = [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
           "-I", str(STUB), "-I", str(inc), *defs, "-o", str(lib), str(cpp)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def function(lib, name, argtypes):
    """The C entry point ``name`` of a built library, its arguments typed as
    the wrappers declare them."""
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
