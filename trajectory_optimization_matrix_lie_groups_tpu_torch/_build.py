"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` unit is compiled by ``nvcc`` for ``sm_90a`` twice, once per
scalar type (``-DTRAOPT_SCALAR=float`` / ``double``), into a shared library
with a plain C interface that is loaded with `ctypes` (no PyTorch headers,
so a build takes seconds to minutes, not tens of minutes).  The libraries go
to ``build/torch_kernels/`` beside the package, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads.
All four libraries are compiled concurrently at first use.

No ``--use_fast_math``: the Taylor guards on theta^2 < 1e-8 and the
small-angle sin/cos need IEEE division, square root and full-precision
trigonometry.  ``-Xptxas -v`` is kept; its report (registers, spills) is
written beside each library and parsed by `ptxas_report`.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
UNITS = ("linearize", "pipeline")
SCALARS = {"f32": "float", "f64": "double"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "this package are built at first use on a machine "
                       "with the CUDA toolkit")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(unit, sfx):
    return BUILD_DIR / f"{unit}_{sfx}_{_digest()}.so"


def build():
    """Compile every (unit, scalar) library that is not built yet, all at
    once.  Returns the seconds spent (0.0 when everything was cached)."""
    todo = [(u, s) for u in UNITS for s in SCALARS
            if not _lib_path(u, s).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(nvcc_path())
    t0 = time.perf_counter()
    procs = []
    for unit, sfx in todo:
        final = _lib_path(unit, sfx)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-DTRAOPT_SCALAR={SCALARS[sfx]}",
               f"-DTRAOPT_SUFFIX={sfx}", "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{unit}.cu")]
        procs.append((final, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for final, tmp, cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out}")
            continue
        final.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, final)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(unit, dtype_suffix):
    """The loaded ctypes library of ``unit`` ("linearize" / "pipeline") for
    ``dtype_suffix`` ("f32" / "f64"), built first if needed."""
    build()
    return ctypes.CDLL(str(_lib_path(unit, dtype_suffix)))


PTR, INT, DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def function(unit, name, dtype_suffix, argtypes):
    """The C entry point ``{name}_{dtype_suffix}`` of ``unit``, with its
    argument types declared (pointers and the stream as c_void_p)."""
    fn = getattr(library(unit, dtype_suffix), f"{name}_{dtype_suffix}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def suffix(dtype):
    """"f32" / "f64" for the kernels' scalar type; TypeError otherwise."""
    import torch

    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")


def arg(t, shape, like, name):
    """``t``'s data pointer (a ctypes.c_void_p) after checking that it is a
    contiguous tensor of ``shape`` with ``like``'s dtype and device."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{like.dtype} on {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return ctypes.c_void_p(t.data_ptr())


def device_index(t):
    """The CUDA device ordinal the kernel launches on (0 for host tensors)."""
    return t.device.index or 0


def check(err, kernel):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def _demangle(names):
    try:
        tool = nvcc_path().parent / "cu++filt"
    except RuntimeError:  # no toolkit here: keep the mangled names
        return names
    if not names or not tool.is_file():
        return names
    out = subprocess.run([str(tool)], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return out.splitlines()


def parse_ptxas(text):
    """[(mangled entry name, {registers, stack_frame, spill_stores,
    spill_loads})] from one ``-Xptxas -v`` log.  A "Function properties"
    block counts only for the entry it names: ptxas also reports device
    helpers (e.g. the double-precision trig reduction) after an entry."""
    rows = []
    cur = None
    props_of = None  # the function the next "stack frame" line is of
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = (m.group(1), {})
            rows.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props_of = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and cur is not None and props_of == cur[0]:
            cur[1].update(stack_frame=int(m.group(1)),
                          spill_stores=int(m.group(2)),
                          spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[1]["registers"] = int(m.group(1))
    return rows


def ptxas_report():
    """{kernel: {registers, stack_frame, spill_stores, spill_loads}} in
    bytes, parsed from the ``-Xptxas -v`` output of every built library."""
    rows = []
    for unit in UNITS:
        for sfx in SCALARS:
            log = _lib_path(unit, sfx).with_suffix(".ptxas.txt")
            if log.is_file():
                rows += parse_ptxas(log.read_text())
    names = _demangle([name for name, _ in rows])
    return dict(zip(names, [r for _, r in rows]))
