"""Build and load the port's CUDA kernels.

Each library of `LIBS` is one `csrc/*.cu` unit compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface that is loaded
with `ctypes` (no PyTorch headers, so a build takes seconds to minutes, not
tens of minutes).  ``linearize`` and ``pipeline`` are built once per scalar
type (``-DTRAOPT_SCALAR=float`` / ``double``, suffixes ``f32`` / ``f64``),
and so are ``so3`` (the SO(3)-family pipeline) and ``fast`` (the generic
fast tier's Riccati backward and rollout);
``polish`` mixes f32 and fp64 by design and is built once, under the suffix
``mx``; ``pipeline_nu`` (per scalar) and ``polish_nu`` (``mx``) hold the
instances of B1-B6 at the input dimensions the tuned ones do not take (up
to `MAX_NU`, which every unit gets as ``-DTRAOPT_MAX_NU``).
The libraries go to ``build/torch_kernels/`` beside the package, named
``{unit}_{suffix}_{hash}.so`` by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads.  All libraries are
compiled concurrently at first use.

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
# (unit, library suffix, -DTRAOPT_SCALAR or None)
LIBS = (("linearize", "f32", "float"), ("linearize", "f64", "double"),
        ("pipeline", "f32", "float"), ("pipeline", "f64", "double"),
        ("polish", "mx", None), ("so3", "f32", "float"), ("so3", "f64", "double"),
        ("fast", "f32", "float"), ("fast", "f64", "double"),
        ("pipeline_nu", "f32", "float"), ("pipeline_nu", "f64", "double"),
        ("polish_nu", "mx", None))
# The input dimensions of B1-B6: their tuned instances (linearize, pipeline,
# polish) take TUNED_NU; their runtime-nu instances (pipeline_nu: B1-B4,
# polish_nu: B5 and B6) every nu from 1 to MU_MAX_NU (csrc/nu.cuh), and
# their large-nu instances every nu from MU_MAX_NU + 1 to MAX_NU
# (csrc/nu_large.cuh).
TUNED_NU, MU_MAX_NU = (6, 4), 12
# An H100's shared memory for one block (csrc/group.cuh kSmemPerBlock).
SMEM_PER_BLOCK = 232448


def _pitch(size, ne):
    """csrc/group.cuh pitch: a row of at least ne elements of ``size``
    bytes, 20 banks (mod 32) from the next."""
    p = ne
    while (p * (size // 4)) % 32 != 20:
        p += 1
    return p


def _align16(n):
    return (n + 15) // 16 * 16


def _group_stride(n):
    s = _align16(n)
    while s % 128 != 80:
        s += 16
    return s


def _vpad(n, size):
    """csrc/group.cuh vpad: n rounded up to whole 16-byte vectors."""
    v = 16 // size
    return (n + v - 1) // v * v


def riccati_large_bytes(nu, tp, tr):
    """The shared memory of a block of the large-nu Riccati kernel (B2 in
    f32: element sizes ``tp`` = ``tr`` = 4; B5: 4, 8; fp64 B2: 8, 8) at
    ``nu``: csrc/riccati_large.cuh's LargeLayout with 8 problems a block (4
    in fp64), which the build checks against this count."""
    P, w = (4 if tp == 8 else 8), nu | 1
    stage = P * ((_pitch(tr, 144) + 2 * _pitch(tr, 12) + _pitch(tr, nu)) * tr
                 + (_pitch(tp, 144) + _pitch(tp, nu)) * tp)
    out = (_align16(12 * nu * (P + 1) * tp) + _align16(nu * (P + 1) * tp)
           + _align16(nu * (P + 1) * tr))
    # V_m, Q_u; V_xx; K^T Q_uu and Q_ux (nu-major); K (13 a row); Q_uu; its
    # lower triangle; F in Tp (mixed)
    group = (_align16(12 * tr) + _align16(nu * tr) + 144 * tp + 2 * _align16(12 * nu * tp)
             + nu * _vpad(13, tp) * tp + _align16(nu * w * tp)
             + _align16(nu * (nu + 1) // 2 * tp) + (144 * tp if tp != tr else 0))
    consts = _align16(6 * w * tp) + _align16(6 * w * tr) + _align16(nu * w * tp)
    return consts + 2 * stage + 2 * out + P * _group_stride(group)


# The largest nu that B1-B6 take, and B13's large-nu instance with them
# (csrc/fast_large.cuh).  The large-nu Riccati layout fits one block in
# every scalar up to nu = 39; no problem of the port needs more than 24.
# Every unit gets it as -DTRAOPT_MAX_NU; csrc/nu_large.cuh checks that it
# fits.
MAX_NU = 34
assert all(riccati_large_bytes(MAX_NU, *k) <= SMEM_PER_BLOCK for k in ((4, 4), (4, 8), (8, 8)))

# An H100 SM's shared memory, and what CUDA reserves of it for each
# resident block (csrc/fast_large.cuh kSmemPerSM, kSmemPerBlockReserved).
SMEM_PER_SM, SMEM_BLOCK_RESERVED = 233472, 1024
# The problems a block of B13's large-nu instance may hold.
FAST_LARGE_PROBLEMS = (8, 4, 2)


def _spread_pitch(size, ne):
    """csrc/group.cuh spread_pitch: whole 16-byte vectors, an odd number of
    4-bank groups."""
    p = ne
    while (p * (size // 4)) % 8 != 4:
        p += 1
    return p


def fast_large_bytes(nx, nu, tp, problems):
    """The shared memory of a block of B13's large-nu instance at (nx, nu)
    with elements of ``tp`` bytes and ``problems`` problems a block:
    csrc/fast_large.cuh's FastLargeLayout (two stage buffers, each input at
    12 for nx; two output buffers; a scratch a group), which the host
    rehearsal checks against this count."""
    P, w = problems, nu | 1
    regions = (144, 12 * w, 12, 12, nu, 144, 12 * nu, nu * w)
    stage = P * sum(_spread_pitch(tp, n) for n in regions)
    out = _vpad((nu * nx + nu + nx + nx * nx) * (P + 1), tp)
    # V_m, Q_u; V_xx; K^T Q_uu and Q_ux (nu-major); [K | k] (13 a row);
    # Q_uu; its lower triangle
    group = (12 + _vpad(nu, tp) + 144 + 24 * nu + nu * _vpad(13, tp)
             + _vpad(nu * w, tp) + _vpad(nu * (nu + 1) // 2, tp))
    return (2 * stage + 2 * out) * tp + P * _group_stride(group * tp)


def fast_large_problems(nx, nu, tp):
    """The problems a block of B13's large-nu instance holds at (nx, nu)
    with elements of ``tp`` bytes (csrc/fast_large.cuh
    fast_large_problems): of `FAST_LARGE_PROBLEMS`, the one whose blocks
    fit the most problems on an SM at once (the larger on a tie), or None
    if no block fits."""
    best, pick = 0, None
    for P in FAST_LARGE_PROBLEMS:
        b = fast_large_bytes(nx, nu, tp, P)
        n = P * (SMEM_PER_SM // (b + SMEM_BLOCK_RESERVED))
        if b <= SMEM_PER_BLOCK and n > best:
            best, pick = n, P
    return pick


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
              f"-DTRAOPT_MAX_NU={MAX_NU}")


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
    """Compile every library of `LIBS` that is not built yet, all at once.
    Returns the seconds spent (0.0 when everything was cached)."""
    todo = [lib for lib in LIBS if not _lib_path(*lib[:2]).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(nvcc_path())
    t0 = time.perf_counter()
    procs = []
    for unit, sfx, scalar in todo:
        final = _lib_path(unit, sfx)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        defs = [f"-DTRAOPT_SUFFIX={sfx}"] + ([f"-DTRAOPT_SCALAR={scalar}"]
                                             if scalar else [])
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-I", str(CSRC), "-o", str(tmp),
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
    """The loaded ctypes library of ``unit`` with suffix ``dtype_suffix``
    (an entry of `LIBS`), built first if needed."""
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


def arg(t, shape, like, name, dtype=None):
    """``t``'s data pointer (a ctypes.c_void_p) after checking that it is a
    contiguous tensor of ``shape`` on ``like``'s device with ``dtype``
    (default: ``like``'s)."""
    dtype = like.dtype if dtype is None else dtype
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{dtype} on {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return ctypes.c_void_p(t.data_ptr())


def device_index(t):
    """The CUDA device ordinal the kernel launches on (0 for host tensors)."""
    return t.device.index or 0


def check_nu(kernel, nu):
    """Raise ValueError, before any launch, for an input dimension ``nu``
    that no instance of B1-B6 takes."""
    if not 1 <= nu <= MAX_NU:
        raise ValueError(f"{kernel}: no kernel for nu = {nu}: the kernels take nu in "
                         f"1..{MAX_NU}")


def nu_counter(wrapper, nu):
    """What counts a launch of the instance of B1-B6 at ``nu``: the tuned
    one's wrapper itself, the runtime-nu one's ``wrapper.nu`` or the
    large-nu one's ``wrapper.nuL``."""
    if nu in TUNED_NU:
        return wrapper
    return wrapper.nu if nu <= MU_MAX_NU else wrapper.nuL


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
    for unit, sfx, _ in LIBS:
        log = _lib_path(unit, sfx).with_suffix(".ptxas.txt")
        if log.is_file():
            rows += parse_ptxas(log.read_text())
    names = _demangle([name for name, _ in rows])
    return dict(zip(names, [r for _, r in rows]))
