"""Native (C++) serial runtime: Lie core + SO(3)/SE(3) MS-iLQR executors
(counterpart of the JAX `native/` package).

`src/lie.hpp` (closed-form SO(3)/SE(3) ops) and `src/ilqr.cpp` (the whole
MS-iLQR hot loop in C++, one group-templated solver covering the SE(3)
free-body/gravity/drone and SO(3) free-attitude/pendulum families) are this
package's own copy of the JAX package's sources, exposed through ctypes (no
pybind11, no PyTorch headers).

Uses: an implementation-independent cross-check of the port's engines
(`FastBatchSolver`, `make_closed_loop`, `ALFastSolver` at f64), and the
deployable host MPC runtime (`NativeMPC`).  It runs on the host CPU by
design: it is not a device path, and no solver of the port falls back to
it.

The shared library is compiled with g++ at first use (the first read of
`LIB` or the first solver built) into ``build/native/`` at the repository
root, named by a hash of the sources, the flags and the host, so a changed
source rebuilds.  ``-fopenmp`` is tried first (multi-core batch fan-out),
then a serial build if libgomp is absent.  Without a toolchain, or when the
build fails, ``LIB`` is None and the solvers raise.  The solvers take
tensors (any device) or arrays, and return CPU float64 tensors.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "ilqr.cpp")
_HDR = os.path.join(_DIR, "src", "lie.hpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_UNSET = object()
_lib = _UNSET


def _lib_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode() + platform.node().encode())
    for f in (_SRC, _HDR):
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"traopt_native_{h.hexdigest()[:16]}.so")


def _build():
    """Compile the shared library unless this build of it exists."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = os.path.join(td, "lib.so")
        base = ["g++", *_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(base + ["-fopenmp"], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def _load():
    lib = ctypes.CDLL(_build())
    dp = ctypes.POINTER(ctypes.c_double)
    i, d = ctypes.c_int, ctypes.c_double
    sig = {
        "traopt_se3_ms_ilqr_solve": [dp, d, dp, dp, dp, dp, dp, i, i, dp, dp, dp, dp, dp],
        "traopt_se3_ms_ilqr_solve_batch": [dp, d, dp, dp, dp, dp, dp, i, i, i,
                                           dp, dp, dp, dp, dp],
        "traopt_rb_ms_ilqr_solve": [dp, d, d, dp, i, dp, dp, dp, dp, dp, i, i,
                                    dp, dp, dp, dp, dp],
        "traopt_rb_ms_ilqr_solve_batch": [dp, d, d, dp, i, dp, dp, dp, dp, dp, i, i, i,
                                          dp, dp, dp, dp, dp],
        "traopt_so3_ms_ilqr_solve": [dp, d, i, d, d, d, i, dp, dp, dp, dp, dp, i, i,
                                     dp, dp, dp, dp, dp],
        "traopt_so3_ms_ilqr_solve_batch": [dp, d, i, d, d, d, i, dp, dp, dp, dp, dp, i, i, i,
                                           dp, dp, dp, dp, dp],
        "traopt_rb_al_ms_ilqr_solve_batch": [dp, d, d, dp, i, dp, dp, dp, dp, dp, i, i,
                                             dp, dp, i, d, d, d, d, i,
                                             dp, dp, dp, dp, dp, dp, ctypes.POINTER(i)],
        "traopt_rb_step": [dp, d, d, dp, i, dp, dp, dp, dp, dp],
        "traopt_so3_step": [dp, d, i, d, d, d, dp, dp, dp, dp, dp],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def get_lib():
    """The loaded library (built now if needed), or None without a
    toolchain or when the build fails."""
    global _lib
    if _lib is _UNSET:
        try:
            _lib = _load()
        except Exception:  # toolchain or build failure: no native runtime
            _lib = None
    return _lib


def __getattr__(name):
    if name == "LIB":
        return get_lib()
    raise AttributeError(name)


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    return lib


def _c(a):
    """A tensor (any device) or array-like as a C-contiguous float64 array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _t(*arrays):
    """numpy results as CPU float64 tensors."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


class NativeSE3Solver:
    """Serial C++ MS-iLQR (fixed budget, mu = 0) on the SE(3) tracking
    families: free body (default), rigid body under gravity (``g > 0``),
    and the drone (``Pu`` 6x4 projection, nu = 4).

    Same iterate sequence as `solvers.batched.FastBatchSolver` at f64; see
    src/ilqr.cpp for the solver layout.
    """

    def __init__(self, J, dt, Q, R, P, q_ref, xi_ref, iterations: int,
                 g: float = 0.0, Pu=None):
        self.lib = _require()
        self.J = _c(J)
        self.dt = float(dt)
        self.Q = _c(Q)
        self.R = _c(R)
        self.P = _c(P)
        self.q_ref = _c(q_ref)
        self.xi_ref = _c(xi_ref).reshape(-1, 6)
        self.N = self.q_ref.shape[0] - 1
        self.iterations = iterations
        self.g = float(g)
        self.Pu = None if Pu is None else _c(Pu)
        self.nu = 6 if self.Pu is None else int(self.Pu.shape[1])
        if self.R.shape != (self.nu, self.nu):
            raise ValueError(f"R must be ({self.nu},{self.nu})")
        if self.Q.shape != (12, 12) or self.P.shape != (12, 12):
            raise ValueError("Q and P must be (12,12) (pose+velocity blocks)")

    def _pu_ptr(self):
        return None if self.Pu is None else _ptr(self.Pu)

    def _window(self, t, H):
        if t + H > self.N:
            raise ValueError(f"window [{t}, {t + H}] exceeds reference (N={self.N})")

    def solve(self, q0, xi0, us0=None):
        """One problem: returns (us, J, grad_norm)."""
        return self.solve_window(q0, xi0, 0, self.N, us0)

    def solve_window(self, q0, xi0, t, H, us0=None):
        """Solve over the (H+1)-entry reference window starting at step t
        (contiguous view, no copy) — the receding-horizon building block."""
        self._window(t, H)
        us = _c(us0).copy() if us0 is not None else np.zeros((H, self.nu))
        J_out = np.zeros(1)
        g_out = np.zeros(1)
        rc = self.lib.traopt_rb_ms_ilqr_solve(
            _ptr(self.J), self.dt, self.g, self._pu_ptr(), self.nu,
            _ptr(self.Q), _ptr(self.R), _ptr(self.P),
            _ptr(self.q_ref[t:]), _ptr(self.xi_ref[t:]), H, self.iterations,
            _ptr(_c(q0)), _ptr(_c(xi0)), _ptr(us), _ptr(J_out), _ptr(g_out))
        if rc:
            raise RuntimeError(f"native solve failed (rc={rc})")
        return _t(us), float(J_out[0]), float(g_out[0])

    def step(self, q, xi, u):
        """One plant step of this model family (4x4 pose in/out)."""
        q_out = np.zeros((4, 4))
        xi_out = np.zeros(6)
        self.lib.traopt_rb_step(_ptr(self.J), self.dt, self.g, self._pu_ptr(), self.nu,
                                _ptr(_c(q)), _ptr(_c(xi)), _ptr(_c(u)),
                                _ptr(q_out), _ptr(xi_out))
        return _t(q_out, xi_out)

    def solve_al(self, q0s, xi0s, lb, ub, us0=None, n_al_iters=10,
                 mu0=1e-2, mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        """Input-constrained batch solve (lb <= u <= ub, elementwise).

        Augmented-Lagrangian outer loop entirely in C (the native twin of
        `solvers.al_fast.ALFastSolver`, ref AL_iLQR_Tracking_SE3_MS).
        Returns (us (B,N,nu), J (B,), grad (B,), max_violation (B,),
        outer_iterations).
        """
        return self.solve_al_window(q0s, xi0s, lb, ub, 0, self.N, us0,
                                    n_al_iters, mu0, mu_scale, mu_max, tol_constr)

    def solve_al_window(self, q0s, xi0s, lb, ub, t, H, us0=None,
                        n_al_iters=10, mu0=1e-2, mu_scale=10.0, mu_max=1e8,
                        tol_constr=1e-2):
        """Constrained solve over the (H+1)-entry window starting at step t."""
        self._window(t, H)
        q0s = _c(q0s)
        B = q0s.shape[0]
        lb = np.broadcast_to(_c(lb), (self.nu,)).copy()
        ub = np.broadcast_to(_c(ub), (self.nu,)).copy()
        us = _c(us0).copy() if us0 is not None else np.zeros((B, H, self.nu))
        J_out = np.zeros(B)
        g_out = np.zeros(B)
        maxv = np.zeros(B)
        outer = ctypes.c_int(0)
        rc = self.lib.traopt_rb_al_ms_ilqr_solve_batch(
            _ptr(self.J), self.dt, self.g, self._pu_ptr(), self.nu,
            _ptr(self.Q), _ptr(self.R), _ptr(self.P),
            _ptr(self.q_ref[t:]), _ptr(self.xi_ref[t:]), H, self.iterations,
            _ptr(lb), _ptr(ub), int(n_al_iters), float(mu0), float(mu_scale),
            float(mu_max), float(tol_constr), B,
            _ptr(q0s), _ptr(_c(xi0s)), _ptr(us), _ptr(J_out), _ptr(g_out),
            _ptr(maxv), ctypes.byref(outer))
        if rc:
            raise RuntimeError(f"native AL solve failed (rc={rc})")
        return (*_t(us, J_out, g_out, maxv), int(outer.value))

    def solve_batch(self, q0s, xi0s, us0=None):
        """B independent problems: returns (us (B,N,nu), J (B,), grad (B,))."""
        q0s = _c(q0s)
        B = q0s.shape[0]
        us = _c(us0).copy() if us0 is not None else np.zeros((B, self.N, self.nu))
        J_out = np.zeros(B)
        g_out = np.zeros(B)
        rc = self.lib.traopt_rb_ms_ilqr_solve_batch(
            _ptr(self.J), self.dt, self.g, self._pu_ptr(), self.nu,
            _ptr(self.Q), _ptr(self.R), _ptr(self.P),
            _ptr(self.q_ref), _ptr(self.xi_ref), self.N, self.iterations, B,
            _ptr(q0s), _ptr(_c(xi0s)), _ptr(us), _ptr(J_out), _ptr(g_out))
        if rc:
            raise RuntimeError(f"native batch solve failed (rc={rc})")
        return _t(us, J_out, g_out)


class NativeSO3Solver:
    """Serial C++ MS-iLQR (fixed budget, mu = 0) on the SO(3) attitude
    families: free attitude body (default) and the pivot-actuated 3-D
    pendulum (``pendulum=True`` with mass/rod-length/gravity).

    Same iterate sequence as `solvers.batched.FastBatchSolver` at f64 with
    the SO(3) models; ``term_quirk`` replicates the reference SO(3) cost
    class's terminal Q/P inconsistency (see `models/costs.tracking_cost`),
    which the parity builders enable for all SO(3)-family problems.
    """

    def __init__(self, J, dt, Q, R, P, q_ref, xi_ref, iterations: int,
                 pendulum: bool = False, m: float = 0.0, length: float = 0.0,
                 g: float = 9.8, term_quirk: bool = True):
        self.lib = _require()
        self.J = _c(J)
        self.dt = float(dt)
        self.Q = _c(Q)
        self.R = _c(R)
        self.P = _c(P)
        self.q_ref = _c(q_ref)
        self.xi_ref = _c(xi_ref).reshape(-1, 3)
        self.N = self.q_ref.shape[0] - 1
        self.iterations = iterations
        self.pendulum = bool(pendulum)
        self.m = float(m)
        self.length = float(length)
        self.g = float(g)
        self.term_quirk = bool(term_quirk)
        self.nu = 3
        if self.J.shape != (3, 3):
            raise ValueError("J must be (3,3)")
        if self.R.shape != (3, 3):
            raise ValueError("R must be (3,3)")
        if self.Q.shape != (6, 6) or self.P.shape != (6, 6):
            raise ValueError("Q and P must be (6,6) (pose+velocity blocks)")
        if self.q_ref.shape[1:] != (3, 3):
            raise ValueError("q_ref must be (N+1,3,3)")

    def _model(self):
        return (_ptr(self.J), self.dt, int(self.pendulum), self.m, self.length,
                self.g, int(self.term_quirk))

    def solve(self, q0, xi0, us0=None):
        """One problem: returns (us, J, grad_norm)."""
        return self.solve_window(q0, xi0, 0, self.N, us0)

    def solve_window(self, q0, xi0, t, H, us0=None):
        """Solve over the (H+1)-entry reference window starting at step t."""
        if t + H > self.N:
            raise ValueError(f"window [{t}, {t + H}] exceeds reference (N={self.N})")
        us = _c(us0).copy() if us0 is not None else np.zeros((H, 3))
        J_out = np.zeros(1)
        g_out = np.zeros(1)
        rc = self.lib.traopt_so3_ms_ilqr_solve(
            *self._model(), _ptr(self.Q), _ptr(self.R), _ptr(self.P),
            _ptr(self.q_ref[t:]), _ptr(self.xi_ref[t:]), H, self.iterations,
            _ptr(_c(q0)), _ptr(_c(xi0)), _ptr(us), _ptr(J_out), _ptr(g_out))
        if rc:
            raise RuntimeError(f"native SO3 solve failed (rc={rc})")
        return _t(us), float(J_out[0]), float(g_out[0])

    def step(self, q, xi, u):
        """One plant step of this model family (3x3 rotation in/out)."""
        q_out = np.zeros((3, 3))
        xi_out = np.zeros(3)
        self.lib.traopt_so3_step(_ptr(self.J), self.dt, int(self.pendulum), self.m,
                                 self.length, self.g, _ptr(_c(q)), _ptr(_c(xi)),
                                 _ptr(_c(u)), _ptr(q_out), _ptr(xi_out))
        return _t(q_out, xi_out)

    def solve_batch(self, q0s, xi0s, us0=None):
        """B independent problems: returns (us (B,N,3), J (B,), grad (B,))."""
        q0s = _c(q0s)
        B = q0s.shape[0]
        us = _c(us0).copy() if us0 is not None else np.zeros((B, self.N, 3))
        J_out = np.zeros(B)
        g_out = np.zeros(B)
        rc = self.lib.traopt_so3_ms_ilqr_solve_batch(
            *self._model(), _ptr(self.Q), _ptr(self.R), _ptr(self.P),
            _ptr(self.q_ref), _ptr(self.xi_ref), self.N, self.iterations, B,
            _ptr(q0s), _ptr(_c(xi0s)), _ptr(us), _ptr(J_out), _ptr(g_out))
        if rc:
            raise RuntimeError(f"native SO3 batch solve failed (rc={rc})")
        return _t(us, J_out, g_out)


class NativeMPC:
    """Receding-horizon closed loop on the native executor.

    Same per-step semantics as `solvers/mpc.make_closed_loop` (window
    slice -> warm-started fixed-budget solve -> apply u0 -> shift), but
    running entirely on the host CPU — the deployable MPC runtime with no
    device in the loop.  The solver must be built on the FULL reference
    path; each plant step solves the H-window starting at that step
    (zero-copy contiguous views).
    """

    def __init__(self, solver, H: int, lb=None, ub=None, n_al_iters=8,
                 mu0=1e-2, tol_constr=1e-2):
        """With `lb`/`ub` set, every window solve runs the AL input-box
        outer loop (SE(3)-family solvers only) — constrained embedded MPC."""
        if solver.N < H + 1:
            raise ValueError("reference shorter than one MPC window")
        if (lb is None) != (ub is None):
            raise ValueError("set both lb and ub or neither")
        if lb is not None and not isinstance(solver, NativeSE3Solver):
            raise ValueError("input constraints: SE(3)-family solvers only")
        self.solver = solver
        self.H = H
        self.lb = None if lb is None else _c(lb)
        self.ub = None if ub is None else _c(ub)
        self.n_al_iters = n_al_iters
        self.mu0 = mu0
        self.tol_constr = tol_constr

    def run(self, q0, xi0, T: int):
        """T closed-loop plant steps; returns (qs, xis, us, J_pred) as CPU
        float64 tensors."""
        s, H = self.solver, self.H
        if T + H > s.N:
            raise ValueError(f"T={T} needs reference N >= {T + H}, have {s.N}")
        q, xi = _c(q0), _c(xi0)
        us_warm = np.zeros((H, s.nu))
        qs, xis, us_applied, J_pred = [q], [xi], [], []
        for t in range(T):
            if self.lb is not None:
                us_b, J_b, _, _, _ = s.solve_al_window(
                    q[None], xi[None], self.lb, self.ub, t, H, us_warm[None],
                    n_al_iters=self.n_al_iters, mu0=self.mu0,
                    tol_constr=self.tol_constr)
                us, J = us_b[0].numpy(), float(J_b[0])
            else:
                us, J, _ = s.solve_window(q, xi, t, H, us_warm)
                us = us.numpy()
            u0 = us[0]
            if self.lb is not None:
                # actuator saturation: never command outside the box even
                # when the AL budget did not fully converge this window
                u0 = np.clip(u0, self.lb, self.ub)
            q, xi = (x.numpy() for x in s.step(q, xi, u0))
            us_warm = np.concatenate([us[1:], us[-1:]], axis=0)
            qs.append(q)
            xis.append(xi)
            us_applied.append(u0)
            J_pred.append(J)
        return _t(np.stack(qs), np.stack(xis), np.stack(us_applied), np.asarray(J_pred))
