"""Input-box constrained solves on the lane-layout pipeline (counterpart of
the JAX `solvers/al_pipeline.py`).

`ALPipelineSolver` runs the augmented-Lagrangian outer loop around the
port's `PipelineSolver`: the AL u-gradient enters the plain glue that forms
lu between the kernels, and the penalty's diagonal Q_uu addition is B2's
``luu_al`` input.  Multipliers are per problem, inner solves restart from
the caller's ``us0`` each outer iteration (ref traopt_controller.py:3237),
and the update is the reference's first-order ascent with the active-set
penalty rebuild (traopt_controller.py:3270-3290) in the diagonal-Imu form
(`models.costs.al_update_diag`).  The outer state (lmbd, imu, mu) is kept
in float64, as the JAX package keeps it under x64; the pipeline rounds it
to the solve's dtype on entry.

`al_polish` and `al_polish_device` refine a constrained f32 solve with the
mixed-precision polish (`solvers/df_mixed.MixedDFPipelineSolver`, kernels
B5-B9) at fixed multipliers, each followed by a dual ascent: in float64 on
the host, or in f32 on the device.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.costs import (
    al_update_diag,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
    solve_device,
)

F32, F64 = torch.float32, torch.float64


class ALPipelineResult(NamedTuple):
    qs: torch.Tensor            # (B, N+1, 4, 4)
    xis: torch.Tensor           # (B, N+1, 6)
    us: torch.Tensor            # (B, N, nu)
    J_opt: torch.Tensor         # (B,) augmented cost at last linearization
    lmbd: torch.Tensor          # (B, N+1, 2nu) final multipliers
    max_violation: torch.Tensor  # (B,)
    outer_iterations: int
    constr_converged: bool
    imu: torch.Tensor = None    # (B, N+1, 2nu) final active-set penalties --
    #   with lmbd, the fixed-multiplier state a polish needs
    #   (MixedDFPipelineSolver.solve(..., al=(lb, ub, lmbd, imu)))


class ALPipelineSolver:
    """AL outer loop around a `PipelineSolver` (input box lb <= u <= ub)."""

    def __init__(self, pipe: PipelineSolver, lb, ub, mu0=1e-2, mu_scale=10.0,
                 mu_max=1e8, tol_constr=1e-2):
        self.pipe = pipe
        # scalar or (nu,); broadcast at solve time when nu is known
        self.lb = np.asarray(lb, np.float64)
        self.ub = np.asarray(ub, np.float64)
        self.mu0 = mu0
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr
        self._warm = None

    def _bounds(self, nu, device):
        box = lambda b: torch.as_tensor(b, dtype=F64, device=device).broadcast_to((nu,))
        return box(self.lb), box(self.ub)

    def _violation(self, us):
        """(max violation (B,), g (B, N, 2nu)) of the controls; float64 as
        the bounds."""
        lb, ub = self._bounds(us.shape[-1], us.device)
        g = torch.cat([lb - us, us - ub], dim=-1)
        # terminal g = 0 (models/constraints.py) -> max is >= 0
        return torch.clamp(torch.amax(g, dim=(1, 2)), min=0.0), g

    def _warm_pipe(self, warm_iters):
        """A clone of the inner pipeline with a shorter iteration budget for
        warm-started outers; every constructor argument is the inner's."""
        if self._warm is None or self._warm.iterations != warm_iters:
            p = self.pipe
            self._warm = PipelineSolver(
                N=p.N, iterations=warm_iters, dt=p.dt, gravity=p.gravity,
                exact_gravity_jacobian=p.exact_grav, fused=p.fused,
                plain=p.plain)
        return self._warm

    def solve(self, dyn, cost, q0s, xi0s, us0, n_al_iters=10, warm_start=False,
              warm_iters=4):
        """Arguments as `PipelineSolver.solve`.  Returns an
        `ALPipelineResult`.

        ``warm_start``: opt-in perf mode -- outer iterations after the first
        start the inner solve from the previous outer's solution with a
        ``warm_iters`` inner budget, instead of the reference's
        restart-from-``us0`` full budget (traopt_controller.py:3237).  Under
        near-flat input directions (R ~ 1e-5 with a wide box) the
        constrained problem is degenerate and the warm path may settle on a
        different near-optimal control sequence than the cold path; use the
        default cold mode when reproducibility matters."""
        if n_al_iters < 1:
            raise ValueError("n_al_iters must be >= 1")
        us0 = torch.as_tensor(us0, device=solve_device(us0))
        B, N, nu = us0.shape
        C = 2 * nu
        dev = us0.device
        lb, ub = self._bounds(nu, dev)
        lmbd = torch.zeros((B, N + 1, C), dtype=F64, device=dev)
        imu = torch.full((B, N + 1, C), self.mu0, dtype=F64, device=dev)
        mu = torch.full((B,), self.mu0, dtype=F64, device=dev)
        st = maxv = None
        converged = False
        outer = 0
        us_in = us0
        for outer in range(n_al_iters):
            pipe = (self.pipe if (outer == 0 or not warm_start)
                    else self._warm_pipe(warm_iters))
            st = pipe.solve(dyn, cost, q0s, xi0s, us_in, al=(lb, ub, lmbd, imu))
            if warm_start:
                us_in = st.us
            maxv, g_stage = self._violation(st.us)
            converged = bool(maxv.max() < self.tol_constr)
            if converged:
                break
            # first-order ascent + active-set rebuild with per-problem
            # freeze; terminal g = 0 appended (costs.al_update_diag)
            g = torch.cat([g_stage, torch.zeros_like(g_stage[:, :1])], dim=1)
            lmbd, imu, mu = al_update_diag(lmbd, imu, mu, g, self.mu_scale,
                                           self.mu_max,
                                           freeze=maxv < self.tol_constr)
        return ALPipelineResult(
            qs=st.qs, xis=st.xis, us=st.us, J_opt=st.J_opt, lmbd=lmbd,
            max_violation=maxv, outer_iterations=outer + 1,
            constr_converged=converged, imu=imu)


def _check_outers(res, n_outers, name):
    if n_outers < 1:
        raise ValueError("n_outers must be >= 1")
    if res.imu is None:
        raise ValueError(
            f"res.imu is None: {name} needs the active-set penalties from an "
            "ALPipelineSolver.solve result (imu field); results built without "
            "it cannot seed the fixed-multiplier polish")


def al_polish(mx, params64, lb, ub, res, q0s, xi0s, n_outers=2, mu_scale=10.0,
              mu_max=1e8, timings=None):
    """Mixed-precision refinement of a constrained (input-box) solve.

    ``mx`` is a `MixedDFPipelineSolver` -- give it the full f32 iteration
    budget of the f32 AL inner (the polish rebuilds its trajectory from the
    reference tail, so its f32 phase must re-close the multiple-shooting
    defects on its own).  ``params64``: {"dyn", "cost"}, the fp64
    parameters; ``res`` an `ALPipelineResult` (or anything with
    .us/.lmbd/.imu) from the f32 AL outer loop.  Each outer runs the polish
    on the augmented Lagrangian at fixed (lmbd, imu), then a first-order
    dual ascent in float64 on the host (`costs.al_update_diag` semantics,
    with the batch-wide mu = max(imu) and no freeze).  The f32 loop
    converges feasibility (violation < tol) but leaves the duals only
    ascent-accurate, which caps the primal at ~1e-3 of the constrained
    optimum; a couple of polish outers close that dual gap.

    Per-lane feasibility fallback: a lane whose f32 duals are not
    ascent-converged can make the augmented problem unbounded-ish in box
    directions (with R ~ 0 and near-zero imu rows the polish may leave the
    box); any lane whose polished max violation exceeds the f32 solution's
    (beyond float slack) keeps the f32 controls instead.

    Returns (us_f64 numpy (B, N, nu), out: DFState, lmbd, imu): the polished
    controls in float64 (fallback applied), the last polish state, and the
    final multipliers (numpy float64).

    ``timings``: optional dict, filled with per-phase walls: ``solve_s``
    (list, the polish solve of each outer, up to the readback of its first
    controls), ``readback_s`` (list, the host copy of the full controls),
    ``host_s`` (list, the float64 dual ascent and the next warm start)."""
    _check_outers(res, n_outers, "al_polish")
    nu = res.us.shape[-1]
    lbv = np.broadcast_to(np.asarray(lb, np.float64), (nu,))
    ubv = np.broadcast_to(np.asarray(ub, np.float64), (nu,))
    lam = np.asarray(torch.as_tensor(res.lmbd).cpu(), np.float64)  # (B, N+1, 2nu)
    imu = np.asarray(torch.as_tensor(res.imu).cpu(), np.float64)
    mu = np.full(lam.shape[0], float(np.max(imu)))
    dev = solve_device(res.us)
    us_warm = torch.as_tensor(res.us).to(device=dev, dtype=F32)
    dyn, cost = params64["dyn"], params64["cost"]
    out = None
    if timings is not None:
        timings.update(solve_s=[], readback_s=[], host_s=[])
    for _ in range(n_outers):
        t0 = time.perf_counter()
        out = mx.solve(dyn, cost, q0s, xi0s, us_warm,
                       al=(lbv, ubv, lam.astype(np.float32),
                           imu.astype(np.float32)))
        if timings is not None:
            # barrier on a small slice; the full copy is timed apart
            _ = out.us_hi[:, 0, :].cpu()
            timings["solve_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        us64 = (out.us_hi.cpu().numpy().astype(np.float64)
                + out.us_lo.cpu().numpy())
        if timings is not None:
            timings["readback_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        g = np.concatenate([lbv[None, None] - us64, us64 - ubv[None, None]],
                           axis=-1)                      # (B, N, 2nu)
        g = np.concatenate([g, np.zeros_like(g[:, :1])], axis=1)
        lam = np.clip(lam + imu * g, 0.0, None)
        mu = np.minimum(mu * mu_scale, mu_max)
        imu = np.where((g < 0.0) & (lam == 0.0), 0.0, mu[:, None, None])
        us_warm = torch.as_tensor(us64, dtype=F32, device=dev)
        if timings is not None:
            timings["host_s"].append(time.perf_counter() - t0)

    viol = lambda u: np.maximum(
        np.maximum(lbv[None, None] - u, u - ubv[None, None]).max(axis=(1, 2)),
        0.0)
    us_f32_64 = np.asarray(torch.as_tensor(res.us).cpu(), np.float64)
    bad = viol(us64) > viol(us_f32_64) + 1e-5
    us64 = np.where(bad[:, None, None], us_f32_64, us64)
    return us64, out, lam, imu


def al_polish_device(mx, params64, lb, ub, res, q0s, xi0s, n_outers=2,
                     mu_scale=10.0, mu_max=1e8):
    """`al_polish` with the dual ascent on the device: no per-outer host
    readback.  The multipliers stay f32 on the device, and the ascent runs
    between the polish solves (`_dual_update`):

      - box residuals from the polished fp64 controls, rounded to f32;
      - lam = clip(lam + imu g, 0): f32, the grade the polish already takes
        its multipliers at (`MixedDFPipelineSolver` rounds them to f32);
      - mu = min(max(imu) scale^k, mu_max), batch-wide;
      - the per-lane feasibility fallback (`al_polish`) also runs on the
        device (`_dual_fallback`).

    Returns (out: DFState with the fallback applied to us_hi/us_lo,
    lam (B, N+1, 2nu) f32, imu f32), on the solve's device."""
    _check_outers(res, n_outers, "al_polish_device")
    dev = solve_device(res.us)
    nu = res.us.shape[-1]
    f32 = lambda x: torch.as_tensor(x).to(device=dev, dtype=F32)
    box = lambda b: f32(b).broadcast_to((nu,))
    lbv, ubv = box(lb), box(ub)
    lam, imu = f32(res.lmbd), f32(res.imu)              # (B, N+1, 2nu)
    mu = imu.max()                                      # stays on the device
    us_f32 = f32(res.us)
    us_warm = us_f32
    dyn, cost = params64["dyn"], params64["cost"]
    out = None
    for _ in range(n_outers):
        out = mx.solve(dyn, cost, q0s, xi0s, us_warm, al=(lbv, ubv, lam, imu))
        lam, imu, mu = _dual_update(out.us_hi, out.us_lo, lam, imu, mu, lbv,
                                    ubv, float(mu_scale), float(mu_max))
        us_warm = out.us_hi
    us_hi, us_lo = _dual_fallback(out.us_hi, out.us_lo, us_f32, lbv, ubv)
    return out._replace(us_hi=us_hi, us_lo=us_lo), lam, imu


def _dual_update(us_hi, us_lo, lam, imu, mu, lbv, ubv, mu_scale, mu_max):
    """One f32 dual ascent step from a polished iterate.  The box residuals
    are computed in fp64 from the exact controls us_hi + us_lo and rounded
    to f32 (the JAX package forms them as f32 compensated sums of its
    double-f32 controls: the two agree to 1 ulp)."""
    us = us_hi.to(F64) + us_lo
    glo = (lbv.to(F64) - us).to(F32)
    ghi = (us - ubv.to(F64)).to(F32)
    g = torch.cat([glo, ghi], dim=-1)                   # (B, N, 2nu)
    g = torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)
    lam_n = torch.clamp(lam + imu * g, min=0.0)
    mu_n = torch.clamp(mu * mu_scale, max=mu_max)
    imu_n = torch.where((g < 0.0) & (lam_n == 0.0), 0.0, mu_n)
    return lam_n, imu_n, mu_n


def _dual_fallback(us_hi, us_lo, us_f32, lbv, ubv):
    """The feasibility fallback on the device: lanes whose polished
    violation exceeds the f32 solution's by more than 1e-5 take the f32
    controls back, with a zero fp64 remainder."""
    vio = lambda u: torch.clamp(torch.amax(torch.maximum(lbv - u, u - ubv),
                                           dim=(1, 2)), min=0.0)
    bad = vio((us_hi.to(F64) + us_lo).to(F32)) > vio(us_f32) + 1e-5
    m = bad[:, None, None]
    return (torch.where(m, us_f32, us_hi),
            torch.where(m, torch.zeros_like(us_lo), us_lo))
