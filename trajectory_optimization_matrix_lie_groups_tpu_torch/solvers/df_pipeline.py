"""The parts of the JAX `solvers/df_pipeline.py` that the mixed-precision
polish (`solvers/df_mixed.py`) builds on: the `DFState` result, the f32
phase, the polish phase's constants, and Fu.

The JAX package carries the polish's residual path in double-f32 hi/lo
pairs (`ops/dfx.py`) only because the TPU has no f64; it splits the f64
problem on the host (`split_pytree`) to get it onto the device.  The port
runs that path in native fp64 on the fp64 `SE3Params` / `TrackingCostParams`
that `convert.py` makes, so neither `ops/dfx.py` nor `split_pytree` is
ported, and the full double-f32 solver `DFPipelineSolver._solve_df` (a plain
XLA path with no TPU kernel) is left for a later fp64 refiner (ROADMAP).
"""

import dataclasses
from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import lane_refs
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
    solve_device,
)

__all__ = ["DFState", "DFPipelineBase", "join_us"]


class DFState(NamedTuple):
    """The polish's result in solver layout.  ``us_hi`` + ``us_lo`` is the
    fp64 controls exactly (`join_us`); the JAX package's fields, with the
    poses and twists kept in fp64."""
    qs: torch.Tensor         # (B, N+1, 4, 4) fp64
    xis: torch.Tensor        # (B, N+1, 6) fp64
    us_hi: torch.Tensor      # (B, N, nu) f32 rounding of the controls
    us_lo: torch.Tensor      # (B, N, nu) fp64 remainder us - us_hi
    J_opt: torch.Tensor      # (B,) f32 cost of the returned iterate
    grad_norm: torch.Tensor  # (B,) fp64


def split_us(us):
    """(us_hi, us_lo) of fp64 controls: the f32 rounding and the exact fp64
    remainder."""
    hi = us.float()
    return hi, us - hi.double()


def join_us(state):
    """The fp64 controls (B, N, nu) of a `DFState`."""
    return state.us_hi.double() + state.us_lo


def cast_params(p, device, dtype):
    """A copy of a parameter dataclass (`SE3Params`, `RigidBodyParams`,
    `TrackingCostParams`) with every tensor field on ``device`` in
    ``dtype``."""
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(device=device, dtype=dtype)
        for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})


def fu_full(Jinv, Pu, dt):
    """Fu = [0; Jinv Pu] dt (12, nu), in the operands' precision (the JAX
    `_fu_df` computes it in double-f32)."""
    bt6 = (Jinv @ Pu) * dt
    return torch.cat([torch.zeros_like(bt6), bt6], dim=0)


class DFPipelineBase:
    """The f32 phase and the polish setup shared by the polish solvers (the
    parts of the JAX `DFPipelineSolver` that `MixedDFPipelineSolver`
    inherits).

    N, dt: horizon and step; f32_iterations: iterations of the f32
    `PipelineSolver` (fused layout); df_iterations: polish iterations;
    gravity, exact_gravity_jacobian: as `PipelineSolver`; plain: run the
    plain versions of every kernel whatever the device."""

    def __init__(self, N: int, dt: float, f32_iterations: int = 12,
                 df_iterations: int = 3, gravity: bool = False,
                 exact_gravity_jacobian: bool = False, plain: bool = False):
        self.N = N
        self.dt = float(dt)
        self.f32_iterations = f32_iterations
        self.df_iterations = df_iterations
        self.gravity = gravity
        self.exact_grav = exact_gravity_jacobian
        self.plain = plain
        self.base = PipelineSolver(N, f32_iterations, dt, gravity=gravity,
                                   exact_gravity_jacobian=exact_gravity_jacobian,
                                   fused=True, plain=plain)

    def _solve_f32(self, dyn, cost, q0s, xi0s, us0, al=None):
        """Phase 1: the f32 pipeline on the f32 rounding of the fp64 problem,
        on ``us0``'s device (the card when it is not a tensor).  ``al``:
        optional input-box AL state (lb, ub, lmbd (B, N+1, 2nu),
        imu (B, N+1, 2nu)), as `PipelineSolver.solve`.
        Returns the lane-layout handoff (qR, qp, xi, us), f32."""
        dev = solve_device(us0)
        f32 = lambda x: torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        if al is not None:
            nu = torch.as_tensor(us0).shape[-1]
            lb, ub, lmbd, imu = al
            al = (f32(lb).broadcast_to((nu,)), f32(ub).broadcast_to((nu,)),
                  f32(lmbd), f32(imu))
        s = self.base.solve_lane(
            cast_params(dyn, dev, torch.float32),
            cast_params(cost, dev, torch.float32), f32(q0s), f32(xi0s),
            f32(us0), al=al)
        return s["qR"], s["qp"], s["xi"], s["us"]

    def _df_setup(self, dyn, cost, device):
        """The polish phase's constants and references in fp64, and the f32
        roundings the preconditioner takes.  Returns (consts, refs,
        consts32): consts J, Jinv, W1, W2, P1, P2 (6, 6), Pu (6, nu), fu2
        (6, nu) (Fu's lower block), R (nu, nu) and mg (a float); refs as
        `lane_refs` (N+1 stages); consts32 the f32 J, Jinv, W1, W2, P1, P2,
        fu2, R, Luu = 2 R and mg."""
        f64 = lambda x: torch.as_tensor(x).to(device=device,
                                              dtype=torch.float64).contiguous()
        Pu = getattr(dyn, "Pu", None)
        Pu = (torch.eye(6, dtype=torch.float64, device=device) if Pu is None
              else f64(Pu))
        Jinv = f64(dyn.Jinv)
        consts = dict(J=f64(dyn.J), Jinv=Jinv, W1=f64(cost.Q1),
                      W2=f64(cost.Q2), P1=f64(cost.P1), P2=f64(cost.P2),
                      Pu=Pu, fu2=fu_full(Jinv, Pu, f64(dyn.dt))[6:].contiguous(),
                      R=f64(cost.R),
                      mg=float(dyn.m * dyn.g) if self.gravity else 0.0)
        refs = lane_refs(f64(cost.q_ref_inv), f64(cost.Ad_ref),
                         f64(cost.xi_ref))
        consts32 = {k: consts[k].float().contiguous()
                    for k in ("J", "Jinv", "W1", "W2", "P1", "P2", "fu2", "R")}
        consts32["Luu"] = 2.0 * consts32["R"]
        consts32["mg"] = (float(dyn.m.float() * dyn.g.float()) if self.gravity
                          else 0.0)
        return consts, refs, consts32
