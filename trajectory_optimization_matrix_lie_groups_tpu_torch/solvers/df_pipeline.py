"""The f32 pipeline followed by a full-precision refiner (counterpart of the
JAX `solvers/df_pipeline.py`): `DFPipelineSolver`, and the parts that the
mixed-precision polish (`solvers/df_mixed.py`) builds on: the `DFState`
result, the f32 phase, the polish phase's constants, and Fu.

The JAX package carries the refinement in double-f32 hi/lo pairs
(`ops/dfx.py`) only because the TPU has no f64; it splits the f64 problem
on the host (`split_pytree`) to get it onto the device, and runs its
`_solve_df` phase as plain XLA on those pairs.  The H100 has native fp64:
the port's refinement is the fp64 `PipelineSolver`, kernels B1, B2 and B3
in fp64, warm-started from the f32 phase's lane-layout handoff
(`PipelineSolver.solve_lane`'s ``init``).  Neither `ops/dfx.py` nor
`split_pytree` is ported.
"""

import dataclasses
from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import lane_refs
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
    solve_device,
)

__all__ = ["DFState", "DFPipelineBase", "DFPipelineSolver", "join_us"]


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


class DFPipelineSolver(DFPipelineBase):
    """f32 pipeline + full-fp64 refinement (the JAX `DFPipelineSolver`).

    ``f32_iterations`` iterations of the f32 `PipelineSolver` (fused
    layout), then ``df_iterations`` iterations of the fp64 `PipelineSolver`
    from its handoff (kernels B1, B2, B3 in fp64; B1, B2, B4 with
    ``fused=False``), then one more fp64 backward pass for the cost and
    gradient norm at the final iterate, as the JAX `_solve_df` reports
    them.  gravity, exact_gravity_jacobian, plain: as `DFPipelineBase`."""

    def __init__(self, N: int, dt: float, f32_iterations: int = 12,
                 df_iterations: int = 3, gravity: bool = False,
                 exact_gravity_jacobian: bool = False, fused: bool = True,
                 plain: bool = False):
        super().__init__(N, dt, f32_iterations, df_iterations, gravity,
                         exact_gravity_jacobian, plain)
        self.refiner = PipelineSolver(N, df_iterations, dt, gravity=gravity,
                                      exact_gravity_jacobian=exact_gravity_jacobian,
                                      fused=fused, plain=plain)

    def refine(self, dyn, cost, qR, qp, xi, us):
        """The fp64 phase from a lane-layout handoff qR (N+1, 3, 3, B),
        qp (N+1, 3, B), xi (N+1, 6, B), us (N, nu, B) in any float dtype
        (promoted to fp64), on its device.  ``dyn``, ``cost``: the fp64
        parameters.  Returns a `DFState`."""
        dev = us.device
        f64 = lambda p: cast_params(p, dev, torch.float64)
        dyn, cost = f64(dyn), f64(cost)
        ref = self.refiner
        s = ref.solve_lane(dyn, cost, None, None, None,
                           init=tuple(x.to(torch.float64) for x in (qR, qp, xi, us)))
        qR, qp, xi, us, lin = s["qR"], s["qp"], s["xi"], s["us"], s["lin"]
        if lin is None:
            lin = ref._linearize(qR, qp, xi, us, s["refs"], s["consts"], dt=ref.dt,
                                 gravity=ref.gravity, exact_grav=ref.exact_grav)
        _, _, J, g = ref._backward_metrics(qR, qp, xi, us, lin, s["refs"], s["consts"], None)
        N, B = self.N, us.shape[-1]
        bk = lambda x: x.movedim(-1, 0)
        qs = torch.zeros((B, N + 1, 4, 4), dtype=torch.float64, device=dev)
        qs[:, :, :3, :3] = bk(qR)
        qs[:, :, :3, 3] = bk(qp)
        qs[:, :, 3, 3] = 1.0
        us_hi, us_lo = split_us(bk(us))
        return DFState(qs=qs, xis=bk(xi), us_hi=us_hi, us_lo=us_lo, J_opt=J,
                       grad_norm=g)

    def solve(self, dyn, cost, q0s, xi0s, us0, al=None):
        """``dyn``, ``cost``: fp64 `SE3Params` (or `RigidBodyParams` with
        ``gravity``) and `TrackingCostParams`; solver-layout q0s (B, 4, 4),
        xi0s (B, 6), us0 (B, N, nu), on the device the solve runs on (the
        card when they are not tensors).  The f32 phase runs on their f32
        rounding, the refinement on its handoff.  Returns a `DFState`."""
        if al is not None:
            raise NotImplementedError(
                "AL terms in the refinement are implemented by "
                "MixedDFPipelineSolver; the full-precision driver takes none")
        return self.refine(dyn, cost, *self._solve_f32(dyn, cost, q0s, xi0s, us0))
