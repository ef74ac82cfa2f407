"""Anchored-pose batched MS-iLQR: full f32 accuracy (counterpart of the JAX
`solvers/anchored.py`), with kernel B13 at (nx, nu) = (12, 6).

World-frame poses carry positions of O(30 m), so storing them in f32
quantizes the trajectory at ~2e-6 m and moves the optimizer's stationary
point by ~1e-3 in flat input directions.  The anchored representation
stores every pose relative to the reference,
    q_loc_i = qbar_i^-1 q_i   (near identity, f32 exact to ~1e-7),
and precomputes the large-magnitude objects once in f64:
    T_i     = qbar_{i+1}^-1 qbar_i   (reference transport)
    Adbar_i = Ad(qbar_i)            (for the left-error cost)
so that
    dynamics   q_loc_{i+1} = T_i q_loc_i Exp(xi dt)
    error      e_i = Adbar_i Log(q_loc_i)               == Log(q_i qbar_i^-1)
    defect     d_q = Log(q_loc_{i+1}^-1 T_i q_loc_i Exp(xi dt))
and the Jacobians are unchanged (tangent quantities).

Scope: the SE(3) free body + GN tracking cost.  Fixed iteration budget,
full steps, mu = 0; the backward pass is kernel B13 (`ops/riccati.
fast_backward`) with ``use_pallas``, else the doubling-scan Riccati of
`solvers/riccati.py` (the JAX package's plain path); the rollout is a loop
over stages on the batch (as in the JAX package, not B14).  Tensors are
batch first; a solve runs on the device of its inputs when they are
tensors, else on the card.
"""

import dataclasses

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    SE3Params,
    _coad_for_jac,
    _se3_G,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.riccati import fast_backward
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


@dataclasses.dataclass
class AnchoredProblem:
    """Anchored problem data, precomputed in f64 and stored at the target
    dtype."""

    dyn: SE3Params
    T: torch.Tensor       # (N, 4, 4) reference transport qbar_{i+1}^-1 qbar_i
    Ad_ref: torch.Tensor  # (N+1, 6, 6)
    xi_ref: torch.Tensor  # (N+1, 6)
    Q1: torch.Tensor
    Q2: torch.Tensor
    R: torch.Tensor
    P1: torch.Tensor
    P2: torch.Tensor


def _hat(v):
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
    out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
    return out


def build_anchored(J, dt, Q, R, P, q_ref, xi_ref, dtype=torch.float32,
                   device=torch.device("cuda")):
    """The anchored problem of the free body with inertia J (6, 6), step dt
    and the tracking weights Q, P (12, 12), R (6, 6) along q_ref (N+1, 4, 4),
    xi_ref (N+1, 6): precomputed in f64 on the host (numpy), then cast to
    ``dtype`` on ``device`` (the card unless asked for another)."""
    f64 = lambda x: np.asarray(torch.as_tensor(x).double().cpu() if isinstance(
        x, torch.Tensor) else x, np.float64)
    q64 = f64(q_ref)
    T = np.einsum("nij,njk->nik", np.linalg.inv(q64[1:]), q64[:-1])
    Rr, p = q64[:, :3, :3], q64[:, :3, 3]
    Ad = np.zeros((q64.shape[0], 6, 6))
    Ad[:, :3, :3] = Rr
    Ad[:, 3:, :3] = np.einsum("nij,njk->nik", _hat(p), Rr)
    Ad[:, 3:, 3:] = Rr
    J, Qm, Pm = f64(J), f64(Q), f64(P)
    c = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)
    dyn = SE3Params(J=c(J), Jinv=c(np.linalg.inv(J)), Ib=c(J[:3, :3]), m=c(J[4, 4]),
                    dt=c(f64(dt)), ref_coad_swap=True)
    return AnchoredProblem(
        dyn=dyn, T=c(T), Ad_ref=c(Ad), xi_ref=c(f64(xi_ref).reshape(len(q64), 6)),
        Q1=c(Qm[:6, :6]), Q2=c(Qm[6:, 6:]), R=c(f64(R)), P1=c(Pm[:6, :6]),
        P2=c(Pm[6:, 6:]))


class AnchoredFastSolver:
    """Fixed-budget anchored batched MS-iLQR (SE(3) free body + GN
    tracking).  ``use_pallas``: the backward pass on kernel B13 (on a CUDA
    tensor it launches the kernel, there is no plain fallback); else the
    doubling-scan Riccati at mu = 0."""

    def __init__(self, prob: AnchoredProblem, N: int, iterations: int,
                 use_pallas: bool = True):
        self.p = prob
        self.N = N
        self.iterations = iterations
        self.use_pallas = use_pallas

    # anchored dynamics step: q_loc' = T_i q_loc Exp(xi dt)
    def _step(self, q_loc, xi, u, i):
        dp = self.p.dyn
        q_next = se3.normalize(self.p.T[i] @ q_loc @ se3.exp(xi * dp.dt))
        wrench = _bmv(se3.coad(xi), _bmv(dp.J, xi)) + u
        return q_next, xi + _bmv(dp.Jinv, wrench) * dp.dt

    def _jac(self, xi):
        dp = self.p.dyn
        tau = xi * dp.dt
        H = dp.Jinv @ (_coad_for_jac(dp, xi) @ dp.J + _se3_G(dp, xi))
        eye6 = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(H.shape)
        top = torch.cat([se3.Ad(se3.exp(-tau)), se3.right_jacobian(tau) * dp.dt], dim=-1)
        bot = torch.cat([torch.zeros_like(H), eye6 + H * dp.dt], dim=-1)
        Fu = torch.cat([torch.zeros_like(dp.Jinv), dp.Jinv], dim=-2) * dp.dt
        return torch.cat([top, bot], dim=-2), Fu.expand(H.shape[:-2] + (12, 6))

    def _quad(self, q_loc, xi, i, W1, W2):
        p = self.p
        e = _bmv(p.Ad_ref[i], se3.log(q_loc))     # == Log(q qbar^-1)
        ev = xi - p.xi_ref[i]
        J_e_x = se3.right_jacobian_inv(e) @ p.Ad_ref[i]
        JT2 = 2.0 * J_e_x.transpose(-1, -2)
        lx = torch.cat([_bmv(JT2 @ W1, e), 2.0 * _bmv(W2, ev)], dim=-1)
        H_e = JT2 @ W1 @ J_e_x
        Z = torch.zeros_like(H_e)
        lxx = torch.cat([torch.cat([H_e, Z], dim=-1),
                         torch.cat([Z, (2.0 * W2).expand(H_e.shape)], dim=-1)], dim=-2)
        l = (torch.einsum("...i,ij,...j->...", e, W1, e)
             + torch.einsum("...i,ij,...j->...", ev, W2, ev))
        return l, lx, lxx

    def _linearize(self, qs, xis, us):
        p, N = self.p, self.N
        idx = torch.arange(N, device=us.device)
        q_s, xi_s = qs[:, :-1], xis[:, :-1]
        fq, fxi = self._step(q_s, xi_s, us, idx)
        Fx, Fu = self._jac(xi_s)
        l, lx, lxx = self._quad(q_s, xi_s, idx, p.Q1, p.Q2)
        l = l + torch.einsum("...i,ij,...j->...", us, p.R, us)
        lu = 2.0 * _bmv(p.R, us)
        luu = (2.0 * p.R).expand(lu.shape[:-1] + (6, 6))
        lux = torch.zeros(lu.shape[:-1] + (6, 12), dtype=lu.dtype, device=lu.device)
        lN, lNx, lNxx = self._quad(qs[:, -1], xis[:, -1], N, p.P1, p.P2)
        d_q = se3.log(se3.inverse(qs[:, 1:]) @ fq)
        return dict(fq=fq, fxi=fxi, Fx=Fx, Fu=Fu, d=torch.cat([d_q, fxi - xis[:, 1:]], dim=-1),
                    L=torch.cat([l, lN[:, None]], dim=1),
                    Lx=torch.cat([lx, lNx[:, None]], dim=1), Lu=lu,
                    Lxx=torch.cat([lxx, lNxx[:, None]], dim=1), Lux=lux, Luu=luu)

    def _backward(self, lin):
        args = tuple(lin[n] for n in ("Fx", "Fu", "d", "Lx", "Lu", "Lxx", "Lux", "Luu"))
        if self.use_pallas:
            return fast_backward(*args)
        return riccati.parallel_backward(*args, mu=0.0)

    def _grad_norm(self, lin, Vx1, Vxx1):
        g = lin["Lu"] + _bmv(lin["Fu"].transpose(-1, -2),
                             Vx1 + _bmv(Vxx1.transpose(-1, -2), lin["d"]))
        return torch.linalg.norm(g, dim=-1).mean(dim=-1)

    def _rollout(self, lin, qs, xis, us, k, K):
        exp_d = se3.exp(lin["d"][..., :6])
        fq_inv = se3.inverse(lin["fq"])
        q_new, xi_new = qs[:, 0], xis[:, 0]
        qs_t, xis_t, us_t = [], [], []
        for i in range(self.N):
            xs_err = torch.cat([se3.log(se3.inverse(qs[:, i]) @ q_new), xi_new - xis[:, i]],
                               dim=-1)
            u_new = us[:, i] + k[:, i] + _bmv(K[:, i], xs_err)
            fq_new, fxi_new = self._step(q_new, xi_new, u_new, i)
            q_new = se3.normalize(qs[:, i + 1] @ exp_d[:, i] @ fq_inv[:, i] @ fq_new)
            xi_new = xis[:, i + 1] + fxi_new - lin["fxi"][:, i] + lin["d"][:, i, 6:]
            qs_t.append(q_new)
            xis_t.append(xi_new)
            us_t.append(u_new)
        return (torch.cat([qs[:, :1], torch.stack(qs_t, dim=1)], dim=1),
                torch.cat([xis[:, :1], torch.stack(xis_t, dim=1)], dim=1),
                torch.stack(us_t, dim=1))

    def _solve(self, q0_locs, xi0s, us0):
        B = q0_locs.shape[0]
        eye = torch.eye(4, dtype=us0.dtype, device=us0.device)
        qs = torch.cat([q0_locs[:, None], eye.expand(B, self.N, 4, 4)], dim=1)
        xi_t = self.p.xi_ref[1:]
        xis = torch.cat([xi0s[:, None], xi_t.expand((B,) + xi_t.shape)], dim=1)
        us = us0
        J = torch.full((B,), float("inf"), dtype=us.dtype, device=us.device)
        g = J.clone()
        for _ in range(self.iterations):
            lin = self._linearize(qs, xis, us)
            k, K, Vx1, Vxx1 = self._backward(lin)
            g = self._grad_norm(lin, Vx1, Vxx1)
            qs, xis, us = self._rollout(lin, qs, xis, us, k, K)
            J = lin["L"].sum(dim=-1)
        return qs, xis, us, J, g

    def solve(self, q0_locs, xi0s, us0):
        """q0_locs = qbar_0^-1 q_0 (B, 4, 4) (compute it in f64 on the host
        for accuracy), xi0s (B, 6), us0 (B, N, nu).  Returns (qs (local
        poses), xis, us, J, grad_norm) after ``iterations`` iterations."""
        dev = solve_device(us0)
        dt = self.p.Q1.dtype
        cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
        return self._solve(cast(q0_locs), cast(xi0s), cast(us0))
