"""Lane-layout MS-iLQR pipeline for the SO(3) family (counterpart of the JAX
`solvers/pipeline_so3.py`), with kernels B10 (linearization), B11 (Riccati
backward) and B12 (rollout and the linearization of the new trajectory).

It covers both SO(3)-family dynamics of the reference: the free rigid-body
attitude (constant Fu = [0; Jinv] dt) and the 3-D pendulum actuated at its
pivot, whose gravity torque hat(m g rho) R^T down and input moment
hat(m rho) R^T u make Fu = [0; Jinv hat(m rho) R^T] dt depend on the stage:
B10 and B12 emit its lower block fu2 per stage and B11 reads it per stage.
The state is (R, xi) with nx = 6 (pose half 3), nu = 3.  The Riccati step
is the SE(3) pipeline's `riccati_stage` with ``half=3`` and ``glow`` = the
pendulum (its L block sits where the SE(3) gravity block does).

The terminal quadratization keeps the reference SO(3) cost's quirk behind
``term_quirk`` (default True): value and gradient weighted by Q, Hessian by
P.  Per iteration two kernels run (B11; B12) after one B10 up front.

Each kernel wrapper (`linearize_so3_lane`, `backward_so3_lane`,
`rollout_linearize_so3_lane`) takes the plain version (`*_plain`) for CPU
tensors and launches the CUDA kernel (`csrc/so3.cu`) for CUDA tensors, or
raises.
"""

from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import _bc, _cross
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    riccati_stage,
    solve_device,
)

NX, NU, H = 6, 3, 3


# -- stage math (lane layout, the plain versions of csrc/so3.cu) ---------------

def so3_stage_dynamics_eval(R, xi, u, Jl, Jil, mgr, mr, *, dt, pendulum):
    """Euler step: fq = normalize(R Exp(xi dt)); fxi = xi + dt Jinv torque
    with torque = hat(xi)^T J xi + u (free) or + the gravity and input
    moments (pendulum)."""
    fqR = ll.so3_normalize(ll.matmul(R, ll.so3_exp(xi * dt)))
    torque = -_cross(xi, ll.matvec(Jl, xi))
    if pendulum:
        Rtd = -R[2]                      # R^T (0, 0, -1) = -(third row of R)
        torque = (torque + _cross(mgr, Rtd)
                  + _cross(mr, ll.matvec(ll.transpose(R), u)))
    else:
        torque = torque + u
    return fqR, xi + dt * ll.matvec(Jil, torque)


def so3_stage_jacobian(R, xi, u, Jl, Jil, mgr, mr, *, dt, pendulum):
    """(Fx, fu2): Fx = [[Exp(-tau), Jr(tau) dt], [C, I + H dt]] (C = L dt
    for the pendulum, 0 for the free body), fu2 the lower block of Fu."""
    tau = xi * dt
    J_q_q = ll.so3_exp(-tau)
    J_q_xi = ll.so3_left_jacobian(-tau) * dt    # Jr(tau) dt
    G = ll.hat(ll.matvec(Jl, xi))
    H_blk = ll.matmul(Jil, G - ll.matmul(ll.hat(xi), Jl))
    D = ll._eye(3, xi) + H_blk * dt
    if pendulum:
        Rt = ll.transpose(R)
        # hat(down) R with down = (0, 0, -1): rows (R[1], -R[0], 0)
        z = torch.zeros_like(R[0, 0])
        hdR = ll._mat3([[R[1, 0], R[1, 1], R[1, 2]],
                        [-R[0, 0], -R[0, 1], -R[0, 2]],
                        [z, z, z]])
        L1 = ll.matmul(ll.hat(mgr), ll.matmul(Rt, hdR))
        L2 = ll.matmul(ll.hat(mr), ll.matmul(Rt, ll.matmul(ll.hat(u), R)))
        C = ll.matmul(Jil, L1 + L2) * dt
        fu2 = ll.matmul(Jil, ll.matmul(ll.hat(mr), Rt)) * dt
    else:
        C = torch.zeros_like(D)
        fu2 = _bc(Jil * dt, D)
    return ll.blk(J_q_q, J_q_xi, C, D), fu2


def so3_stage_cost_quad(R, xi, RbiR, xib, W1v, W2v, W1h, W2h):
    """GN tracking quadratization on SO(3): e = Log(R Rref^-1),
    J_e_x = Jr^-1(e) Ad(Rref) with Ad(Rref) = Rref = RbiR^T.  (W1v, W2v)
    weight the value and gradient, (W1h, W2h) the Hessian: equal for stage
    costs, (Q, P) for the terminal quirk.  Returns (lx, lxx, l)."""
    e = ll.so3_log(ll.matmul(R, RbiR))
    ev = xi - xib
    Jex = ll.matmul(ll.so3_left_jacobian_inv(-e), ll.transpose(RbiR))
    W1e = ll.matvec(W1v, e)
    W2ev = ll.matvec(W2v, ev)
    lx = torch.cat([ll.matvec(2.0 * ll.transpose(Jex), W1e), 2.0 * W2ev], dim=0)
    H_e = ll.matmul(ll.matmul(2.0 * ll.transpose(Jex), W1h), Jex)
    Z = torch.zeros_like(H_e)
    lxx = ll.blk(H_e, Z, Z, _bc(2.0 * W2h, H_e))
    l_val = ((e[0] * W1e[0] + e[1] * W1e[1] + e[2] * W1e[2])
             + (ev[0] * W2ev[0] + ev[1] * W2ev[1] + ev[2] * W2ev[2]))
    return lx, lxx, l_val


def so3_defect(R, xi, fqR, fxi):
    """d = [Log(R^T fq); fxi - xi] against the next state (R, xi)."""
    return torch.cat([ll.so3_log(ll.matmul(ll.transpose(R), fqR)), fxi - xi],
                     dim=0)


def so3_rollout_stage(R_new, xi_new, R_t, Rn_t, xi_t, xin_t, u_t, k_t, K_t,
                      d_t, fqR_t, fxi_t, Jl, Jil, mgr, mr, *, dt, pendulum):
    """Gap-closing rollout step: feedback on the deviation from the nominal,
    then x+ = x_next Exp(d) f(xbar)^-1 f(x_new).
    Returns (R_nn, xi_nn, u_new, fqR_n, fxi_n)."""
    xs_err = torch.cat([ll.so3_log(ll.matmul(ll.transpose(R_t), R_new)),
                        xi_new - xi_t], dim=0)
    u_new = u_t + k_t + ll.matvec(K_t, xs_err)
    fqR_n, fxi_n = so3_stage_dynamics_eval(R_new, xi_new, u_new, Jl, Jil, mgr,
                                           mr, dt=dt, pendulum=pendulum)
    R_a = ll.matmul(Rn_t, ll.so3_exp(d_t[:3]))
    R_b = ll.matmul(R_a, ll.transpose(fqR_t))
    R_nn = ll.so3_normalize(ll.matmul(R_b, fqR_n))
    xi_nn = xin_t + fxi_n - fxi_t + d_t[3:]
    return R_nn, xi_nn, u_new, fqR_n, fxi_n


LIN = ("fqR", "fxi", "d", "Fx", "fu2", "lx", "lxx", "l")


def _model(c):
    return c["J"], c["Jinv"], c["mgr"], c["mr"]


# -- B10: linearization ---------------------------------------------------------

def linearize_so3_plain(qR, xi, us, refs, consts, *, dt, pendulum):
    """Plain version of kernel B10, all N stages at once (stage becomes a
    batch axis).  Same arguments and outputs as `linearize_so3_lane`."""
    st = lambda x: x.movedim(0, -2)          # (N, ..., B) -> (..., N, B)
    back = lambda x: x.movedim(-2, 0).contiguous()
    R, x, u = st(qR[:-1]), st(xi[:-1]), st(us)
    m = _model(consts)
    kw = dict(dt=dt, pendulum=pendulum)
    fqR, fxi = so3_stage_dynamics_eval(R, x, u, *m, **kw)
    d = so3_defect(st(qR[1:]), st(xi[1:]), fqR, fxi)
    Fx, fu2 = so3_stage_jacobian(R, x, u, *m, **kw)
    N = us.shape[0]
    ref = lambda k: refs[k][:N].movedim(0, -1)[..., None]   # (..., N, 1)
    W1, W2 = consts["W1"], consts["W2"]
    lx, lxx, l = so3_stage_cost_quad(R, x, ref("RbiR"), ref("xib"), W1, W2, W1, W2)
    return dict(fqR=back(fqR), fxi=back(fxi), d=back(d), Fx=back(Fx),
                fu2=back(fu2), lx=back(lx), lxx=back(lxx), l=back(l[None]))


_P, _I, _D = _build.PTR, _build.INT, _build.DBL
_LINEARIZE_ARGS = [_P] * 11 + [_D, _I] + [_P] * 8 + [_I] * 3 + [_P]


def _model_ptrs(a, consts):
    return [a(consts[k], (3, 3), k) for k in ("J", "Jinv", "W1", "W2")] + \
        [a(consts[k], (3,), k) for k in ("mgr", "mr")]


def _alloc_lin(e, N, B):
    return dict(fqR=e(N, 3, 3, B), fxi=e(N, 3, B), d=e(N, NX, B),
                Fx=e(N, NX, NX, B), fu2=e(N, 3, 3, B), lx=e(N, NX, B),
                lxx=e(N, NX, NX, B), l=e(N, 1, B))


def _launch(name, x):
    """The C entry point ``name`` of the so3 library for ``x``'s dtype, and
    the current CUDA stream of ``x``'s device."""
    fn = _build.function("so3", name, _build.suffix(x.dtype), _ARGS[name])
    return fn, torch.cuda.current_stream(x.device).cuda_stream


def _linearize_so3_kernel(fn, stream, qR, xi, us, refs, consts, *, dt, pendulum):
    """B10's C entry point ``fn`` on ``stream`` (arguments and outputs as
    `linearize_so3_lane`); raises if the launch fails."""
    N, _, B = us.shape
    a = lambda t, shape, name: _build.arg(t, shape, us, name)
    out = _alloc_lin(lambda *s: torch.empty(s, dtype=us.dtype, device=us.device), N, B)
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(xi, (N + 1, 3, B), "xi"),
             a(us, (N, NU, B), "us"), a(refs["RbiR"], (N + 1, 3, 3), "RbiR"),
             a(refs["xib"], (N + 1, 3), "xib"), *_model_ptrs(a, consts),
             float(dt), int(pendulum), *[a(out[k], out[k].shape, k) for k in LIN],
             N, B, _build.device_index(us), stream)
    _build.check(err, "linearize_so3")
    return out


def linearize_so3_lane(qR, xi, us, refs, consts, *, dt, pendulum):
    """Kernel B10 (replaces `solvers/pipeline_so3.py::_linearize_kernel_so3`
    as called by `SO3PipelineSolver._linearize_lane`).

    Lane layout: qR (N+1, 3, 3, B), xi (N+1, 3, B), us (N, 3, B); ``refs``
    RbiR (N+1, 3, 3), xib (N+1, 3), shared by the batch; ``consts`` J, Jinv,
    W1, W2 (3, 3), mgr, mr (3,) (zero for the free body).  Returns
    dict(fqR (N, 3, 3, B), fxi (N, 3, B), d (N, 6, B), Fx (N, 6, 6, B),
    fu2 (N, 3, 3, B), lx (N, 6, B), lxx (N, 6, 6, B), l (N, 1, B)).

    On an H100 it is bound by its stores like B1 (Fx, lxx and fu2: 81 of
    its 100 values per stage and problem); one thread per (problem, stage)
    writes every entry once, coalesced over the batch."""
    kw = dict(dt=dt, pendulum=pendulum)
    if us.device.type == "cpu":
        return linearize_so3_plain(qR, xi, us, refs, consts, **kw)
    if us.device.type != "cuda":
        raise ValueError(f"linearize_so3_lane: no kernel for device {us.device}")
    out = _linearize_so3_kernel(*_launch("linearize_so3", us), qR, xi, us, refs, consts,
                                **kw)
    linearize_so3_lane.launches += 1
    return out


linearize_so3_lane.launches = 0


# -- B11: Riccati backward ------------------------------------------------------

def backward_so3_plain(lin, lu, qR, xi, refs, consts, *, pendulum):
    """Plain version of kernel B11: the terminal quadratization (weights
    W1vN, W2vN for the value and gradient, W1hN, W2hN for the Hessian),
    then `riccati_stage` (``half=3``, ``glow=pendulum``, per-stage fu2) over
    the stages in reverse.  Same arguments and outputs as
    `backward_so3_lane`."""
    N = lu.shape[0]
    c = consts
    lxN, lxxN, lN = so3_stage_cost_quad(
        qR[N], xi[N], refs["RbiR"][N][..., None], refs["xib"][N][..., None],
        c["W1vN"], c["W2vN"], c["W1hN"], c["W2hN"])
    Luu = c["Luu"][..., None]
    k, gvec = torch.empty_like(lu), torch.empty_like(lu)
    K = torch.empty((N, NU, NX) + tuple(lu.shape[2:]), dtype=lu.dtype,
                    device=lu.device)
    Vx, Vxx = lxN, lxxN
    for t in reversed(range(N)):
        fu2 = lin["fu2"][t]
        k[t], K[t], gvec[t], Vx, Vxx = riccati_stage(
            lin["Fx"][t], lin["d"][t], lin["lx"][t], lu[t], lin["lxx"][t],
            fu2, ll.transpose(fu2), Luu, Vx, Vxx, nu=NU, glow=pendulum, half=H)
    return k, K, gvec, lN


_RICCATI_ARGS = [_P] * 15 + [_I] + [_P] * 4 + [_I] * 3 + [_P]


def _backward_so3_kernel(fn, stream, lin, lu, qR, xi, refs, consts, *, pendulum):
    """B11's C entry point ``fn`` on ``stream`` (arguments and outputs as
    `backward_so3_lane`); raises if the launch fails."""
    N, _, B = lu.shape
    a = lambda t, shape, name: _build.arg(t, shape, lu, name)
    e = lambda *s: torch.empty(s, dtype=lu.dtype, device=lu.device)
    k, K, gvec, lN = e(N, NU, B), e(N, NU, NX, B), e(N, NU, B), e(B)
    err = fn(a(lin["Fx"], (N, NX, NX, B), "Fx"), a(lin["fu2"], (N, 3, 3, B), "fu2"),
             a(lin["d"], (N, NX, B), "d"), a(lin["lx"], (N, NX, B), "lx"),
             a(lu, (N, NU, B), "lu"), a(lin["lxx"], (N, NX, NX, B), "lxx"),
             a(qR, (N + 1, 3, 3, B), "qR"), a(xi, (N + 1, 3, B), "xi"),
             a(refs["RbiR"], (N + 1, 3, 3), "RbiR"), a(refs["xib"], (N + 1, 3), "xib"),
             *[a(consts[n], (3, 3), n) for n in ("W1vN", "W2vN", "W1hN", "W2hN", "Luu")],
             int(pendulum), a(k, k.shape, "k"), a(K, K.shape, "K"),
             a(gvec, gvec.shape, "gvec"), a(lN, lN.shape, "lN"),
             N, B, _build.device_index(lu), stream)
    _build.check(err, "riccati_so3")
    return k, K, gvec, lN


def backward_so3_lane(lin, lu, qR, xi, refs, consts, *, pendulum):
    """Kernel B11 (replaces `solvers/pipeline_so3.py::_riccati_kernel_so3` as
    called by `SO3PipelineSolver._backward_lane`).

    ``lin``: Fx (N, 6, 6, B), fu2 (N, 3, 3, B), d (N, 6, B), lx (N, 6, B),
    lxx (N, 6, 6, B); ``lu`` (N, 3, B); the terminal state is stage N of
    qR (N+1, 3, 3, B) and xi (N+1, 3, B); ``refs`` as `linearize_so3_lane`;
    ``consts`` the terminal weights W1vN, W2vN, W1hN, W2hN and Luu = 2 R
    (3, 3).  Returns k (N, 3, B), K (N, 3, 6, B), gvec = Qu (N, 3, B),
    lN (B,).

    On an H100 one thread runs one problem's recursion on blocks of one
    warp, with the carry (V_x 6, V_xx 36) in registers, and copies each
    stage's 96 inputs into shared memory one stage ahead."""
    kw = dict(pendulum=pendulum)
    if lu.device.type == "cpu":
        return backward_so3_plain(lin, lu, qR, xi, refs, consts, **kw)
    if lu.device.type != "cuda":
        raise ValueError(f"backward_so3_lane: no kernel for device {lu.device}")
    out = _backward_so3_kernel(*_launch("riccati_so3", lu), lin, lu, qR, xi, refs,
                               consts, **kw)
    backward_so3_lane.launches += 1
    return out


backward_so3_lane.launches = 0


# -- B12: rollout, then the linearization of the new trajectory --------------

def rollout_linearize_so3_plain(qR, xi, us, k, K, lin, refs, consts, *, dt,
                                pendulum):
    """Plain version of kernel B12; same arguments and outputs as
    `rollout_linearize_so3_lane`."""
    N = us.shape[0]
    m = _model(consts)
    W1, W2 = consts["W1"], consts["W2"]
    oR, oxi, ou = torch.empty_like(qR), torch.empty_like(xi), torch.empty_like(us)
    oR[0], oxi[0] = qR[0], xi[0]
    new = {k_: torch.empty_like(lin[k_]) for k_ in LIN}
    R, x = qR[0], xi[0]
    for t in range(N):
        R_nn, xi_nn, ou[t], fqR_n, fxi_n = so3_rollout_stage(
            R, x, qR[t], qR[t + 1], xi[t], xi[t + 1], us[t], k[t], K[t],
            lin["d"][t], lin["fqR"][t], lin["fxi"][t], *m, dt=dt,
            pendulum=pendulum)
        # linearize stage t of the NEW trajectory: the rollout's dynamics
        # evaluation is reused, the gap-closed x_{t+1} closes the defect
        new["fqR"][t], new["fxi"][t] = fqR_n, fxi_n
        new["d"][t] = so3_defect(R_nn, xi_nn, fqR_n, fxi_n)
        new["Fx"][t], new["fu2"][t] = so3_stage_jacobian(
            R, x, ou[t], *m, dt=dt, pendulum=pendulum)
        new["lx"][t], new["lxx"][t], new["l"][t, 0] = so3_stage_cost_quad(
            R, x, refs["RbiR"][t][..., None], refs["xib"][t][..., None],
            W1, W2, W1, W2)
        oR[t + 1], oxi[t + 1] = R_nn, xi_nn
        R, x = R_nn, xi_nn
    return oR, oxi, ou, new


_ROLLOUT_ARGS = [_P] * 16 + [_D, _I] + [_P] * 11 + [_I] * 3 + [_P]


def _rollout_so3_kernel(fn, stream, qR, xi, us, k, K, lin, refs, consts, *, dt,
                        pendulum, linearize=True):
    """B12's C entry point ``fn`` on ``stream`` (arguments and outputs as
    `rollout_linearize_so3_lane`); raises if the launch fails.  With
    ``linearize`` False only the rollout phase runs, and the returned
    linearization is empty."""
    N, _, B = us.shape
    a = lambda t, shape, name: _build.arg(t, shape, us, name)
    e = lambda *s: torch.empty(s, dtype=us.dtype, device=us.device)
    oR, oxi, ou = e(N + 1, 3, 3, B), e(N + 1, 3, B), e(N, NU, B)
    new = _alloc_lin(e, N, B) if linearize else {}
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(xi, (N + 1, 3, B), "xi"),
             a(us, (N, NU, B), "us"), a(k, (N, NU, B), "k"), a(K, (N, NU, NX, B), "K"),
             a(lin["d"], (N, NX, B), "d"), a(lin["fqR"], (N, 3, 3, B), "fqR"),
             a(lin["fxi"], (N, 3, B), "fxi"),
             a(refs["RbiR"], (N + 1, 3, 3), "RbiR"), a(refs["xib"], (N + 1, 3), "xib"),
             *_model_ptrs(a, consts), float(dt), int(pendulum),
             a(oR, oR.shape, "oR"), a(oxi, oxi.shape, "oxi"), a(ou, ou.shape, "ou"),
             *([a(new[k_], new[k_].shape, k_) for k_ in LIN] if linearize
               else [None] * len(LIN)),
             N, B, _build.device_index(us), stream)
    _build.check(err, "rollout_so3")
    return oR, oxi, ou, new


def rollout_linearize_so3_lane(qR, xi, us, k, K, lin, refs, consts, *, dt,
                               pendulum):
    """Kernel B12 (replaces
    `solvers/pipeline_so3.py::_rollout_linearize_kernel_so3` as called by
    `SO3PipelineSolver._rollout_linearize_lane`).

    The gap-closing rollout and the linearization of every stage of the
    NEW trajectory.  Nominal qR (N+1, 3, 3, B), xi (N+1, 3, B), us
    (N, 3, B); gains k (N, 3, B), K (N, 3, 6, B); ``lin`` d, fqR, fxi of the
    nominal; ``refs`` and ``consts`` as `linearize_so3_lane`.  Returns the
    new (qR, xi) (N+1 stages, stage 0 unchanged), us and ``lin`` as
    `linearize_so3_lane` returns it.

    On an H100 it runs in two phases on the caller's stream, counted as one
    launch: the rollout (one problem per thread on blocks of one warp, the
    carry (R, xi) in registers, each stage's inputs copied into shared
    memory a stage ahead), then B10's kernel on the new trajectory (a
    thread per problem and stage), so the linearization's stores (Fx, lxx
    and fu2, 81 values per stage) do not wait behind the rollout's serial
    chain.  The values are the fused loop's: the same stage functions on
    the same inputs."""
    kw = dict(dt=dt, pendulum=pendulum)
    if us.device.type == "cpu":
        return rollout_linearize_so3_plain(qR, xi, us, k, K, lin, refs, consts, **kw)
    if us.device.type != "cuda":
        raise ValueError(f"rollout_linearize_so3_lane: no kernel for device {us.device}")
    out = _rollout_so3_kernel(*_launch("rollout_so3", us), qR, xi, us, k, K, lin, refs,
                              consts, **kw)
    rollout_linearize_so3_lane.launches += 1
    return out


rollout_linearize_so3_lane.launches = 0

_ARGS = {"linearize_so3": _LINEARIZE_ARGS, "riccati_so3": _RICCATI_ARGS,
         "rollout_so3": _ROLLOUT_ARGS}
KERNELS = {"B10": linearize_so3_lane, "B11": backward_so3_lane,
           "B12": rollout_linearize_so3_lane}


# -- the solver ---------------------------------------------------------------

class SO3PipelineState(NamedTuple):
    qs: torch.Tensor         # (B, N+1, 3, 3)
    xis: torch.Tensor        # (B, N+1, 3)
    us: torch.Tensor         # (B, N, 3)
    J_opt: torch.Tensor      # (B,)
    grad_norm: torch.Tensor  # (B,)


class SO3PipelineSolver:
    """End-to-end lane-layout MS-iLQR for the SO(3) attitude (``pendulum``
    False) or the 3-D pendulum: one B10, then B11 and B12 per iteration, at
    a fixed iteration budget with full steps and mu = 0 (so R > 0).

    ``term_quirk``: the terminal value and gradient weighted by Q, the
    Hessian by P (the reference SO(3) cost); False weights all three by P.
    ``plain``: run the plain versions of B10-B12 whatever the device (the
    reference path the kernels are held against on the card)."""

    def __init__(self, N: int, iterations: int, dt: float,
                 pendulum: bool = False, term_quirk: bool = True,
                 plain: bool = False):
        self.N = N
        self.iterations = iterations
        self.dt = float(dt)
        self.pendulum = pendulum
        self.term_quirk = term_quirk
        if plain:
            self._linearize, self._backward, self._rollout_linearize = (
                linearize_so3_plain, backward_so3_plain, rollout_linearize_so3_plain)
        else:
            self._linearize, self._backward, self._rollout_linearize = (
                linearize_so3_lane, backward_so3_lane, rollout_linearize_so3_lane)

    def _prepare(self, dyn, cost, q0s, xi0s, us0):
        """Lane-layout setup: constants, references and the initial
        (qR, xi, us) state, x0 followed by the reference tail."""
        B = us0.shape[0]
        dev, dtp = us0.device, us0.dtype
        cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtp).contiguous()
        if self.pendulum:
            rho = (cast(dyn.l) / 2.0) * torch.tensor([0.0, 0.0, -1.0], dtype=dtp,
                                                     device=dev)
            mgr, mr = cast(dyn.m) * cast(dyn.g) * rho, cast(dyn.m) * rho
        else:
            mgr = mr = torch.zeros(3, dtype=dtp, device=dev)
        Q1, Q2, P1, P2 = cast(cost.Q1), cast(cost.Q2), cast(cost.P1), cast(cost.P2)
        R = cast(cost.R)
        consts = dict(J=cast(dyn.J), Jinv=cast(dyn.Jinv), W1=Q1, W2=Q2,
                      mgr=mgr.contiguous(), mr=mr.contiguous(), R=R,
                      Luu=(2.0 * R).contiguous(),
                      W1vN=Q1 if self.term_quirk else P1,
                      W2vN=Q2 if self.term_quirk else P2, W1hN=P1, W2hN=P2)
        refs = dict(RbiR=cast(cost.q_ref_inv), xib=cast(cost.xi_ref))
        q_ref, xi_ref = cast(cost.q_ref), cast(cost.xi_ref)
        first = lambda x: cast(x).movedim(0, -1)[None]
        tail = lambda x: x[1:, ..., None].expand(x[1:].shape + (B,))
        qR = torch.cat([first(q0s), tail(q_ref)]).contiguous()
        xi = torch.cat([first(xi0s), tail(xi_ref)]).contiguous()
        return qR, xi, us0.movedim(0, -1).contiguous(), refs, consts

    def _backward_metrics(self, qR, xi, us, lin, refs, consts):
        """B11, the mean per-stage gradient norm and the cost J of the
        current trajectory."""
        R = consts["R"]
        lu = 2.0 * torch.einsum("ij,nj...->ni...", R, us)
        k, K, gvec, lN = self._backward(lin, lu.contiguous(), qR, xi, refs,
                                        consts, pendulum=self.pendulum)
        g = torch.mean(torch.sqrt(torch.sum(gvec * gvec, dim=1)), dim=0)
        J = (torch.sum(lin["l"][:, 0], dim=0)
             + torch.einsum("ni...,ij,nj...->...", us, R, us) + lN)
        return k, K, J, g

    def solve_lane(self, dyn, cost, q0s, xi0s, us0):
        """The solve in lane layout.  Returns dict(qR, xi, us, J, g, refs,
        consts, lin): the final trajectory, the cost and mean gradient norm
        of the last backward pass, and the linearization of the final
        trajectory."""
        us0 = torch.as_tensor(us0, device=solve_device(us0))
        B = us0.shape[0]
        qR, xi, us, refs, consts = self._prepare(dyn, cost, q0s, xi0s, us0)
        kw = dict(dt=self.dt, pendulum=self.pendulum)
        J = torch.full((B,), float("inf"), dtype=us0.dtype, device=us0.device)
        g = J.clone()
        lin = self._linearize(qR, xi, us, refs, consts, **kw)
        for _ in range(self.iterations):
            k, K, J, g = self._backward_metrics(qR, xi, us, lin, refs, consts)
            qR, xi, us, lin = self._rollout_linearize(qR, xi, us, k, K, lin,
                                                      refs, consts, **kw)
        return dict(qR=qR, xi=xi, us=us, J=J, g=g, refs=refs, consts=consts,
                    lin=lin)

    def solve(self, dyn, cost, q0s, xi0s, us0):
        """dyn: `SO3Params` (or `Pendulum3dParams` with ``pendulum``); cost:
        `TrackingCostParams` on SO(3); solver-layout q0s (B, 3, 3),
        xi0s (B, 3), us0 (B, N, 3).  The solve runs in us0's dtype, on its
        device if it is a tensor, else on the card.
        Returns an `SO3PipelineState`."""
        s = self.solve_lane(dyn, cost, q0s, xi0s, us0)
        bk = lambda x: x.movedim(-1, 0)
        return SO3PipelineState(qs=bk(s["qR"]), xis=bk(s["xi"]), us=bk(s["us"]),
                                J_opt=s["J"], grad_norm=s["g"])
