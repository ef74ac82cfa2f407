"""Lane-layout MS-iLQR pipeline (counterpart of the JAX `solvers/pipeline.py`),
with kernels B2 (Riccati backward), B3 (rollout fused with the next
linearization) and B4 (rollout).

The whole solve stays in lane layout (batch last); conversion happens once
at entry and exit.  Per iteration, by default, two kernels run: the backward
pass (B2) and the rollout fused with the next iteration's stage
linearization (B3), after one standalone linearization (B1) up front.  With
``fused=False`` each iteration runs linearize (B1), backward (B2) and
rollout (B4).

Scope: SE(3) free body (or rigid body / drone with ``gravity``) + GN
tracking cost, fixed iteration budget, full steps, mu = 0 (so Quu must be
positive definite: R > 0).  Fu and Luu are constant and Lux = 0.

Each kernel wrapper (`backward_lane`, `rollout_lane`,
`rollout_linearize_lane`) takes the plain version (`*_plain`, a Python loop
over stages) for CPU tensors and launches the CUDA kernel
(`csrc/pipeline.cu`) for CUDA tensors, or raises.  The tuned kernels take
nu = 6 and 4; at every other nu the same wrappers launch the runtime-nu
instances (`csrc/pipeline_nu.cu`: nu.cuh up to 12, nu_large.cuh from 13
to `_build.MAX_NU`) and count them apart (each wrapper's ``nu.launches``
and ``nuL.launches``), and nu outside 1..MAX_NU raises ValueError before
any launch.
"""

from typing import NamedTuple

import types

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    defect,
    lane_refs,
    linearize_lane,
    linearize_plain,
    stage_cost_quad,
    stage_dynamics_eval,
    stage_jacobian,
    stage_refs,
)

NX = 12


def solve_device(x):
    """The device a solve on ``x`` runs on: ``x``'s when it is a tensor, else
    the card.  The CPU takes a solve only when it is given CPU tensors."""
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


# -- Riccati backward, const-Fu/Luu specialization ---------------------------

def chol_factor_lane(Quu, nu):
    """Batched nu x nu Cholesky of Quu (nu, nu, *b), column by column, each
    column's rows at once: entry (i, j) is Quu[i, j] - L[i, 0] L[j, 0] -
    L[i, 1] L[j, 1] - ... in that order, as the kernels sum it.  Returns L
    (nu, nu, *b), its lower triangle set.  The DIAGONAL IS STORED AS ITS
    RECIPROCAL (L[j][j] = 1/sqrt(pivot)); `chol_solve_lane` multiplies by it."""
    L = torch.empty_like(Quu)
    for j in range(nu):
        sv = Quu[j:, j]
        for kk in range(j):
            sv = sv - L[j:, kk] * L[j, kk]
        inv = 1.0 / torch.sqrt(sv[0])
        L[j, j] = inv
        L[j + 1:, j] = sv[1:] * inv
    return L


def chol_solve_lane(L, Bm, nu):
    """Solve (L L^T) X = Bm for Bm (nu, p, *b); ``L`` from `chol_factor_lane`.
    The forward substitution updates the rows below each Y[kk] at once, which
    subtracts the terms of each row in the kernels' order (kk ascending)."""
    Y = [None] * nu
    S = Bm
    for kk in range(nu):
        Y[kk] = S[0] * L[kk, kk]
        if kk + 1 < nu:
            S = S[1:] - L[kk + 1:, kk].unsqueeze(1) * Y[kk]
    X = [None] * nu
    for i2 in reversed(range(nu)):
        sv = Y[i2]
        for kk in range(i2 + 1, nu):
            sv = sv - L[kk][i2] * X[kk]
        X[i2] = sv * L[i2][i2]
    return torch.stack(X)


def hessian_chain(fx, Vxx, lxx_t, fu2, fu2T, Luu, *, nu, glow, half=6,
                  luual_t=None):
    """The value-Hessian (preconditioner) part of a Riccati step, with the
    block structure Fu = [0; fu2], Lux = 0 and Fx = [[A, Bb], [C, D]] (C = 0
    unless ``glow``, the gravity J_xi_q block): Q_xx, Q_ux, Q_uu (``Luu``
    (nu, nu, 1) constant, ``luual_t`` (nu, *b) an AL diagonal added to it),
    the Cholesky factor L of Q_uu and K = -Q_uu^-1 Q_ux.
    Returns (Qxx, Qux, Quu, L, K)."""
    h = half
    A, Bb, D = fx[:h, :h], fx[:h, h:], fx[h:, h:]
    AT, BbT, DT = ll.transpose(A), ll.transpose(Bb), ll.transpose(D)
    VF_l = ll.matmul(Vxx[:, :h], A)
    VF_r = ll.matmul(Vxx[:, :h], Bb) + ll.matmul(Vxx[:, h:], D)
    if glow:
        C = fx[h:, :h]
        VF_l = VF_l + ll.matmul(Vxx[:, h:], C)
    VF = torch.cat([VF_l, VF_r], dim=1)
    Qxx_top = ll.matmul(AT, VF[:h])
    if glow:
        Qxx_top = Qxx_top + ll.matmul(ll.transpose(C), VF[h:])
    Qxx_bot = ll.matmul(BbT, VF[:h]) + ll.matmul(DT, VF[h:])
    Qxx = lxx_t + torch.cat([Qxx_top, Qxx_bot], dim=0)
    Qux = ll.matmul(fu2T, VF[h:])                       # Lux = 0
    Quu = Luu + ll.matmul(fu2T, ll.matmul(Vxx[h:, h:], fu2))
    if luual_t is not None:
        eye = torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
        Quu = Quu + eye.reshape((nu, nu) + (1,) * (Quu.dim() - 2)) * luual_t[:, None]
    L = chol_factor_lane(Quu, nu)
    K = -chol_solve_lane(L, Qux, nu)
    return Qxx, Qux, Quu, L, K


def adjoint_chain(fx, Vmod, lx_t, lu_t, fu2T, *, glow, half=6):
    """The gradient (residual) part of a Riccati step: Qx = lx + Fx^T Vmod,
    Qu = lu + fu2^T Vmod[h:], with Vmod = V_x + V_xx d.  Returns (Qx, Qu)."""
    h = half
    Qx_top = ll.matvec(ll.transpose(fx[:h, :h]), Vmod[:h])
    Qx_bot = (ll.matvec(ll.transpose(fx[:h, h:]), Vmod[:h])
              + ll.matvec(ll.transpose(fx[h:, h:]), Vmod[h:]))
    if glow:
        Qx_top = Qx_top + ll.matvec(ll.transpose(fx[h:, :h]), Vmod[h:])
    Qx = lx_t + torch.cat([Qx_top, Qx_bot], dim=0)
    Qu = lu_t + ll.matvec(fu2T, Vmod[h:])
    return Qx, Qu


def value_update(K, k, Qu, Qxx, Qux, Quu):
    """The V_x correction terms (K^T Q_uu k, K^T Q_u, Q_ux^T k) and the
    symmetrized V_xx of a Riccati step.  KT Qux + QuxT K = M + M^T, so one
    product and the symmetrized (Qxx + KTQuu K) give V_xx."""
    KT = ll.transpose(K)
    KTQuu = ll.matmul(KT, Quu)
    terms = (ll.matvec(KTQuu, k), ll.matvec(KT, Qu),
             ll.matvec(ll.transpose(Qux), k))
    M = ll.matmul(KT, Qux)
    S = Qxx + ll.matmul(KTQuu, K)
    Vxx_new = 0.5 * (S + ll.transpose(S)) + M + ll.transpose(M)
    return terms, Vxx_new


def riccati_stage(fx, dd, lx_t, lu_t, lxx_t, fu2, fu2T, Luu, Vx, Vxx,
                  *, nu, glow, half=6, luual_t=None):
    """One defect-aware Riccati step on lane values, with the block
    structure Fu = [0; fu2], Lux = 0 and Fx = [[A, Bb], [C, D]] (C = 0
    unless ``glow``, the gravity J_xi_q block).  ``Luu`` (nu, nu, 1) is
    constant; ``luual_t`` (nu, *b) adds the AL diagonal to Quu.
    Returns (k, K, Qu, Vx_new, Vxx_new)."""
    Vmod = Vx + ll.matvec(Vxx, dd)
    Qx, Qu = adjoint_chain(fx, Vmod, lx_t, lu_t, fu2T, glow=glow, half=half)
    Qxx, Qux, Quu, L, K = hessian_chain(fx, Vxx, lxx_t, fu2, fu2T, Luu, nu=nu,
                                        glow=glow, half=half, luual_t=luual_t)
    k = -chol_solve_lane(L, Qu[:, None], nu)[:, 0]
    (c1, c2, c3), Vxx_new = value_update(K, k, Qu, Qxx, Qux, Quu)
    return k, K, Qu, Qx + c1 + c2 + c3, Vxx_new


def backward_plain(lin, lu, qR, qp, xi, refs, consts, *, glow, luu_al=None):
    """Plain version of kernel B2: the terminal quadratization, then
    `riccati_stage` over the stages in reverse.  Same arguments and outputs
    as `backward_lane`."""
    N, nu = lu.shape[:2]
    lxN, lxxN, lN = stage_cost_quad(qR[N], qp[N], xi[N], *stage_refs(refs, N),
                                    consts["W1N"], consts["W2N"])
    fu2 = consts["fu2"]
    Luu = consts["Luu"][..., None]
    k = torch.empty_like(lu)
    K = torch.empty((N, nu, NX) + tuple(lu.shape[2:]), dtype=lu.dtype,
                    device=lu.device)
    gvec = torch.empty_like(lu)
    Vx, Vxx = lxN, lxxN
    for t in reversed(range(N)):
        k[t], K[t], gvec[t], Vx, Vxx = riccati_stage(
            lin["Fx"][t], lin["d"][t], lin["lx"][t], lu[t], lin["lxx"][t],
            fu2, fu2.T, Luu, Vx, Vxx, nu=nu, glow=glow,
            luual_t=None if luu_al is None else luu_al[t])
    return k, K, gvec, lN


_P, _I = _build.PTR, _build.INT
_RICCATI_ARGS = [_P] * 17 + [_I] + [_P] * 4 + [_I] * 4 + [_P]
# the runtime-nu entry also takes the fp64 terminal hand-off (48, B)
_RICCATI_NU_ARGS = _RICCATI_ARGS + [_P]


def _backward_kernel(fn, stream, lin, lu, qR, qp, xi, refs, consts, *, glow,
                     luu_al, hand=False):
    """Check the arguments, allocate the outputs and launch B2 through the C
    entry point ``fn`` on ``stream``; ``hand``: ``fn`` is the runtime-nu
    entry, which also takes the (48, B) array its fp64 terminal
    quadratization hands over in (allocated here; none in f32)."""
    N, nu, B = lu.shape
    a = lambda t, shape, name: _build.arg(t, shape, lu, name)
    e = lambda *shape: torch.empty(shape, dtype=lu.dtype, device=lu.device)
    k, K, gvec, lN = e(N, nu, B), e(N, nu, NX, B), e(N, nu, B), e(B)
    extra = []
    if hand:
        hand = e(48, B) if lu.dtype == torch.float64 else None  # alive until the launch
        extra = [None if hand is None else a(hand, (48, B), "hand")]
    err = fn(a(lin["Fx"], (N, NX, NX, B), "Fx"), a(lin["d"], (N, NX, B), "d"),
             a(lin["lx"], (N, NX, B), "lx"), a(lu, (N, nu, B), "lu"),
             a(lin["lxx"], (N, NX, NX, B), "lxx"),
             None if luu_al is None else a(luu_al, (N, nu, B), "luu_al"),
             a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"),
             a(refs["RbiR"], (N + 1, 3, 3), "RbiR"),
             a(refs["Rbip"], (N + 1, 3), "Rbip"),
             a(refs["Adb"], (N + 1, 6, 6), "Adb"),
             a(refs["xib"], (N + 1, 6), "xib"),
             a(consts["W1N"], (6, 6), "W1N"), a(consts["W2N"], (6, 6), "W2N"),
             a(consts["fu2"], (6, nu), "fu2"), a(consts["Luu"], (nu, nu), "Luu"),
             int(glow), a(k, k.shape, "k"), a(K, K.shape, "K"),
             a(gvec, gvec.shape, "gvec"), a(lN, lN.shape, "lN"),
             N, nu, B, _build.device_index(lu), stream, *extra)
    _build.check(err, "riccati")
    return k, K, gvec, lN


def backward_lane(lin, lu, qR, qp, xi, refs, consts, *, glow, luu_al=None):
    """Kernel B2 (replaces `solvers/pipeline.py::_riccati_kernel_const` as
    called by `PallasPipelineSolver._backward_lane`).

    ``lin``: Fx (N, 12, 12, B), d (N, 12, B), lx (N, 12, B),
    lxx (N, 12, 12, B); ``lu`` (N, nu, B); the terminal state is stage N of
    qR (N+1, 3, 3, B), qp, xi; ``refs`` as for `linearize_lane`; ``consts``
    W1N, W2N (6, 6) (the terminal weights P1, P2), fu2 (6, nu), Luu (nu, nu).
    ``glow``: the gravity J_xi_q block of Fx is nonzero.  ``luu_al``:
    optional (N, nu, B) diagonal Quu additions (input-box AL penalty).
    Returns k (N, nu, B), K (N, nu, 12, B), gvec = Qu (N, nu, B), lN (B,).

    On an H100 a group of 16 threads runs one problem's recursion: lane r
    keeps row r of V_xx in registers, the group exchanges V_xx F, K and the
    new V_xx's halves through shared memory, and each stage's inputs are
    copied there one stage ahead.  In fp64 the terminal quadratization runs
    first, a thread a problem, and each lane of the group computes a 3 x 3
    block of every 12 x 12 product, V_xx between stages in shared memory:
    two kernels on the caller's stream, counted as one launch.

    At nu other than 6 and 4 it launches the runtime-nu instance, counted in
    ``backward_lane.nu``: the same design with nu a runtime argument
    (`csrc/nu.cuh`): every per-lane array sized for the instance's maximum
    (6, or 12 past nu = 6), fu2 and Luu padded in shared memory so that the
    dimensions past nu contribute exact zeros, the stage copies and stores
    of the (N, nu, ...) arrays at the runtime nu; in fp64 the terminal
    quadratization hands over in a (48, B) array of its own.  Past nu = 12
    the large-nu instance, counted in ``backward_lane.nuL``
    (`csrc/riccati_large.cuh`): Q_uu, its factor and the nu-long arrays in
    the group's shared memory (sized from nu at launch), lane l the rows
    l, l + 16, l + 32 of Q_uu, of its factor and of the 13 right-hand sides,
    the factorization and the solves a barrier step a row, every lane's
    rows updated at once; the 12 x 12 products a 3 x 3 block a lane."""
    kw = dict(glow=glow, luu_al=luu_al)
    if lu.device.type == "cpu":
        return backward_plain(lin, lu, qR, qp, xi, refs, consts, **kw)
    _build.check_nu("backward_lane", lu.shape[1])
    if lu.device.type != "cuda":
        raise ValueError(f"backward_lane: no kernel for device {lu.device}")
    tuned = lu.shape[1] in _build.TUNED_NU
    fn = (_build.function("pipeline", "riccati", _build.suffix(lu.dtype), _RICCATI_ARGS)
          if tuned else _build.function("pipeline_nu", "riccati_nu",
                                        _build.suffix(lu.dtype), _RICCATI_NU_ARGS))
    out = _backward_kernel(fn, torch.cuda.current_stream(lu.device).cuda_stream,
                           lin, lu, qR, qp, xi, refs, consts, hand=not tuned, **kw)
    _build.nu_counter(backward_lane, lu.shape[1]).launches += 1
    return out


backward_lane.launches = 0
backward_lane.nu = types.SimpleNamespace(launches=0)
backward_lane.nuL = types.SimpleNamespace(launches=0)


# -- rollout ------------------------------------------------------------------

def deviation(R_new, p_new, xi_new, qR_t, qp_t, xi_t):
    """xs_err = [Log((qR_t, qp_t)^-1 (R_new, p_new)); xi_new - xi_t]: the
    tangent-space deviation of the new state from the nominal."""
    Ri_inv, pi_inv = ll.se3_inverse(qR_t, qp_t)
    Re, pe = ll.se3_compose(Ri_inv, pi_inv, R_new, p_new)
    return torch.cat([ll.se3_log(Re, pe), xi_new - xi_t], dim=0)


def gap_close(R_new, p_new, xi_new, u_new, qRn_t, qpn_t, xin_t, d_t, fqR_t,
              fqp_t, fxi_t, Jl, Jil, Pu, mg, *, dt, gravity):
    """The dynamics evaluation f(x_new, u_new) and the gap-closing step
    x+ = x_next Exp(d) f(xbar)^-1 f(x_new).
    Returns (R_nn, p_nn, xi_nn, fqR_n, fqp_n, fxi_new)."""
    fqR_n, fqp_n, fxi_new = stage_dynamics_eval(
        R_new, p_new, xi_new, u_new, Jl, Jil, Pu, mg, dt=dt, gravity=gravity)
    edR, edp = ll.se3_exp(d_t[:6])
    fiR, fip = ll.se3_inverse(fqR_t, fqp_t)
    R_a, p_a = ll.se3_compose(qRn_t, qpn_t, edR, edp)
    R_b, p_b = ll.se3_compose(R_a, p_a, fiR, fip)
    R_nn, p_nn = ll.se3_compose(R_b, p_b, fqR_n, fqp_n)
    R_nn = ll.so3_normalize(R_nn)
    xi_nn = xin_t + fxi_new - fxi_t + d_t[6:]
    return R_nn, p_nn, xi_nn, fqR_n, fqp_n, fxi_new


def rollout_stage(R_new, p_new, xi_new, qR_t, qp_t, qRn_t, qpn_t, xi_t,
                  xin_t, u_t, k_t, K_t, d_t, fqR_t, fqp_t, fxi_t,
                  Jl, Jil, Pu, mg, *, dt, gravity):
    """One gap-closing rollout step on lane values: feedback on the
    tangent-space deviation from the nominal, then the group composition
    x+ = x_next Exp(d) f(xbar)^-1 f(x_new).
    Returns (R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new)."""
    xs_err = deviation(R_new, p_new, xi_new, qR_t, qp_t, xi_t)
    u_new = u_t + k_t + ll.matvec(K_t, xs_err)
    R_nn, p_nn, xi_nn, fqR_n, fqp_n, fxi_new = gap_close(
        R_new, p_new, xi_new, u_new, qRn_t, qpn_t, xin_t, d_t, fqR_t, fqp_t,
        fxi_t, Jl, Jil, Pu, mg, dt=dt, gravity=gravity)
    return R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new


def _rollout_plain(qR, qp, xi, us, k, K, lin, refs, consts, *, dt, gravity,
                   exact_grav, fused):
    N = us.shape[0]
    c = consts
    oR, op, oxi, ou = (torch.empty_like(x) for x in (qR, qp, xi, us))
    oR[0], op[0], oxi[0] = qR[0], qp[0], xi[0]
    new = {}
    if fused:
        new = {k_: torch.empty_like(lin[k_]) for k_ in
               ("fqR", "fqp", "fxi", "d", "Fx", "lx", "lxx", "l")}
    R, p, x = qR[0], qp[0], xi[0]
    for t in range(N):
        R_nn, p_nn, xi_nn, ou[t], fqR_n, fqp_n, fxi_n = rollout_stage(
            R, p, x, qR[t], qp[t], qR[t + 1], qp[t + 1], xi[t], xi[t + 1],
            us[t], k[t], K[t], lin["d"][t], lin["fqR"][t], lin["fqp"][t],
            lin["fxi"][t], c["J"], c["Jinv"], c["Pu"], c["mg"], dt=dt,
            gravity=gravity)
        if fused:
            # linearize stage t of the NEW trajectory: the rollout's dynamics
            # evaluation is reused, the gap-closed x_{t+1} closes the defect
            new["fqR"][t], new["fqp"][t], new["fxi"][t] = fqR_n, fqp_n, fxi_n
            new["d"][t] = defect(R_nn, p_nn, xi_nn, fqR_n, fqp_n, fxi_n)
            new["Fx"][t] = stage_jacobian(R, x, c["J"], c["Jinv"], c["mg"],
                                          dt=dt, gravity=gravity,
                                          exact_grav=exact_grav)
            new["lx"][t], new["lxx"][t], new["l"][t, 0] = stage_cost_quad(
                R, p, x, *stage_refs(refs, t), c["W1"], c["W2"])
        oR[t + 1], op[t + 1], oxi[t + 1] = R_nn, p_nn, xi_nn
        R, p, x = R_nn, p_nn, xi_nn
    return oR, op, oxi, ou, new


def rollout_plain(qR, qp, xi, us, k, K, lin, consts, *, dt, gravity):
    """Plain version of kernel B4; same arguments and outputs as
    `rollout_lane`."""
    return _rollout_plain(qR, qp, xi, us, k, K, lin, None, consts, dt=dt,
                          gravity=gravity, exact_grav=False, fused=False)[:4]


def rollout_linearize_plain(qR, qp, xi, us, k, K, lin, refs, consts, *, dt,
                            gravity, exact_grav):
    """Plain version of kernel B3; same arguments and outputs as
    `rollout_linearize_lane`."""
    return _rollout_plain(qR, qp, xi, us, k, K, lin, refs, consts, dt=dt,
                          gravity=gravity, exact_grav=exact_grav, fused=True)


_D = _build.DBL
_ROLLOUT_ARGS = [_P] * 19 + [_D, _D, _I, _I] + [_P] * 12 + [_I] * 4 + [_P]


def _rollout_kernel(fn, stream, qR, qp, xi, us, k, K, lin, refs, consts, *,
                    dt, gravity, exact_grav, fused):
    N, nu, B = us.shape
    a = lambda t, shape, name: _build.arg(t, shape, us, name)
    e = lambda *shape: torch.empty(shape, dtype=us.dtype, device=us.device)
    oR, op, oxi, ou = e(N + 1, 3, 3, B), e(N + 1, 3, B), e(N + 1, 6, B), e(N, nu, B)
    new = {}
    if fused:
        new = dict(fqR=e(N, 3, 3, B), fqp=e(N, 3, B), fxi=e(N, 6, B),
                   d=e(N, NX, B), Fx=e(N, NX, NX, B), lx=e(N, NX, B),
                   lxx=e(N, NX, NX, B), l=e(N, 1, B))
        r = lambda key, shape: a(refs[key], shape, key)
        ref_ptrs = [r("RbiR", (N + 1, 3, 3)), r("Rbip", (N + 1, 3)),
                    r("Adb", (N + 1, 6, 6)), r("xib", (N + 1, 6)),
                    a(consts["W1"], (6, 6), "W1"), a(consts["W2"], (6, 6), "W2")]
    else:
        ref_ptrs = [None] * 6
    c = consts
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"), a(us, (N, nu, B), "us"),
             a(k, (N, nu, B), "k"), a(K, (N, nu, NX, B), "K"),
             a(lin["d"], (N, NX, B), "d"), a(lin["fqR"], (N, 3, 3, B), "fqR"),
             a(lin["fqp"], (N, 3, B), "fqp"), a(lin["fxi"], (N, 6, B), "fxi"),
             *ref_ptrs[:4], a(c["J"], (6, 6), "J"), a(c["Jinv"], (6, 6), "Jinv"),
             *ref_ptrs[4:], a(c["Pu"], (6, nu), "Pu"), float(c["mg"]), float(dt),
             int(gravity), int(exact_grav),
             a(oR, oR.shape, "oR"), a(op, op.shape, "op"), a(oxi, oxi.shape, "oxi"),
             a(ou, ou.shape, "ou"),
             *([a(new[k_], new[k_].shape, k_) for k_ in
                ("fqR", "fqp", "fxi", "d", "Fx", "lx", "lxx", "l")]
               if fused else [None] * 8),
             N, nu, B, _build.device_index(us), stream)
    _build.check(err, "rollout_linearize" if fused else "rollout")
    return oR, op, oxi, ou, new


def _rollout_entry(tuned):
    """(unit, entry) of B3's and B4's C entry: the tuned instances' or the
    runtime-nu ones'."""
    return ("pipeline", "rollout") if tuned else ("pipeline_nu", "rollout_nu")


def rollout_lane(qR, qp, xi, us, k, K, lin, consts, *, dt, gravity=False):
    """Kernel B4 (replaces `solvers/pipeline.py::_rollout_kernel_lane` as
    called by `PallasPipelineSolver._rollout_lane`).

    Nominal trajectory qR (N+1, 3, 3, B), qp, xi, us (N, nu, B); gains
    k (N, nu, B), K (N, nu, 12, B); ``lin`` d, fqR, fqp, fxi of the nominal;
    ``consts`` J, Jinv (6, 6), Pu (6, nu), mg.  Returns the new
    (qR, qp, xi) (N+1 stages, stage 0 unchanged) and us (N, nu, B).

    On an H100: one thread per problem walks the stages with the carry
    (R, p, xi) in registers, on blocks of one warp, and copies the next
    stage's ~150 inputs into shared memory while it computes a stage (in
    fp64 each input once: the nominal states in a ring of three, K in the
    slot the feedback has just read).

    At nu other than 6 and 4 it launches the large-nu rollout
    (`csrc/nu_large.cuh`), in f32 and fp64 alike the fp64 rollout's design
    with nu a runtime argument: each stage input copied once into the
    thread's shared-memory column and read where it is used, u, k and K in a
    feedback slot of 14 nu values, refilled with the next stage's as soon as
    a stage's feedback has read it, so the feedback's loop over the inputs
    reads shared memory and nothing on the carry's chain waits on device
    memory; where the slots cannot hold the whole batch at once, the same
    kernel reads them from device memory.  Up to nu = 12 (counted in
    ``rollout_lane.nu``) a stage-parallel pass (`g_kernel`) first forms
    G_t = (x_{t+1} Exp(d_q)) f(xbar_t)^-1 of every stage while the batch
    fills at most `rollout_nu_g_warps` one-warp blocks an SM, and the
    rollout reads it; past that the rollout forms G_t in its loop, as it
    does past nu = 12 (counted in ``rollout_lane.nuL``).
    `rollout_nu_instances` and `rollout_large_instances` count the
    launches by the instance taken."""
    kw = dict(dt=dt, gravity=gravity)
    if us.device.type == "cpu":
        return rollout_plain(qR, qp, xi, us, k, K, lin, consts, **kw)
    _build.check_nu("rollout_lane", us.shape[1])
    if us.device.type != "cuda":
        raise ValueError(f"rollout_lane: no kernel for device {us.device}")
    tuned = us.shape[1] in _build.TUNED_NU
    fn = _build.function(*_rollout_entry(tuned), _build.suffix(us.dtype), _ROLLOUT_ARGS)
    out = _rollout_kernel(fn, torch.cuda.current_stream(us.device).cuda_stream,
                          qR, qp, xi, us, k, K, lin, None, consts,
                          exact_grav=False, fused=False, **kw)
    _build.nu_counter(rollout_lane, us.shape[1]).launches += 1
    return out[:4]


rollout_lane.launches = 0
rollout_lane.nu = types.SimpleNamespace(launches=0)
rollout_lane.nuL = types.SimpleNamespace(launches=0)


def rollout_large_instances(dtype):
    """{"slot": n, "device": n}: the large-nu rollout's launches in ``dtype``
    past nu = 12 (B3nuL's first phase and B4nuL alike) since its library was
    loaded, by the instance its launcher took: the feedback from the
    shared-memory slot while the whole batch is resident at once, else from
    device memory."""
    fn = _build.function("pipeline_nu", "rollout_large_launches", _build.suffix(dtype),
                         [_build.INT])
    return {"slot": fn(1), "device": fn(0)}


def rollout_nu_instances(dtype):
    """{"pass slot", "pass device", "slot", "device": n}: the rollout's
    launches in ``dtype`` at nu <= 12 other than 6 and 4 (B3nu's first phase
    and B4nu alike) since its library was loaded, by the instance taken:
    with g_kernel's pass before it or not, the feedback from its slot or
    from device memory (as `rollout_large_instances`)."""
    fn = _build.function("pipeline_nu", "rollout_nu_launches", _build.suffix(dtype),
                         [_build.INT])
    return {"pass slot": fn(3), "pass device": fn(2), "slot": fn(1), "device": fn(0)}


def rollout_nu_g_warps(dtype):
    """The one-warp blocks an SM up to which the rollout at nu <= 12 in
    ``dtype`` takes g_kernel's pass: it runs the pass for B <= this x 32 x
    the card's SMs (`csrc/nu_large.cuh` kRolloutNuGWarps)."""
    return _build.function("pipeline_nu", "rollout_nu_g_warps", _build.suffix(dtype), [])()


def rollout_linearize_lane(qR, qp, xi, us, k, K, lin, refs, consts, *, dt,
                           gravity=False, exact_grav=False):
    """Kernel B3 (replaces `solvers/pipeline.py::_rollout_linearize_kernel`
    as called by `PallasPipelineSolver._rollout_linearize_lane`).

    B4's new trajectory and B1's linearization of it.
    Arguments as `rollout_lane` plus ``refs`` and ``consts`` W1, W2.
    Returns (qR, qp, xi, us, lin) with ``lin`` as `linearize_lane` returns it.

    On an H100 it runs in two phases on the caller's stream, counted as one
    launch: B4's rollout, then B1's kernel on the new trajectory (a thread
    per problem and stage), so the linearization's stores (Fx and lxx, 288
    values per stage) do not wait behind the rollout's serial chain.  The
    values are the fused loop's: the same stage functions on the same
    inputs.  At nu other than 6 and 4: `rollout_lane`'s rollout (up to 12
    after g_kernel's pass at the batches that take it) and
    `linearize_lane`'s runtime-nu instance, counted in
    ``rollout_linearize_lane.nu``; past nu = 12 the rollout and B1's
    large-nu instance, counted in ``rollout_linearize_lane.nuL``."""
    kw = dict(dt=dt, gravity=gravity, exact_grav=exact_grav)
    if us.device.type == "cpu":
        return rollout_linearize_plain(qR, qp, xi, us, k, K, lin, refs, consts,
                                       **kw)
    _build.check_nu("rollout_linearize_lane", us.shape[1])
    if us.device.type != "cuda":
        raise ValueError(f"rollout_linearize_lane: no kernel for device {us.device}")
    tuned = us.shape[1] in _build.TUNED_NU
    fn = _build.function(*_rollout_entry(tuned), _build.suffix(us.dtype), _ROLLOUT_ARGS)
    out = _rollout_kernel(fn, torch.cuda.current_stream(us.device).cuda_stream,
                          qR, qp, xi, us, k, K, lin, refs, consts, fused=True,
                          **kw)
    _build.nu_counter(rollout_linearize_lane, us.shape[1]).launches += 1
    return out


rollout_linearize_lane.launches = 0
rollout_linearize_lane.nu = types.SimpleNamespace(launches=0)
rollout_linearize_lane.nuL = types.SimpleNamespace(launches=0)


# the tuned instances (nu = 6 and 4), the runtime-nu ones (nu <= 12) and the
# large-nu ones, each counted
KERNELS = {"B1": linearize_lane, "B2": backward_lane,
           "B3": rollout_linearize_lane, "B4": rollout_lane,
           "B1nu": linearize_lane.nu, "B2nu": backward_lane.nu,
           "B3nu": rollout_linearize_lane.nu, "B4nu": rollout_lane.nu,
           "B1nuL": linearize_lane.nuL, "B2nuL": backward_lane.nuL,
           "B3nuL": rollout_linearize_lane.nuL, "B4nuL": rollout_lane.nuL}


# -- the solver ---------------------------------------------------------------

class PipelineState(NamedTuple):
    qs: torch.Tensor         # (B, N+1, 4, 4)
    xis: torch.Tensor        # (B, N+1, 6)
    us: torch.Tensor         # (B, N, nu)
    J_opt: torch.Tensor      # (B,)
    grad_norm: torch.Tensor  # (B,)


class PipelineSolver:
    """End-to-end lane-layout MS-iLQR: 2 kernels per iteration by default
    (B2; B3), or the 3-kernel B1/B2/B4 layout with ``fused=False``.
    Iterates are the same in both layouts.

    ``gravity`` selects the rigid-body / drone family (pass
    `RigidBodyParams` as ``dyn``; its Pu sets nu);
    ``exact_gravity_jacobian`` matches the flag of `models/dynamics.py`.
    ``plain``: run the plain versions of B1-B4 whatever the device (the
    reference path the kernels are held against on the card)."""

    def __init__(self, N: int, iterations: int, dt: float,
                 gravity: bool = False, exact_gravity_jacobian: bool = False,
                 fused: bool = True, plain: bool = False):
        self.N = N
        self.iterations = iterations
        self.dt = float(dt)
        self.gravity = gravity
        self.exact_grav = exact_gravity_jacobian
        self.fused = fused
        self.plain = plain
        if plain:
            self._linearize, self._backward = linearize_plain, backward_plain
            self._rollout, self._rollout_linearize = (rollout_plain,
                                                      rollout_linearize_plain)
        else:
            self._linearize, self._backward = linearize_lane, backward_lane
            self._rollout, self._rollout_linearize = (rollout_lane,
                                                      rollout_linearize_lane)

    def _prepare(self, dyn, cost, q0s, xi0s, us0, init=None):
        """Lane-layout setup: constants, per-stage references and the initial
        (qR, qp, xi, us) state: x0 followed by the reference tail, or the
        warm start ``init`` in us0's dtype and device."""
        B, N = us0.shape[0], self.N
        dev, dtp = us0.device, us0.dtype
        cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtp).contiguous()
        Pu = getattr(dyn, "Pu", None)
        Pu = torch.eye(6, dtype=dtp, device=dev) if Pu is None else cast(Pu)
        mg = float(dyn.m * dyn.g) if self.gravity else 0.0
        Jinv = cast(dyn.Jinv)
        R = cast(cost.R)
        consts = dict(J=cast(dyn.J), Jinv=Jinv, W1=cast(cost.Q1),
                      W2=cast(cost.Q2), W1N=cast(cost.P1), W2N=cast(cost.P2),
                      Pu=Pu.contiguous(),
                      fu2=((Jinv @ Pu) * cast(dyn.dt)).contiguous(),
                      Luu=(2.0 * R).contiguous(), R=R, mg=mg)
        refs = lane_refs(cast(cost.q_ref_inv), cast(cost.Ad_ref),
                         cast(cost.xi_ref))
        if init is not None:
            return (*(cast(x) for x in init), refs, consts)
        q_ref, xi_ref = cast(cost.q_ref), cast(cost.xi_ref)
        q0s, xi0s = cast(q0s), cast(xi0s)
        first = lambda x: x.movedim(0, -1)[None]
        tail = lambda x: x[1:, ..., None].expand(x[1:].shape + (B,))
        qR = torch.cat([first(q0s[:, :3, :3]), tail(q_ref[:, :3, :3])]).contiguous()
        qp = torch.cat([first(q0s[:, :3, 3]), tail(q_ref[:, :3, 3])]).contiguous()
        xi = torch.cat([first(xi0s), tail(xi_ref)]).contiguous()
        us = us0.movedim(0, -1).contiguous()  # (N, nu, B)
        return qR, qp, xi, us, refs, consts

    def _backward_metrics(self, qR, qp, xi, us, lin, refs, consts, al):
        """B2 plus the AL terms of lu and Quu, the mean per-stage gradient
        norm and the cost J of the current trajectory."""
        R = consts["R"]
        lu = 2.0 * torch.einsum("ij,nj...->ni...", R, us)
        luu_al = None
        J_al = 0.0
        if al is not None:
            lb, ub, lam_l, imu_l = al
            nu = us.shape[1]
            lam_lo, lam_hi = lam_l[:-1, :nu], lam_l[:-1, nu:]
            im_lo, im_hi = imu_l[:-1, :nu], imu_l[:-1, nu:]
            glo = lb[None, :, None] - us
            ghi = us - ub[None, :, None]
            lu = lu - (lam_lo + im_lo * glo) + (lam_hi + im_hi * ghi)
            luu_al = (im_lo + im_hi).contiguous()
            J_al = torch.sum(lam_lo * glo + lam_hi * ghi
                             + 0.5 * (im_lo * glo * glo + im_hi * ghi * ghi),
                             dim=(0, 1))
        k, K, gvec, lN = self._backward(lin, lu.contiguous(), qR, qp, xi, refs,
                                        consts, glow=self.gravity, luu_al=luu_al)
        # gvec_t = lu + Fu^T (V_x[t+1] + V_xx[t+1] d[t]) from the kernel
        g = torch.mean(torch.sqrt(torch.sum(gvec * gvec, dim=1)), dim=0)
        J = (torch.sum(lin["l"][:, 0], dim=0)
             + torch.einsum("ni...,ij,nj...->...", us, R, us) + lN + J_al)
        return k, K, J, g

    def solve_lane(self, dyn, cost, q0s, xi0s, us0, al=None, init=None):
        """The solve in lane layout.  Returns dict(qR, qp, xi, us, J, g, refs,
        consts, lin): the final trajectory, the cost and mean gradient norm
        of the last backward pass, and (fused layout) the linearization of
        the final trajectory.

        ``init``: a warm start, the lane-layout trajectory (qR (N+1, 3, 3, B),
        qp (N+1, 3, B), xi (N+1, 6, B), us (N, nu, B)) to iterate from in
        place of x0 followed by the reference tail with us0; q0s, xi0s and
        us0 are then unused (None) and the solve takes init's dtype and
        device (those of its us)."""
        if init is not None:
            us0 = init[3].movedim(-1, 0)
        us0 = torch.as_tensor(us0, device=solve_device(us0))
        B = us0.shape[0]
        dev, dtp = us0.device, us0.dtype
        qR, qp, xi, us, refs, consts = self._prepare(dyn, cost, q0s, xi0s, us0, init)
        if al is not None:
            cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtp)
            lb, ub, lmbd, imu = al
            al = (cast(lb), cast(ub), cast(lmbd).movedim(0, -1),
                  cast(imu).movedim(0, -1))
        kw = dict(dt=self.dt, gravity=self.gravity)
        J = torch.full((B,), float("inf"), dtype=dtp, device=dev)
        g = J.clone()
        lin = None
        if self.fused:
            lin = self._linearize(qR, qp, xi, us, refs, consts,
                                  exact_grav=self.exact_grav, **kw)
            for _ in range(self.iterations):
                k, K, J, g = self._backward_metrics(qR, qp, xi, us, lin, refs,
                                                    consts, al)
                qR, qp, xi, us, lin = self._rollout_linearize(
                    qR, qp, xi, us, k, K, lin, refs, consts,
                    exact_grav=self.exact_grav, **kw)
        else:
            for _ in range(self.iterations):
                lin_t = self._linearize(qR, qp, xi, us, refs, consts,
                                        exact_grav=self.exact_grav, **kw)
                k, K, J, g = self._backward_metrics(qR, qp, xi, us, lin_t, refs,
                                                    consts, al)
                qR, qp, xi, us = self._rollout(qR, qp, xi, us, k, K, lin_t,
                                               consts, **kw)
        return dict(qR=qR, qp=qp, xi=xi, us=us, J=J, g=g, refs=refs,
                    consts=consts, lin=lin)

    def solve(self, dyn, cost, q0s, xi0s, us0, al=None):
        """dyn: SE3Params (or RigidBodyParams with ``gravity``); cost:
        TrackingCostParams; solver-layout q0s (B, 4, 4), xi0s (B, 6),
        us0 (B, N, nu), whose dtype the solve runs in, on its device if it is
        a tensor, else on the card.

        ``al``: optional input-box AL state (lb (nu,), ub (nu,),
        lmbd (B, N+1, 2nu), imu (B, N+1, 2nu) diagonal penalties), adding the
        augmented-Lagrangian u-terms to every backward pass."""
        s = self.solve_lane(dyn, cost, q0s, xi0s, us0, al=al)
        qR, qp, xi, us = s["qR"], s["qp"], s["xi"], s["us"]
        B, N = us.shape[-1], self.N
        bk = lambda x: x.movedim(-1, 0)
        qs = torch.zeros((B, N + 1, 4, 4), dtype=us.dtype, device=us.device)
        qs[:, :, :3, :3] = bk(qR)
        qs[:, :, :3, 3] = bk(qp)
        qs[:, :, 3, 3] = 1.0
        return PipelineState(qs=qs, xis=bk(xi), us=bk(us), J_opt=s["J"],
                             grad_norm=s["g"])
