"""Mixed-precision polish (counterpart of the JAX `solvers/df_mixed.py`):
fp64 residuals, f32 preconditioner, with kernels B5 (Riccati backward), B6
(rollout) and B7-B9 (the linearization tail, one kernel).

The f32 pipeline settles ~1e-3 from the f64 optimum in the flat input
directions.  The accuracy of the converged iterate is set only by the
accuracy of the residuals the iteration drives to zero (defects d = 0 and
per-stage gradient Q_u = 0), not by the preconditioner applied to them
(mixed-precision iterative refinement).  So these run in fp64: the
trajectory and control carry, the defect d, the Jacobian Fx, the gradient
lx and lu, the adjoint V_x chain and Q_u.  The rest only preconditions the
step and runs in f32, from the f32 rounding of its fp64 operands: V_xx,
Q_xx, Q_ux, Q_uu, its Cholesky, the gains k and K, the GN Hessian lxx, the
feedback K xs_err and the vanishing V_x corrections (their rounding is
multiplied by a residual that goes to zero).  The JAX package carries the
residual path in double-f32 because the TPU has no f64; wherever it reads
the hi part of a double-f32 value to feed the f32 chain, the port takes the
f32 rounding of the fp64 value, and where it promotes an f32 value, the port
upcasts.

Per polish iteration (the loop is rotated as in the JAX solver: linearize,
backward, rollout, with no trailing linearization): B7-B9 linearize the
iterate reusing the previous rollout's dynamics evaluations, B5 runs the
backward, B6 the rollout, which emits the next evaluations.

Each kernel wrapper (`backward_mx_lane`, `rollout_mx_lane`,
`linearize_tail_mx_lane`) takes the plain version (`*_plain`) for CPU
tensors and launches the CUDA kernel (`csrc/polish.cu`) for CUDA tensors, or
raises; B5 and B6 at nu other than 6 and 4 launch their runtime-nu
instances (`csrc/polish_nu.cu`: up to 12 and past it), counted apart (each
wrapper's ``nu.launches`` and ``nuL.launches``), and nu outside
1.._build.MAX_NU raises ValueError before any launch.  The TPU-only
specializations of the JAX polish (small-angle Log, truncated Exp series,
one-step Newton renormalization, sublane packing) are not ported: the port
uses the full fp64 `se3_log`, `se3_exp` and `so3_normalize`.
"""

import types

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    cost_gradient,
    defect,
    gn_hessian,
    stage_dynamics_eval,
    stage_jacobian,
    stage_refs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    DFPipelineBase,
    DFState,
    split_us,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    NX,
    adjoint_chain,
    chol_solve_lane,
    deviation,
    gap_close,
    hessian_chain,
    solve_device,
    value_update,
)

__all__ = ["MixedDFPipelineSolver", "riccati_stage_mx", "stage_cost_quad_mx",
           "rollout_stage_mx"]

F32, F64 = torch.float32, torch.float64


# -- stage math ---------------------------------------------------------------

def stage_cost_quad_mx(R, p, xi, RbiR, Rbip, Adb, xib, W1, W2, W1_32):
    """Mixed GN tracking quadratization: the gradient lx (residual path) in
    fp64, the GN Hessian lxx (preconditioner) and the cost value l (a
    diagnostic) in f32 from the f32 roundings of the fp64 terms.
    Returns (lx fp64 (12, *b), lxx32 (12, 12, *b), l32 (*b))."""
    e, ev, Jex, W1e, W2ev, lx = cost_gradient(R, p, xi, RbiR, Rbip, Adb, xib,
                                              W1, W2)
    f = lambda x: x.to(F32)
    lxx32, l32 = gn_hessian(f(e), f(ev), f(Jex), f(W1e), f(W2ev), W1_32, f(W2))
    return lx, lxx32, l32


def riccati_stage_mx(fx, dd, lx_t, lu_t, lxx32, fu2, fu2T, fu2_32, fu2T_32,
                     Luu32, Vx, Vxx32, *, nu, glow, half=6, luual_t=None):
    """One mixed-precision defect-aware Riccati step on lane values (the
    block structure of `solvers.pipeline.riccati_stage`).  The value-Hessian
    chain runs in f32 on the f32 rounding of ``fx``; the adjoint chain
    (Vmod, Qx, Qu, V_x) in fp64.  ``fx`` may be fp64 or f32 (an f32 Jacobian,
    `fx_mode='f32'`): its adjoint products run in fp64 either way.
    Returns (k32, K32, Qu fp64, Vx_new fp64, Vxx_new32)."""
    Qxx, Qux, Quu, L, K = hessian_chain(fx.to(F32), Vxx32, lxx32, fu2_32,
                                        fu2T_32, Luu32, nu=nu, glow=glow,
                                        half=half, luual_t=luual_t)
    # V_xx d enters the residual multiplied by d -> 0: f32, upcast
    Vmod = Vx + ll.matvec(Vxx32, dd.to(F32)).to(F64)
    Qx, Qu = adjoint_chain(fx.to(F64), Vmod, lx_t, lu_t, fu2T, glow=glow,
                           half=half)
    # k from the f32 rounding of the fp64 gradient: relative error only, so
    # the iteration still converges to Qu = 0
    Qu32 = Qu.to(F32)
    k = -chol_solve_lane(L, Qu32[:, None], nu)[:, 0]
    (c1, c2, c3), Vxx_new = value_update(K, k, Qu32, Qxx, Qux, Quu)
    return k, K, Qu, Qx + ((c1 + c2) + c3).to(F64), Vxx_new


def rollout_stage_mx(R_new, p_new, xi_new, qR_t, qp_t, qRn_t, qpn_t, xi_t,
                     xin_t, u_t, k32_t, K32_t, d_t, fqR_t, fqp_t, fxi_t,
                     Jl, Jil, Pu, mg, *, dt, gravity):
    """One gap-closing rollout step, mixed precision: the state carry, the
    deviation xs_err, the control and the dynamics evaluation in fp64; the
    feedback k + K xs_err in f32 from xs_err's f32 rounding (its rounding is
    multiplied by xs_err -> 0).
    Returns (R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new), all fp64."""
    xs_err = deviation(R_new, p_new, xi_new, qR_t, qp_t, xi_t)
    u_new = u_t + (k32_t + ll.matvec(K32_t, xs_err.to(F32))).to(F64)
    R_nn, p_nn, xi_nn, fqR_n, fqp_n, fxi_new = gap_close(
        R_new, p_new, xi_new, u_new, qRn_t, qpn_t, xin_t, d_t, fqR_t, fqp_t,
        fxi_t, Jl, Jil, Pu, mg, dt=dt, gravity=gravity)
    return R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new


# -- plain versions of the kernels ---------------------------------------------

def _stages(x):
    """(N, ..., B) -> (..., N, B): the stage axis as a batch axis."""
    return x.movedim(0, -2)


def _unstage(x):
    return x.movedim(-2, 0).contiguous()


def dyn_evals_mx(qR, qp, xi, us, consts, *, dt, gravity):
    """fp64 dynamics evaluations (fqR, fqp, fxi) (N, ..., B) of every stage
    of a trajectory (plain PyTorch; the polish needs them only at entry)."""
    c = consts
    out = stage_dynamics_eval(_stages(qR[:-1]), _stages(qp[:-1]),
                              _stages(xi[:-1]), _stages(us), c["J"],
                              c["Jinv"], c["Pu"], c["mg"], dt=dt,
                              gravity=gravity)
    return tuple(_unstage(x) for x in out)


def linearize_tail_mx_plain(qR, qp, xi, evals, refs, consts, *, dt, gravity,
                            exact_grav, with_fx=True):
    """Plain version of kernels B7-B9, all N stages at once.  Same arguments
    and outputs as `linearize_tail_mx_lane`."""
    c = consts
    N = qR.shape[0] - 1
    R, p, x = _stages(qR[:-1]), _stages(qp[:-1]), _stages(xi[:-1])
    fqR, fqp, fxi = evals
    d = defect(_stages(qR[1:]), _stages(qp[1:]), _stages(xi[1:]),
               _stages(fqR), _stages(fqp), _stages(fxi))
    Fx = None
    if with_fx:
        Fx = _unstage(stage_jacobian(R, x, c["J"], c["Jinv"], c["mg"], dt=dt,
                                     gravity=gravity, exact_grav=exact_grav))
    lx, lxx32, l32 = stage_cost_quad_mx(
        R, p, x, *stage_refs(refs, slice(0, N)), c["W1"], c["W2"],
        c["W1"].to(F32))
    return dict(fqR=fqR, fqp=fqp, fxi=fxi, d=_unstage(d), Fx=Fx,
                lx=_unstage(lx), lxx32=_unstage(lxx32), l32=l32.contiguous())


def backward_mx_plain(lin, lu, VxN, VxxN, consts, consts32, *, glow,
                      luu_al=None):
    """Plain version of kernel B5: `riccati_stage_mx` over the stages in
    reverse.  Same arguments and outputs as `backward_mx_lane`."""
    N, nu = lu.shape[:2]
    fu2, fu2_32 = consts["fu2"], consts32["fu2"]
    Luu = consts32["Luu"][..., None]
    tail = tuple(lu.shape[2:])
    k = torch.empty((N, nu) + tail, dtype=F32, device=lu.device)
    K = torch.empty((N, nu, NX) + tail, dtype=F32, device=lu.device)
    gvec = torch.empty_like(lu)
    Vx, Vxx = VxN, VxxN
    for t in reversed(range(N)):
        k[t], K[t], gvec[t], Vx, Vxx = riccati_stage_mx(
            lin["Fx"][t], lin["d"][t], lin["lx"][t], lu[t], lin["lxx32"][t],
            fu2, fu2.T, fu2_32, fu2_32.T, Luu, Vx, Vxx, nu=nu, glow=glow,
            luual_t=None if luu_al is None else luu_al[t])
    return k, K, gvec


def rollout_mx_plain(qR, qp, xi, us, k32, K32, lin, consts, *, dt, gravity):
    """Plain version of kernel B6; same arguments and outputs as
    `rollout_mx_lane`."""
    N = us.shape[0]
    c = consts
    oR, op, oxi, ou = (torch.empty_like(x) for x in (qR, qp, xi, us))
    ev = tuple(torch.empty_like(lin[k_]) for k_ in ("fqR", "fqp", "fxi"))
    oR[0], op[0], oxi[0] = qR[0], qp[0], xi[0]
    R, p, x = qR[0], qp[0], xi[0]
    for t in range(N):
        R, p, x, ou[t], ev[0][t], ev[1][t], ev[2][t] = rollout_stage_mx(
            R, p, x, qR[t], qp[t], qR[t + 1], qp[t + 1], xi[t], xi[t + 1],
            us[t], k32[t], K32[t], lin["d"][t], lin["fqR"][t], lin["fqp"][t],
            lin["fxi"][t], c["J"], c["Jinv"], c["Pu"], c["mg"], dt=dt,
            gravity=gravity)
        oR[t + 1], op[t + 1], oxi[t + 1] = R, p, x
    return oR, op, oxi, ou, ev


# -- kernel wrappers ---------------------------------------------------------------

_P, _I, _D = _build.PTR, _build.INT, _build.DBL
_RICCATI_ARGS = [_P] * 11 + [_I] + [_P] * 3 + [_I] * 4 + [_P]
_ROLLOUT_ARGS = [_P] * 13 + [_D, _D, _I] + [_P] * 7 + [_I] * 4 + [_P]
_TAIL_ARGS = [_P] * 14 + [_D, _D, _I, _I] + [_P] * 5 + [_I] * 3 + [_P]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _backward_mx_kernel(fn, stream, lin, lu, VxN, VxxN, consts, consts32, *,
                        glow, luu_al):
    N, nu, B = lu.shape
    a = lambda t, shape, name, dt=F64: _build.arg(t, shape, lu, name, dtype=dt)
    k = torch.empty((N, nu, B), dtype=F32, device=lu.device)
    K = torch.empty((N, nu, NX, B), dtype=F32, device=lu.device)
    gvec = torch.empty_like(lu)
    err = fn(a(lin["Fx"], (N, NX, NX, B), "Fx"), a(lin["d"], (N, NX, B), "d"),
             a(lin["lx"], (N, NX, B), "lx"), a(lu, (N, nu, B), "lu"),
             a(lin["lxx32"], (N, NX, NX, B), "lxx32", F32),
             None if luu_al is None else a(luu_al, (N, nu, B), "luu_al", F32),
             a(VxN, (NX, B), "VxN"), a(VxxN, (NX, NX, B), "VxxN", F32),
             a(consts["fu2"], (6, nu), "fu2"),
             a(consts32["fu2"], (6, nu), "fu2_32", F32),
             a(consts32["Luu"], (nu, nu), "Luu32", F32), int(glow),
             a(k, k.shape, "k", F32), a(K, K.shape, "K", F32),
             a(gvec, gvec.shape, "gvec"), N, nu, B, _build.device_index(lu),
             stream)
    _build.check(err, "riccati_mx")
    return k, K, gvec


def backward_mx_lane(lin, lu, VxN, VxxN, consts, consts32, *, glow,
                     luu_al=None):
    """Kernel B5 (replaces `solvers/df_mixed.py::_riccati_kernel_mx` as
    called by `MixedDFPipelineSolver._backward_mx_k`).

    ``lin``: Fx (N, 12, 12, B), d (N, 12, B), lx (N, 12, B) fp64 and lxx32
    (N, 12, 12, B) f32; ``lu`` (N, nu, B) fp64; the terminal carry VxN
    (12, B) fp64 and VxxN (12, 12, B) f32 (the terminal quadratization);
    ``consts`` fu2 (6, nu) fp64, ``consts32`` fu2 (6, nu) and Luu (nu, nu)
    f32; ``glow``: the gravity J_xi_q block of Fx is nonzero; ``luu_al``:
    optional (N, nu, B) f32 AL diagonal on Q_uu.
    Returns k32 (N, nu, B), K32 (N, nu, 12, B) f32 and gvec = Q_u (N, nu, B)
    fp64.

    On an H100 a group of 16 threads runs one problem's recursion, as B2,
    with the fp64 V_x and f32 V_xx rows of the carry in registers and each
    stage's inputs copied ahead into shared memory.  At nu other than 6
    and 4 it launches the runtime-nu instance, counted in
    ``backward_mx_lane.nu``: the same design with nu a runtime argument
    (`csrc/nu.cuh`), as `pipeline.backward_lane`'s is B2's; past nu = 12
    the large-nu instance, counted in ``backward_mx_lane.nuL``
    (`csrc/riccati_large.cuh`, as B2's)."""
    kw = dict(glow=glow, luu_al=luu_al)
    if lu.device.type == "cpu":
        return backward_mx_plain(lin, lu, VxN, VxxN, consts, consts32, **kw)
    _build.check_nu("backward_mx_lane", lu.shape[1])
    _check_device(lu, "backward_mx_lane")
    tuned = lu.shape[1] in _build.TUNED_NU
    fn = _build.function(*(("polish", "riccati") if tuned else ("polish_nu", "riccati_nu")),
                         "mx", _RICCATI_ARGS)
    out = _backward_mx_kernel(fn, _stream(lu), lin, lu, VxN, VxxN, consts,
                              consts32, **kw)
    _build.nu_counter(backward_mx_lane, lu.shape[1]).launches += 1
    return out


backward_mx_lane.launches = 0
backward_mx_lane.nu = types.SimpleNamespace(launches=0)
backward_mx_lane.nuL = types.SimpleNamespace(launches=0)


def rollout_mx_lane(qR, qp, xi, us, k32, K32, lin, consts, *, dt, gravity):
    """Kernel B6 (replaces `solvers/df_mixed.py::_rollout_kernel_mx` as
    called by `MixedDFPipelineSolver._rollout_mx_k`).

    Nominal trajectory qR (N+1, 3, 3, B), qp, xi, us (N, nu, B) fp64; gains
    k32 (N, nu, B), K32 (N, nu, 12, B) f32; ``lin`` d, fqR, fqp, fxi of the
    nominal (fp64); ``consts`` J, Jinv (6, 6), Pu (6, nu), mg.  Returns the
    new (qR, qp, xi) (stage 0 unchanged), us, and the dynamics evaluations
    (fqR, fqp, fxi) (N, ..., B) of the new trajectory, all fp64.

    On an H100 one thread per problem walks the stages with the fp64 carry
    in registers; the fp64 state and the dynamics evaluation press on the
    register file.  At nu other than 6 and 4 it launches the runtime-nu
    instance, counted in ``rollout_mx_lane.nu``: u, k and K zero past nu in
    registers, Pu padded in the block's shared memory (`csrc/nu.cuh`); past
    nu = 12 the large-nu instance, counted in ``rollout_mx_lane.nuL``: u, k
    and K read one row at a time, the wrench Pu u summed one input at a time
    (`csrc/nu_large.cuh`)."""
    kw = dict(dt=dt, gravity=gravity)
    if us.device.type == "cpu":
        return rollout_mx_plain(qR, qp, xi, us, k32, K32, lin, consts, **kw)
    _build.check_nu("rollout_mx_lane", us.shape[1])
    _check_device(us, "rollout_mx_lane")
    tuned = us.shape[1] in _build.TUNED_NU
    fn = _build.function(*(("polish", "rollout") if tuned else ("polish_nu", "rollout_nu")),
                         "mx", _ROLLOUT_ARGS)
    out = _rollout_mx_kernel(fn, _stream(us), qR, qp, xi, us, k32, K32, lin, consts,
                             **kw)
    _build.nu_counter(rollout_mx_lane, us.shape[1]).launches += 1
    return out


rollout_mx_lane.launches = 0
rollout_mx_lane.nu = types.SimpleNamespace(launches=0)
rollout_mx_lane.nuL = types.SimpleNamespace(launches=0)


def _rollout_mx_kernel(fn, stream, qR, qp, xi, us, k32, K32, lin, consts, *, dt,
                       gravity):
    """Check the arguments, allocate the outputs and launch B6 through the C
    entry point ``fn`` on ``stream``."""
    N, nu, B = us.shape
    a = lambda t, shape, name, dt_=F64: _build.arg(t, shape, us, name, dtype=dt_)
    e = lambda *shape: torch.empty(shape, dtype=F64, device=us.device)
    oR, op, oxi, ou = e(N + 1, 3, 3, B), e(N + 1, 3, B), e(N + 1, 6, B), e(N, nu, B)
    ev = (e(N, 3, 3, B), e(N, 3, B), e(N, 6, B))
    c = consts
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"), a(us, (N, nu, B), "us"),
             a(k32, (N, nu, B), "k32", F32), a(K32, (N, nu, NX, B), "K32", F32),
             a(lin["d"], (N, NX, B), "d"), a(lin["fqR"], (N, 3, 3, B), "fqR"),
             a(lin["fqp"], (N, 3, B), "fqp"), a(lin["fxi"], (N, 6, B), "fxi"),
             a(c["J"], (6, 6), "J"), a(c["Jinv"], (6, 6), "Jinv"),
             a(c["Pu"], (6, nu), "Pu"), float(c["mg"]), float(dt), int(gravity),
             *(a(o, o.shape, "out") for o in (oR, op, oxi, ou) + ev),
             N, nu, B, _build.device_index(us), stream)
    _build.check(err, "rollout_mx")
    return oR, op, oxi, ou, ev


def linearize_tail_mx_lane(qR, qp, xi, evals, refs, consts, *, dt, gravity,
                           exact_grav, with_fx=True):
    """Kernels B7 (defect), B8 (Jacobian) and B9 (cost quadratization), one
    CUDA kernel (replaces `solvers/df_mixed.py::_defect_kernel_mx`,
    `_jacobian_kernel_mx` and `_cost_quad_kernel_mx` as called by
    `MixedDFPipelineSolver._linearize_tail_mx_k`).

    The linearization of the trajectory qR (N+1, 3, 3, B), qp, xi (fp64)
    reusing the dynamics evaluations ``evals`` = (fqR, fqp, fxi) (N, ..., B)
    of its own rollout; ``refs`` as `lane_refs` (N+1 stages), ``consts`` J,
    Jinv, W1, W2 (6, 6) fp64 and mg.  ``with_fx=False`` skips the Jacobian
    (the 'f32' Jacobian of `fx_mode` comes from the caller).  Returns
    dict(fqR, fqp, fxi (the given evals), d (N, 12, B), Fx (N, 12, 12, B) or
    None, lx (N, 12, B) fp64, lxx32 (N, 12, 12, B), l32 (N, B) f32).

    On an H100 it is store-bound like B1 (fp64 Fx and f32 lxx dominate);
    one thread per (problem, stage) writes every entry once, coalesced."""
    kw = dict(dt=dt, gravity=gravity, exact_grav=exact_grav, with_fx=with_fx)
    if qR.device.type == "cpu":
        return linearize_tail_mx_plain(qR, qp, xi, evals, refs, consts, **kw)
    _check_device(qR, "linearize_tail_mx_lane")
    N, B = qR.shape[0] - 1, qR.shape[-1]
    a = lambda t, shape, name, dt_=F64: _build.arg(t, shape, qR, name, dtype=dt_)
    e = lambda dtype, *shape: torch.empty(shape, dtype=dtype, device=qR.device)
    out = dict(fqR=evals[0], fqp=evals[1], fxi=evals[2], d=e(F64, N, NX, B),
               Fx=e(F64, N, NX, NX, B) if with_fx else None,
               lx=e(F64, N, NX, B), lxx32=e(F32, N, NX, NX, B),
               l32=e(F32, N, B))
    c = consts
    r = lambda key, shape: a(refs[key], shape, key)
    fn = _build.function("polish", "linearize_tail", "mx", _TAIL_ARGS)
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"), a(evals[0], (N, 3, 3, B), "fqR"),
             a(evals[1], (N, 3, B), "fqp"), a(evals[2], (N, 6, B), "fxi"),
             r("RbiR", (N + 1, 3, 3)), r("Rbip", (N + 1, 3)),
             r("Adb", (N + 1, 6, 6)), r("xib", (N + 1, 6)),
             a(c["J"], (6, 6), "J"), a(c["Jinv"], (6, 6), "Jinv"),
             a(c["W1"], (6, 6), "W1"), a(c["W2"], (6, 6), "W2"),
             float(c["mg"]), float(dt), int(gravity), int(exact_grav),
             a(out["d"], (N, NX, B), "d"),
             None if out["Fx"] is None else a(out["Fx"], (N, NX, NX, B), "Fx"),
             a(out["lx"], (N, NX, B), "lx"),
             a(out["lxx32"], (N, NX, NX, B), "lxx32", F32),
             a(out["l32"], (N, B), "l32", F32), N, B,
             _build.device_index(qR), _stream(qR))
    _build.check(err, "linearize_tail_mx")
    linearize_tail_mx_lane.launches += 1
    linearize_tail_mx_lane.with_fx.launches += int(with_fx)
    return out


linearize_tail_mx_lane.launches = 0
# B8's count: the launches of the tail kernel that computed Fx
linearize_tail_mx_lane.with_fx = types.SimpleNamespace(launches=0)

# B7, B8 and B9 are one kernel; each keeps its name and count.  B5 and B6
# at nu other than 6 and 4: their runtime-nu instances (nu <= 12) and their
# large-nu ones, counted apart.
KERNELS = {"B5": backward_mx_lane, "B6": rollout_mx_lane,
           "B7": linearize_tail_mx_lane, "B8": linearize_tail_mx_lane.with_fx,
           "B9": linearize_tail_mx_lane, "B5nu": backward_mx_lane.nu,
           "B6nu": rollout_mx_lane.nu, "B5nuL": backward_mx_lane.nuL,
           "B6nuL": rollout_mx_lane.nuL}


# -- the solver -------------------------------------------------------------------

class MixedDFPipelineSolver(DFPipelineBase):
    """The f32 pipeline followed by the mixed-precision polish (module
    docstring): ``f32_iterations`` iterations of `PipelineSolver`, then
    ``df_iterations`` polish iterations in fp64 residuals and an f32
    preconditioner.  `solve` returns a `DFState`.

    ``fx_mode``: 'df' computes the stage Jacobian in fp64; 'f32' in f32 from
    the f32-rounded state (its rounding is a persistent gradient bias: the
    polish converges to a point farther from the optimum,
    tests/test_torch_polish_oracle.py); 'hybrid' uses the f32 Jacobian on
    every polish iteration but the last.  ``plain``: run the plain versions of B1-B9 whatever the
    device (the reference the kernels are held against on the card)."""

    def __init__(self, N: int, dt: float, f32_iterations: int = 12,
                 df_iterations: int = 3, gravity: bool = False,
                 exact_gravity_jacobian: bool = False, fx_mode: str = "df",
                 plain: bool = False):
        if fx_mode not in ("df", "f32", "hybrid"):
            raise ValueError(
                f"fx_mode must be 'df', 'f32' or 'hybrid', got {fx_mode}")
        super().__init__(N, dt, f32_iterations, df_iterations, gravity,
                         exact_gravity_jacobian, plain)
        self.fx_mode = fx_mode
        if plain:
            self._backward, self._rollout, self._tail = (
                backward_mx_plain, rollout_mx_plain, linearize_tail_mx_plain)
        else:
            self._backward, self._rollout, self._tail = (
                backward_mx_lane, rollout_mx_lane, linearize_tail_mx_lane)

    # -- pieces (lane layout) ---------------------------------------------------

    def _linearize_tail_mx(self, qR, qp, xi, evals, refs, consts, consts32,
                           fx_df=None):
        """B7-B9 on the trajectory, reusing its dynamics evaluations.
        ``fx_df`` overrides the Jacobian's precision for this call (None:
        follow fx_mode); an f32 Jacobian (plain PyTorch) is handed on as
        fp64."""
        if fx_df is None:
            fx_df = self.fx_mode != "f32"
        lin = self._tail(qR, qp, xi, evals, refs, consts, dt=self.dt,
                         gravity=self.gravity, exact_grav=self.exact_grav,
                         with_fx=fx_df)
        if not fx_df:
            c = consts32
            Fx32 = stage_jacobian(_stages(qR[:-1]).to(F32),
                                  _stages(xi[:-1]).to(F32), c["J"], c["Jinv"],
                                  c["mg"], dt=self.dt, gravity=self.gravity,
                                  exact_grav=self.exact_grav)
            lin["Fx"] = _unstage(Fx32).to(F64)
        return lin

    def _terminal(self, qR, qp, xi, refs, consts, consts32):
        """The terminal quadratization (plain glue, as in the JAX kernel
        path): the backward's initial carry (VxN fp64 (12, B),
        VxxN f32 (12, 12, B))."""
        N = self.N
        lxN, lxxN32, _ = stage_cost_quad_mx(
            qR[N], qp[N], xi[N], *stage_refs(refs, N), consts["P1"],
            consts["P2"], consts32["P1"])
        return lxN.contiguous(), lxxN32.contiguous()

    def _backward_mx(self, lin, lu, qR, qp, xi, refs, consts, consts32,
                     luu_al=None):
        """B5 from the terminal quadratization.  Returns (k32, K32, gvec
        fp64)."""
        return self._backward(lin, lu, *self._terminal(qR, qp, xi, refs,
                                                       consts, consts32),
                              consts, consts32, glow=self.gravity,
                              luu_al=luu_al)

    def _cost_value32(self, qR, qp, xi, us, refs, consts32):
        """f32 cost of an fp64 iterate from its f32 rounding: tracking
        stage values + control quadratic + terminal (J is a diagnostic; the
        polish's accuracy gate is on the controls)."""
        N = self.N
        c = consts32
        f = lambda x: x.to(F32)
        r32 = {k_: f(v) for k_, v in refs.items()}

        def value(R, p, x, t, W1, W2):
            RbiR, Rbip, _, xib = stage_refs(r32, t)
            Reb, peb = ll.se3_compose(R, p, RbiR, Rbip)
            e = ll.se3_log(Reb, peb)
            ev = x - xib
            return ((e * ll.matvec(W1, e)).sum(0)
                    + (ev * ll.matvec(W2, ev)).sum(0))

        l = value(_stages(f(qR[:-1])), _stages(f(qp[:-1])), _stages(f(xi[:-1])),
                  slice(0, N), c["W1"], c["W2"]).sum(0)
        lN = value(f(qR[N]), f(qp[N]), f(xi[N]), N, c["P1"], c["P2"])
        us32 = f(us)
        return l + torch.einsum("ni...,ij,nj...->...", us32, c["R"], us32) + lN

    # -- the polish ---------------------------------------------------------------

    def polish(self, dyn, cost, qR, qp, xi, us, al=None):
        """The polish phase from a lane-layout handoff qR (N+1, 3, 3, B),
        qp (N+1, 3, B), xi (N+1, 6, B), us (N, nu, B) in any float dtype
        (promoted to fp64), on its device (the card when it is not a
        tensor); the counterpart of the JAX
        `MixedDFPipelineSolver._solve_df`.  ``dyn``, ``cost``: fp64
        parameters.  ``al``: optional input-box AL state (lb, ub,
        lmbd (B, N+1, 2nu), imu (B, N+1, 2nu)) at fixed multipliers, rounded
        to f32 as the JAX package takes them: its u-gradient enters the fp64
        lu, its diagonal the f32 Q_uu.

        The loop is rotated: each iteration linearizes at its own iterate
        (reusing the previous rollout's dynamics evaluations, or one plain
        dynamics pass for the handoff), then runs the backward, then the
        rollout.  J_opt is the f32 cost at the returned iterate; grad_norm
        is the gradient at the last backward's evaluation point, one
        polish step stale.  Returns a `DFState`."""
        dev = solve_device(us)
        f64 = lambda x: torch.as_tensor(x).to(device=dev, dtype=F64).contiguous()
        qR, qp, xi, us = f64(qR), f64(qp), f64(xi), f64(us)
        N, nu, B = us.shape
        consts, refs, consts32 = self._df_setup(dyn, cost, dev)
        kw = dict(dt=self.dt, gravity=self.gravity)

        luu_al = None
        if al is not None:
            f32 = lambda x: torch.as_tensor(x).to(device=dev, dtype=F32)
            lb, ub, lmbd, imu = al
            lam_l = f32(lmbd).movedim(0, -1)[:-1]   # (N, 2nu, B)
            imu_l = f32(imu).movedim(0, -1)[:-1]
            lam_lo, lam_hi = lam_l[:, :nu], lam_l[:, nu:]
            im_lo, im_hi = imu_l[:, :nu], imu_l[:, nu:]
            lb32 = f32(lb).broadcast_to((nu,))[None, :, None]
            ub32 = f32(ub).broadcast_to((nu,))[None, :, None]
            luu_al = (im_lo + im_hi).contiguous()

        def lu_glue(us):
            lu = 2.0 * torch.einsum("ij,nj...->ni...", consts["R"], us)
            if al is not None:
                # the multipliers are f32 parameters; the box residuals carry
                # the fp64 iterate
                glo = lb32.to(F64) - us
                ghi = us - ub32.to(F64)
                lu = (lu - (lam_lo.to(F64) + im_lo.to(F64) * glo)
                      + (lam_hi.to(F64) + im_hi.to(F64) * ghi))
            return lu.contiguous()

        def linearize_backward(qR, qp, xi, us, evals, fx_df=None):
            lin = self._linearize_tail_mx(qR, qp, xi, evals, refs, consts,
                                          consts32, fx_df=fx_df)
            return lin, self._backward_mx(lin, lu_glue(us), qR, qp, xi, refs,
                                          consts, consts32, luu_al=luu_al)

        evals = dyn_evals_mx(qR, qp, xi, us, consts, **kw)
        if self.df_iterations == 0:
            # no polish: the metrics at the handoff iterate
            _, (_, _, gvec) = linearize_backward(qR, qp, xi, us, evals)
        for i in range(self.df_iterations):
            fx_df = (i == self.df_iterations - 1 if self.fx_mode == "hybrid"
                     else None)
            lin, (k32, K32, gvec) = linearize_backward(qR, qp, xi, us, evals,
                                                       fx_df)
            qR, qp, xi, us, evals = self._rollout(qR, qp, xi, us, k32, K32,
                                                  lin, consts, **kw)

        g = torch.mean(torch.sqrt(torch.sum(gvec * gvec, dim=1)), dim=0)
        J = self._cost_value32(qR, qp, xi, us, refs, consts32)
        if al is not None:
            # augmented-cost term (f32 diagnostic)
            us32 = us.to(F32)
            glo, ghi = lb32 - us32, us32 - ub32
            J = J + torch.sum(lam_lo * glo + lam_hi * ghi
                              + 0.5 * (im_lo * glo * glo + im_hi * ghi * ghi),
                              dim=(0, 1))
        bk = lambda x: x.movedim(-1, 0)
        qs = torch.zeros((B, N + 1, 4, 4), dtype=F64, device=dev)
        qs[:, :, :3, :3] = bk(qR)
        qs[:, :, :3, 3] = bk(qp)
        qs[:, :, 3, 3] = 1.0
        us_hi, us_lo = split_us(bk(us))
        return DFState(qs=qs, xis=bk(xi), us_hi=us_hi, us_lo=us_lo, J_opt=J,
                       grad_norm=g)

    def f32_phase(self, dyn, cost, q0s, xi0s, us0, al=None):
        """The f32 phase of `solve`: the handoff (qR, qp, xi, us) in fp64
        lane layout, the f32 solve's iterate promoted exactly.  Stage 0 stays
        the f32 rounding of the initial state, as the JAX package leaves it:
        the polish keeps stage 0 fixed, so its fixed point is that of the
        f32-rounded start."""
        return tuple(x.to(F64) for x in
                     self._solve_f32(dyn, cost, q0s, xi0s, us0, al=al))

    def solve(self, dyn, cost, q0s, xi0s, us0, al=None):
        """``dyn``, ``cost``: fp64 `SE3Params` (or `RigidBodyParams` with
        ``gravity``) and `TrackingCostParams`; solver-layout q0s (B, 4, 4),
        xi0s (B, 6), us0 (B, N, nu), on the device the solve runs on.  The
        f32 phase runs on their f32 rounding (`f32_phase`), the polish on
        its handoff.  ``al``: as `polish`, for both phases.  Returns a
        `DFState`."""
        handoff = self.f32_phase(dyn, cost, q0s, xi0s, us0, al=al)
        return self.polish(dyn, cost, *handoff, al=al)
