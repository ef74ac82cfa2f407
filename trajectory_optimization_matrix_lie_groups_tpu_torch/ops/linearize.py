"""Stage linearization + GN quadratization (counterpart of the JAX
`ops/pallas_linearize.py`), with kernel B1.

For every stage, on batch-last lane tensors:

    dynamics eval   fq = normalize(q Exp(xi dt)),  fxi (Euler-Poincare)
    defect          d = [Log(q_{i+1}^-1 fq); fxi - xi_{i+1}]
    dynamics jac    Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [J_xi_q, I + H dt]]
                    (H with the reference coad-swap quirk)
    cost quad       e = Log(q qbar^-1),  J_e_x = Jr^-1(e) Ad(qbar),
                    l, lx, lxx (Gauss-Newton)

`stage_dynamics_eval`, `stage_jacobian` and `stage_cost_quad` are the plain
stage math, shared with the pipeline's rollout.  `linearize_lane` is kernel
B1's wrapper: CPU tensors take the plain version `linearize_plain` (all N
stages at once), CUDA tensors the kernel (`csrc/linearize.cu`).
`linearize` is the solver-layout wrapper (counterpart of `pallas_linearize`).

Scope: the SE(3) free body, rigid body with gravity and drone + GN tracking.
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll


def _cross(a, b):
    return ll._vec([a[1] * b[2] - a[2] * b[1],
                    a[2] * b[0] - a[0] * b[2],
                    a[0] * b[1] - a[1] * b[0]])


def _bc(M, like):
    """Constant ``M`` (r, c) expanded to ``like``'s (r, c, *batch) shape."""
    return M.reshape(M.shape + (1,) * (like.dim() - M.dim())).expand_as(like)


def stage_dynamics_eval(R, p, xi, u, Jl, Jil, Pu, mg, *, dt, gravity):
    """Semi-implicit Euler step: fq = normalize(q Exp(xi dt)),
    fxi = xi + dt Jinv (coad(xi) J xi [+ m g R^T down] + Pu u)."""
    Re, pe = ll.se3_exp(xi * dt)
    fqR, fqp = ll.se3_compose(R, p, Re, pe)
    fqR = ll.so3_normalize(fqR)
    Jxi = ll.matvec(Jl, xi)
    w, v = xi[:3], xi[3:]
    wrench = torch.cat([-_cross(w, Jxi[:3]) - _cross(v, Jxi[3:]),
                        -_cross(w, Jxi[3:])], dim=0) + ll.matvec(Pu, u)
    if gravity:
        # down = (0, 0, -1): R^T down = -(third row of R)
        g_lin = -mg * R[2]
        wrench = wrench + torch.cat([torch.zeros_like(g_lin), g_lin], dim=0)
    fxi = xi + dt * ll.matvec(Jil, wrench)
    return fqR, fqp, fxi


def stage_jacobian(R, xi, Jl, Jil, mg, *, dt, gravity, exact_grav):
    """Fx with the reference's coad-swap quirk #1 (always applied: the lane
    kernels ignore ``ref_coad_swap``) and its gravity-Jacobian quirk #2 (no
    m g factor unless ``exact_grav``).  The mass is read as J[4, 4]."""
    w, v = xi[:3], xi[3:]
    tau = xi * dt
    ReN, peN = ll.se3_exp(-tau)
    J_q_q = ll.se3_Ad(ReN, peN)
    J_q_xi = ll.se3_right_jacobian(tau) * dt
    # coad(eta) = ad(eta)^T = [[-hat(ew), -hat(ev)], [0, -hat(ev)]], applied
    # to the [v, w]-SWAPPED twist (reference quirk #1)
    z3 = torch.zeros_like(ll.hat(v))
    coad_sw = ll.blk(-ll.hat(v), -ll.hat(w), z3, -ll.hat(v))
    Ibw = ll.matvec(Jl[0:3, 0:3], w)
    m = Jl[4, 4]
    Gv = m * ll.hat(v)
    G = ll.blk(ll.hat(Ibw), Gv, Gv, z3)
    H = ll.matmul(Jil, ll.matmul(coad_sw, Jl) + G)
    eye6 = ll._eye(6, xi)
    if gravity:
        grow = -R[2] if not exact_grav else -(mg * R[2])
        J_xi_q = ll.matmul(Jil, ll.blk(z3, z3, ll.hat(grow), z3)) * dt
    else:
        J_xi_q = torch.zeros_like(H)
    return ll.blk(J_q_q, J_q_xi, J_xi_q, eye6 + H * dt)


def stage_cost_quad(R, p, xi, RbiR, Rbip, Adb, xib, W1, W2):
    """GN tracking quadratization: e = Log(q q_ref^-1),
    J_e_x = Jr^-1(e) Ad_ref.  Returns (lx (12, *b), lxx (12, 12, *b),
    l (*b)); with the terminal weights (P1, P2) it is the terminal
    quadratization."""
    Reb, peb = ll.se3_compose(R, p, RbiR, Rbip)
    e = ll.se3_log(Reb, peb)
    ev = xi - xib
    Jex = ll.matmul(ll.se3_right_jacobian_inv(e), Adb)
    JT2 = 2.0 * ll.transpose(Jex)
    W1e = ll.matvec(W1, e)
    W2ev = ll.matvec(W2, ev)
    lx = torch.cat([ll.matvec(JT2, W1e), 2.0 * W2ev], dim=0)
    H_e = ll.matmul(ll.matmul(JT2, W1), Jex)
    Z = torch.zeros_like(H_e)
    lxx = ll.blk(H_e, Z, Z, _bc(2.0 * W2, H_e))
    l_val = (e * W1e).sum(0) + (ev * W2ev).sum(0)
    return lx, lxx, l_val


def defect(R, p, xi, fqR, fqp, fxi):
    """d = [Log((R, p)^-1 fq); fxi - xi] against the next state (R, p, xi)."""
    Rni, pni = ll.se3_inverse(R, p)
    Rd, pd = ll.se3_compose(Rni, pni, fqR, fqp)
    return torch.cat([ll.se3_log(Rd, pd), fxi - xi], dim=0)


def stage_refs(refs, t):
    """References of stage(s) ``t`` (an int, or a slice for all-stage lane
    tensors) with the trailing batch axis the lane math broadcasts over."""
    if isinstance(t, slice):
        mv = lambda x: x[t].movedim(0, -1)[..., None]   # (..., N, 1)
    else:
        mv = lambda x: x[t][..., None]                  # (..., 1)
    return mv(refs["RbiR"]), mv(refs["Rbip"]), mv(refs["Adb"]), mv(refs["xib"])


def linearize_plain(qR, qp, xi, us, refs, consts, *, dt, gravity=False,
                    exact_grav=False):
    """Plain version of kernel B1, all N stages at once (stage becomes a
    batch axis).  Same arguments and outputs as `linearize_lane`."""
    st = lambda x: x.movedim(0, -2)          # (N, ..., B) -> (..., N, B)
    back = lambda x: x.movedim(-2, 0).contiguous()
    R, p, x, u = st(qR[:-1]), st(qp[:-1]), st(xi[:-1]), st(us)
    c = consts
    fqR, fqp, fxi = stage_dynamics_eval(R, p, x, u, c["J"], c["Jinv"], c["Pu"],
                                        c["mg"], dt=dt, gravity=gravity)
    d = defect(st(qR[1:]), st(qp[1:]), st(xi[1:]), fqR, fqp, fxi)
    Fx = stage_jacobian(R, x, c["J"], c["Jinv"], c["mg"], dt=dt,
                        gravity=gravity, exact_grav=exact_grav)
    N = us.shape[0]
    lx, lxx, l = stage_cost_quad(R, p, x, *stage_refs(refs, slice(0, N)),
                                 c["W1"], c["W2"])
    return dict(fqR=back(fqR), fqp=back(fqp), fxi=back(fxi), d=back(d),
                Fx=back(Fx), lx=back(lx), lxx=back(lxx),
                l=back(l[None]))


_LINEARIZE_ARGS = [_build.PTR] * 13 + [_build.DBL, _build.DBL, _build.INT,
                                       _build.INT] + [_build.PTR] * 8 + \
    [_build.INT] * 4 + [_build.PTR]


def _linearize_kernel(fn, stream, qR, qp, xi, us, refs, consts, *, dt,
                      gravity, exact_grav):
    """Check the arguments, allocate the outputs and launch B1 through the C
    entry point ``fn`` on ``stream`` (a ``cudaStream_t`` as an int)."""
    N, nu, B = us.shape
    a = lambda t, shape, name: _build.arg(t, shape, us, name)
    e = lambda *shape: torch.empty(shape, dtype=us.dtype, device=us.device)
    out = dict(fqR=e(N, 3, 3, B), fqp=e(N, 3, B), fxi=e(N, 6, B),
               d=e(N, 12, B), Fx=e(N, 12, 12, B), lx=e(N, 12, B),
               lxx=e(N, 12, 12, B), l=e(N, 1, B))
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"), a(us, (N, nu, B), "us"),
             a(refs["RbiR"], (N + 1, 3, 3), "RbiR"),
             a(refs["Rbip"], (N + 1, 3), "Rbip"),
             a(refs["Adb"], (N + 1, 6, 6), "Adb"),
             a(refs["xib"], (N + 1, 6), "xib"),
             a(consts["J"], (6, 6), "J"), a(consts["Jinv"], (6, 6), "Jinv"),
             a(consts["W1"], (6, 6), "W1"), a(consts["W2"], (6, 6), "W2"),
             a(consts["Pu"], (6, nu), "Pu"), float(consts["mg"]), float(dt),
             int(gravity), int(exact_grav),
             *[a(out[k], out[k].shape, k) for k in
               ("fqR", "fqp", "fxi", "d", "Fx", "lx", "lxx", "l")],
             N, nu, B, _build.device_index(us), stream)
    _build.check(err, "linearize")
    return out


def linearize_lane(qR, qp, xi, us, refs, consts, *, dt, gravity=False,
                   exact_grav=False):
    """Kernel B1 (replaces `ops/pallas_linearize.py::_linearize_kernel` as
    called by `PallasPipelineSolver._linearize_lane`).

    Lane layout: qR (N+1, 3, 3, B), qp (N+1, 3, B), xi (N+1, 6, B),
    us (N, nu, B); ``refs`` RbiR (N+1, 3, 3), Rbip (N+1, 3), Adb (N+1, 6, 6),
    xib (N+1, 6), shared by the batch; ``consts`` J, Jinv, W1, W2 (6, 6),
    Pu (6, nu) and mg (float).  Returns dict(fqR (N, 3, 3, B), fqp, fxi,
    d (N, 12, B), Fx (N, 12, 12, B), lx, lxx, l (N, 1, B)).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or float64), or raise.  On an H100 the kernel is bound by its
    stores (Fx and lxx, 288 values per stage and problem); it writes each
    entry once, coalesced over the batch."""
    kw = dict(dt=dt, gravity=gravity, exact_grav=exact_grav)
    if us.device.type == "cpu":
        return linearize_plain(qR, qp, xi, us, refs, consts, **kw)
    if us.device.type != "cuda":
        raise ValueError(f"linearize_lane: no kernel for device {us.device}")
    fn = _build.function("linearize", "linearize", _build.suffix(us.dtype),
                         _LINEARIZE_ARGS)
    out = _linearize_kernel(fn, torch.cuda.current_stream(us.device).cuda_stream,
                            qR, qp, xi, us, refs, consts, **kw)
    linearize_lane.launches += 1
    return out


linearize_lane.launches = 0


def lane_refs(q_ref_inv, Ad_ref, xi_ref):
    """Per-stage references (N+1 stages) in the layout the lane functions
    and kernels take."""
    return dict(RbiR=q_ref_inv[:, :3, :3].contiguous(),
                Rbip=q_ref_inv[:, :3, 3].contiguous(),
                Adb=Ad_ref.contiguous(), xib=xi_ref.contiguous())


def linearize(qs, xis, us, q_ref_inv, Ad_ref, xi_ref, Jm, Jinv, W1, W2, dt,
              Pu=None, mg=None, gravity=False, exact_grav=False):
    """Fused stage linearization in solver layout (counterpart of
    `pallas_linearize`): qs (B, N+1, 4, 4), xis (B, N+1, 6), us (B, N, nu);
    references q_ref_inv (N+1, 4, 4), Ad_ref (N+1, 6, 6), xi_ref (N+1, 6);
    constants Jm/Jinv/W1/W2 (6, 6).  Returns dict(fq, fxi, d, Fx, lx, lxx, l)
    in solver layout for stages 0..N-1."""
    B, Np1 = qs.shape[0], qs.shape[1]
    N = Np1 - 1
    tl = lambda x: x.movedim(0, -1).contiguous()
    if Pu is None:
        Pu = torch.eye(6, dtype=us.dtype, device=us.device)
    consts = dict(J=Jm.contiguous(), Jinv=Jinv.contiguous(),
                  W1=W1.contiguous(), W2=W2.contiguous(), Pu=Pu.contiguous(),
                  mg=0.0 if mg is None else float(mg))
    out = linearize_lane(tl(qs[:, :, :3, :3]), tl(qs[:, :, :3, 3]), tl(xis),
                         tl(us), lane_refs(q_ref_inv, Ad_ref, xi_ref), consts,
                         dt=float(dt), gravity=gravity, exact_grav=exact_grav)
    bk = lambda x: x.movedim(-1, 0)
    fq = torch.zeros((B, N, 4, 4), dtype=us.dtype, device=us.device)
    fq[:, :, :3, :3] = bk(out["fqR"])
    fq[:, :, :3, 3] = bk(out["fqp"])
    fq[:, :, 3, 3] = 1.0
    return dict(fq=fq, fxi=bk(out["fxi"]), d=bk(out["d"]), Fx=bk(out["Fx"]),
                lx=bk(out["lx"]), lxx=bk(out["lxx"]), l=bk(out["l"])[..., 0])
