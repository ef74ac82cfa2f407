"""The batched gap-closing rollout of the SE(3) free body (counterpart of the
JAX `ops/pallas_rollout.py`), with kernel B14.

The sequential stage recursion (alpha = 1)

    xs_err = [Log(q_i^-1 q_new); xi_new - xi_i]
    u_new  = u_i + k_i + K_i xs_err
    f(q_new, xi_new, u_new)             (free rigid body, Euler)
    q+     = normalize(q_{i+1} Exp(d_q) f(x_i)^-1 f(x_new))
    xi+    = xi_{i+1} + fxi_new - fxi_i + d_xi

with Exp(d_q) and f(x_i)^-1 precomputed by the caller.  The rotation of
f(x_new) is renormalized before the gap-closing composition, and the result
again after it.

Lane layout (batch last): qR (N+1, 3, 3, B), qp (N+1, 3, B), xi (N+1, 6, B),
us, k (N, 6, B), K (N, 6, 12, B), d (N, 12, B), fxi (N, 6, B), Exp(d_q) as
edR (N, 3, 3, B), edp (N, 3, B) and f(x_i)^-1 as fiR (N, 3, 3, B),
fip (N, 3, B); J, Jinv (6, 6).  Outputs stages 1..N of the new trajectory,
oR (N, 3, 3, B), op (N, 3, B), oxi (N, 6, B), and the new controls
ou (N, 6, B).

`rollout_plain` is the plain version, `rollout_lane` kernel B14's wrapper,
`fast_rollout` the solver-layout wrapper (counterpart of `pallas_rollout`).
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    stage_dynamics_eval,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    deviation,
)


def rollout_plain(qR, qp, xi, us, k, K, d, fxi, edR, edp, fiR, fip, J, Jinv, *, dt):
    """Plain version of kernel B14; same arguments and outputs as
    `rollout_lane`."""
    N = us.shape[0]
    Pu = torch.eye(6, dtype=us.dtype, device=us.device)
    oR, op = torch.empty_like(qR[1:]), torch.empty_like(qp[1:])
    oxi, ou = torch.empty_like(xi[1:]), torch.empty_like(us)
    R, p, x = qR[0], qp[0], xi[0]
    for t in range(N):
        xs_err = deviation(R, p, x, qR[t], qp[t], xi[t])
        u_new = us[t] + k[t] + ll.matvec(K[t], xs_err)
        fqR, fqp, fxi_new = stage_dynamics_eval(R, p, x, u_new, J, Jinv, Pu, 0.0,
                                                dt=dt, gravity=False)
        R_a, p_a = ll.se3_compose(qR[t + 1], qp[t + 1], edR[t], edp[t])
        R_b, p_b = ll.se3_compose(R_a, p_a, fiR[t], fip[t])
        R_nn, p_nn = ll.se3_compose(R_b, p_b, fqR, fqp)
        R = ll.so3_normalize(R_nn)
        p = p_nn
        x = xi[t + 1] + fxi_new - fxi[t] + d[t, 6:]
        oR[t], op[t], oxi[t], ou[t] = R, p, x, u_new
    return oR, op, oxi, ou


_P = _build.PTR
_ARGS = [_P] * 14 + [_build.DBL] + [_P] * 4 + [_build.INT] * 3 + [_P]


def _rollout_kernel(fn, stream, qR, qp, xi, us, k, K, d, fxi, edR, edp, fiR, fip, J,
                    Jinv, *, dt):
    """Kernel B14 through the C entry point ``fn`` on ``stream``: the
    arguments checked, the outputs allocated on ``us``'s device."""
    N, nu, B = us.shape
    a = lambda t, shape, name: _build.arg(t, shape, us, name)
    e = lambda *shape: torch.empty(shape, dtype=us.dtype, device=us.device)
    oR, op, oxi, ou = e(N, 3, 3, B), e(N, 3, B), e(N, 6, B), e(N, 6, B)
    err = fn(a(qR, (N + 1, 3, 3, B), "qR"), a(qp, (N + 1, 3, B), "qp"),
             a(xi, (N + 1, 6, B), "xi"), a(us, (N, 6, B), "us"),
             a(k, (N, 6, B), "k"), a(K, (N, 6, 12, B), "K"),
             a(d, (N, 12, B), "d"), a(fxi, (N, 6, B), "fxi"),
             a(edR, (N, 3, 3, B), "edR"), a(edp, (N, 3, B), "edp"),
             a(fiR, (N, 3, 3, B), "fiR"), a(fip, (N, 3, B), "fip"),
             a(J, (6, 6), "J"), a(Jinv, (6, 6), "Jinv"), float(dt),
             a(oR, oR.shape, "oR"), a(op, op.shape, "op"), a(oxi, oxi.shape, "oxi"),
             a(ou, ou.shape, "ou"), N, B, _build.device_index(us), stream)
    _build.check(err, "fast_rollout")
    return oR, op, oxi, ou


def rollout_lane(qR, qp, xi, us, k, K, d, fxi, edR, edp, fiR, fip, J, Jinv, *, dt):
    """Kernel B14 (replaces `ops/pallas_rollout.py::_rollout_kernel` as
    called by `pallas_rollout`).  Lane layout as in the module docstring;
    returns (oR, op, oxi, ou).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or float64), or raise.  On an H100 one thread per problem walks
    the stages with the carry (R, p, xi) in registers, on blocks of one
    warp, copying each stage's 156 inputs into shared memory a stage ahead
    and composing (q_{t+1} Exp(d_q)) f(x_t)^-1 and q_t^-1 off the carry's
    chain (`csrc/fast.cu`)."""
    args = (qR, qp, xi, us, k, K, d, fxi, edR, edp, fiR, fip, J, Jinv)
    if us.device.type == "cpu":
        return rollout_plain(*args, dt=dt)
    if us.device.type != "cuda":
        raise ValueError(f"rollout_lane: no kernel for device {us.device}")
    fn = _build.function("fast", "fast_rollout", _build.suffix(us.dtype), _ARGS)
    out = _rollout_kernel(fn, torch.cuda.current_stream(us.device).cuda_stream, *args, dt=dt)
    rollout_lane.launches += 1
    return out


rollout_lane.launches = 0


def fast_rollout(qs, xis, us, k, K, d, fxi, exp_d, fq_inv, Jm, Jinv, dt, plain=False):
    """Batched gap-closing rollout in solver layout (counterpart of
    `pallas_rollout`): qs (B, N+1, 4, 4), xis (B, N+1, 6), us, k (B, N, 6),
    K (B, N, 6, 12), d (B, N, 12), fxi (B, N, 6), exp_d = Exp(d_q) and
    fq_inv = f(x)^-1 (B, N, 4, 4), Jm, Jinv (6, 6), dt a float.  Returns
    (qs_new (B, N+1, 4, 4), xis_new, us_new), stage 0 unchanged.  ``plain``
    runs the plain version whatever the device (the counterpart of
    ``interpret``)."""
    B, N = us.shape[:2]
    tl = lambda x: x.movedim(0, -1).contiguous()   # (B, N, ...) -> (N, ..., B)
    args = (tl(qs[:, :, :3, :3]), tl(qs[:, :, :3, 3]), tl(xis), tl(us), tl(k),
            tl(K), tl(d), tl(fxi), tl(exp_d[:, :, :3, :3]), tl(exp_d[:, :, :3, 3]),
            tl(fq_inv[:, :, :3, :3]), tl(fq_inv[:, :, :3, 3]),
            Jm.to(us).contiguous(), Jinv.to(us).contiguous())
    oR, op, oxi, ou = (rollout_plain if plain else rollout_lane)(*args, dt=float(dt))
    bk = lambda x: x.movedim(-1, 0)
    qs_t = torch.zeros((B, N, 4, 4), dtype=us.dtype, device=us.device)
    qs_t[:, :, :3, :3] = bk(oR)
    qs_t[:, :, :3, 3] = bk(op)
    qs_t[:, :, 3, 3] = 1.0
    return (torch.cat([qs[:, :1], qs_t], dim=1),
            torch.cat([xis[:, :1], bk(oxi)], dim=1), bk(ou))
