"""The generic batched Riccati backward pass (counterpart of the JAX
`ops/pallas_riccati.py`), with kernel B13.

A dense defect-aware Riccati step on per-stage Fx, Fu, Lux and Luu, fixed
mu = 0 (so Q_uu must be positive definite), for any state size nx <=
`MAX_NX` and input size nu <= `MAX_NU` on the card (the JAX kernel takes
the sizes from its arguments; the plain version any).  The kernel has tuned
instances at `SHAPES`, the sizes of the package's model families: (nx, nu)
= (12, 6) (SE(3) free body, rigid body), (12, 4) (drone) and (6, 3) (SO(3)
families); any other size with nu <= `ANY_MAX_NU` takes its runtime-shape
instance, the nx = 12 instances' group design with (nx, nu) a runtime
argument (compiled for nu <= 6 and for nu <= 12), and nu past it the
large-nu instance (Q_uu, its factor and the solves in the group's shared
memory), up to `_build.MAX_NU`, the input dimension B1-B6 take too.

Lane layout (batch last): Fx (N, nx, nx, B), Fu (N, nx, nu, B), d (N, nx, B),
Lx (N+1, nx, B), Lu (N, nu, B), Lxx (N+1, nx, nx, B), Lux (N, nu, nx, B),
Luu (N, nu, nu, B); stage N of Lx and Lxx is the terminal quadratization.
Outputs k (N, nu, B), K (N, nu, nx, B), Vx1 (N, nx, B), Vxx1 (N, nx, nx, B),
with Vx1[i], Vxx1[i] the value function of stage i+1 (the carry before stage
i's update).

`backward_plain` is the plain version (a Python loop over stages on lane
tensors), `backward_lane` kernel B13's wrapper (its runtime-shape instance
through `backward_lane_any`), `fast_backward` the solver-layout wrapper
(counterpart of `pallas_backward`).
"""

import types

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import lane_lie as ll
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.linalg import (
    chol_factor,
    chol_solve,
)

# the (nx, nu) of the kernel's tuned instances; any other (nx, nu) with
# nx <= MAX_NX takes the runtime-shape instance up to nu = ANY_MAX_NU and the
# large-nu one past it, up to MAX_NU
SHAPES = ((12, 6), (12, 4), (6, 3))
MAX_NX, ANY_MAX_NU, MAX_NU = 12, 12, _build.MAX_NU


def riccati_step(fx, fu, dd, lx, lu, lxx, lux, luu, Vx, Vxx):
    """One dense Riccati step on lane values (the JAX `_riccati_kernel`'s
    stage body).  Returns (k, K, Vx_new, Vxx_new)."""
    nu = fu.shape[1]
    fxT, fuT = ll.transpose(fx), ll.transpose(fu)
    Vmod = Vx + ll.matvec(Vxx, dd)
    Qx = lx + ll.matvec(fxT, Vmod)
    Qu = lu + ll.matvec(fuT, Vmod)
    VF = ll.matmul(Vxx, fx)
    Qxx = lxx + ll.matmul(fxT, VF)
    Qux = lux + ll.matmul(fuT, VF)
    Quu = luu + ll.matmul(fuT, ll.matmul(Vxx, fu))
    L = chol_factor(Quu, nu)
    K = -chol_solve(L, Qux, nu)
    k = -chol_solve(L, Qu[:, None], nu)[:, 0]
    KT, QuxT = ll.transpose(K), ll.transpose(Qux)
    KTQuu = ll.matmul(KT, Quu)
    Vx_new = Qx + ll.matvec(KTQuu, k) + ll.matvec(KT, Qu) + ll.matvec(QuxT, k)
    Vxx_new = Qxx + ll.matmul(KTQuu, K) + ll.matmul(KT, Qux) + ll.matmul(QuxT, K)
    return k, K, Vx_new, 0.5 * (Vxx_new + ll.transpose(Vxx_new))


def backward_plain(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu):
    """Plain version of kernel B13; same arguments and outputs as
    `backward_lane`."""
    N, nx = d.shape[:2]
    nu = Lu.shape[1]
    bs = tuple(d.shape[2:])
    e = lambda *shape: torch.empty(shape + bs, dtype=d.dtype, device=d.device)
    k, K, Vx1, Vxx1 = e(N, nu), e(N, nu, nx), e(N, nx), e(N, nx, nx)
    Vx, Vxx = Lx[N], Lxx[N]
    for t in reversed(range(N)):
        Vx1[t], Vxx1[t] = Vx, Vxx
        k[t], K[t], Vx, Vxx = riccati_step(Fx[t], Fu[t], d[t], Lx[t], Lu[t],
                                           Lxx[t], Lux[t], Luu[t], Vx, Vxx)
    return k, K, Vx1, Vxx1


_P, _I = _build.PTR, _build.INT
_ARGS = [_P] * 12 + [_I] * 5 + [_P]


def _backward_kernel(fn, stream, Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu):
    """Kernel B13 through the C entry point ``fn`` on ``stream``: the
    arguments checked, the outputs allocated on ``d``'s device."""
    N, nx, B = d.shape
    nu = Lu.shape[1]
    a = lambda t, shape, name: _build.arg(t, shape, d, name)
    e = lambda *shape: torch.empty(shape, dtype=d.dtype, device=d.device)
    k, K, Vx1, Vxx1 = e(N, nu, B), e(N, nu, nx, B), e(N, nx, B), e(N, nx, nx, B)
    err = fn(a(Fx, (N, nx, nx, B), "Fx"), a(Fu, (N, nx, nu, B), "Fu"),
             a(d, (N, nx, B), "d"), a(Lx, (N + 1, nx, B), "Lx"),
             a(Lu, (N, nu, B), "Lu"), a(Lxx, (N + 1, nx, nx, B), "Lxx"),
             a(Lux, (N, nu, nx, B), "Lux"), a(Luu, (N, nu, nu, B), "Luu"),
             a(k, k.shape, "k"), a(K, K.shape, "K"), a(Vx1, Vx1.shape, "Vx1"),
             a(Vxx1, Vxx1.shape, "Vxx1"), N, nx, nu, B, _build.device_index(d), stream)
    _build.check(err, "fast_riccati")
    return k, K, Vx1, Vxx1


def backward_lane(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu):
    """Kernel B13 (replaces `ops/pallas_riccati.py::_riccati_kernel` as
    called by `pallas_backward`).  Lane layout as in the module docstring;
    returns (k, K, Vx1, Vxx1).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or float64), its tuned instance at the (nx, nu) of `SHAPES`
    and `backward_lane_any`'s at any other shape up to (`MAX_NX`,
    `MAX_NU`), or raise.  On an H100, at nx = 12 (and at the other shapes)
    a group of 16 threads runs one problem's stage recursion, lane r
    holding row r of V_xx in registers, the group exchanging the stage's
    products through shared memory, and the block copies each stage's
    inputs into shared memory a stage ahead;
    at (6, 3) one thread runs one problem with its carry in registers, on
    blocks of one warp, copying each stage's 132 inputs into shared memory
    a stage ahead (`csrc/fast.cu`)."""
    if d.device.type == "cpu":
        return backward_plain(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    if (d.shape[1], Lu.shape[1]) not in SHAPES:
        return backward_lane_any(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    if d.device.type != "cuda":
        raise ValueError(f"backward_lane: no kernel for device {d.device}")
    fn = _build.function("fast", "fast_riccati", _build.suffix(d.dtype), _ARGS)
    out = _backward_kernel(fn, torch.cuda.current_stream(d.device).cuda_stream,
                           Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    backward_lane.launches += 1
    return out


backward_lane.launches = 0


def backward_lane_any(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu):
    """Kernel B13's runtime-shape and large-nu instances, at any (nx, nu)
    with nx <= `MAX_NX` and nu <= `MAX_NU` (`backward_lane` sends it the
    shapes its tuned instances do not take).  Same arguments and outputs as
    `backward_lane`.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise ValueError before any launch (beyond the bounds, or on another
    device).  Up to nu = `ANY_MAX_NU` the runtime-shape instance runs
    (counted here): on an H100 the tuned nx = 12 kernel's group design with
    the shape a runtime argument, a group of 16 threads running one
    problem's stage recursion (8 problems a block), lane r < nx holding row
    r of V_xx in registers (every per-lane array sized for the instance's
    maximum, nu <= 6 or nu <= 12, and indexed by constants), the group
    factoring Q_uu together and exchanging the stage's products through
    shared memory laid out for the runtime shape, the block copying each
    stage's inputs into shared memory a stage ahead.  Past it the large-nu
    instance runs (counted in ``backward_lane_any.nuL``): the same group and
    copies, but V_xx Fu, Q_ux, Q_uu, its factor and the solves' rows in the
    group's shared memory, the lanes sharing out Q_uu's rows and its
    Cholesky column by column, no register array sized by nu, and 8, 4 or 2
    problems a block as nu and the scalar type let the most fit on an SM
    (`_build.fast_large_problems`; `csrc/fast.cu`, `csrc/fast_large.cuh`)."""
    if d.device.type == "cpu":
        return backward_plain(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    nx, nu = d.shape[1], Lu.shape[1]
    if not (1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU):
        raise ValueError(f"backward_lane: no kernel for (nx, nu) = ({nx}, {nu}): "
                         f"the kernels take nx in 1..{MAX_NX} and nu in 1..{MAX_NU}")
    if d.device.type != "cuda":
        raise ValueError(f"backward_lane_any: no kernel for device {d.device}")
    fn = _build.function("fast", "fast_riccati_any", _build.suffix(d.dtype), _ARGS)
    out = _backward_kernel(fn, torch.cuda.current_stream(d.device).cuda_stream,
                           Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    (backward_lane_any if nu <= ANY_MAX_NU else backward_lane_any.nuL).launches += 1
    return out


backward_lane_any.launches = 0
backward_lane_any.nuL = types.SimpleNamespace(launches=0)


def fast_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, plain=False):
    """Batched Riccati backward (mu = 0) in solver layout (counterpart of
    `pallas_backward`): Fx (B, N, nx, nx), Fu (B, N, nx, nu), d (B, N, nx),
    Lx (B, N+1, nx), Lu (B, N, nu), Lxx (B, N+1, nx, nx), Lux (B, N, nu, nx),
    Luu (B, N, nu, nu).  Returns (k, K, Vx1, Vxx1) in solver layout.
    ``plain`` runs the plain version whatever the device (the counterpart
    of ``interpret``)."""
    to_lanes = lambda x: x.movedim(0, -1).contiguous()   # (B, N, ...) -> (N, ..., B)
    args = [to_lanes(x) for x in (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)]
    out = (backward_plain if plain else backward_lane)(*args)
    return tuple(x.movedim(-1, 0) for x in out)
