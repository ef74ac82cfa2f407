"""Time-axis-sharded parallel-prefix Riccati backward pass (counterpart of
the JAX `parallel/riccati_sharded.py`).

The one-device associative sweep (`solvers/riccati.parallel_backward`)
takes O(log N) depth; this module splits the same value-element suffix scan
over the ranks of a mesh along the *time* axis, for very long horizons (the
reference's reach N = 1400).  Two-level parallel prefix:

  1. each rank runs the local doubling scan over its contiguous block of
     stages;
  2. the per-block aggregates (one element, five <= n x n tensors a
     problem) are all-gathered over the time axis and combined serially,
     suffix-exclusive (one combine a later block);
  3. each rank folds the aggregate of all later blocks into its local
     suffixes with one batched `combine`.

Then each rank solves its block's stage gains, and the per-stage outputs
(k, K, Vx_next, Vxx_next) are all-gathered, so that every rank holds the
whole sweep (as the JAX function returns global arrays) and the adaptive
retry's positive-definiteness check reads the same tensors, and takes the
same branch, on every rank.  Horizons whose N + 1 elements do not divide
by the block count are padded on the late-time end with the combine's
identity element (A = I, b = 0, C = 0, eta = 0, J = 0), which the suffix
scan ignores.

The algorithm is one function of the blocks a caller holds and a
``gather`` callable (`_two_level`): `sharded_parallel_backward` passes an
all-gather over the mesh's time group (one block a rank);
`blocked_parallel_backward` passes a stack of every block on one device,
the emulation the tests and the card's check use.  Each element tensor
carries a leading problem axis, time is axis 1 (`solvers/riccati.py`).
"""

import functools
import math

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.riccati import (
    build_elements,
    combine,
    doubling_scan,
    stage_gains,
)


def default_time_mesh(axis: str = "time", n: int = None, device=None):
    """A 1-d mesh over every rank of the process group (``n``, where given,
    must be its size) for the time-sharded sweep; a process in no group
    joins a one-process group on ``device`` (the card unless 'cpu')."""
    return multihost.world_mesh(axis, n, device)


def _identity_element(B, n, dtype, device):
    """The combine's identity, one per problem: (I, 0, 0, 0, 0)."""
    z = torch.zeros((B, n, n), dtype=dtype, device=device)
    zv = torch.zeros((B, n), dtype=dtype, device=device)
    I = torch.eye(n, dtype=dtype, device=device).expand(B, n, n)
    return (I, zv, z, zv, z)


def _pad_elements(elems, n_pad):
    """Append ``n_pad`` identity elements on the late-time end (axis 1)."""
    if n_pad == 0:
        return elems
    A = elems[0]
    ident = _identity_element(A.shape[0], A.shape[-1], A.dtype, A.device)
    return tuple(torch.cat([e, i[:, None].expand((i.shape[0], n_pad) + i.shape[1:])], dim=1)
                 for e, i in zip(elems, ident))


def _terminal_element(Lx_N, Lxx_N):
    """`build_elements`' element of the terminal stage."""
    z = torch.zeros_like(Lxx_N)
    return (z, torch.zeros_like(Lx_N), z, -Lx_N, Lxx_N)


def _block_elements(prob, mu, a, b):
    """The elements a..b-1 of the N + 1 (``prob``'s stages, then the
    terminal one), identity past N."""
    Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu = prob
    N = Fx.shape[1]
    if a < N:
        e = min(b, N)
        el = build_elements(Fx[:, a:e], Fu[:, a:e], d[:, a:e], Lx[:, a:e + 1], Lu[:, a:e],
                            Lxx[:, a:e + 1], Lux[:, a:e], Luu[:, a:e], mu)
        # the last is the element of stage e's cost as a terminal: stage N's only
        el = tuple(x[:, :e - a + (b > N)] for x in el)
    else:
        el = tuple(x[:, None] for x in _terminal_element(Lx[:, N], Lxx[:, N]))
        el = el if a == N else tuple(x[:, :0] for x in el)
    return _pad_elements(el, (b - a) - el[0].shape[1])


def _pack(xs, lead):
    """The tensors ``xs``, each flattened past its ``lead`` leading axes,
    side by side on one last axis (one collective for all)."""
    return torch.cat([x.reshape(tuple(x.shape[:lead]) + (-1,)) for x in xs], dim=-1)


def _unpack(flat, shapes):
    out, i = [], 0
    for s in shapes:
        size = math.prod(s)
        out.append(flat[..., i:i + size].reshape(tuple(flat.shape[:-1]) + tuple(s)))
        i += size
    return tuple(out)


def _suffix_blocks(local, blocks, n_blocks, gather):
    """The two-level suffix scan: ``local[i]`` holds the elements (B, L, ...)
    of block ``blocks[i]`` of ``n_blocks``; ``gather`` takes one (B, P)
    tensor for each block held and returns all blocks' (n_blocks, B, P), in
    block order.  Returns each held block's suffix elements: entry j of
    block k is e_{kL+j} . e_{kL+j+1} ... e_{n_blocks L - 1}."""
    shapes = [tuple(x.shape[2:]) for x in local[0]]
    scans = [doubling_scan(combine, el, reverse=True) for el in local]
    aggs = gather([_pack([x[:, 0] for x in s], 1) for s in scans])
    agg = [_unpack(aggs[j], shapes) for j in range(n_blocks)]
    out = []
    for k, s in zip(blocks, scans):
        A = s[0]
        # suffix-exclusive: S = A_{k+1} . A_{k+2} ... A_{n-1}
        S = _identity_element(A.shape[0], A.shape[-1], A.dtype, A.device)
        for j in range(n_blocks - 1, k, -1):
            S = combine(agg[j], S)
        out.append(combine(s, tuple(x[:, None].expand_as(y) for x, y in zip(S, s))))
    return out


def _two_level(prob, mu, n_blocks, blocks, gather):
    """(k, K, Vx_next, Vxx_next) of `riccati.parallel_backward` on ``prob``
    with the N + 1 elements in ``n_blocks`` blocks, of which the caller
    holds ``blocks`` (`_suffix_blocks`' ``gather``)."""
    Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu = prob
    B, N, n = Fx.shape[0], Fx.shape[1], Fx.shape[-1]
    m = Fu.shape[-1]
    L = -(-(N + 1) // n_blocks)
    spans = [(k * L, (k + 1) * L) for k in blocks]
    suffix = _suffix_blocks([_block_elements(prob, mu, a, b) for a, b in spans],
                            blocks, n_blocks, gather)
    outs = []
    for (a, b), s in zip(spans, suffix):
        # entry j of the block is V_j, the value after stage j - 1: that
        # stage's gains (rows j = 0 and j > N are dropped below)
        t = torch.arange(a, b, device=Fx.device).clamp(1, N) - 1
        Vx, Vxx = -s[3], s[4]
        k, K = stage_gains(Fx[:, t], Fu[:, t], d[:, t], Lu[:, t], Lux[:, t], Luu[:, t],
                           Vx, Vxx, mu)
        outs.append(_pack((k, K, Vx, Vxx), 2).reshape(B, -1))
    full = gather(outs).reshape(n_blocks, B, L, -1).transpose(0, 1).reshape(B, n_blocks * L, -1)
    return _unpack(full[:, 1:N + 1], [(m,), (m, n), (n,), (n, n)])


def _stack(xs):
    return torch.stack(xs)


def _mesh_gather(mesh, axis):
    """(this rank's block, the block count, a ``gather`` over the mesh's
    ``axis`` group)."""
    r, size, group = multihost.mesh_rank(mesh, axis)

    def gather(xs):
        (x,) = xs
        return multihost.all_gather_rows(x[None], group)

    return r, size, gather


def sharded_suffix_scan(elems, mesh, axis: str = "time"):
    """Suffix-combine scan of value elements, time-sharded over ``mesh``.

    ``elems``: the element tuple of `build_elements` (B, M, ...), the same
    on every rank, M = N + 1 already padded to a multiple of the mesh
    size.  Returns the (B, M, ...) suffix elements on every rank:
    out[:, i] = e_i . e_{i+1} ... e_{M-1}."""
    multihost.check_device(mesh, elems[0])
    r, size, gather = _mesh_gather(mesh, axis)
    B, M = elems[0].shape[:2]
    if M % size:
        raise ValueError(f"{M} elements do not divide over {size} ranks: pad them")
    L = M // size
    (mine,) = _suffix_blocks([tuple(e[:, r * L:(r + 1) * L] for e in elems)], [r], size,
                             gather)
    full = gather([_pack(mine, 2).reshape(B, -1)])
    full = full.reshape(size, B, L, -1).transpose(0, 1).reshape(B, M, -1)
    return _unpack(full, [tuple(e.shape[2:]) for e in elems])


def sharded_parallel_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mesh, axis: str = "time",
                              mu=0.0):
    """The time-sharded twin of `riccati.parallel_backward`: the same
    (k, K, Vx_next, Vxx_next) on every rank, the element scan split over
    the ranks of ``mesh``'s ``axis``, each rank's gain solves on its block.
    Inputs the same on every rank, on the rank's device."""
    multihost.check_device(mesh, Fx)
    r, size, gather = _mesh_gather(mesh, axis)
    return _two_level((Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu), mu, size, [r], gather)


def blocked_parallel_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, n_blocks: int, mu=0.0):
    """The two-level sweep of `sharded_parallel_backward` with its
    ``n_blocks`` blocks all on this device (the gather a stack): what a mesh
    of ``n_blocks`` ranks computes, in one process."""
    return _two_level((Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu), mu, n_blocks, range(n_blocks),
                      _stack)


def sharded_backward_adaptive(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu, delta, mesh,
                              axis: str = "time", mu_min=1e-6, mu_max=1e10, delta_0=2.0,
                              active=None):
    """The time-sharded twin of `riccati.parallel_backward_adaptive`: the
    same per-problem Levenberg-Marquardt retry and finite-output
    guarantee, each attempt `sharded_parallel_backward` over ``mesh``.
    Every rank reads the same gathered outputs for the retry's check, so
    every rank takes the same branch.  Returns the 7-tuple `LieILQR`
    expects, so `backward='associative_sharded'` drops in."""
    return riccati.parallel_backward_adaptive(
        Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu, delta, mu_min=mu_min, mu_max=mu_max,
        delta_0=delta_0, active=active,
        sweep=functools.partial(sharded_parallel_backward, mesh=mesh, axis=axis))
