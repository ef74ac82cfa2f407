"""Parallel-prefix (associative-scan) Riccati backward pass (counterpart of
the JAX `solvers/riccati.py`).

The value-function recursion is an associative combination of per-stage
conditional value-function elements e = (A, b, C, eta, Jm) (the JAX
module's docstring has the algebra), so every V_i comes out of a prefix
over stages of O(log N) depth.  The JAX package takes that prefix with
`lax.associative_scan`, an XLA scan; here it is `doubling_scan`, a
Hillis-Steele scan over the stage axis in which every level is one set of
batched matmuls and solves over all stages and problems at once.

Every tensor carries a leading problem axis: Fx (B, N, n, n), Fu (B, N, n, m),
d (B, N, n), Lx (B, N+1, n), Lu (B, N, m), Lxx (B, N+1, n, n),
Lux (B, N, m, n), Luu (B, N, m, m).  B = 1 is the JAX single-problem
function; B > 1 is its `jax.vmap`.  ``mu`` and ``delta`` are a float or a
(B,) tensor.

`parallel_backward_adaptive` keeps the JAX whole-sweep Levenberg-Marquardt
retry, per problem: the sweep is redone at an escalated mu while any
problem's Quu is not positive definite (one host read a retry), and each
problem keeps its own mu, delta and ``exceeded`` flag.
"""

import torch


def _solve(A, B):
    """A^-1 B without the error check (`torch.linalg.solve` reads the
    factorization's status back to the host; a singular A gives
    non-finite entries, as in the JAX package)."""
    return torch.linalg.solve_ex(A, B)[0]


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


def _T(M):
    return M.transpose(-1, -2)


def _lane(x, like):
    """A float or per-problem (B,) tensor shaped to broadcast against
    ``like`` (B, ...)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def doubling_scan(combine, elems, reverse=False):
    """Inclusive scan of ``combine`` over axis 1 of every tensor in the tuple
    ``elems`` (Hillis-Steele: level j combines each element with the one
    2**j stages away).  ``combine(earlier, later)`` must be associative.
    Forward, entry i is e_0 . e_1 ... e_i; with ``reverse`` it is the suffix
    e_i . e_{i+1} ... e_{n-1}."""
    n = elems[0].shape[1]
    off = 1
    while off < n:
        head = tuple(e[:, :n - off] for e in elems)
        tail = tuple(e[:, off:] for e in elems)
        new = combine(head, tail)
        if reverse:
            elems = tuple(torch.cat([x, e[:, n - off:]], dim=1)
                          for x, e in zip(new, elems))
        else:
            elems = tuple(torch.cat([e[:, :off], x], dim=1)
                          for x, e in zip(new, elems))
        off *= 2
    return elems


def build_elements(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=0.0):
    """Per-stage elements and the terminal element, stacked along the stage
    axis (N + 1 entries).  mu regularizes as the reference's
    Quu = Luu + fu^T (V + mu I) fu, Qux = Lux + fu^T (V + mu I) fx does."""
    n = Fx.shape[-1]
    FuT = _T(Fu)
    mu4 = _lane(mu, Luu)
    LuuR = Luu + mu4 * (FuT @ Fu)
    Lux = Lux + mu4 * (FuT @ Fx)
    # Luu^-1 [Lux | Lu | Fu^T] in one solve
    X = _solve(LuuR, torch.cat([Lux, Lu[..., None], FuT], dim=-1))
    Ui_Lux, Ui_Lu, Ui_FuT = X[..., :n], X[..., n], X[..., n + 1:]
    LuxT = _T(Lux)
    A = Fx - Fu @ Ui_Lux
    b = d - _bmv(Fu, Ui_Lu)
    C = Fu @ Ui_FuT
    Jm = Lxx[:, :-1] - LuxT @ Ui_Lux
    eta = _bmv(LuxT, Ui_Lu) - Lx[:, :-1]
    z = torch.zeros_like(A[:, :1])
    return (torch.cat([A, z], dim=1), torch.cat([b, torch.zeros_like(b[:, :1])], dim=1),
            torch.cat([C, z], dim=1), torch.cat([eta, -Lx[:, -1:]], dim=1),
            torch.cat([Jm, Lxx[:, -1:]], dim=1))


def combine(e_earlier, e_later):
    """Associative combination (earlier segment, later segment)."""
    A1, b1, C1, eta1, J1 = e_earlier
    A2, b2, C2, eta2, J2 = e_later
    n = A1.shape[-1]
    I = torch.eye(n, dtype=A1.dtype, device=A1.device)
    # (I + C1 J2)^-1 [A1 | b1 + C1 eta2 | C1]
    X = _solve(I + C1 @ J2,
                           torch.cat([A1, (b1 + _bmv(C1, eta2))[..., None], C1], dim=-1))
    Minv_A1, Minv_bC, Minv_C1 = X[..., :n], X[..., n], X[..., n + 1:]
    Mtinv = _solve(I + J2 @ C1, I.expand(J2.shape))
    A1T_Mtinv = _T(A1) @ Mtinv
    A = A2 @ Minv_A1
    b = _bmv(A2, Minv_bC) + b2
    C = A2 @ Minv_C1 @ _T(A2) + C2
    eta = _bmv(A1T_Mtinv, eta2 - _bmv(J2, b1)) + eta1
    J = A1T_Mtinv @ J2 @ A1 + J1
    return A, b, C, eta, 0.5 * (J + _T(J))


def parallel_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=0.0):
    """All-stage gains and value functions via the doubling scan.

    Returns (k (B, N, m), K (B, N, m, n), Vx_next (B, N, n),
    Vxx_next (B, N, n, n)), as the sequential backward: Vx_next[:, i] is
    V_x at stage i+1."""
    elems = build_elements(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu)
    _, _, _, eta_s, J_s = doubling_scan(combine, elems, reverse=True)
    Vx_next, Vxx_next = -eta_s[:, 1:], J_s[:, 1:]
    k, K = stage_gains(Fx, Fu, d, Lu, Lux, Luu, Vx_next, Vxx_next, mu)
    return k, K, Vx_next, Vxx_next


def stage_gains(Fx, Fu, d, Lu, Lux, Luu, Vx_next, Vxx_next, mu):
    """Every stage's gains (k, K) from the value function of the stage after
    it, stage-batched: k = -Quu^-1 Qu, K = -Quu^-1 Qux."""
    n = Fx.shape[-1]
    FuT = _T(Fu)
    eye = torch.eye(n, dtype=Fx.dtype, device=Fx.device)
    Vreg = Vxx_next + _lane(mu, Vxx_next) * eye
    Vmod = Vx_next + _bmv(Vxx_next, d)
    Qu = Lu + _bmv(FuT, Vmod)
    Qux = Lux + FuT @ Vreg @ Fx
    Quu = Luu + FuT @ Vreg @ Fu
    X = _solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    return -X[..., 0], -X[..., 1:]


def _all_quu_pd(Fx, Fu, Luu, Vxx_next, mu):
    """Per problem (B,): every stage's regularized Quu positive definite
    (batched Cholesky)."""
    n = Fx.shape[-1]
    eye = torch.eye(n, dtype=Fx.dtype, device=Fx.device)
    FuT = _T(Fu)
    Quu = Luu + FuT @ (Vxx_next + _lane(mu, Vxx_next) * eye) @ Fu
    L, info = torch.linalg.cholesky_ex(0.5 * (Quu + _T(Quu)))
    return ((info == 0) & torch.isfinite(L).all(dim=(-1, -2))).all(dim=1)


def _finite(x):
    return torch.isfinite(x).flatten(1).all(dim=1)


def parallel_backward_adaptive(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu, delta,
                               mu_min=1e-6, mu_max=1e10, delta_0=2.0,
                               active=None, sweep=parallel_backward):
    """PD-safe parallel-prefix backward with the whole-sweep LM retry, per
    problem: a problem whose sweep has a non-PD Quu or a non-finite output
    is swept again at mu escalated by the reference's delta-doubling
    schedule until it passes or mu reaches mu_max; on success its mu
    de-escalates for the next iteration.  ``active`` (B,) bool: problems
    whose result is wanted (a frozen problem never triggers a retry).
    ``sweep``: the all-stage backward that each attempt runs
    (`parallel_backward`; the time-sharded one of
    `parallel/riccati_sharded.py` there).

    Returns (k, K, Vx_next, Vxx_next, mu_out, delta_out, exceeded), mu_out,
    delta_out and exceeded per problem (B,)."""
    B = Fx.shape[0]
    kw = dict(dtype=Fx.dtype, device=Fx.device)
    full = lambda v: (v.to(**kw) if isinstance(v, torch.Tensor) else
                      torch.tensor(v, **kw)).expand(B).clone()
    mu_q, dlt = full(mu), full(delta)

    def attempt(m):
        out = sweep(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=m)
        ok = _all_quu_pd(Fx, Fu, Luu, out[3], m)
        for x in out:
            ok = ok & _finite(x)
        return out, ok

    outs, ok = attempt(mu_q)
    done = ok if active is None else ok | ~active
    exceeded = torch.zeros(B, dtype=torch.bool, device=Fx.device)
    while not bool(done.all()):
        dlt_inc = torch.clamp(dlt, min=1.0) * delta_0
        mu_inc = torch.clamp(mu_q * dlt_inc, min=mu_min)
        hit = mu_inc >= mu_max
        new, ok = attempt(mu_inc)
        upd = ~done
        outs = tuple(torch.where(_lane(upd, x), y, x) for x, y in zip(outs, new))
        mu_q = torch.where(upd, mu_inc, mu_q)
        dlt = torch.where(upd, dlt_inc, dlt)
        exceeded = exceeded | (upd & hit & ~ok)
        done = done | ok | hit
    dlt_dec = torch.clamp(dlt, max=1.0) / delta_0
    mu_dec = mu_q * dlt_dec
    mu_dec = torch.where(mu_dec <= mu_min, torch.zeros_like(mu_dec), mu_dec)
    mu_out = torch.where(exceeded, mu_q, mu_dec)
    delta_out = torch.where(exceeded, dlt, dlt_dec)
    # the JAX package's sanitizing of an `exceeded` sweep's non-finite rows:
    # zero gains and the pure-cost value function (no-ops on success)
    k, K, Vx_n, Vxx_n = outs
    fin = lambda x, fb: torch.where(torch.isfinite(x), x, fb)
    return (fin(k, torch.zeros_like(k)), fin(K, torch.zeros_like(K)),
            fin(Vx_n, Lx[:, 1:]), fin(Vxx_n, Lxx[:, 1:]), mu_out, delta_out,
            exceeded)
