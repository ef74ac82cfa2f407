"""The port's parallel-prefix Riccati (`solvers/riccati.py`) against the JAX
package's on the same numpy inputs, f64: `parallel_backward` at several
fixed mu, one problem and a batch of three (the batch equals the JAX
function mapped over problems), and `parallel_backward_adaptive` on a
problem whose mu = 0 sweep is not positive definite, all at rtol = atol =
1e-10.  The fixed-mu scan also equals the sequential fixed-mu recursion (a
numpy oracle, as tests/test_riccati_reg.py:67 checks in JAX, atol 1e-9 on
the gains, 1e-8 on V) and, at mu = 0, `LieILQR`'s 'sequential_fixed'
backward (1e-10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import riccati as jr
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)

TOL = dict(rtol=1e-10, atol=1e-10)
NAMES = ("Fx", "Fu", "d", "Lx", "Lu", "Lxx", "Lux", "Luu")


def random_ltv(N=24, n=4, m=2, seed=0, indefinite=False):
    """A random time-varying LQ problem (tests/test_riccati_reg.py's), or
    with ``indefinite`` its control penalty ~1e-5 and a terminal Hessian with
    one negative direction, so that Quu loses definiteness at mu = 0."""
    rng = np.random.default_rng(seed)
    rs = 1e-5 if indefinite else 1.0
    Fx = np.eye(n) + 0.08 * rng.standard_normal((N, n, n))
    Fu = 0.3 * rng.standard_normal((N, n, m))
    d = 0.01 * rng.standard_normal((N, n))
    Lx = rng.standard_normal((N + 1, n))
    Lu = rs * rng.standard_normal((N, m))
    M = rng.standard_normal((N + 1, n, n))
    Lxx = M @ np.swapaxes(M, -1, -2) + (0.5 if indefinite else 0.1) * np.eye(n)
    Lux = rs * 0.1 * rng.standard_normal((N, m, n))
    Lm = rng.standard_normal((N, m, m))
    Luu = rs * (Lm @ np.swapaxes(Lm, -1, -2) + 0.5 * np.eye(m))
    if indefinite:
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Lxx[N] = (Q * np.array([-0.05, 0.01, 0.01, 0.01])) @ Q.T
    return (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)


def as_jax(prob):
    return tuple(jnp.asarray(x, jnp.float64) for x in prob)


def as_port(*probs):
    """The problems stacked along a leading problem axis."""
    return tuple(torch.as_tensor(np.stack(xs)) for xs in zip(*probs))


def sequential_fixed_mu(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu):
    """The fixed-mu defect-aware recursion in numpy (the oracle of
    tests/test_riccati_reg.py)."""
    N, n = Fx.shape[0], Fx.shape[-1]
    Vx, Vxx = Lx[-1], Lxx[-1]
    ks, Ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        Vmod = Vx + Vxx @ d[t]
        Vreg = Vxx + mu * np.eye(n)
        Qx, Qu = Lx[t] + Fx[t].T @ Vmod, Lu[t] + Fu[t].T @ Vmod
        Qxx = Lxx[t] + Fx[t].T @ Vxx @ Fx[t]
        Qux = Lux[t] + Fu[t].T @ Vreg @ Fx[t]
        Quu = Luu[t] + Fu[t].T @ Vreg @ Fu[t]
        ks[t], Ks[t] = -np.linalg.solve(Quu, Qu), -np.linalg.solve(Quu, Qux)
        k, K = ks[t], Ks[t]
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
    return np.stack(ks), np.stack(Ks)


@pytest.mark.parametrize("mu", [0.0, 0.37, 5.0])
def test_parallel_backward_matches_jax(mu):
    prob = random_ltv(seed=1)
    want = jr.parallel_backward(*as_jax(prob), mu=mu)
    got = riccati.parallel_backward(*as_port(prob), mu=mu)
    for w, g in zip(want, got):
        assert tuple(g.shape) == (1,) + np.shape(w)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **TOL)
    k_s, K_s = sequential_fixed_mu(*prob, mu=mu)
    np.testing.assert_allclose(got[0][0].numpy(), k_s, atol=1e-9)
    np.testing.assert_allclose(got[1][0].numpy(), K_s, atol=1e-9)


def test_parallel_backward_batch_is_jax_vmap():
    """Three problems in one batch, each at its own mu, equal the JAX
    function mapped over them."""
    probs = [random_ltv(seed=s) for s in (2, 3, 4)]
    mus = np.array([0.0, 0.5, 2.0])
    want = jax.vmap(lambda *a: jr.parallel_backward(*a[:-1], mu=a[-1]))(
        *(jnp.asarray(np.stack(xs)) for xs in zip(*probs)), jnp.asarray(mus))
    got = riccati.parallel_backward(*as_port(*probs), mu=torch.as_tensor(mus))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_adaptive_rescues_indefinite_like_jax():
    """The whole-sweep retry escalates mu on the indefinite problem (and
    not on the PD one beside it in the batch): outputs, mu, delta and the
    exceeded flag per problem equal the JAX function's on each."""
    probs = [random_ltv(N=30, seed=2, indefinite=True), random_ltv(N=30, seed=5)]
    Fx, Fu, _, _, _, _, _, Luu = as_port(probs[0])
    Vxx0 = riccati.parallel_backward(*as_port(probs[0]), mu=0.0)[3]
    assert not bool(riccati._all_quu_pd(Fx, Fu, Luu, Vxx0, 0.0)[0])
    got = riccati.parallel_backward_adaptive(*as_port(*probs), mu=0.0, delta=2.0)
    for b, prob in enumerate(probs):
        want = jr.parallel_backward_adaptive(*as_jax(prob), mu=0.0, delta=2.0)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **TOL)
    assert float(got[4][0]) > 0.0 and float(got[4][1]) == 0.0


def test_scan_at_mu0_equals_sequential_fixed():
    """`parallel_backward` at mu = 0 equals `LieILQR`'s 'sequential_fixed'
    recursion on the same linearization."""
    prob = as_port(random_ltv(N=20, n=12, m=6, seed=6), random_ltv(N=20, n=12, m=6, seed=7))
    lin = dict(zip(NAMES, prob))
    solver = LieILQR(None, SolverConfig(N=20, backward="sequential_fixed"))
    zero = torch.zeros(2, dtype=torch.float64)
    seq = solver._backward_sequential_fixed(lin, zero, zero)
    par = riccati.parallel_backward(*prob, mu=0.0)
    for s, p in zip(seq[:4], par):
        np.testing.assert_allclose(p.numpy(), s.numpy(), **TOL)
