"""Kernels B2, B3 and B4: the port's plain versions against the JAX
pipeline's lane methods (`_backward_lane`, `_rollout_linearize_lane`,
`_rollout_lane`, Pallas in interpret mode), fed the same inputs: the JAX
lane arrays converted to torch.

Tolerances: f64, rtol 1e-7 with atol 1e-7.  The JAX lane Log takes its
angle from the `atan2_pos` polynomial (~1e-8), and B3 re-linearizes
through it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P

from torch_port_cases import initial_batch, problem

H, B = 10, 3
CLOSE = dict(rtol=1e-7, atol=1e-7)


def _case(drone, al):
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, jnp.float64, drone=drone)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=7, dtype=jnp.float64,
                                   u_scale=0.3)
    pipe = PallasPipelineSolver(N=H, iterations=1, dt=float(dp.dt),
                                interpret=True, gravity=drone)
    qR, qp, xi, us, refs, consts = pipe._prepare(dp, cp, jnp.asarray(q0s),
                                                 jnp.asarray(xi0s), jnp.asarray(us0))
    lin = pipe._linearize_lane(qR, qp, xi, us, refs, consts)
    lu = 2.0 * jnp.einsum("ij,nj...->ni...", cp.R, us)
    luu_al = None
    if al:
        luu_al = jnp.asarray(np.abs(np.random.default_rng(8).standard_normal((H, nu, B))))
    lanes = lambda M: jnp.broadcast_to(jnp.asarray(M)[..., None], jnp.shape(M) + (B,))
    term = (qR[-1], qp[-1], xi[-1], lanes(cp.q_ref_inv[-1, :3, :3]),
            lanes(cp.q_ref_inv[-1, :3, 3]), lanes(cp.Ad_ref[-1]),
            lanes(cp.xi_ref[-1]), lanes(cp.P1), lanes(cp.P2))
    k, K, gvec, lN = pipe._backward_lane(lin, lu, term, consts, luu_al=luu_al)
    ro = pipe._rollout_lane(qR, qp, xi, us, k, K, lin, consts)
    rl = pipe._rollout_linearize_lane(qR, qp, xi, us, k, K, lin, refs, consts)

    t = lambda x: torch.as_tensor(np.array(x))
    tsolver = P.PipelineSolver(H, 1, float(dp.dt), gravity=drone)
    _, _, _, _, trefs, tconsts = tsolver._prepare(tdp, tcp, q0s, xi0s, torch.as_tensor(us0))
    traj = tuple(t(x) for x in (qR, qp, xi, us))
    tlin = {name: t(v) for name, v in lin.items()}
    jax_out = dict(
        backward=(k, K, gvec, lN), rollout=ro, rollout_linearize=rl)
    port = dict(
        backward=P.backward_plain(tlin, t(lu), *traj[:3], trefs, tconsts,
                                  glow=drone,
                                  luu_al=None if luu_al is None else t(luu_al)),
        rollout=P.rollout_plain(*traj, t(k), t(K), tlin, tconsts, dt=tsolver.dt,
                                gravity=drone),
        rollout_linearize=P.rollout_linearize_plain(
            *traj, t(k), t(K), tlin, trefs, tconsts, dt=tsolver.dt, gravity=drone,
            exact_grav=False))
    return jax_out, port


@pytest.fixture(scope="module", params=[(False, False), (False, True), (True, False)],
                ids=["free", "free-al", "drone"])
def case(request):
    return _case(*request.param)


def _flat(x):
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    return [t for e in x for t in _flat(e)] if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("kernel", ["backward", "rollout", "rollout_linearize"])
def test_plain_kernel_matches_jax_lane_kernel(case, kernel):
    jax_out, port = case
    a, b = _flat(port[kernel]), _flat(jax_out[kernel])
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **CLOSE,
                                   err_msg=f"{kernel} output {i}")


def test_cholesky_reciprocal_diagonal():
    """chol_factor_lane stores 1/sqrt(pivot) on the diagonal, and
    chol_solve_lane solves with it."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 6, 6))
    Q = torch.as_tensor(np.einsum("bij,bkj->ikb", A, A) + 6 * np.eye(6)[..., None])
    L = P.chol_factor_lane(Q, 6)
    Lfull = np.linalg.cholesky(np.moveaxis(Q.numpy(), -1, 0))
    for j in range(6):
        np.testing.assert_allclose(L[j][j].numpy(), 1.0 / Lfull[:, j, j], rtol=1e-13)
    rhs = torch.as_tensor(rng.standard_normal((6, 3, 4)))
    X = P.chol_solve_lane(L, rhs, 6)
    want = np.linalg.solve(np.moveaxis(Q.numpy(), -1, 0), np.moveaxis(rhs.numpy(), -1, 0))
    np.testing.assert_allclose(np.moveaxis(X.numpy(), -1, 0), want, rtol=1e-11, atol=1e-12)
