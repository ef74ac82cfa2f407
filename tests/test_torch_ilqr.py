"""The port's Euclidean tier (`models/autodiff.py`, `solvers/ilqr.py`,
`tasks/cartpole.py`) against the JAX package's, f64.

- The autodiff model of the cartpole (RK4 step, quadratic goal cost):
  step, Jacobians, DDP Hessians and the cost quadratization at random
  points, `torch.func` against `jax.jacfwd`/`hessian`, atol 1e-12 (rtol
  1e-12).
- The cartpole swing-up (the reference task cut to N = 60) with `ILQR`,
  iLQR and DDP: the same iteration count, J history rtol 1e-10, controls
  atol 1e-8.  A batch of two starts equals each start's own solve (1e-12).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.tasks import cartpole as jcp
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import cartpole_from_numpy
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import cartpole as tcp

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

N = 60
TOL = dict(rtol=1e-12, atol=1e-12)


def test_autodiff_derivatives_match_jax():
    jm = jcp.build(N=N, hessians=True).model
    tm = tcp.build(N=N, hessians=True, device="cpu").model
    rng = np.random.default_rng(4)
    for _ in range(3):
        x, u = rng.standard_normal(4) * [1.0, 1.0, 3.0, 2.0], rng.standard_normal(1) * 5.0
        jx, ju = jnp.asarray(x), jnp.asarray(u)
        tx, tu = torch.as_tensor(x), torch.as_tensor(u)
        for name, args_j, args_t in (("step", (jx, ju, 0), (tx, tu, 0)),
                                     ("jac", (jx, ju, 0), (tx, tu, 0)),
                                     ("hess", (jx, ju, 0), (tx, tu, 0)),
                                     ("stage_quad", (jx, ju, 0), (tx, tu, 0)),
                                     ("term_quad", (jx, N), (tx, N))):
            want = jax.jit(getattr(jm, name))(*args_j)
            got = getattr(tm, name)(*args_t)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            assert len(got) == len(want), name
            for w, g in zip(want, got):
                assert tuple(g.shape) == np.shape(w), name
                np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("hessians", [False, True], ids=["ilqr", "ddp"])
def test_cartpole_matches_jax(hessians):
    x0 = np.array([9.0, 0.0, 0.0, 0.0])
    us0 = np.zeros((N, 1))
    jout = jcp.build(N=N, hessians=hessians).fit(jnp.asarray(x0), jnp.asarray(us0),
                                                 n_iterations=60)
    solver = cartpole_from_numpy(N, 0.01, x_goal=np.array([10.0, 0.0, np.pi, 0.0]),
                                 hessians=hessians)
    tout = solver.fit(torch.as_tensor(x0)[None], torch.as_tensor(us0)[None], n_iterations=60)
    assert len(tout[2]) == len(jout[2])
    np.testing.assert_allclose(np.asarray(tout[2])[:, 0], np.asarray(jout[2]), rtol=1e-10)
    np.testing.assert_allclose(tout[1][0].numpy(), np.asarray(jout[1]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tout[0][0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-8)
    assert bool(tout[4].converged[0]) == bool(jout[4].converged)


def test_cartpole_batch_equals_single_solves():
    solver = tcp.build(N=N, device="cpu")
    x0s = torch.tensor([[9.0, 0.0, 0.0, 0.0], [9.5, 0.0, 0.4, 0.0]], dtype=torch.float64)
    us0 = torch.zeros((2, N, 1), dtype=torch.float64)
    both = solver.solve(x0s, us0)
    for b in range(2):
        one = solver.solve(x0s[b:b + 1], us0[b:b + 1])
        assert int(both.iteration[b]) == int(one.iteration[0])
        np.testing.assert_allclose(both.us[b].numpy(), one.us[0].numpy(), rtol=0, atol=1e-12)
