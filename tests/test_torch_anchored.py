"""The port's anchored tier (`solvers/anchored.py`) against the JAX
package's on the screw-tracking problem (R = 1e-3 I) cut to H = 30, three
perturbed starts, 6 iterations.

f64, the plain path (``use_pallas=False``: the doubling-scan Riccati)
against the JAX one at atol 1e-10 (controls, J and grad norms rtol 1e-10).
f32, the kernel path (``use_pallas=True``: B13's plain version on CPU
tensors) against the JAX `pallas_backward` in interpret mode at the
pipeline tests' tolerance (tests/test_pipeline.py: atol 5e-4, rtol 1e-4 on
the controls; rtol 1e-4 on J).  `convert.anchored_from_numpy` of the JAX
problem equals the port's own `build_anchored` (1e-15).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import anchored as ja
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import anchored_from_numpy
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import anchored

from torch_port_cases import initial_batch, one_cpu_thread, problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B, ITERS = 30, 3, 6


@pytest.fixture(scope="module")
def case():
    dp, cp, _, _, q0, xi0, nu = problem(H)
    Q = np.block([[np.asarray(cp.Q1), np.zeros((6, 6))], [np.zeros((6, 6)), np.asarray(cp.Q2)]])
    P = np.block([[np.asarray(cp.P1), np.zeros((6, 6))], [np.zeros((6, 6)), np.asarray(cp.P2)]])
    args = (np.asarray(dp.J), float(dp.dt), Q, np.asarray(cp.R), P, np.asarray(cp.q_ref),
            np.asarray(cp.xi_ref))
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=3, dtype=jnp.float64)
    q0_locs = np.linalg.inv(np.asarray(cp.q_ref[0]))[None] @ q0s
    return args, q0_locs, xi0s, us0


def run_both(case, dtype, use_pallas):
    args, q0_locs, xi0s, us0 = case
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    jprob = ja.build_anchored(*args, dtype=jdt)
    jout = ja.AnchoredFastSolver(jprob, N=H, iterations=ITERS, use_pallas=use_pallas,
                                 interpret=True).solve(
        jnp.asarray(q0_locs, jdt), jnp.asarray(xi0s, jdt), jnp.asarray(us0, jdt))
    tprob = anchored.build_anchored(*args, dtype=tdt, device="cpu")
    tout = anchored.AnchoredFastSolver(tprob, N=H, iterations=ITERS,
                                       use_pallas=use_pallas).solve(
        torch.as_tensor(q0_locs), torch.as_tensor(xi0s), torch.as_tensor(us0))
    return jprob, jout, tprob, tout


def test_anchored_f64_plain_matches_jax(case):
    _, jout, _, tout = run_both(case, "f64", use_pallas=False)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == np.shape(j)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=1e-10)
    np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]), rtol=1e-10, atol=1e-16)


def test_anchored_f32_kernel_path_matches_jax(case):
    _, jout, _, tout = run_both(case, "f32", use_pallas=True)
    assert tout[2].dtype == torch.float32
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=1e-4)
    assert np.all(np.isfinite(tout[4].numpy()))


def test_anchored_problem_from_jax_fields(case):
    args = case[0]
    jprob = ja.build_anchored(*args, dtype=jnp.float64)
    fields = {k: (np.asarray(v) if k != "dyn" else
                  {f: np.asarray(x) for f, x in v._asdict().items()})
              for k, v in jprob._asdict().items()}
    got = anchored_from_numpy(fields)
    want = anchored.build_anchored(*args, dtype=torch.float64, device="cpu")
    for name in ("T", "Ad_ref", "xi_ref", "Q1", "Q2", "R", "P1", "P2"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   rtol=0, atol=1e-15)
    for name in ("J", "Jinv", "Ib", "m", "dt"):
        np.testing.assert_allclose(getattr(got.dyn, name).numpy(),
                                   getattr(want.dyn, name).numpy(), rtol=0, atol=1e-15)
