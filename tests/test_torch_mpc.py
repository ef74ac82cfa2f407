"""The port's batched closed-loop MPC (`solvers/mpc.make_closed_loop_batch`)
against the JAX package's (Pallas in interpret mode) and against a host
loop of its own solver, on the screw-tracking reference (R = 1e-3 I), at
H = 10, T = 5, B = 3, 3 iterations a step: f64 at 1e-8 on us and qs (atol
and rtol: the two pipelines' f64 controls of up to ~3 differ by 1.7e-8),
f32 at atol 2e-4; the host loop of `PipelineSolver.solve` over hand-sliced
windows at 1e-10 (tests/test_mpc.py:91-135's check); the disturbances:
sigma = 0 with a generator reproduces the noiseless run, sigma > 0 stays
finite and differs.  The constrained driver is in
test_torch_mpc_constrained.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import mpc as jmpc
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)

from torch_port_cases import mpc_setup, one_cpu_thread, window_by_hand  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, T, B, ITERS = 10, 5, 3, 3


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_batch_mpc_matches_jax(dtype):
    dp, cp, jmodel, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(dtype, T, H, B)
    jres = jmpc.make_closed_loop_batch(
        PallasPipelineSolver(N=H, iterations=ITERS, dt=0.01, interpret=True), jmodel, T)(
            dp, cp, q0s, xi0s)
    res = mpc.make_closed_loop_batch(PipelineSolver(H, ITERS, 0.01), tmodel, T)(
        tdp, tcp, torch.as_tensor(q0s), torch.as_tensor(xi0s))
    tol = dict(rtol=1e-8, atol=1e-8) if dtype == jnp.float64 else dict(rtol=0, atol=2e-4)
    for f in ("us", "qs", "xis", "J_pred"):
        assert tuple(getattr(res, f).shape) == np.shape(getattr(jres, f)), f
    np.testing.assert_allclose(res.us.numpy(), np.asarray(jres.us), **tol)
    np.testing.assert_allclose(res.qs.numpy(), np.asarray(jres.qs), **tol)
    np.testing.assert_allclose(res.J_pred.numpy(), np.asarray(jres.J_pred),
                               rtol=1e-7 if dtype == jnp.float64 else 1e-4)


def test_batch_mpc_matches_host_loop():
    """The driver against a host loop of `PipelineSolver.solve` on
    hand-sliced windows, warm-started by the shifted solution."""
    *_, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(jnp.float64, T, H, B)
    pipe = PipelineSolver(H, ITERS, 0.01)
    qs, xis = torch.as_tensor(q0s), torch.as_tensor(xi0s)
    res = mpc.make_closed_loop_batch(pipe, tmodel, T)(tdp, tcp, qs, xis)
    params = {"dyn": tdp, "cost": tcp}
    us_warm = torch.zeros((B, H, 6), dtype=torch.float64)
    for t in range(T):
        out = pipe.solve(tdp, window_by_hand(tcp, t, H), qs, xis, us_warm)
        u0 = out.us[:, 0]
        np.testing.assert_allclose(res.us[:, t].numpy(), u0.numpy(), rtol=0, atol=1e-10)
        qs, xis = tmodel.step(params, qs, xis, u0, 0)
        us_warm = torch.cat([out.us[:, 1:], out.us[:, -1:]], dim=1)
    np.testing.assert_allclose(res.qs[:, -1].numpy(), qs.numpy(), rtol=0, atol=1e-10)
    # the windows are slices of the full reference, not recomputed
    w = mpc._window(tcp, 2, H)
    assert w.Ad_ref.data_ptr() == tcp.Ad_ref[2].data_ptr()
    assert w.q_ref_inv.data_ptr() == tcp.q_ref_inv[2].data_ptr()


def test_batch_mpc_disturbances():
    *_, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(jnp.float64, T, H, B)
    run = mpc.make_closed_loop_batch(PipelineSolver(H, ITERS, 0.01), tmodel, T)
    args = (tdp, tcp, torch.as_tensor(q0s), torch.as_tensor(xi0s))
    clean = run(*args)
    zero = run(*args, noise_generator=torch.Generator().manual_seed(1), noise_sigma=0.0)
    noisy = run(*args, noise_generator=torch.Generator().manual_seed(1), noise_sigma=0.05)
    again = run(*args, noise_generator=torch.Generator().manual_seed(1), noise_sigma=0.05)
    assert torch.equal(zero.us, clean.us) and torch.equal(zero.qs, clean.qs)
    assert all(torch.isfinite(x).all() for x in noisy)
    assert float((noisy.xis - clean.xis).abs().max()) > 1e-3
    assert torch.equal(noisy.us, again.us)
    # the disturbance of step t is draw t of one (T, B, 6) array
    w = 0.05 * torch.randn((T, B, 6), generator=torch.Generator().manual_seed(1),
                           dtype=torch.float64)
    params = {"dyn": tdp, "cost": tcp}
    _, xi1 = tmodel.step(params, noisy.qs[:, 0], noisy.xis[:, 0], noisy.us[:, 0], 0)
    np.testing.assert_allclose(noisy.xis[:, 1].numpy(), (xi1 + w[0]).numpy(), rtol=0,
                               atol=1e-14)
