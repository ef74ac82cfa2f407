"""The port's constrained batched MPC
(`solvers/mpc.make_closed_loop_batch_constrained`, box +-5, f32) from the
AL problem's offset start, where the box binds: against the JAX package's
(Pallas in interpret mode) and a host loop at H = 10, T = 4, B = 2, 3 AL
outers a step, atol 1e-4, the applied controls saturated at the box
(tests/test_al_pipeline.py:92-160's); and, in f64 at H = 6 with one AL
outer a step (which leaves lanes above tolerance), with the
`ALFastSolver` rescue against a host loop of the same rescue at 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import mpc as jmpc
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)

from torch_port_cases import mpc_setup, one_cpu_thread, window_by_hand  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CH, CT, CB, ITERS, NAL, BOX = 10, 4, 2, 3, 3, 5.0
RH = 6


def _constrained_host_loop(pipe, tdp, tcp, tmodel, q0s, xi0s, steps, nal, rescue=None):
    """The constrained driver's per-step semantics by hand: a fixed number
    of AL outers from a fresh multiplier state, the rescue's in-graph AL
    loop where a lane is left above tolerance, the first control clipped."""
    qs, xis = torch.as_tensor(q0s), torch.as_tensor(xi0s)
    dt = qs.dtype
    lb, ub = torch.full((6,), -BOX, dtype=dt), torch.full((6,), BOX, dtype=dt)
    h = pipe.N
    us_warm = torch.zeros((qs.shape[0], h, 6), dtype=dt)
    us_applied = []
    for t in range(steps):
        cp_t = window_by_hand(tcp, t, h)
        lmbd = torch.zeros((qs.shape[0], h + 1, 12), dtype=dt)
        imu = torch.full_like(lmbd, 1e-2)
        mu = torch.full((qs.shape[0],), 1e-2, dtype=dt)
        for _ in range(nal):
            out = pipe.solve(tdp, cp_t, qs, xis, us_warm, al=(lb, ub, lmbd, imu))
            g = torch.cat([torch.cat([lb - out.us, out.us - ub], dim=-1),
                           torch.zeros_like(lmbd[:, :1])], dim=1)
            frz = torch.amax(g, dim=(1, 2)) < 1e-2
            lmbd, imu, mu = costs.al_update_diag(lmbd, imu, mu, g, freeze=frz)
        if rescue is not None:
            bad = torch.amax(torch.maximum(lb - out.us, out.us - ub), dim=(1, 2)) >= 1e-2
            alp = rescue._broadcast_al(costs.al_init_params(
                cp_t, cs.input_box_params(lb, ub, 6), h, 12, dtype=dt), qs.shape[0])
            us_r = rescue._outer_loop_graph(rescue._ls_solver(), tdp, alp, qs, xis, us_warm,
                                            cp_t.q_ref, cp_t.xi_ref, 8)[3]
            out = out._replace(us=torch.where(bad[:, None, None], us_r, out.us))
        u0 = torch.clamp(out.us[:, 0], -BOX, BOX)
        us_applied.append(u0)
        qs, xis = tmodel.step({"dyn": tdp, "cost": tcp}, qs, xis, u0, 0)
        us_warm = torch.cat([out.us[:, 1:], out.us[:, -1:]], dim=1)
    return torch.stack(us_applied, dim=1), qs


def test_constrained_mpc_matches_jax_and_host_loop():
    dp, cp, jmodel, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(jnp.float32, CT, CH, CB, offset=True)
    jres, jmaxv = jmpc.make_closed_loop_batch_constrained(
        PallasPipelineSolver(N=CH, iterations=ITERS, dt=0.01, interpret=True), jmodel, CT,
        -BOX, BOX, n_al_iters=NAL)(dp, cp, q0s, xi0s)
    pipe = PipelineSolver(CH, ITERS, 0.01)
    res, maxv = mpc.make_closed_loop_batch_constrained(pipe, tmodel, CT, -BOX, BOX,
                                                       n_al_iters=NAL)(
        tdp, tcp, torch.as_tensor(q0s), torch.as_tensor(xi0s))
    # the box binds: the applied controls saturate
    assert float(res.us.abs().max()) == BOX
    assert float(res.us.max()) <= BOX and float(res.us.min()) >= -BOX
    assert all(torch.isfinite(x).all() for x in res)
    np.testing.assert_allclose(res.us.numpy(), np.asarray(jres.us), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.qs.numpy(), np.asarray(jres.qs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(maxv.numpy(), np.asarray(jmaxv), rtol=0, atol=1e-4)
    assert maxv.shape == (CB, CT)
    us_h, qs_h = _constrained_host_loop(pipe, tdp, tcp, tmodel, q0s, xi0s, CT, NAL)
    np.testing.assert_allclose(res.us.numpy(), us_h.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.qs[:, -1].numpy(), qs_h.numpy(), rtol=0, atol=1e-4)


def test_constrained_mpc_with_rescue_matches_host_loop():
    """One AL outer a step leaves lanes above tolerance; the rescue
    re-solves them, as a host loop of the same rescue does."""
    *_, tdp, tcp, tmodel, q0s, xi0s = mpc_setup(jnp.float64, 1, RH, CB, offset=True)
    pipe = PipelineSolver(RH, ITERS, 0.01)
    constr = cs.input_box(12, 6)
    model_c, _ = make_model(dynamics.se3_dynamics(),
                            costs.al_cost(costs.tracking_cost(SE3, 6), constr), tdp, None)
    rescue = ALFastSolver(FastBatchSolver(model_c, RH, 4), constr)
    kw = dict(n_al_iters=1)
    args = (tdp, tcp, torch.as_tensor(q0s), torch.as_tensor(xi0s))
    _, maxv0 = mpc.make_closed_loop_batch_constrained(pipe, tmodel, 1, -BOX, BOX, **kw)(*args)
    assert float(maxv0.max()) > 1e-2, "no lane needs the rescue"
    res, maxv = mpc.make_closed_loop_batch_constrained(
        pipe, tmodel, 1, -BOX, BOX, rescue=rescue, rescue_outers=8, **kw)(*args)
    assert float(maxv.max()) < float(maxv0.max())
    us_h, qs_h = _constrained_host_loop(pipe, tdp, tcp, tmodel, q0s, xi0s, 1, 1, rescue)
    np.testing.assert_allclose(res.us.numpy(), us_h.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.qs[:, -1].numpy(), qs_h.numpy(), rtol=0, atol=1e-10)
