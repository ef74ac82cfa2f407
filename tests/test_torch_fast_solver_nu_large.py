"""The port's generic fast tier past input dimension 12 against the JAX
package, on screw200_rcs16 (`tasks/al_bench.screw200_nu_model` with
`rcs16_pu`: the rigid body driven by 16 thrusters, g = 0, the exact gravity
Jacobian, R = 1e-2 I16), f64, on the same numpy inputs (the port's
parameters through `convert.py`):

- `FastBatchSolver` (B13's plain version: on the card its large-nu
  instance) against the JAX `FastBatchSolver` on its XLA path, H = 20,
  B = 2, 3 iterations, at `tests/test_torch_fast_solver.py`'s f64
  tolerances;
- `ALFastSolver` with the input box +-3 (it binds), H = 10, B = 2, against
  the JAX `ALFastSolver`, at `tests/test_torch_al_fast.py`'s tolerances;
- the committed golden (`tasks/golden/screw200_rcs16_us.npy`, the JAX f64
  fast tier's optimum) is a fixed point of one plain f64 iteration of the
  port's `FastBatchSolver` at full width (N = 200), and the goldens of
  rcs16 and rcs24 record the JAX fast tier's own f32 error, which
  `chip_smoke.py` gates the card's fast solve at 10 x.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import constraints as jcs
from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.al_fast import (
    ALFastSolver as JaxALFastSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver as JaxFastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as tcs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tcosts
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as tdyn
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

from torch_port_cases import initial_batch, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

NU, B = 16, 2
T = lambda x: torch.as_tensor(np.array(x))


def _rcs16(H, al_box=None):
    """(jax model, jax params, port model, port params, q0, xi0) of
    screw200_rcs16 cut to H stages, the port's parameters converted from
    the JAX ones; with ``al_box`` the tracking cost wrapped in the AL cost
    of the input box +-al_box (multipliers 0, mu0 = 1e-2), and the box
    constraints returned after them."""
    params, _, _, q0, xi0, _, _ = build_al1400(jnp.float64, H)
    dp = jdyn.rigid_body_params(params["dyn"].J, params["dyn"].dt, g=0.0,
                                Pu=jnp.asarray(al_bench.rcs16_pu()),
                                exact_gravity_jacobian=True)
    cp = params["cost"]._replace(R=1e-2 * jnp.eye(NU, dtype=jnp.float64))
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    tdp, tcp = dyn_from_numpy(fields(dp)), cost_from_numpy(fields(cp))
    jdef, tdef = (jdyn.rigid_body_dynamics()._replace(nu=NU),
                  tdyn.rigid_body_dynamics()._replace(nu=NU))
    if al_box is None:
        jm, jp = jmake(jdef, jcosts.tracking_cost(JSE3, NU), dp, cp)
        tm, tp = make_model(tdef, tcosts.tracking_cost(SE3, NU), tdp, tcp)
        return jm, jp, tm, tp, np.asarray(q0), np.asarray(xi0)
    jcon, tcon = jcs.input_box(12, NU), tcs.input_box(12, NU)
    jm, _ = jmake(jdef, jcosts.al_cost(jcosts.tracking_cost(JSE3, NU), jcon), dp, None)
    tm, _ = make_model(tdef, tcosts.al_cost(tcosts.tracking_cost(SE3, NU), tcon), tdp, None)
    jal = jcosts.al_init_params(cp, jcs.input_box_params(-al_box, al_box, NU), H, 2 * NU,
                                mu0=1e-2, dtype=jnp.float64)
    box = lambda v: torch.tensor(v, dtype=torch.float64)
    tal = tcosts.al_init_params(tcp, tcs.input_box_params(box(-al_box), box(al_box), NU), H,
                                2 * NU, mu0=1e-2, dtype=torch.float64)
    return (jm, {"dyn": dp, "cost": jal}, tm, {"dyn": tdp, "cost": tal}, np.asarray(q0),
            np.asarray(xi0), jcon, tcon)


def test_screw200_nu_model_is_the_jax_problem():
    """`al_bench.screw200_nu_model` (the port's own builder, which
    `chip_smoke.py` solves) equals the JAX problem converted: every
    dynamics and cost field to 1e-15, the model at nu = 16."""
    *_, tp, q0, xi0 = _rcs16(20)
    model, params, tq0, txi0 = al_bench.screw200_nu_model(al_bench.rcs16_pu(), torch.float64,
                                                          "cpu", horizon=20)
    assert model.nu == NU
    for got, want in ((params["dyn"], tp["dyn"]), (params["cost"], tp["cost"])):
        for name in (fd.name for fd in dataclasses.fields(want)):
            a, b = getattr(got, name), getattr(want, name)
            if isinstance(b, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-15, msg=name)
            else:
                assert a == b, name
    np.testing.assert_allclose(tq0.numpy(), q0, rtol=0, atol=1e-15)
    np.testing.assert_allclose(txi0.numpy(), xi0, rtol=0, atol=1e-15)


@pytest.fixture(scope="module")
def fast_solved():
    """The JAX f64 solve (XLA path) and the port's, H = 20, B = 2, 3
    iterations, from perturbed initial poses and zero controls."""
    H, iters = 20, 3
    jm, jp, tm, tp, q0, xi0 = _rcs16(H)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, NU, 0, jnp.float64)
    cp, tcp = jp["cost"], tp["cost"]
    jout = JaxFastBatchSolver(jm, N=H, iterations=iters, use_pallas=False).solve(
        jp, q0s, xi0s, us0, cp.q_ref, cp.xi_ref)
    tout = FastBatchSolver(tm, H, iters).solve(tp, T(q0s), T(xi0s), T(us0), tcp.q_ref,
                                               tcp.xi_ref)
    return jout, tout


def test_fast_solver_rcs16_f64_matches_jax_xla(fast_solved):
    """The port's `FastBatchSolver` (B13's plain version) against the JAX
    one on its XLA path: us at 1e-8, J at rtol 1e-10, the gradient norm at
    rtol 1e-6, the poses at 1e-9."""
    jout, tout = fast_solved
    assert tout.us.shape == (B, 20, NU)
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), rtol=1e-10)
    np.testing.assert_allclose(tout.grad_norm.numpy(), np.asarray(jout.grad_norm),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tout.qs.numpy(), np.asarray(jout.qs), rtol=0, atol=1e-9)


def test_fast_solver_rcs16_loop_backward_matches_b13_plain(fast_solved):
    """The port's loop backward (``use_pallas=False``) solves to the same
    iterate as B13's plain version (us at 1e-10)."""
    _, tout = fast_solved
    H, iters = 20, 3
    *_, tm, tp, q0, xi0 = _rcs16(H)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, NU, 0, jnp.float64)
    loop = FastBatchSolver(tm, H, iters, use_pallas=False).solve(
        tp, T(q0s), T(xi0s), T(us0), tp["cost"].q_ref, tp["cost"].xi_ref)
    torch.testing.assert_close(loop.us, tout.us, rtol=0, atol=1e-10)


H_AL, ITERS_AL, NAL, BOX = 10, 4, 10, 3.0


@pytest.fixture(scope="module")
def al_solved():
    """The JAX `ALFastSolver` (inner `FastBatchSolver` on its XLA path) and
    the port's (B13's plain version) on the box +-3, H = 10, B = 2."""
    jm, jp, tm, tp, q0, xi0, jcon, tcon = _rcs16(H_AL, al_box=BOX)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H_AL, NU, 0, jnp.float64)
    js = JaxALFastSolver(JaxFastBatchSolver(jm, N=H_AL, iterations=ITERS_AL, use_pallas=False),
                         jcon, tol_constr=1e-2)
    ts = ALFastSolver(FastBatchSolver(tm, H_AL, ITERS_AL), tcon, tol_constr=1e-2)
    jres = js.solve(jp, q0s, xi0s, us0, n_al_iters=NAL)
    tres = ts.solve(tp, T(q0s), T(xi0s), T(us0), n_al_iters=NAL)
    return jres, tres


def test_al_fast_box_rcs16_matches_jax(al_solved):
    """`ALFastSolver` at nu = 16 with a binding input box against the JAX
    one: us, J, the constraint values and the trajectory at 1e-8, the
    multipliers and penalties at 1e-8, the same outer iterations."""
    jres, tres = al_solved
    assert tres.constr_converged and tres.outer_iterations > 1
    assert (tres.us.abs() >= BOX - 1e-3).sum() >= 4, "the box does not bind"
    for f in ("us", "J_opt", "constr_eval", "max_violation", "qs", "xis"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    for f in ("lmbd", "Imu", "mu"):
        np.testing.assert_allclose(getattr(tres.al_params, f).numpy(),
                                   np.asarray(getattr(jres.al_params, f)), err_msg=f,
                                   rtol=1e-8, atol=1e-8)
    assert tres.outer_iterations == jres.outer_iterations


def test_rcs16_golden_is_a_fixed_point_of_the_plain_fast_iteration():
    """From the rcs16 golden's controls and the trajectory they roll out to
    from x0 (the port's model), one plain f64 iteration of the port's
    `FastBatchSolver` (B13's plain version at nu = 16) moves the controls
    by less than 1e-9, and its gradient norm is at most the golden's (the
    JAX f64 fast tier's final one)."""
    us_gold, meta = al_bench.load_nu_golden("screw200_rcs16")
    N = us_gold.shape[0]
    model, params, q0, xi0 = al_bench.screw200_nu_model(al_bench.rcs16_pu(), torch.float64,
                                                        "cpu", horizon=N)
    us = torch.as_tensor(us_gold)[None]
    qs, xis = [q0[None]], [xi0[None]]
    for t in range(N):
        q, xi = model.step(params, qs[-1], xis[-1], us[:, t], t)
        qs.append(q)
        xis.append(xi)
    qs, xis = torch.stack(qs, dim=1), torch.stack(xis, dim=1)
    _, _, us_new, _, grad = FastBatchSolver(model, N, 1)._iteration(params, qs, xis, us)
    assert (us_new - us).abs().max().item() < 1e-9
    assert grad.item() <= meta["grad_norm_f64"]


@pytest.mark.parametrize("name", ["screw200_rcs16", "screw200_rcs24"])
def test_goldens_record_the_jax_fast_tier_f32_error(name):
    """The rcs16 and rcs24 metas hold the JAX f32 `FastBatchSolver`'s lane-0
    error against the golden at the card solve's 12 iterations (the f32
    fast solve's gate on the card is 10 x it), each of its tried counts
    within the f32 floor of 1e-4."""
    _, meta = al_bench.load_nu_golden(name)
    fast = meta["jax_f32_fast"]
    assert fast["iterations"] == 12 and fast["solver"].startswith("FastBatchSolver")
    assert fast["lane0_us_max_abs_err"] == fast["tried"]["12"]
    assert all(0.0 < e < 1e-4 for e in fast["tried"].values())
