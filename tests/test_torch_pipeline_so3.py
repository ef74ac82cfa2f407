"""The port's SO(3)-family pipeline (`solvers/pipeline_so3.py`) against the
JAX package on the same numpy inputs: the solve against the JAX
`SO3PipelineSolver` (interpret mode) for both families in f32 and f64, the
lane stage math against the JAX models and cost, the batch-first SO(3)
models, the parameter conversion, and the plain f64 solve of the pendulum
swing-up against its committed golden.  Also: the problem builders and the
solvers ask for the card unless they are given the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SO3 as JSO3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline_so3 import (
    SO3PipelineSolver as JaxSO3PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as tdyn
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
)

from torch_port_cases import TORCH_DTYPE

FAMILIES = [("so3_track249", False), ("pendulum_swingup80", True)]
FAMILY_IDS = ["free_attitude", "pendulum"]


def _fields(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def _builder(pendulum):
    return (so3_bench.build_pendulum_swingup80 if pendulum
            else so3_bench.build_so3_track249)


def problem(name, H, dtype=jnp.float64):
    """(jax dyn, jax cost, port dyn, port cost) of the ``name`` problem cut
    to horizon H, in ``dtype``: the JAX params from the problem's constants
    and the port's f64 reference, the port's through `convert.py`."""
    pendulum, dt, _, _, r = so3_bench.PROBLEMS[name]
    _, cost64, _, _ = _builder(pendulum)(torch.float64, device="cpu", horizon=H)
    J = np.diag(so3_bench.INERTIA)
    dp = (jdyn.pendulum3d_params(J, 1.0, 0.5, dt) if pendulum
          else jdyn.so3_params(J, dt))
    Q = np.diag([10.0] * 3 + [1.0] * 3)
    cp = jcosts.tracking_cost_params(JSO3, Q, r * np.eye(3), 10.0 * Q,
                                     cost64.q_ref.numpy(), cost64.xi_ref.numpy())
    to = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)
    dp, cp = to(dp), to(cp)
    tdt = TORCH_DTYPE[dtype]
    return dp, cp, dyn_from_numpy(_fields(dp), dtype=tdt), cost_from_numpy(
        _fields(cp), dtype=tdt)


def initial_batch(B, H, seed, dtype):
    """Perturbed initial attitudes Exp(0.05 n) (f64 numpy, cast to
    ``dtype``), at rest, zero controls."""
    dq = 0.05 * np.random.default_rng(seed).standard_normal((B, 3))
    q0s = np.asarray(JSO3.normalize(JSO3.exp(jnp.asarray(dq))))
    np_dt = np.float32 if dtype == jnp.float32 else np.float64
    return (q0s.astype(np_dt), np.zeros((B, 3), np_dt),
            np.zeros((B, H, 3), np_dt))


# (problem, pendulum, dtype, term_quirk): both families in both dtypes with
# the quirk, and term_quirk=False once
SOLVE_CASES = [(n, p, dt, True) for n, p in FAMILIES for dt in (jnp.float32, jnp.float64)]
SOLVE_CASES.append(("pendulum_swingup80", True, jnp.float64, False))
SOLVE_IDS = [f"{'pendulum' if p else 'free_attitude'}-{'f32' if dt == jnp.float32 else 'f64'}"
             f"-{'quirk' if q else 'no_quirk'}" for _, p, dt, q in SOLVE_CASES]


@pytest.mark.parametrize("name,pendulum,dtype,term_quirk", SOLVE_CASES, ids=SOLVE_IDS)
def test_so3_pipeline_matches_jax_pipeline(name, pendulum, dtype, term_quirk):
    """H = 20, B = 3, 4 iterations: f32 at tests/test_pipeline_so3.py's
    tolerances (us atol 5e-4 / rtol 1e-4, J rtol 1e-4), f64 at us atol 1e-6,
    J rtol 1e-7 (the JAX closed-form angle coefficients cancel where the
    port's series do not, so f64 agrees to ~1e-8, not to roundoff)."""
    H, B, ITERS = 20, 3, 4
    dp, cp, tdp, tcp = problem(name, H, dtype)
    q0s, xi0s, us0 = initial_batch(B, H, 0, dtype)
    jout = JaxSO3PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt),
                                pendulum=pendulum, term_quirk=term_quirk,
                                interpret=True).solve(dp, cp, q0s, xi0s, us0)
    tout = S.SO3PipelineSolver(H, ITERS, float(dp.dt), pendulum=pendulum,
                               term_quirk=term_quirk).solve(
        tdp, tcp, torch.as_tensor(q0s), torch.as_tensor(xi0s), torch.as_tensor(us0))
    if dtype == jnp.float64:
        us_tol, J_tol = dict(atol=1e-6, rtol=0), dict(rtol=1e-7)
    else:
        us_tol, J_tol = dict(atol=5e-4, rtol=1e-4), dict(rtol=1e-4)
    np.testing.assert_allclose(tout.us.numpy(), np.asarray(jout.us), **us_tol)
    np.testing.assert_allclose(tout.J_opt.numpy(), np.asarray(jout.J_opt), **J_tol)
    np.testing.assert_allclose(tout.grad_norm.numpy(), np.asarray(jout.grad_norm),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tout.qs.numpy(), np.asarray(jout.qs), atol=1e-5)
    np.testing.assert_allclose(tout.xis.numpy(), np.asarray(jout.xis), atol=1e-4)
    for f in ("qs", "xis", "us", "J_opt", "grad_norm"):
        assert getattr(tout, f).shape == np.shape(getattr(jout, f)), f


def _states(B, seed):
    """Random states (f64 numpy): R (B, 3, 3), xi (B, 3), u (B, 3)."""
    rng = np.random.default_rng(seed)
    R = np.asarray(JSO3.exp(jnp.asarray(rng.uniform(-1.0, 1.0, (B, 3)))))
    return R, rng.normal(size=(B, 3)), rng.normal(size=(B, 3))


def _lane(x):
    """Batch-first (B, ...) numpy -> lane layout (..., B) tensor."""
    return torch.as_tensor(np.array(x)).movedim(0, -1)


def _lane_consts(tdp, pendulum):
    c = dict(J=tdp.J, Jinv=tdp.Jinv, mgr=torch.zeros(3, dtype=torch.float64),
             mr=torch.zeros(3, dtype=torch.float64))
    if pendulum:
        rho = tdp.l / 2.0 * torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64)
        c.update(mgr=tdp.m * tdp.g * rho, mr=tdp.m * rho)
    return c["J"], c["Jinv"], c["mgr"], c["mr"]


@pytest.mark.parametrize("name,pendulum", FAMILIES, ids=FAMILY_IDS)
def test_lane_jacobian_and_fu_match_jax_models(name, pendulum):
    """The lane Fx and fu2 (B10/B12's stage math) against JAX
    `dynamics._so3_jac` / `_pendulum3d_jac`, and the port's batch-first
    Jacobians against the same, f64 at 1e-12."""
    dp, _, tdp, _ = problem(name, 4)
    R, xi, u = _states(7, 1)
    jac = jdyn._pendulum3d_jac if pendulum else jdyn._so3_jac
    Fx, Fu = (np.asarray(a) for a in jac(dp, jnp.asarray(R), jnp.asarray(xi),
                                         jnp.asarray(u), 0))
    lFx, lfu2 = S.so3_stage_jacobian(_lane(R), _lane(xi), _lane(u),
                                     *_lane_consts(tdp, pendulum),
                                     dt=float(dp.dt), pendulum=pendulum)
    np.testing.assert_allclose(lFx.movedim(-1, 0).numpy(), Fx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lfu2.movedim(-1, 0).numpy(), Fu[:, 3:], rtol=0,
                               atol=1e-12)
    assert np.abs(Fu[:, :3]).max() == 0.0
    tjac = tdyn._pendulum3d_jac if pendulum else tdyn._so3_jac
    bFx, bFu = tjac(tdp, torch.as_tensor(R), torch.as_tensor(xi), torch.as_tensor(u))
    np.testing.assert_allclose(bFx.numpy(), Fx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(bFu.numpy(), Fu, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,pendulum", FAMILIES, ids=FAMILY_IDS)
def test_steps_match_jax_models(name, pendulum):
    """The port's batch-first steps and the lane dynamics evaluation against
    JAX `dynamics._so3_step` / `_pendulum3d_step`, f64."""
    dp, _, tdp, _ = problem(name, 4)
    R, xi, u = _states(7, 2)
    step = jdyn._pendulum3d_step if pendulum else jdyn._so3_step
    qn, xin = (np.asarray(a) for a in step(dp, jnp.asarray(R), jnp.asarray(xi),
                                           jnp.asarray(u), 0))
    tstep = tdyn._pendulum3d_step if pendulum else tdyn._so3_step
    tq, txi = tstep(tdp, torch.as_tensor(R), torch.as_tensor(xi), torch.as_tensor(u))
    np.testing.assert_allclose(tq.numpy(), qn, rtol=0, atol=1e-13)
    np.testing.assert_allclose(txi.numpy(), xin, rtol=0, atol=1e-13)
    fqR, fxi = S.so3_stage_dynamics_eval(_lane(R), _lane(xi), _lane(u),
                                         *_lane_consts(tdp, pendulum),
                                         dt=float(dp.dt), pendulum=pendulum)
    np.testing.assert_allclose(fqR.movedim(-1, 0).numpy(), qn, rtol=0, atol=1e-13)
    np.testing.assert_allclose(fxi.movedim(-1, 0).numpy(), xin, rtol=0, atol=1e-13)


@pytest.mark.parametrize("terminal", [False, True], ids=["stage", "terminal"])
def test_lane_cost_quad_matches_jax_tracking_cost(terminal):
    """The lane quadratization (B10-B12's) against the JAX
    `costs.tracking_cost(SO3, 3, ref_so3_terminal_quirk=True)` stage and
    terminal quadratizations (the quirk: value and gradient from Q, Hessian
    from P), f64 at 1e-12."""
    H = 6
    dp, cp, tdp, tcp = problem("so3_track249", H)
    cd = jcosts.tracking_cost(JSO3, 3, ref_so3_terminal_quirk=True)
    R, xi, u = _states(5, 3)
    i = H if terminal else 2
    if terminal:
        l, lx, lxx = cd.term_quad(cp, jnp.asarray(R), jnp.asarray(xi), i)
        W = (tcp.Q1, tcp.Q2, tcp.P1, tcp.P2)
    else:
        l, lx, _, lxx, _, _ = cd.stage_quad(cp, jnp.asarray(R), jnp.asarray(xi),
                                            jnp.zeros((5, 3)), i)
        W = (tcp.Q1, tcp.Q2, tcp.Q1, tcp.Q2)
    tlx, tlxx, tl = S.so3_stage_cost_quad(
        _lane(R), _lane(xi), tcp.q_ref_inv[i][..., None], tcp.xi_ref[i][..., None], *W)
    np.testing.assert_allclose(tlx.movedim(-1, 0).numpy(), np.asarray(lx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tlxx.movedim(-1, 0).numpy(), np.asarray(lxx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l), rtol=1e-12)


@pytest.mark.parametrize("name,pendulum", FAMILIES, ids=FAMILY_IDS)
def test_convert_round_trips_and_builders_match_jax(name, pendulum):
    """`convert.py` carries the JAX SO(3)-family params across field by
    field (`SO3Params` / `Pendulum3dParams`), and the port's builder makes
    the same problem as JAX `costs.tracking_cost_params(SO3, ...)` on its
    constants (`TrackingCostParams` with ``group=SO3``)."""
    H = 12
    dp, cp, tdp, tcp = problem(name, H)
    assert type(tdp) is (tdyn.Pendulum3dParams if pendulum else tdyn.SO3Params)
    for k, v in _fields(dp).items():
        np.testing.assert_array_equal(getattr(tdp, k).numpy(), v, err_msg=k)
    bdyn, bcost, q0, xi0 = _builder(pendulum)(torch.float64, device="cpu", horizon=H)
    for k, v in _fields(dp).items():
        np.testing.assert_allclose(getattr(bdyn, k).numpy(), v, rtol=1e-14, err_msg=k)
    for k, v in _fields(cp).items():
        np.testing.assert_allclose(getattr(bcost, k).numpy(), v, rtol=0, atol=1e-15,
                                   err_msg=k)
    np.testing.assert_array_equal(q0.numpy(), np.eye(3))
    np.testing.assert_array_equal(xi0.numpy(), np.zeros(3))
    assert tcp.q_ref.shape == (H + 1, 3, 3) and tcp.xi_ref.shape == (H + 1, 3)


def test_so3_batch_keeps_lane_zero_and_is_seeded():
    _, _, q0, xi0 = so3_bench.build_so3_track249(torch.float64, device="cpu", horizon=2)
    q0s, xi0s = so3_bench.so3_batch(q0, xi0, 5, seed=7)
    assert torch.equal(q0s[0], q0) and torch.equal(xi0s, xi0[None].expand(5, 3))
    assert torch.equal(q0s, so3_bench.so3_batch(q0, xi0, 5, seed=7)[0])
    dev = torch.linalg.norm(SO3.log(q0s[1:]), dim=-1)
    assert (dev > 1e-3).all() and (dev < 0.3).all()
    orth = q0s @ q0s.transpose(-1, -2) - torch.eye(3, dtype=torch.float64)
    assert orth.abs().max() < 1e-14


def test_pendulum_swingup80_f64_plain_solve_reaches_the_golden():
    """Lane 0 of the plain f64 solve (the golden's iteration count of the
    JAX f64 engine) against the committed golden: controls to 1e-6, J to
    1e-9."""
    us_gold, meta = so3_bench.load_so3_golden("pendulum_swingup80")
    dyn, cost, q0, xi0 = so3_bench.build_pendulum_swingup80(torch.float64, device="cpu")
    out = S.SO3PipelineSolver(80, meta["iterations_f64"], float(dyn.dt),
                              pendulum=True).solve(
        dyn, cost, q0[None], xi0[None], torch.zeros((1, 80, 3), dtype=torch.float64))
    assert np.abs(out.us[0].numpy() - us_gold).max() <= 1e-6
    assert abs(out.J_opt[0].item() - meta["J_f64"]) <= 1e-9 * meta["J_f64"]
    assert out.grad_norm[0].item() < meta["grad_tol"]


@pytest.mark.parametrize("build", [build_screw200, so3_bench.build_so3_track249,
                                   so3_bench.build_pendulum_swingup80],
                         ids=["screw200", "so3_track249", "pendulum_swingup80"])
def test_builders_and_solvers_ask_for_the_card(build):
    """Without a device argument a builder puts its problem on the card, and
    a solve given numpy inputs runs on the card: here, with no CUDA device,
    both fail with torch's CUDA error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    with pytest.raises(AssertionError, match="CUDA"):
        build(torch.float32)
    dyn, cost, q0, xi0 = build(torch.float32, device="cpu", horizon=4)
    nq = q0.shape[-1]
    inputs = (np.broadcast_to(q0.numpy(), (2, nq, nq)), np.zeros((2, xi0.shape[0]), np.float32),
              np.zeros((2, 4, 3 if nq == 3 else 6), np.float32))
    solver = (S.SO3PipelineSolver(4, 1, float(dyn.dt), pendulum=hasattr(dyn, "l"))
              if nq == 3 else PipelineSolver(4, 1, float(dyn.dt)))
    with pytest.raises(AssertionError, match="CUDA"):
        solver.solve(dyn, cost, *inputs)
