"""Problems shared by the test_torch_*.py files: the same inputs, made from a
seed with numpy, for the JAX package and its PyTorch port.

The problem is the screw-tracking problem of `tasks/al_bench.build_al1400`
cut to a short horizon, with R = 1e-3 I (the pipeline's Cholesky needs
Quu > 0) and no input box; the drone variant swaps in `drone_params`
(gravity, a 6x4 input projection) with R = 1e-2 I on its 4 inputs.  The
constrained tests take the problem as it is (`al_problem`: R = 0, the box
given by each test) from each package's own builder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _to(tree, dtype):
    return jax.tree.map(
        lambda x: jnp.asarray(x, dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        tree)


def problem(H, dtype=jnp.float64, drone=False):
    """(jax dyn, jax cost, torch dyn, torch cost, q0 (4, 4), xi0 (6,), nu)
    in ``dtype``; the torch containers come through `convert.py`."""
    params, _, _, q0, xi0, _, _ = build_al1400(jnp.float64, H)
    dp, cp = params["dyn"], params["cost"]
    nu = 6
    if drone:
        dp = dynamics.drone_params(dp.J, dp.dt)
        nu = 4
    cp = cp._replace(R=(1e-2 if drone else 1e-3) * jnp.eye(nu, dtype=jnp.float64))
    dp, cp = _to(dp, dtype), _to(cp, dtype)
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    tdt = TORCH_DTYPE[dtype]
    return (dp, cp, dyn_from_numpy(fields(dp), dtype=tdt),
            cost_from_numpy(fields(cp), dtype=tdt), np.asarray(q0),
            np.asarray(xi0), nu)


def initial_batch(q0, xi0, B, H, nu, seed, dtype, u_scale=0.0):
    """Perturbed initial poses q0 Exp(0.05 n) (f64 numpy, cast to ``dtype``),
    xi0 for all, controls u_scale * N(0, 1)."""
    rng = np.random.default_rng(seed)
    dq = 0.05 * rng.standard_normal((B, 6))
    q0s = np.asarray(SE3.normalize(jnp.asarray(q0)[None] @ SE3.exp(jnp.asarray(dq))))
    xi0s = np.broadcast_to(xi0, (B, 6)).copy()
    us0 = u_scale * rng.standard_normal((B, H, nu))
    np_dt = np.float32 if dtype == jnp.float32 else np.float64
    return q0s.astype(np_dt), xi0s.astype(np_dt), us0.astype(np_dt)


def solve_both(H, B, ITERS, dtype, fused=True, drone=False, al=False, seed=0):
    """(jax PipelineState, port PipelineState) of the JAX
    `PallasPipelineSolver` (interpret mode) and the port's `PipelineSolver`
    on the same inputs: horizon H, B lanes, ITERS iterations."""
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, dtype, drone=drone)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed, dtype)
    al_arg = None
    if al:
        rng = np.random.default_rng(0)
        np_dt = np.asarray(us0).dtype
        lmbd = np.abs(rng.normal(size=(B, H + 1, 2 * nu))).astype(np_dt)
        imu = np.full((B, H + 1, 2 * nu), 0.5, np_dt)
        al_arg = (np.full(nu, -5.0), np.full(nu, 5.0), lmbd, imu)
    jout = PallasPipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt),
                                interpret=True, gravity=drone, fused=fused
                                ).solve(dp, cp, q0s, xi0s, us0,
                                        al=None if al_arg is None else
                                        tuple(jnp.asarray(a) for a in al_arg))
    tout = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt), gravity=drone,
                          fused=fused).solve(tdp, tcp, torch.as_tensor(q0s),
                                             torch.as_tensor(xi0s),
                                             torch.as_tensor(us0), al=al_arg)
    return jout, tout


def check_solves(jout, tout, dtype):
    """f64: us atol 1e-6, J rtol 1e-7; f32: tests/test_pipeline.py's
    atol 5e-4 / rtol 1e-4 on us and rtol 1e-4 on J."""
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


@pytest.fixture(scope="module")
def one_cpu_thread():
    """The plain versions run thousands of tiny tensor ops; on a shared
    host, intra-op threads make a small batched matmul ~1000x slower than
    one thread does.  Modules that import this fixture run on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def al_problem(H, dtype=jnp.float64, seed=0, B=2, lanes=None):
    """The reference's AL problem (`build_al1400`: R = 0, box +-10) cut to H
    stages, from each package's own builder: (jax params, port params,
    q0s, xi0s, us0) with the batch `al_bench.screw_batch` draws from
    ``seed`` (lane 0 unperturbed), optionally the given ``lanes`` of it,
    as numpy arrays in ``dtype``."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import (
        al_bench as tal,
    )

    jp = build_al1400(dtype, H)[0]
    tdt = TORCH_DTYPE[dtype]
    tp, _, _, q0, xi0, _, _ = tal.build_al1400(tdt, H, device="cpu")
    n = B if lanes is None else max(lanes) + 1
    q0s, xi0s = tal.screw_batch(q0, xi0, n, seed)
    if lanes is not None:
        q0s, xi0s = q0s[list(lanes)], xi0s[list(lanes)]
    us0 = np.zeros((q0s.shape[0], H, 6), np.asarray(q0s.numpy()).dtype)
    return jp, tp, q0s.numpy(), xi0s.numpy(), us0


def al_fast_pair(jp, tp, H, box, iterations, tol=1e-2, **port_kw):
    """The JAX `ALFastSolver` (its XLA path, ``use_pallas=False``) and the
    port's (B13 and B14's plain versions on CPU tensors), each around an
    inner `FastBatchSolver` on the AL-wrapped tracking cost with the box
    +-``box``; returns (jax solver, jax params, port solver, port params)."""
    from trajectory_optimization_matrix_lie_groups_tpu.models import constraints as jcs
    from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
    from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
    from trajectory_optimization_matrix_lie_groups_tpu.solvers.al_fast import (
        ALFastSolver as JALFast,
    )
    from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
        FastBatchSolver as JFast,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3 as TSE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import ALFastSolver
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
        FastBatchSolver,
    )

    dt = jp["cost"].Q1.dtype
    jcon = jcs.input_box(12, 6)
    jmodel, _ = jmm(dynamics.se3_dynamics(), jc.al_cost(jc.tracking_cost(SE3, 6), jcon),
                    jp["dyn"], None)
    jbox = jax.tree.map(lambda x: jnp.asarray(x, dt), jcs.input_box_params(-box, box, 6))
    jalp = jc.al_init_params(jp["cost"], jbox, H, 12, mu0=1e-2, dtype=dt)
    jsolver = JALFast(JFast(jmodel, N=H, iterations=iterations, use_pallas=False), jcon,
                      tol_constr=tol)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    tcon = cs.input_box(12, 6)
    tmodel, _ = make_model(td.se3_dynamics(), tc.al_cost(tc.tracking_cost(TSE3, 6), tcon),
                           tp["dyn"], None)
    talp = tc.al_init_params(tp["cost"], cs.input_box_params(
        torch.tensor(-box, dtype=tdt), torch.tensor(box, dtype=tdt), 6), H, 12, mu0=1e-2,
        dtype=tdt)
    kw = dict(use_pallas=True, pallas_rollout_dt=0.01)
    kw.update(port_kw)
    tsolver = ALFastSolver(FastBatchSolver(tmodel, H, iterations, **kw), tcon,
                           tol_constr=tol)
    return (jsolver, {"dyn": jp["dyn"], "cost": jalp}, tsolver,
            {"dyn": tp["dyn"], "cost": talp})


def mpc_setup(dtype, steps, H, lanes, offset=False):
    """Both packages' screw-tracking problems (R = 1e-3 I) over ``steps`` +
    H + 1 reference entries, their SE(3) tracking models, and a batch
    q0 Exp(0.05 n) (lane 0 unperturbed) from the reference's start, or with
    ``offset`` from the AL problem's offset start.  Returns (jax dyn, jax
    cost, jax model, port dyn, port cost, port model, q0s, xi0s) with the
    batch as numpy arrays in ``dtype``."""
    from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
    from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3 as TSE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench as tal

    dp, cp, tdp, tcp, q0, xi0, nu = problem(steps + H, dtype)
    jmodel, _ = jmm(dynamics.se3_dynamics(), jc.tracking_cost(SE3, 6), dp, cp)
    tmodel, _ = make_model(td.se3_dynamics(), tc.tracking_cost(TSE3, 6), tdp, tcp)
    start = (torch.as_tensor(np.array(q0)), torch.as_tensor(np.array(xi0))) if offset else (
        tcp.q_ref[0].double(), tcp.xi_ref[0].double())
    q0s, xi0s = tal.screw_batch(*start, lanes, seed=4)
    np_dt = np.float64 if dtype == jnp.float64 else np.float32
    return (dp, cp, jmodel, tdp, tcp, tmodel, q0s.numpy().astype(np_dt),
            xi0s.numpy().astype(np_dt))


def window_by_hand(cp, t, H):
    """The reference window of plant step t, sliced by hand."""
    import dataclasses

    cut = lambda a: a[t:t + H + 1]
    return dataclasses.replace(cp, q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                               Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))


# -- the reference-exact tier (`LieILQR`): both packages' models ----------------

def lie_se3_case(H):
    """Both packages' SE(3) tracking (model, params) of `problem` (H
    stages, f64) and a batch of three perturbed starts: (jax model, jax
    params, port model, port params, q0s, xi0s, us0)."""
    from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
    from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3 as TSE3

    dp, cp, tdp, tcp, q0, xi0, nu = problem(H)
    jm, jp = jmm(dynamics.se3_dynamics(), jc.tracking_cost(SE3, 6), dp, cp)
    tm, tp = make_model(td.se3_dynamics(), tc.tracking_cost(TSE3, 6), tdp, tcp)
    q0s, xi0s, us0 = initial_batch(q0, xi0, 3, H, nu, seed=0, dtype=jnp.float64)
    return jm, jp, tm, tp, q0s, xi0s, us0


def so3_case(name, horizon):
    """Both packages' (model, params) of an SO(3) problem of
    `tasks/so3_bench.py` cut to ``horizon``, from the port's f64 build, and
    its start (q0, xi0)."""
    from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
    from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmm
    from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SO3 as JSO3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs as tc
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as td
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench

    jd = dynamics
    pendulum, dt = so3_bench.PROBLEMS[name][:2]
    build = (so3_bench.build_pendulum_swingup80 if pendulum
             else so3_bench.build_so3_track249)
    tdyn, tcost, q0, xi0 = build(torch.float64, "cpu", horizon)
    J = jnp.asarray(tdyn.J.numpy())
    dp = jd.pendulum3d_params(J, 1.0, 0.5, dt) if pendulum else jd.so3_params(J, dt)
    cp = jc.tracking_cost_params(JSO3, *(jnp.asarray(x.numpy()) for x in (
        torch.block_diag(tcost.Q1, tcost.Q2), tcost.R, torch.block_diag(tcost.P1, tcost.P2),
        tcost.q_ref, tcost.xi_ref)))
    dyn = jd.pendulum3d_dynamics() if pendulum else jd.so3_dynamics()
    jm, jp = jmm(dyn, jc.tracking_cost(JSO3, 3, ref_so3_terminal_quirk=True), dp, cp)
    tdyn_def = td.pendulum3d_dynamics() if pendulum else td.so3_dynamics()
    tm, tp = make_model(tdyn_def, tc.tracking_cost(SO3, 3, ref_so3_terminal_quirk=True),
                        tdyn, tcost)
    return jm, jp, tm, tp, q0.numpy(), xi0.numpy()


def fit_both(jm, jp, tm, tp, q0, xi0, us0, cfg):
    """(JAX fit, port fit) of one problem under the same config."""
    from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )

    jout = JL.LieILQR(jm, JL.SolverConfig(**cfg)).fit(
        jp, (jnp.asarray(q0), jnp.asarray(xi0)), jnp.asarray(us0))
    tout = LieILQR(tm, SolverConfig(**cfg)).fit(
        tp, (torch.as_tensor(q0)[None], torch.as_tensor(xi0)[None]),
        torch.as_tensor(us0)[None])
    return jout, tout


def check_fits(jout, tout, rtol, grad_atol, us_atol):
    """The same iteration count and flags; J, grad-norm and defect
    histories at ``rtol`` (the last two also at ``grad_atol``); the
    controls and the poses at ``us_atol``; mu at 1e-12."""
    assert len(tout[2]) == len(jout[2])
    for j_h, t_h, atol in ((jout[2], tout[2], 0.0), (jout[3], tout[3], grad_atol),
                           (jout[4], tout[4], grad_atol)):
        np.testing.assert_allclose(np.asarray(t_h)[:, 0], np.asarray(j_h), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tout[1][0].numpy(), np.asarray(jout[1]), rtol=0, atol=us_atol)
    np.testing.assert_allclose(tout[0][0][0].numpy(), np.asarray(jout[0][0]), rtol=0,
                               atol=us_atol)
    js, ts = jout[5], tout[5]
    for f in ("converged", "failed", "accepted"):
        assert bool(getattr(ts, f)[0]) == bool(getattr(js, f)), f
    np.testing.assert_allclose(ts.mu[0].item(), float(js.mu), rtol=1e-12)
