"""The port's constrained path against the JAX package on the same numpy
inputs: the input box and the augmented-Lagrangian cost (f64, 1e-12), the
diagonal and dense multiplier updates with per-problem freeze (1e-12), and
`ALPipelineSolver` against the JAX one (Pallas in interpret mode) on the
reference's AL problem (`build_al1400`, R = 0) cut to H = 16 with the box
at +-9, where it binds.

Solver tolerances: f64 us atol 1e-6 and J rtol 1e-7
(tests/test_torch_pipeline.py's); f32 us rtol 2e-5 / atol 2e-4 and
violations atol 2e-4 (tests/test_al_pipeline.py's, between two f32
engines).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import constraints as jcs
from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jc
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.al_pipeline import (
    ALPipelineSolver as JALPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    al_params_from_numpy,
    cost_from_numpy,
    input_box_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
    ALPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)

from torch_port_cases import al_problem, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TIGHT = dict(rtol=1e-12, atol=1e-12)
H, B, ITERS, NAL, BOX = 16, 2, 4, 10, 9.0


def _close(t, j, **tol):
    np.testing.assert_allclose(torch.as_tensor(t).numpy(), np.asarray(j), **(tol or TIGHT))


def _fields(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()}


# -- the golden of the full problem -----------------------------------------------------

@pytest.mark.parametrize("name", ["al1400_us.npy", "al1400_meta.json"])
def test_al1400_golden_is_the_jax_packages(name):
    """The port's copy of the f64 golden is byte for byte the JAX package's."""
    import os

    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_file = os.path.join(root, "trajectory_optimization_matrix_lie_groups_tpu", "tasks",
                            "golden", name)
    with open(os.path.join(al_bench.GOLDEN_DIR, name), "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    us, meta = al_bench.load_al1400_golden()
    assert us.shape == (1400, 6) and us.dtype == np.float64
    assert meta["H"] == 1400 and meta["outer_iterations"] == 11
    assert int((us >= 10.0 - 1e-6).sum()) == meta["n_active"] == 31


# -- the input box and the AL cost ---------------------------------------------------

def test_input_box_matches_jax():
    rng = np.random.default_rng(0)
    lb, ub = -rng.uniform(1, 3, 6), rng.uniform(1, 3, 6)
    u = 4.0 * rng.standard_normal((3, 5, 6))
    q, xi = np.eye(4), np.zeros(6)
    jc_, tc_ = jcs.input_box(12, 6), cs.input_box(12, 6)
    jp, tp = jcs.input_box_params(lb, ub, 6), cs.input_box_params(lb, ub, 6)
    tu = torch.as_tensor(u)
    for term in (False, True):
        _close(tc_.g(tp, q, xi, tu, 0, term), jc_.g(jp, q, xi, u, 0, term))
        _close(tc_.g_x(tp, q, xi, tu, 0, term), jc_.g_x(jp, q, xi, u, 0, term))
        _close(tc_.g_u(tp, q, xi, tu, 0, term), jc_.g_u(jp, q, xi, u, 0, term))
    mask = np.array([True, False, True])[:, None, None]
    _close(tc_.g(tp, q, xi, tu, 0, torch.as_tensor(mask)),
           jc_.g(jp, q, xi, u, 0, jnp.asarray(mask)))
    assert tc_.constr_size == jc_.constr_size == 12
    # array bounds keep their dtype; python scalars take float64
    assert cs.input_box_params(np.float32(-1), np.float32(1), 6).lb.dtype == torch.float32
    assert cs.input_box_params(torch.ones(6, dtype=torch.float32), 2.0, 6).ub.dtype == \
        torch.float32
    assert cs.input_box_params(-1.0, 1.0, 6).lb.dtype == torch.float64


def _al_inputs(per_problem, seed=1, Bq=3, N=5):
    """A tracking problem's reference, perturbed states and controls, and AL
    state (shared (N+1, c) or per problem (B, N+1, c)) for both packages."""
    rng = np.random.default_rng(seed)
    jp = al_problem(N)[0]
    cp = jp["cost"]
    dq = 0.2 * rng.standard_normal((Bq, N + 1, 6))
    q = np.asarray(JSE3.normalize(jnp.asarray(cp.q_ref)[None] @ JSE3.exp(jnp.asarray(dq))))
    xi = np.asarray(cp.xi_ref)[None] + 0.3 * rng.standard_normal((Bq, N + 1, 6))
    u = 12.0 * rng.standard_normal((Bq, N, 6))
    lead = (Bq,) if per_problem else ()
    lmbd = np.abs(rng.standard_normal(lead + (N + 1, 12)))
    Imu = np.zeros(lead + (N + 1, 12, 12))
    Imu[..., np.arange(12), np.arange(12)] = rng.uniform(0, 5, lead + (N + 1, 12))
    mu = np.asarray(0.5) if not per_problem else rng.uniform(0.1, 1, Bq)
    box = jcs.input_box_params(-8.0, 9.0, 6)
    jal = jc.ALParams(cost=cp, constr=box, lmbd=jnp.asarray(lmbd), Imu=jnp.asarray(Imu),
                      mu=jnp.asarray(mu))
    tal = al_params_from_numpy({"cost": _fields(cp), "constr": _fields(box), "lmbd": lmbd,
                                "Imu": Imu, "mu": mu})
    return jal, tal, q, xi, u, N


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per_problem"])
def test_al_cost_matches_jax(per_problem):
    """Stage and terminal values and quadratizations of al_cost(tracking)."""
    jal, tal, q, xi, u, N = _al_inputs(per_problem)
    jcost = jc.al_cost(jc.tracking_cost(JSE3, 6), jcs.input_box(12, 6))
    tcost = costs.al_cost(costs.tracking_cost(SE3, 6), cs.input_box(12, 6))
    T = torch.as_tensor
    idx = np.arange(N)
    qs, xs = q[:, :-1], xi[:, :-1]
    _close(tcost.stage_cost(tal, T(qs), T(xs), T(u), torch.arange(N)),
           jcost.stage_cost(jal, qs, xs, u, idx))
    for a, b in zip(tcost.stage_quad(tal, T(qs), T(xs), T(u), torch.arange(N)),
                    jcost.stage_quad(jal, qs, xs, u, idx)):
        _close(a, b)
    _close(tcost.term_cost(tal, T(q[:, -1]), T(xi[:, -1]), N),
           jcost.term_cost(jal, q[:, -1], xi[:, -1], N))
    for a, b in zip(tcost.term_quad(tal, T(q[:, -1]), T(xi[:, -1]), N),
                    jcost.term_quad(jal, q[:, -1], xi[:, -1], N)):
        _close(a, b)
    # one stage by an int index
    _close(tcost.stage_cost(tal, T(qs[:, 2]), T(xs[:, 2]), T(u[:, 2]), 2),
           jcost.stage_cost(jal, qs[:, 2], xs[:, 2], u[:, 2], 2))


def test_al_init_params_matches_jax():
    jp = al_problem(4)[0]
    box = jcs.input_box_params(-10.0, 10.0, 6)
    j = jc.al_init_params(jp["cost"], box, 4, 12, mu0=0.3)
    t = costs.al_init_params(cost_from_numpy(_fields(jp["cost"])),
                             input_box_from_numpy(_fields(box)), 4, 12, mu0=0.3)
    for f in ("lmbd", "Imu", "mu"):
        _close(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == torch.float64


def test_al_update_diag_matches_jax():
    rng = np.random.default_rng(3)
    Bq, N1, C = 4, 6, 12
    lmbd = np.maximum(rng.standard_normal((Bq, N1, C)), 0.0)
    imu = rng.uniform(0, 2, (Bq, N1, C)) * (rng.uniform(size=(Bq, N1, C)) > 0.3)
    mu = rng.uniform(0.1, 1e7, Bq)
    g = rng.standard_normal((Bq, N1, C))
    g[:, -1] = 0.0
    freeze = np.array([True, False, False, True])
    for frz in (None, freeze):
        j = jc.al_update_diag(*map(jnp.asarray, (lmbd, imu, mu, g)), 10.0, 1e8,
                              freeze=None if frz is None else jnp.asarray(frz))
        t = costs.al_update_diag(*map(torch.as_tensor, (lmbd, imu, mu, g)), 10.0, 1e8,
                                 freeze=None if frz is None else torch.as_tensor(frz))
        for a, b in zip(t, j):
            _close(a, b)
    # mu is capped at mu_max
    assert float(t[2].max()) <= 1e8


def test_al_update_params_matches_jax():
    """The first update from the shared state with a freeze mask makes the
    state per problem; the second updates the per-problem state."""
    jal, tal, q, xi, u, N = _al_inputs(False)
    tcon, jcon = cs.input_box(12, 6), jcs.input_box(12, 6)
    rng = np.random.default_rng(5)
    for step in range(2):
        ce = np.concatenate([jcon.g(jal.constr, None, None, u, 0, False),
                             np.zeros((u.shape[0], 1, 12))], axis=1)
        ce = ce + 0.1 * rng.standard_normal(ce.shape) * (step == 1)
        frz = np.array([False, True, False])
        jal = jc.al_update_params(jal, jnp.asarray(ce), 10.0, 1e8, freeze=jnp.asarray(frz))
        tal = costs.al_update_params(tal, torch.as_tensor(ce), 10.0, 1e8,
                                     freeze=torch.as_tensor(frz))
        for f in ("lmbd", "Imu", "mu"):
            _close(getattr(tal, f), getattr(jal, f))
    assert tal.lmbd.shape == (3, N + 1, 12) and tal.mu.shape == (3,)
    # without freeze the scalar mu stays scalar
    _, tal0, *_ = _al_inputs(False)
    assert costs.al_update_params(tal0, torch.as_tensor(ce)).mu.dim() == 0
    assert tcon.constr_size == 12


# -- ALPipelineSolver against the JAX one ---------------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    """One interpret-mode JAX pipeline for the module: its compiled solve
    is reused by the tests of one dtype."""
    return PallasPipelineSolver(N=H, iterations=ITERS, dt=0.01, interpret=True)


@pytest.mark.parametrize("dtype,warm", [(jnp.float64, False), (jnp.float32, False),
                                        (jnp.float64, True)],
                         ids=["f64-cold", "f32-cold", "f64-warm"])
def test_al_pipeline_matches_jax(jax_pipe, dtype, warm):
    """Lanes 0 and 1 of seed 1: lane 0 rails at +-9, lane 1 stays inside;
    both converge in 10 outers (9 multiplier updates)."""
    jp, tp, q0s, xi0s, us0 = al_problem(H, dtype, seed=1, B=B)
    kw = dict(n_al_iters=NAL, warm_start=warm, warm_iters=2)
    jres = JALPipelineSolver(jax_pipe, np.full(6, -BOX), np.full(6, BOX)).solve(
        jp["dyn"], jp["cost"], q0s, xi0s, us0, **kw)
    al = ALPipelineSolver(PipelineSolver(H, ITERS, 0.01), np.full(6, -BOX), np.full(6, BOX))
    res = al.solve(tp["dyn"], tp["cost"], torch.as_tensor(q0s), torch.as_tensor(xi0s),
                   torch.as_tensor(us0), **kw)
    us = res.us.numpy()
    assert (np.abs(us[0]) >= BOX - 1e-3).sum() >= 10, "the box does not bind"
    assert res.outer_iterations == jres.outer_iterations
    assert res.constr_converged == bool(jres.constr_converged)
    assert res.lmbd.dtype == res.imu.dtype == torch.float64
    if dtype == jnp.float64:
        _close(us, jres.us, rtol=0, atol=1e-6)
        _close(res.J_opt, jres.J_opt, rtol=1e-7)
        scale = float(np.abs(np.asarray(jres.lmbd)).max())
        _close(res.lmbd, jres.lmbd, rtol=0, atol=1e-6 * scale)
        _close(res.imu, jres.imu, rtol=1e-12)
        _close(res.max_violation, jres.max_violation, rtol=0, atol=1e-9)
    else:
        _close(us, jres.us, rtol=2e-5, atol=2e-4)
        _close(res.max_violation, jres.max_violation, rtol=0, atol=2e-4)
    for f in ("qs", "xis", "us", "J_opt", "lmbd", "max_violation", "imu"):
        assert tuple(getattr(res, f).shape) == np.shape(getattr(jres, f)), f
    if warm:
        assert al._warm.plain == al.pipe.plain and al._warm.iterations == 2


def test_al_pipeline_rejects_no_outer():
    al = ALPipelineSolver(PipelineSolver(4, 1, 0.01), -1.0, 1.0)
    with pytest.raises(ValueError):
        al.solve(None, None, None, None, torch.zeros(1, 4, 6), n_al_iters=0)
