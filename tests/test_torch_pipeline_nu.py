"""The SE(3) pipeline and the constrained pipeline at input dimensions
other than 6 and 4, the port's plain path against the JAX package's on the
same numpy inputs: here nu = 3; nu = 12 in tests/test_torch_pipeline_nu12.py
and the mixed-precision polish at nu = 3 in tests/test_torch_df_mixed_nu.py,
files of their own because each JAX interpret solve takes 10-20 s to
compile.  One JAX solve a module and nu, in f64: the port's f64 and f32
solves are both held against it (the f32 one at the f32 tolerances, which
it meets in us by two orders of magnitude on these inputs).  The JAX
pipeline runs unfused (``fused=False``, which compiles in two thirds of
the fused solve's time); its iterates are the fused layout's.

The problem is the screw-tracking problem cut to a short horizon on a rigid
body driven through an input projection Pu (6, nu), with g = 0, the exact
gravity Jacobian (zero at g = 0) and R = 1e-2 I (`tasks/al_bench.
build_screw200_nu`): nu = 3 (Pu = [I3; 0], three body torques) and nu = 12
(the 12-thruster layout `al_bench.rcs12_pu`).  The rigid-body family
(``gravity=True``) is how Pu reaches the solvers in both packages.

Tolerances: `PipelineSolver` as tests/torch_port_cases.py's check_solves
(f64 us atol 1e-6, J rtol 1e-7; f32 tests/test_pipeline.py's atol 5e-4 /
rtol 1e-4); the constrained pipeline as tests/test_torch_al.py's f64 case (us 1e-6, J
rtol 1e-7).  The full-width problems' goldens: tests/test_torch_nu_goldens.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.solvers.al_pipeline import (
    ALPipelineSolver as JALPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
    ALPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

from torch_port_cases import TORCH_DTYPE, check_solves, initial_batch, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, B, ITERS = 16, 3, 4
GRAV = dict(gravity=True, exact_gravity_jacobian=True)
NUS = [pytest.param(3, id="nu3_torques")]


def _to(tree, dtype):
    return jax.tree.map(
        lambda x: jnp.asarray(x, dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def nu_problem(H, nu, dtype=jnp.float64):
    """(jax dyn, jax cost, torch dyn, torch cost, q0 (4, 4), xi0 (6,)) of
    the rigid body driven through `al_bench.nu_pu(nu)` in ``dtype``; the
    torch containers come through `convert.py`."""
    params, _, _, q0, xi0, _, _ = build_al1400(jnp.float64, H)
    dp = jdyn.rigid_body_params(params["dyn"].J, params["dyn"].dt, g=0.0,
                                Pu=jnp.asarray(al_bench.nu_pu(nu)),
                                exact_gravity_jacobian=True)
    cp = params["cost"]._replace(R=1e-2 * jnp.eye(nu, dtype=jnp.float64))
    dp, cp = _to(dp, dtype), _to(cp, dtype)
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    tdt = TORCH_DTYPE[dtype]
    return (dp, cp, dyn_from_numpy(fields(dp), dtype=tdt),
            cost_from_numpy(fields(cp), dtype=tdt), np.asarray(q0), np.asarray(xi0))


def test_port_problem_matches_the_jax_problem():
    """The port's problem (`al_bench.build_screw200_nu`) and the JAX-side
    one above have the same parameters, at both nu."""
    for nu in (3, 12):
        _, _, tdp, tcp, q0, xi0 = nu_problem(H, nu)
        dyn, cost, q0p, xi0p = al_bench.build_screw200_nu(al_bench.nu_pu(nu), torch.float64,
                                                          "cpu", horizon=H)
        for f in ("J", "Jinv", "g", "dt", "Pu"):
            np.testing.assert_allclose(getattr(dyn, f).numpy(), getattr(tdp, f).numpy(),
                                       rtol=1e-15, atol=0)
        assert dyn.exact_gravity_jacobian and tdp.exact_gravity_jacobian
        for f in ("Q1", "Q2", "P1", "P2", "R", "q_ref", "xi_ref"):
            np.testing.assert_allclose(getattr(cost, f).numpy(), getattr(tcp, f).numpy(),
                                       rtol=1e-15, atol=1e-15)
        np.testing.assert_array_equal(q0p.numpy(), q0)
        np.testing.assert_array_equal(xi0p.numpy(), xi0)
    assert np.linalg.matrix_rank(al_bench.rcs12_pu()) == 6


@pytest.fixture(scope="module")
def jax_solves():
    """{nu: the JAX f64 solve}, each made once a module by `check_pipeline`."""
    return {}


def check_pipeline(dtype, nu, jax_solves, H=H, B=B):
    """The port's `PipelineSolver` (fused) in ``dtype`` against the JAX
    `PallasPipelineSolver(interpret=True, fused=False)` in f64 at ``nu``,
    rigid-body family, horizon ``H``, batch ``B``, from the same seeded
    inputs (rounded to ``dtype``), at ``dtype``'s tolerances."""
    if nu not in jax_solves:
        dp, cp, _, _, q0, xi0 = nu_problem(H, nu)
        q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=0, dtype=jnp.float64)
        jax_solves[nu] = PallasPipelineSolver(
            N=H, iterations=ITERS, dt=float(dp.dt), interpret=True, fused=False,
            **GRAV).solve(dp, cp, q0s, xi0s, us0)
    dp, _, tdp, tcp, q0, xi0 = nu_problem(H, nu, dtype)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=0, dtype=dtype)
    tout = PipelineSolver(H, ITERS, float(dp.dt), **GRAV).solve(
        tdp, tcp, *(torch.as_tensor(x) for x in (q0s, xi0s, us0)))
    check_solves(jax_solves[nu], tout, dtype)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_pipeline_matches_jax(dtype, nu, jax_solves):
    """`check_pipeline` at nu = 3."""
    check_pipeline(dtype, nu, jax_solves)


# -- the constrained pipeline -------------------------------------------------------------

NAL, BOX = 6, 0.5


def test_al_pipeline_nu3_matches_jax():
    """`ALPipelineSolver` with an input box of +-BOX at nu = 3 (f64, cold
    start) against the JAX one: the box binds, the same outer iterations."""
    check_al_pipeline(3)


def check_al_pipeline(nu, H=H):
    """`ALPipelineSolver` with an input box of +-BOX at ``nu`` (f64, cold
    start, horizon ``H``, two problems) against the JAX one: the box binds,
    the same outer iterations, us to 1e-6, J to rtol 1e-7."""
    dp, cp, tdp, tcp, q0, xi0 = nu_problem(H, nu)
    q0s, xi0s, us0 = initial_batch(q0, xi0, 2, H, nu, seed=1, dtype=jnp.float64)
    jpipe = PallasPipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt), interpret=True,
                                 fused=False, **GRAV)
    jres = JALPipelineSolver(jpipe, np.full(nu, -BOX), np.full(nu, BOX)).solve(
        dp, cp, q0s, xi0s, us0, n_al_iters=NAL)
    al = ALPipelineSolver(PipelineSolver(H, ITERS, float(dp.dt), **GRAV),
                          np.full(nu, -BOX), np.full(nu, BOX))
    res = al.solve(tdp, tcp, *(torch.as_tensor(x) for x in (q0s, xi0s, us0)),
                   n_al_iters=NAL)
    us = res.us.numpy()
    assert (np.abs(us) >= BOX - 1e-2).sum() >= 4, "the box does not bind"
    assert res.outer_iterations == jres.outer_iterations
    np.testing.assert_allclose(us, np.asarray(jres.us), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.J_opt.numpy(), np.asarray(jres.J_opt), rtol=1e-7)
    np.testing.assert_allclose(res.max_violation.numpy(), np.asarray(jres.max_violation),
                               rtol=0, atol=1e-9)
