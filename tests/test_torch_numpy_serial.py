"""The port's own copies of plain-numpy and pickle-free pieces, against the
JAX package's:

  - `baselines/numpy_serial.py`: `SerialSE3MSiLQR.fit` on screw-200 cut to
    H = 20 (R = 1e-3 I) from a perturbed start, 3 iterations, and each
    numpy Lie map on random twists: bit for bit (the same numpy code);
  - `tasks/toy.py`: the toy problem of `__graft_entry__._toy_problem`
    (N = 16) built by the JAX package from the same numpy draws
    (`toy.toy_arrays`) and carried across by `convert.toy_from_numpy`
    equals the port's own build, f64: the reference path, the weights,
    the start, and the model's step, Jacobians and stage quadratization at
    the reference, to 1e-12.
"""

import numpy as np
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.baselines import numpy_serial as jns
from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import build_al1400_np64
from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines import numpy_serial as tns
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import toy_from_numpy
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import toy

H = 20


def _serial(mod):
    p = build_al1400_np64(H)
    dp, cp = p["dyn"], p["cost"]
    Q = np.block([[cp.Q1, np.zeros((6, 6))], [np.zeros((6, 6)), cp.Q2]])
    P = np.block([[cp.P1, np.zeros((6, 6))], [np.zeros((6, 6)), cp.P2]])
    return mod.SerialSE3MSiLQR(dp.J, dp.dt, Q, 1e-3 * np.eye(6), P, cp.q_ref, cp.xi_ref)


def test_serial_fit_is_the_jax_copy_bit_for_bit():
    rng = np.random.default_rng(0)
    q0 = jns._se3_exp(0.05 * rng.standard_normal(6))
    xi0 = np.array([0.0, 0.0, 0.1, 2.0, 0.0, 0.2])
    us0 = 0.1 * rng.standard_normal((H, 6))
    a = _serial(tns).fit(q0, xi0, us0, n_iterations=3)
    b = _serial(jns).fit(q0, xi0, us0, n_iterations=3)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert np.isfinite(a[3]).all() and a[4][-1] < a[4][0]


def test_serial_lie_maps_are_the_jax_copy_bit_for_bit():
    rng = np.random.default_rng(1)
    for xi in rng.standard_normal((8, 6)) * np.array([[1e-9], [1e-3], [0.5], [1.0], [2.0],
                                                       [3.0], [3.14], [0.2]]):
        T = tns._se3_exp(xi)
        np.testing.assert_array_equal(T, jns._se3_exp(xi))
        for name in ("_se3_log", "_normalize", "_se3_inv", "_se3_Ad"):
            np.testing.assert_array_equal(getattr(tns, name)(T), getattr(jns, name)(T), name)
        for name in ("_se3_Jr", "_se3_Jr_inv", "_coad"):
            np.testing.assert_array_equal(getattr(tns, name)(xi), getattr(jns, name)(xi), name)


def _jax_toy(N=16):
    """The JAX package's build of the toy problem (`__graft_entry__.
    _toy_problem`'s code) from `toy.toy_arrays`' numbers, f64."""
    a = toy.toy_arrays(N)
    xi_path = jnp.asarray(a["xi_path"])
    q_ref = [jnp.eye(4)]
    for i in range(N):
        q_ref.append(q_ref[-1] @ JSE3.exp(xi_path[i] * a["dt"]))
    q_ref = jnp.stack(q_ref)
    dp = jdyn.se3_params(jnp.asarray(a["J"]), jnp.asarray(a["dt"]))
    cp = jcosts.tracking_cost_params(JSE3, jnp.asarray(a["Q"]), jnp.asarray(a["R"]),
                                     jnp.asarray(a["P"]), q_ref, xi_path)
    return dp, cp, JSE3.exp(jnp.asarray(a["q0_twist"])), jnp.zeros(6)


def test_toy_problem_matches_the_jax_build():
    dp, cp, q0, xi0 = _jax_toy()
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    jm, jp, jq0, jxi0, jq_ref, jxi_ref, N = toy_from_numpy(fields(dp), fields(cp), q0, xi0)
    tm, tp, tq0, txi0, tq_ref, txi_ref, tN = toy.toy_problem(16, torch.float64, "cpu")
    assert N == tN == 16
    for x, y in ((jq0, tq0), (jxi0, txi0), (jq_ref, tq_ref), (jxi_ref, txi_ref)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-12)
    for name in ("Q1", "Q2", "R", "P1", "P2", "q_ref_inv", "Ad_ref"):
        np.testing.assert_allclose(getattr(tp["cost"], name).numpy(),
                                   getattr(jp["cost"], name).numpy(), rtol=0, atol=1e-12)
    idx = torch.arange(N)
    u = torch.as_tensor(np.random.default_rng(2).standard_normal((N, 6)))
    q = tq_ref[:-1] @ tm.group.exp(0.01 * txi_ref[:-1])
    evals = lambda m, p: [*m.step(p, q, txi_ref[:-1], u, idx), *m.jac(p, q, txi_ref[:-1], u, idx),
                          *m.stage_quad(p, q, txi_ref[:-1], u, idx)]
    for x, y in zip(evals(tm, tp), evals(jm, jp), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-12)
