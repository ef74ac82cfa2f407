"""Kernel B1's plain version (`ops/linearize`) against the JAX package's
`pallas_linearize(..., interpret=True)`, and the SE(3) steps of
`models/dynamics` against the JAX steps, on the same inputs.

Tolerances:
- f64: rtol 1e-7, atol 1e-7.  The JAX lane Log takes its angle from
  `pallas_lie.atan2_pos`, a polynomial good to ~1e-8; the port's from
  native atan2.
- f32: atol 5e-5 (the largest entries, in lxx, are ~20).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.ops.pallas_linearize import (
    pallas_linearize,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics as tdyn
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import linearize as L
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3 as tse3

from torch_port_cases import TORCH_DTYPE, problem

H, B = 12, 3
KEYS = ("fq", "fxi", "d", "Fx", "lx", "lxx", "l")


def _trajectory(cp, q0, nu, dtype, seed):
    """A trajectory off the reference at every stage: perturbed poses and
    twists and random controls (numpy, in ``dtype``)."""
    rng = np.random.default_rng(seed)
    q_ref = np.asarray(cp.q_ref, np.float64)
    xi_ref = np.asarray(cp.xi_ref, np.float64)
    dq = 0.05 * rng.standard_normal((B, H + 1, 6))
    qs = np.array(jse3.normalize(jnp.asarray(q_ref)[None] @ jse3.exp(jnp.asarray(dq))))
    qs[:, 0] = q0
    xis = xi_ref[None] + 0.1 * rng.standard_normal((B, H + 1, 6))
    us = 0.3 * rng.standard_normal((B, H, nu))
    np_dt = np.float32 if dtype == jnp.float32 else np.float64
    return qs.astype(np_dt), xis.astype(np_dt), us.astype(np_dt)


def _both(dtype, drone, exact):
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, dtype, drone=drone)
    qs, xis, us = _trajectory(cp, q0, nu, dtype, seed=3)
    gravity = drone
    mg = float(np.asarray(dp.m * dp.g)) if gravity else None
    jax_out = pallas_linearize(
        jnp.asarray(qs), jnp.asarray(xis), jnp.asarray(us), cp.q_ref_inv,
        cp.Ad_ref, cp.xi_ref, dp.J, dp.Jinv, cp.Q1, cp.Q2, float(dp.dt),
        interpret=True, Pu=dp.Pu if drone else None, mg=mg, gravity=gravity,
        exact_grav=exact)
    t = lambda x: torch.as_tensor(x)
    port = L.linearize(t(qs), t(xis), t(us), tcp.q_ref_inv, tcp.Ad_ref,
                       tcp.xi_ref, tdp.J, tdp.Jinv, tcp.Q1, tcp.Q2,
                       float(dp.dt), Pu=tdp.Pu if drone else None, mg=mg,
                       gravity=gravity, exact_grav=exact)
    return ({k: np.asarray(v) for k, v in jax_out.items()},
            {k: v.numpy() for k, v in port.items()})


CASES = [(jnp.float64, False, False), (jnp.float32, False, False),
         (jnp.float64, True, False), (jnp.float32, True, True)]


@pytest.mark.parametrize("dtype,drone,exact", CASES,
                         ids=["f64-free", "f32-free", "f64-drone", "f32-drone-exact"])
def test_linearize_plain_matches_pallas_linearize(dtype, drone, exact):
    jax_out, port = _both(dtype, drone, exact)
    for k in KEYS:
        assert port[k].shape == jax_out[k].shape, k
        assert port[k].dtype == jax_out[k].dtype, k
        if dtype == jnp.float64:
            np.testing.assert_allclose(port[k], jax_out[k], rtol=1e-7, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(port[k], jax_out[k], rtol=0, atol=5e-5,
                                       err_msg=k)


@pytest.mark.parametrize("drone", [False, True], ids=["free", "drone"])
def test_steps_match_jax_and_the_lane_stage_math(drone):
    """Batch-first steps (port vs JAX), and the port's lane dynamics
    evaluation against its own batch-first step (an independent
    formulation of the same physics), f64."""
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, jnp.float64, drone=drone)
    qs, xis, us = _trajectory(cp, q0, nu, jnp.float64, seed=4)
    q, xi, u = qs[:, :-1], xis[:, :-1], us
    jstep = jdyn._rigid_body_step if drone else jdyn._se3_step
    tstep = tdyn._rigid_body_step if drone else tdyn._se3_step
    jq, jxi = jstep(dp, jnp.asarray(q), jnp.asarray(xi), jnp.asarray(u), 0)
    tq, txi = tstep(tdp, torch.as_tensor(q), torch.as_tensor(xi), torch.as_tensor(u))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-12)
    np.testing.assert_allclose(txi.numpy(), np.asarray(jxi), rtol=0, atol=1e-12)

    mg = float(tdp.m * tdp.g) if drone else 0.0
    lane = lambda x: torch.as_tensor(np.moveaxis(x, 0, -1).copy())  # b to last
    st = lambda x: lane(x).movedim(0, -2)  # (H, ..., B) -> (..., H, B)
    Pu = tdp.Pu if drone else torch.eye(6, dtype=torch.float64)
    fqR, fqp, fxi = L.stage_dynamics_eval(
        st(q[..., :3, :3]), st(q[..., :3, 3]), st(xi), st(u), tdp.J, tdp.Jinv,
        Pu, mg, dt=float(tdp.dt), gravity=drone)
    back = lambda x: x.movedim(-2, 0).movedim(-1, 0).numpy()  # (B, H, ...)
    np.testing.assert_allclose(back(fqR), tq[..., :3, :3].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(back(fqp), tq[..., :3, 3].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(back(fxi), txi.numpy(), rtol=0, atol=1e-12)


def test_lane_jacobian_applies_the_coad_swap_whatever_ref_coad_swap():
    """The lane Fx (the port's, as the JAX lane kernels') always applies the
    reference's coad swap: it equals the JAX model Jacobian with
    ref_coad_swap=True and differs from it with ref_coad_swap=False."""
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, jnp.float64)
    qs, xis, us = _trajectory(cp, q0, nu, jnp.float64, seed=5)
    q, xi = qs[0, :-1], xis[0, :-1]
    lane = lambda x: torch.as_tensor(np.moveaxis(x, 0, -1).copy())
    Fx = L.stage_jacobian(lane(q[:, :3, :3]), lane(xi), tdp.J, tdp.Jinv, 0.0,
                          dt=float(tdp.dt), gravity=False, exact_grav=False)
    Fx = np.moveaxis(Fx.numpy(), -1, 0)
    for swap in (True, False):
        p = dp._replace(ref_coad_swap=jnp.asarray(swap))
        want = np.stack([np.asarray(jdyn._se3_jac(p, jnp.asarray(q[i]),
                                                  jnp.asarray(xi[i]),
                                                  jnp.asarray(us[0, i]), i)[0])
                         for i in range(H)])
        diff = np.abs(Fx - want).max()
        assert diff <= 1e-12 if swap else diff > 1e-3, (swap, diff)


def test_convert_round_trip():
    dp, cp, tdp, tcp, *_ = problem(H, jnp.float64, drone=True)
    assert isinstance(tdp, tdyn.RigidBodyParams) and tdp.Pu.shape == (6, 4)
    assert tdp.ref_coad_swap is True and tdp.exact_gravity_jacobian is False
    for k, v in cp._asdict().items():
        np.testing.assert_array_equal(getattr(tcp, k).numpy(), np.asarray(v))
    assert tcp.R.dtype == TORCH_DTYPE[jnp.float64]
    # the port's own setup builds the same containers as the converted ones
    own = tdyn.drone_params(tdp.J, tdp.dt)
    for k in ("J", "Jinv", "Ib", "m", "g", "dt", "Pu"):
        np.testing.assert_allclose(getattr(own, k).numpy(), getattr(tdp, k).numpy(),
                                   rtol=0, atol=1e-15)
    np.testing.assert_allclose(tse3.Ad(tcp.q_ref).numpy(), np.asarray(cp.Ad_ref),
                               rtol=0, atol=1e-12)
