"""The mixed-precision polish: the port's plain stage math and lane passes
(`solvers/df_mixed.py`, fp64 residuals) against the JAX package's
(double-f32 residuals) on the same numpy inputs.

The JAX side gets each f64 value as the hi/lo f32 split of
tests/test_df_mixed.py; the port gets the f64 value itself, and the JAX
results are joined (hi + lo) for the comparison.  The f32 preconditioner
parts of the two packages sum in other orders, so they agree at f32 grade;
the residual path agrees at double-f32 grade where no f32 value feeds it.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.ops import dfx
from trajectory_optimization_matrix_lie_groups_tpu.ops import pallas_lie as pll
from trajectory_optimization_matrix_lie_groups_tpu.solvers import df_mixed as jdm
from trajectory_optimization_matrix_lie_groups_tpu.solvers.df_pipeline import (
    join_us as jax_join_us,
    split_pytree,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    lane_state_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    stage_dynamics_eval,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as dm
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    join_us,
)

from torch_port_cases import initial_batch, problem

t64 = lambda x: torch.as_tensor(np.array(x, np.float64))
t32 = lambda x: torch.as_tensor(np.array(x, np.float32))


@contextlib.contextmanager
def x64_off():
    """The JAX polish is traced with x64 off, as its `solve` runs it."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _df_of(x64):
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return dfx.DF(jnp.asarray(hi), jnp.asarray(lo))


def _join(d):
    return np.asarray(d.hi, np.float64) + np.asarray(d.lo, np.float64)


def _lane(a):
    return np.moveaxis(np.asarray(a), 0, -1).copy()


def _psd(rng, n, B, scale=1.0):
    A = rng.normal(size=(B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) / n * scale + 0.1 * np.eye(n)[None] * scale
    return _lane(M)


def _max(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# -- stage math ------------------------------------------------------------------

@pytest.mark.parametrize("glow,al", [(False, False), (True, False), (False, True)],
                         ids=["free", "glow", "luual"])
def test_riccati_stage_mx_matches_jax(glow, al):
    """K and Vxx (the f32 chain) at f32 grade, 1e-5 of their scale; Qu at
    1e-12 (double-f32 grade: its only f32 input, V_xx d, is computed alike
    by the two packages); Vx at 1e-6 of its scale (its correction terms are
    f32); k at rtol 5e-3 (tests/test_df_mixed.py:47-93).  Measured: K 1.4e-6,
    Vx 5.7e-6 at scale 10, Qu 6e-15."""
    B, nu = 16, 6
    RNG = np.random.default_rng(11)
    fx64 = _lane(RNG.normal(size=(B, 12, 12)) * 0.3 + np.eye(12)[None])
    dd64 = _lane(RNG.normal(size=(B, 12)) * 1e-3)
    lx64, lu64 = _lane(RNG.normal(size=(B, 12))), _lane(RNG.normal(size=(B, nu)))
    Vx64 = _lane(RNG.normal(size=(B, 12)))
    fu2_64 = _lane(RNG.normal(size=(B, 6, nu)) * 0.05)
    lxx32 = _psd(RNG, 12, B).astype(np.float32)
    Vxx32 = _psd(RNG, 12, B).astype(np.float32)
    Luu32 = _psd(RNG, nu, B, scale=0.1).astype(np.float32)
    luual = np.abs(_lane(RNG.normal(size=(B, nu)))).astype(np.float32) if al else None

    fu2_df = _df_of(fu2_64)
    with x64_off():
        jk, jK, jQu, jVx, jVxx = jdm.riccati_stage_mx(
            _df_of(fx64), _df_of(dd64), _df_of(lx64), _df_of(lu64),
            jnp.asarray(lxx32), fu2_df, pll.transpose(fu2_df), fu2_df.hi,
            pll.transpose(fu2_df.hi), jnp.asarray(Luu32), _df_of(Vx64),
            jnp.asarray(Vxx32), nu=nu, glow=glow,
            luual_t=None if luual is None else jnp.asarray(luual))
    fu2_32 = t32(np.asarray(fu2_df.hi))
    k, K, Qu, Vx, Vxx = dm.riccati_stage_mx(
        t64(fx64), t64(dd64), t64(lx64), t64(lu64), t32(lxx32), t64(fu2_64),
        t64(fu2_64).transpose(0, 1), fu2_32, fu2_32.transpose(0, 1), t32(Luu32),
        t64(Vx64), t32(Vxx32), nu=nu, glow=glow,
        luual_t=None if luual is None else t32(luual))
    assert (k.dtype, K.dtype, Qu.dtype, Vx.dtype, Vxx.dtype) == (
        torch.float32, torch.float32, torch.float64, torch.float64, torch.float32)
    scale = max(1.0, np.abs(_join(jVx)).max())
    assert _max(K, jK) < 1e-5 * max(1.0, np.abs(np.asarray(jK)).max())
    assert _max(Vxx, jVxx) < 1e-5 * max(1.0, np.abs(np.asarray(jVxx)).max())
    assert _max(Qu, _join(jQu)) < 1e-12
    assert _max(Vx, _join(jVx)) < 1e-6 * scale
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=5e-3, atol=2e-5)


def _poses(rng, B, scale):
    """Random lane-layout poses (R (3, 3, B), p (3, B)) in f64."""
    R = so3.exp(torch.as_tensor(rng.normal(size=(B, 3)) * scale))
    return R.permute(1, 2, 0).contiguous(), t64(_lane(rng.normal(size=(B, 3))))


def test_stage_cost_quad_mx_matches_jax():
    """lx (fp64) at atol 1e-9, lxx32 and l32 at f32 grade
    (tests/test_df_mixed.py:96-129)."""
    B = 16
    RNG = np.random.default_rng(12)
    R, p = _poses(RNG, B, 0.3)
    Rb, pb = _poses(RNG, B, 0.3)
    RbiR = Rb.transpose(0, 1)
    Rbip = -torch.einsum("jib,jb->ib", Rb, pb)
    Adb = torch.zeros((6, 6, B), dtype=torch.float64)
    Adb[:3, :3] = Adb[3:, 3:] = Rb
    xi, xib = t64(_lane(RNG.normal(size=(B, 6)))), t64(_lane(RNG.normal(size=(B, 6))))
    W1, W2 = t64(_psd(RNG, 6, B)), t64(_psd(RNG, 6, B))
    args = (R, p, xi, RbiR, Rbip, Adb, xib, W1, W2)
    with x64_off():
        jargs = [_df_of(a.numpy()) for a in args]
        jlx, jlxx, jl = jdm.stage_cost_quad_mx(*jargs, jargs[-2].hi)
    lx, lxx32, l32 = dm.stage_cost_quad_mx(*args, W1.float())
    assert lx.dtype == torch.float64 and lxx32.dtype == l32.dtype == torch.float32
    np.testing.assert_allclose(lx.numpy(), _join(jlx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(lxx32.numpy(), np.asarray(jlxx), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(l32.numpy(), np.asarray(jl), rtol=2e-5, atol=1e-5)


def test_rollout_stage_mx_matches_jax():
    """A near-converged step (new state 1e-3 from the nominal, d ~ 1e-4:
    inside the JAX small-angle envelope): poses, twists and evaluations at
    1e-12 (double-f32 grade), the controls at 1e-9 (the f32 feedback,
    |k + K xs_err| ~ 1e-2, rounded by the two packages in other orders)."""
    B, nu = 16, 6
    J = t64(np.diag([0.5, 0.7, 0.9, 1.0, 1.0, 1.0]))
    Jinv, Pu, dt = torch.linalg.inv(J), t64(np.eye(6)), 0.01
    RNG = np.random.default_rng(13)
    Rt, pt = _poses(RNG, B, 1.0)
    xit = t64(_lane(np.array([0.0, 0.0, 1.0, 2.0, 0.0, 0.2]) + 0.1 * RNG.normal(size=(B, 6))))
    ut = t64(_lane(0.1 * RNG.normal(size=(B, nu))))
    dR = so3.exp(torch.as_tensor(1e-3 * RNG.normal(size=(B, 3)))).permute(1, 2, 0)
    R_new = torch.einsum("ikb,kjb->ijb", Rt, dR)
    p_new = pt + t64(_lane(1e-3 * RNG.normal(size=(B, 3))))
    xi_new = xit + t64(_lane(1e-3 * RNG.normal(size=(B, 6))))
    fqR, fqp, fxi = stage_dynamics_eval(Rt, pt, xit, ut, J, Jinv, Pu, 0.0, dt=dt,
                                        gravity=False)
    dn = so3.exp(torch.as_tensor(1e-4 * RNG.normal(size=(B, 3)))).permute(1, 2, 0)
    Rn = torch.einsum("ikb,kjb->ijb", fqR, dn)
    pn = fqp + t64(_lane(1e-4 * RNG.normal(size=(B, 3))))
    xin = fxi + t64(_lane(1e-4 * RNG.normal(size=(B, 6))))
    d = t64(_lane(1e-4 * RNG.normal(size=(B, 12))))
    k32 = t32(_lane(1e-3 * RNG.normal(size=(B, nu))))
    K32 = t32(_lane(RNG.normal(size=(B, nu, 12))))
    traj = (R_new, p_new, xi_new, Rt, pt, Rn, pn, xit, xin, ut)
    nom = (d, fqR, fqp, fxi)

    lanes = lambda M: np.broadcast_to(M.numpy()[..., None], M.shape + (B,))
    with x64_off():
        jout = jdm.rollout_stage_mx(
            *[_df_of(a.numpy()) for a in traj], jnp.asarray(k32.numpy()),
            jnp.asarray(K32.numpy()), *[_df_of(a.numpy()) for a in nom],
            _df_of(lanes(J)), _df_of(lanes(Jinv)), _df_of(lanes(Pu)),
            _df_of(np.zeros((1, B))), dt=dt, gravity=False)
    out = dm.rollout_stage_mx(*traj, k32, K32, *nom, J, Jinv, Pu, 0.0, dt=dt,
                              gravity=False)
    names = ("R", "p", "xi", "u", "fqR", "fqp", "fxi")
    for name, a, b in zip(names, out, jout):
        assert a.dtype == torch.float64, name
        tol = 1e-9 if name == "u" else 1e-12
        assert _max(a, _join(b)) < tol, (name, _max(a, _join(b)))


# -- the polish from one handoff ----------------------------------------------------

H, B, F32_IT, DF_IT = 8, 4, 4, 2


@pytest.fixture(scope="module")
def handoff():
    """One JAX `MixedDFPipelineSolver` (interpret mode, so its polish is the
    plain XLA path) compiled once: its f32 handoff, its polish of it and its
    `solve`, with the port's problem and inputs beside them."""
    dp, cp, tdp, tcp, q0, xi0, nu = problem(H, jnp.float64)
    q0s, xi0s, us0 = initial_batch(q0, xi0, B, H, nu, seed=0, dtype=jnp.float64)
    np_params = jax.tree.map(np.asarray, {"dyn": dp, "cost": cp})
    mx = jdm.MixedDFPipelineSolver(N=H, dt=float(dp.dt), f32_iterations=F32_IT,
                                   df_iterations=DF_IT, fx_mode="df", interpret=True)
    sp = split_pytree(np_params)
    f32 = lambda x: np.asarray(x, np.float32)
    with x64_off():
        ls = mx._f32_jit(sp, f32(q0s), f32(xi0s), f32(us0), None)
        polished = mx._df_jit(sp, *ls, None)
        solved = mx.solve(np_params, q0s, xi0s, us0)
    return dict(mx=mx, sp=sp, ls=[np.asarray(x) for x in ls], polished=polished,
                solved=solved, dyn=tdp, cost=tcp, dt=float(dp.dt),
                inputs=tuple(torch.as_tensor(x) for x in (q0s, xi0s, us0)))


def _check_state(out, ref, us_atol, g_atol):
    np.testing.assert_allclose(join_us(out).numpy(), jax_join_us(ref), rtol=0,
                               atol=us_atol)
    np.testing.assert_allclose(out.J_opt.numpy(), np.asarray(ref.J_opt), rtol=1e-6)
    np.testing.assert_allclose(out.grad_norm.numpy(), np.asarray(ref.grad_norm),
                               rtol=0, atol=g_atol)
    np.testing.assert_allclose(out.qs.numpy(), np.asarray(ref.qs), rtol=0, atol=1e-6)
    for f in ("qs", "xis", "us_hi", "us_lo", "J_opt", "grad_norm"):
        assert tuple(getattr(out, f).shape) == np.shape(getattr(ref, f)), f


def test_polish_from_the_jax_handoff(handoff):
    """The port's polish of the JAX f32 handoff against the JAX polish of
    it: the same start, two mixed iterations each.  The f32 preconditioner
    contracts only linearly (its relative error is ~cond(Q_uu) eps_f32), and
    the two packages round it in other orders, so after two iterations each
    lands a few 1e-7 from the common fixed point: us at 1e-6 (measured
    4.1e-7), J (f32) at rtol 1e-6, grad_norm (~1e-8, one step stale) at
    1e-9 (measured 8e-11), the poses at 1e-6."""
    port = dm.MixedDFPipelineSolver(H, handoff["dt"], F32_IT, DF_IT, fx_mode="df")
    out = port.polish(handoff["dyn"], handoff["cost"],
                      *lane_state_from_numpy(*handoff["ls"]))
    _check_state(out, handoff["polished"], us_atol=1e-6, g_atol=1e-9)


def test_mixed_solve_matches_jax_solve(handoff):
    """The whole solve against the JAX `solve`.  Both polish from the f32
    phase's iterate with stage 0 the f32 rounding of the initial state, so
    stage 0 of the poses and twists agrees exactly (it read 3.9e-8 while the
    port reset it to the fp64 state).  The f32 phases differ by f32 noise
    (2.7e-5 in the handoff's us), which two polish iterations contract to
    the preconditioner's rounding, as in `test_polish_from_the_jax_handoff`:
    us at 6e-7 (measured 4.1e-7), grad_norm at 5e-9 (measured 1.6e-9)."""
    port = dm.MixedDFPipelineSolver(H, handoff["dt"], F32_IT, DF_IT, fx_mode="df")
    out = port.solve(handoff["dyn"], handoff["cost"], *handoff["inputs"])
    ref = handoff["solved"]
    _check_state(out, ref, us_atol=6e-7, g_atol=5e-9)
    np.testing.assert_array_equal(out.qs[:, 0].numpy(), np.asarray(ref.qs)[:, 0])
    np.testing.assert_array_equal(out.xis[:, 0].numpy(), np.asarray(ref.xis)[:, 0])


def test_linearize_tail_matches_jax(handoff):
    """The plain tail (B7-B9) against the JAX `_linearize_tail_mx` (its XLA
    path) on the handoff trajectory promoted to fp64 / double-f32, with the
    dynamics evaluations of each package's own `_dyn_evals_mx`: evals, d, Fx
    and lx at 1e-12 (measured 4e-14), lxx32 and l32 at f32 grade."""
    mx, sp, ls = handoff["mx"], handoff["sp"], handoff["ls"]
    prom = lambda x: dfx.DF(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    with x64_off():
        consts_df, refs_df, _, _, R32 = mx._df_setup(sp, B)
        dyn, cost = sp["dyn"], sp["cost"]
        lanes = lambda M: jnp.broadcast_to(jnp.asarray(M)[..., None], M.shape + (B,))
        consts32 = dict(W1=lanes(cost.Q1[0]), Jl=lanes(dyn.J[0]),
                        Jil=lanes(dyn.Jinv[0]), mg=jnp.zeros((1, B), jnp.float32))
        qR, qp, xi, us = (prom(x) for x in ls)
        evals = mx._dyn_evals_mx(qR, qp, xi, us, consts_df)
        jlin = mx._linearize_tail_mx(qR, qp, xi, evals, refs_df, consts_df, consts32)
    port = dm.MixedDFPipelineSolver(H, handoff["dt"], F32_IT, DF_IT)
    tq = tuple(x.double() for x in lane_state_from_numpy(*ls))
    consts, refs, _ = port._df_setup(handoff["dyn"], handoff["cost"], "cpu")
    tev = dm.dyn_evals_mx(*tq, consts, dt=port.dt, gravity=False)
    lin = dm.linearize_tail_mx_plain(*tq[:3], tev, refs, consts, dt=port.dt,
                                     gravity=False, exact_grav=False)
    for name in ("fqR", "fqp", "fxi", "d", "Fx", "lx"):
        assert lin[name].dtype == torch.float64
        assert _max(lin[name], _join(jlin[name])) < 1e-12, name
    np.testing.assert_allclose(lin["lxx32"].numpy(), np.asarray(jlin["lxx32"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lin["l32"].numpy(), np.asarray(jlin["l32"]),
                               rtol=1e-5, atol=1e-5)

