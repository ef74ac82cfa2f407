"""The port's CUDA kernels B1-B14 against their plain versions on the card.

Marked ``cuda``; each test skips without a CUDA device (the kernels are
built by nvcc at first use and run only on the card).  This file imports no
JAX, so on a machine with the card it runs without the JAX test setup:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    FAST_OUTPUTS,
    GATES,
    OUTPUTS,
    READS,
    _flat,
    calls,
    compare,
    fast_compare,
    fast_inputs,
    kernel_inputs,
    polish_compare,
    polish_inputs,
    rel_err,
    riccati_inputs,
    so3_compare,
    so3_inputs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    drone_params,
    rigid_body_params,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
    join_us,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    screw200_model,
    screw_batch,
)

pytestmark = pytest.mark.cuda

_MAX_NU = _build.MAX_NU  # the largest input dimension B1-B6 take

H, B = 16, 130  # B crosses a 128-thread block boundary and ends a ragged 8-problem block


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _problem(dtype, device, drone, B_=B, H_=H):
    dyn, cost, q0, xi0 = build_screw200(dtype, device, horizon=H_)
    nu = 6
    if drone:
        dyn = drone_params(dyn.J, dyn.dt)
        cost.R = 1e-2 * torch.eye(4, dtype=dtype, device=device)
        nu = 4
    q0s, xi0s = screw_batch(q0, xi0, B_, seed=1)
    us0 = torch.zeros((B_, H_, nu), dtype=dtype, device=device)
    return dyn, cost, q0s, xi0s, us0


def _al_state(nu, dtype, device, seed=2):
    """Input-box AL state (lb, ub, lmbd, imu) in solver layout."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return (t(np.full(nu, -5.0)), t(np.full(nu, 5.0)),
            t(np.abs(rng.normal(size=(B, H + 1, 2 * nu)))),
            t(np.full((B, H + 1, 2 * nu), 0.5)))


@pytest.mark.parametrize("al", [False, True], ids=["plain_quu", "al_quu"])
@pytest.mark.parametrize("drone", [False, True], ids=["free_body", "drone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernels_match_plain(cuda, dtype, drone, al):
    dyn, cost, q0s, xi0s, us0 = _problem(dtype, cuda, drone)
    solver = P.PipelineSolver(H, 2, float(dyn.dt), gravity=drone,
                              exact_gravity_jacobian=drone)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=al)
    errs = compare(s, dt=solver.dt, gravity=drone, exact_grav=drone)
    torch.cuda.synchronize()
    assert ("B2_al" in errs) == al
    for name, e in errs.items():
        assert e["max_rel"] <= GATES[dtype][name], (name, e["per_output"])


@pytest.mark.parametrize("al", [False, True], ids=["no_al", "al"])
def test_kernel_solve_matches_plain_solve(cuda, al):
    """Fused and unfused kernel solves against the plain solve (f64), with
    and without the AL terms."""
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    al_arg = _al_state(6, torch.float64, cuda) if al else None
    ref = P.PipelineSolver(H, 3, float(dyn.dt), plain=True).solve(
        dyn, cost, q0s, xi0s, us0, al=al_arg)
    for fused in (True, False):
        out = P.PipelineSolver(H, 3, float(dyn.dt), fused=fused).solve(
            dyn, cost, q0s, xi0s, us0, al=al_arg)
        torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
        torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-12, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    solver = P.PipelineSolver(H, 1, float(dyn.dt))
    qR, qp, xi, us, refs, consts = solver._prepare(dyn, cost, q0s, xi0s, us0)
    with pytest.raises(TypeError):
        P.linearize_lane(qR.half(), qp.half(), xi.half(), us.half(), refs,
                         consts, dt=solver.dt)
    with pytest.raises(ValueError):
        P.linearize_lane(qR, qp, xi, us[:-1], refs, consts, dt=solver.dt)


@pytest.mark.parametrize("drone", [False, True], ids=["free_body", "drone"])
def test_polish_kernels_match_plain(cuda, drone):
    """B5 (and its AL branch), B6 and B7-B9 on a real polish iterate (the
    handoff of the polish's 7 f32 iterations), each output within its gate
    (kernel_check.GATES["mixed"])."""
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, drone)
    solver = DM.MixedDFPipelineSolver(H, float(dyn.dt), 7, 1, gravity=drone,
                                      exact_gravity_jacobian=drone)
    s = polish_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    errs = polish_compare(s, solver)
    torch.cuda.synchronize()
    for name, e in errs.items():
        for out, err in e["per_output"].items():
            assert err <= GATES["mixed"][name][out], (name, out, err)


# The group Riccati kernels (B2, B5) at their edges: one problem, a ragged
# last block of 8 problems (7, 257), rows that are not 16-byte aligned (odd
# B), one and three stages, nu = 6 (free body) and 4 (the drone, with the
# gravity block of Fx), each with and without the AL diagonal on Q_uu.
_EDGES = [pytest.param(B_, N_, id=f"B{B_}-N{N_}") for B_ in (1, 7, 257) for N_ in (1, 3)]
# B2 also at B = 33 and 129: a ragged last block whichever of 8, 4 or 32
# problems a block its f32 and fp64 designs take
_B2_EDGES = _EDGES + [pytest.param(B_, 3, id=f"B{B_}-N3") for B_ in (33, 129)]


@pytest.mark.parametrize("B_,N_", _B2_EDGES)
@pytest.mark.parametrize("drone", [False, True], ids=["nu6", "nu4_drone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_group_riccati_b2_edges(cuda, dtype, drone, B_, N_):
    dyn, cost, q0s, xi0s, us0 = _problem(dtype, cuda, drone, B_, N_)
    solver = P.PipelineSolver(N_, 2, float(dyn.dt), gravity=drone,
                              exact_gravity_jacobian=drone)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    errs = compare(s, dt=solver.dt, gravity=drone, exact_grav=drone)
    torch.cuda.synchronize()
    for name in ("B2", "B2_al"):
        assert errs[name]["max_rel"] <= GATES[dtype][name], (name, errs[name]["per_output"])


@pytest.mark.parametrize("B_,N_", _EDGES)
@pytest.mark.parametrize("drone", [False, True], ids=["nu6", "nu4_drone"])
def test_group_riccati_b5_edges(cuda, drone, B_, N_):
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, drone, B_, N_)
    solver = DM.MixedDFPipelineSolver(N_, float(dyn.dt), 7, 1, gravity=drone,
                                      exact_gravity_jacobian=drone)
    s = polish_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    errs = polish_compare(s, solver)
    torch.cuda.synchronize()
    for name in ("B5", "B5_al"):
        for out, err in errs[name]["per_output"].items():
            assert err <= GATES["mixed"][name][out], (name, out, err)


def test_riccati_wrappers_raise_when_the_launch_fails(cuda):
    """nu = MAX_NU + 1 passes the wrappers' shape checks: B2's and B5's
    wrappers raise ValueError before any launch, count none and do not fall
    back to their plain versions; called directly, the launchers of the
    tuned and the runtime-nu instances return an error that the kernel calls
    raise."""
    N_, B_, nu = 2, 3, _MAX_NU + 1
    g = torch.Generator().manual_seed(0)
    r = lambda *shape, dtype=torch.float64: torch.randn(
        shape, generator=g, dtype=torch.float64).to(dtype=dtype, device=cuda)
    lin = dict(Fx=r(N_, 12, 12, B_), d=r(N_, 12, B_), lx=r(N_, 12, B_),
               lxx=r(N_, 12, 12, B_))
    refs = dict(RbiR=r(N_ + 1, 3, 3), Rbip=r(N_ + 1, 3), Adb=r(N_ + 1, 6, 6),
                xib=r(N_ + 1, 6))
    consts = dict(W1N=r(6, 6), W2N=r(6, 6), fu2=r(6, nu), Luu=r(nu, nu))
    bargs = (lin, r(N_, nu, B_), r(N_ + 1, 3, 3, B_), r(N_ + 1, 3, B_), r(N_ + 1, 6, B_),
             refs, consts)
    launches = {k: w.launches for k, w in P.KERNELS.items()}
    with pytest.raises(ValueError, match=rf"1\.\.{_MAX_NU}$"):
        P.backward_lane(*bargs, glow=False)
    assert {k: w.launches for k, w in P.KERNELS.items()} == launches
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for unit, name, argtypes, hand in (("pipeline", "riccati", P._RICCATI_ARGS, False),
                                       ("pipeline_nu", "riccati_nu", P._RICCATI_NU_ARGS, True)):
        fn = _build.function(unit, name, "f64", argtypes)
        with pytest.raises(RuntimeError, match="riccati"):
            P._backward_kernel(fn, stream, *bargs, glow=False, luu_al=None, hand=hand)
    f32 = torch.float32
    lin_mx = dict(Fx=lin["Fx"], d=lin["d"], lx=lin["lx"], lxx32=lin["lxx"].to(f32))
    consts32 = dict(fu2=consts["fu2"].to(f32), Luu=consts["Luu"].to(f32))
    margs = (lin_mx, r(N_, nu, B_), r(12, B_), r(12, 12, B_, dtype=f32), consts, consts32)
    launches = {k: w.launches for k, w in DM.KERNELS.items()}
    with pytest.raises(ValueError, match=rf"1\.\.{_MAX_NU}$"):
        DM.backward_mx_lane(*margs, glow=False)
    assert {k: w.launches for k, w in DM.KERNELS.items()} == launches
    for unit, name in (("polish", "riccati"), ("polish_nu", "riccati_nu")):
        fn = _build.function(unit, name, "mx", DM._RICCATI_ARGS)
        with pytest.raises(RuntimeError, match="riccati_mx"):
            DM._backward_mx_kernel(fn, stream, *margs, glow=False, luu_al=None)


@pytest.mark.parametrize("fx_mode", ["df", "hybrid"])
def test_polish_solve_matches_plain_solve(cuda, fx_mode):
    """The mixed solve through the kernels against the plain solve: the
    same f32 phase up to the pipeline kernels' f32 agreement, then two
    polish iterations toward the same fixed point (us at 1e-5, a tenth of
    the accuracy gate; J at rtol 1e-6)."""
    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    mk = lambda plain: DM.MixedDFPipelineSolver(H, float(dyn.dt), 4, 2,
                                                fx_mode=fx_mode, plain=plain)
    out = mk(False).solve(dyn, cost, q0s, xi0s, us0)
    ref = mk(True).solve(dyn, cost, q0s, xi0s, us0)
    torch.testing.assert_close(join_us(out), join_us(ref), rtol=0, atol=1e-5)
    torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-6, atol=0)


def _so3_problem(pendulum, dtype, device, B_, H_=H):
    build = (so3_bench.build_pendulum_swingup80 if pendulum
             else so3_bench.build_so3_track249)
    dyn, cost, q0, xi0 = build(dtype, device, horizon=H_)
    q0s, xi0s = so3_bench.so3_batch(q0, xi0, B_, seed=1)
    return dyn, cost, q0s, xi0s, torch.zeros((B_, H_, 3), dtype=dtype, device=device)


@pytest.mark.parametrize("pendulum", [False, True], ids=["free_attitude", "pendulum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_so3_kernels_match_plain(cuda, dtype, pendulum):
    """B10-B12 on a real SO(3) iterate (2 iterations), within
    kernel_check.GATES["so3"]."""
    dyn, cost, q0s, xi0s, us0 = _so3_problem(pendulum, dtype, cuda, B)
    solver = S.SO3PipelineSolver(H, 2, float(dyn.dt), pendulum=pendulum)
    errs = so3_compare(so3_inputs(solver, dyn, cost, q0s, xi0s, us0),
                       dt=solver.dt, pendulum=pendulum)
    torch.cuda.synchronize()
    for name, e in errs.items():
        assert e["max_rel"] <= GATES["so3"][dtype][name], (name, e["per_output"])


@pytest.mark.parametrize("pendulum", [False, True], ids=["free_attitude", "pendulum"])
def test_so3_kernel_solve_matches_plain_solve(cuda, pendulum):
    """A kernel solve against the plain solve on the card, f64, B = 64."""
    dyn, cost, q0s, xi0s, us0 = _so3_problem(pendulum, torch.float64, cuda, 64)
    mk = lambda plain: S.SO3PipelineSolver(H, 4, float(dyn.dt), pendulum=pendulum,
                                           plain=plain)
    out = mk(False).solve(dyn, cost, q0s, xi0s, us0)
    ref = mk(True).solve(dyn, cost, q0s, xi0s, us0)
    torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
    torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-12, atol=0)


@pytest.mark.parametrize("pendulum", [False, True], ids=["free_attitude", "pendulum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_so3_b12_is_its_rollout_then_b10(cuda, dtype, pendulum):
    """B12's outputs equal, bit for bit, its rollout phase alone followed by
    B10 (`linearize_so3_lane`) on the new trajectory."""
    dyn, cost, q0s, xi0s, us0 = _so3_problem(pendulum, dtype, cuda, B)
    solver = S.SO3PipelineSolver(H, 2, float(dyn.dt), pendulum=pendulum)
    s = so3_inputs(solver, dyn, cost, q0s, xi0s, us0)
    args = (s["qR"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"], s["consts"])
    kw = dict(dt=solver.dt, pendulum=pendulum)
    oR, oxi, ou, new = S.rollout_linearize_so3_lane(*args, **kw)
    rR, rxi, ru, empty = S._rollout_so3_kernel(*S._launch("rollout_so3", s["us"]), *args,
                                               linearize=False, **kw)
    lin = S.linearize_so3_lane(rR, rxi, ru, s["refs"], s["consts"], **kw)
    torch.cuda.synchronize()
    assert empty == {}
    for name, a, b in (("qR", oR, rR), ("xi", oxi, rxi), ("us", ou, ru),
                       *((n, new[n], lin[n]) for n in S.LIN)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("pendulum", [False, True], ids=["free_attitude", "pendulum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_so3_kernels_match_plain_at_a_ragged_batch(cuda, dtype, pendulum):
    """B11 and B12 at B = 8191, a ragged last block of one warp (B11 and
    B12's rollout) and of 128 threads (B10), within
    kernel_check.GATES["so3"]."""
    dyn, cost, q0s, xi0s, us0 = _so3_problem(pendulum, dtype, cuda, 8191)
    solver = S.SO3PipelineSolver(H, 2, float(dyn.dt), pendulum=pendulum)
    errs = so3_compare(so3_inputs(solver, dyn, cost, q0s, xi0s, us0),
                       dt=solver.dt, pendulum=pendulum)
    torch.cuda.synchronize()
    for name in ("B11", "B12"):
        assert errs[name]["max_rel"] <= GATES["so3"][dtype][name], (name,
                                                                    errs[name]["per_output"])


def test_so3_launchers_refuse_what_they_do_not_take(cuda):
    """An empty horizon (N = 0) reaches B11's and B12's launchers, which
    return an error that the kernel calls raise, with no fallback to the
    plain versions."""
    N_, B_ = 0, 3
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64).to(cuda)
    lin = dict(Fx=r(N_, 6, 6, B_), fu2=r(N_, 3, 3, B_), d=r(N_, 6, B_), lx=r(N_, 6, B_),
               lxx=r(N_, 6, 6, B_), fqR=r(N_, 3, 3, B_), fxi=r(N_, 3, B_))
    refs = dict(RbiR=r(N_ + 1, 3, 3), xib=r(N_ + 1, 3))
    consts = {k: r(3, 3) for k in ("J", "Jinv", "W1", "W2", "W1vN", "W2vN", "W1hN", "W2hN",
                                   "Luu")}
    consts.update(mgr=r(3), mr=r(3))
    lu = r(N_, 3, B_)
    with pytest.raises(RuntimeError, match="riccati_so3"):
        S._backward_so3_kernel(*S._launch("riccati_so3", lu), lin, lu, r(N_ + 1, 3, 3, B_),
                               r(N_ + 1, 3, B_), refs, consts, pendulum=False)
    us = r(N_, 3, B_)
    with pytest.raises(RuntimeError, match="rollout_so3"):
        S._rollout_so3_kernel(*S._launch("rollout_so3", us), r(N_ + 1, 3, 3, B_),
                              r(N_ + 1, 3, B_), us, r(N_, 3, B_), r(N_, 3, 6, B_), lin, refs,
                              consts, dt=0.01, pendulum=False)


def _fast_case(kind, dtype, device, B_=B, H_=H, iterations=2):
    """(solver, params, q0s, xi0s, us0) of the generic fast tier: the free
    body on all three kernels (B1, B13, B14), the drone and the free
    attitude on B13."""
    if kind == "so3":
        model, params, q0, xi0 = so3_bench.so3_track249_model(dtype, device, horizon=H_)
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, B_, seed=1)
        nu, kw = 3, {}
    else:
        model, params, q0, xi0 = screw200_model(dtype, device, horizon=H_,
                                                drone=kind == "drone")
        q0s, xi0s = screw_batch(q0, xi0, B_, seed=1)
        nu = 4 if kind == "drone" else 6
        kw = {} if kind == "drone" else dict(pallas_rollout_dt=float(params["dyn"].dt),
                                             use_pallas_linearize=True)
    solver = FastBatchSolver(model, H_, iterations, **kw)
    return solver, params, q0s, xi0s, torch.zeros((B_, H_, nu), dtype=dtype, device=device)


@pytest.mark.parametrize("kind", ["free_body", "drone", "so3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fast_kernels_match_plain(cuda, dtype, kind):
    """B13 at (nx, nu) = (12, 6), (12, 4) and (6, 3), and B14 (free body), on
    a real FastBatchSolver iterate, within kernel_check.GATES["fast"]."""
    solver, params, *args = _fast_case(kind, dtype, cuda)
    errs = fast_compare(fast_inputs(solver, params, *args))
    torch.cuda.synchronize()
    assert set(errs) == ({"B13", "B14"} if kind == "free_body" else {"B13"})
    for name, e in errs.items():
        assert e["max_rel"] <= GATES["fast"][dtype][name], (name, e["per_output"])


@pytest.mark.parametrize("kind", ["free_body", "drone"])
def test_fast_kernel_solve_matches_plain_solve(cuda, kind):
    """A FastBatchSolver solve through the kernels against the plain solve on
    the card, f64."""
    solver, params, *args = _fast_case(kind, torch.float64, cuda, B_=64, iterations=3)
    cp = params["cost"]
    out = solver.solve(params, *args, cp.q_ref, cp.xi_ref)
    solver.plain = True
    ref = solver.solve(params, *args, cp.q_ref, cp.xi_ref)
    torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
    torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-12, atol=0)


# B13 on the group design at its edges: one problem, a ragged last block of
# 8 problems (7, 257), rows that are not 16-byte aligned (odd B), one, three
# and 200 stages, (nx, nu) = (12, 6) (free body) and (12, 4) (drone).
_FAST_EDGES = [pytest.param(B_, N_, id=f"B{B_}-N{N_}") for B_ in (1, 7, 257)
               for N_ in (1, 3, 200)]


@pytest.mark.parametrize("B_,N_", _FAST_EDGES)
@pytest.mark.parametrize("kind", ["free_body", "drone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_group_riccati_b13_edges(cuda, dtype, kind, B_, N_):
    solver, params, *args = _fast_case(kind, dtype, cuda, B_=B_, H_=N_)
    errs = fast_compare(fast_inputs(solver, params, *args))
    torch.cuda.synchronize()
    assert errs["B13"]["max_rel"] <= GATES["fast"][dtype]["B13"], errs["B13"]["per_output"]


# B13 at (6, 3) and B14, one thread per problem on blocks of one warp with
# each stage's inputs copied ahead, at their edges: one problem, a ragged
# block of one warp (31), a ragged second block (33), a ragged last block
# past B = 8192 (8193).  f64 takes 67,584 B (B13) and 79,872 B (B14) of
# shared memory, above the 48 KB a launch gets without the launchers' opt-in.
@pytest.mark.parametrize("B_", [1, 31, 33, 8193])
@pytest.mark.parametrize("name,kind", [("B13", "so3"), ("B14", "free_body")],
                         ids=["B13_6x3", "B14"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_ahead_b13_b14_edges(cuda, dtype, name, kind, B_):
    solver, params, *args = _fast_case(kind, dtype, cuda, B_=B_)
    errs = fast_compare(fast_inputs(solver, params, *args))
    torch.cuda.synchronize()
    assert errs[name]["max_rel"] <= GATES["fast"][dtype][name], errs[name]["per_output"]


def test_b13_refuses_a_shape_it_has_no_kernel_for(cuda):
    """A CUDA tensor at (nx, nu) = (13, 3) or (6, MAX_NU + 1), past the
    kernel's bounds of nx = 12 and nu = MAX_NU, raises ValueError naming
    both from backward_lane before any launch: no kernel, and no fallback to
    the plain version."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    N_, B_ = 2, 3
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float32).to(cuda)
    for nx, nu in ((13, 3), (6, _MAX_NU + 1)):
        launches = _b13_counts()
        with pytest.raises(ValueError, match=rf"\(nx, nu\) = \({nx}, {nu}\): the kernels "
                                             rf"take nx in 1\.\.12 and nu in 1\.\.{_MAX_NU}$"):
            RC.backward_lane(r(N_, nx, nx, B_), r(N_, nx, nu, B_), r(N_, nx, B_),
                             r(N_ + 1, nx, B_), r(N_, nu, B_), r(N_ + 1, nx, nx, B_),
                             r(N_, nu, nx, B_), r(N_, nu, nu, B_))
        assert _b13_counts() == launches


def _b13_counts():
    """The launches of B13's tuned, runtime-shape and large-nu instances."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    return (RC.backward_lane.launches, RC.backward_lane_any.launches,
            RC.backward_lane_any.nuL.launches)


# B13's large-nu instance through backward_lane: its first nu (12, 13), the
# rcs16 and rcs24 problems' (12, 16) and (12, 24), the largest (12, MAX_NU),
# a small state (6, 24); one problem, a ragged block of every block size
# (33, 257)
@pytest.mark.parametrize("B_", [1, 33, 257], ids=["B1", "B33", "B257"])
@pytest.mark.parametrize("nx,nu", [(12, 13), (12, 16), (12, 24), (12, _MAX_NU), (6, 24)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_large_nu_launches_its_instance(cuda, dtype, nx, nu, B_):
    """Past nu = 12 backward_lane launches B13's large-nu instance (counted
    in backward_lane_any.nuL, no other instance) and agrees with the plain
    version within the kernel's gate, N = 20."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    s = riccati_inputs(nx, nu, B_, 20, dtype, cuda, seed=nx + nu)
    args = tuple(s[n] for n in READS["B13"])
    before = _b13_counts()
    kern = RC.backward_lane(*args)
    assert _b13_counts() == (before[0], before[1], before[2] + 1)
    plain = RC.backward_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= GATES["fast"][dtype]["B13"], (name, rel_err(a, b))


def _rcs_model(nu, device, H_, box=None):
    """(model, params, q0s, xi0s, us0) of the rigid body driven through 16
    thrusters (rcs16) or `nu_pu(nu)`, f64, B = 33, H_ stages; with ``box``
    its tracking cost in the AL cost of the input box +-box, and the
    constraint after them."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    Pu = al_bench.rcs16_pu() if nu == 16 else al_bench.nu_pu(nu)
    model, params, q0, xi0 = al_bench.screw200_nu_model(Pu, torch.float64, device, horizon=H_)
    q0s, xi0s = screw_batch(q0, xi0, 33, seed=1)
    us0 = torch.zeros((33, H_, nu), dtype=torch.float64, device=device)
    if box is None:
        return model, params, q0s, xi0s, us0
    con = cs.input_box(12, nu)
    model, _ = make_model(dynamics.rigid_body_dynamics()._replace(nu=nu),
                          costs.al_cost(costs.tracking_cost(SE3, nu), con), params["dyn"], None)
    bound = lambda v: torch.tensor(v, dtype=torch.float64, device=device)
    al = costs.al_init_params(params["cost"], cs.input_box_params(bound(-box), bound(box), nu),
                              H_, 2 * nu, mu0=1e-2, dtype=torch.float64)
    return model, {"dyn": params["dyn"], "cost": al}, q0s, xi0s, us0, con


@pytest.mark.parametrize("nu", [16, _MAX_NU], ids=lambda nu: f"nu{nu}")
def test_fast_solver_large_nu_kernel_solve_matches_plain_solve(cuda, nu):
    """A FastBatchSolver solve at nu = 16 (rcs16) and MAX_NU, B = 33,
    N = 40, 3 iterations, through B13's large-nu instance (3 launches, no
    other B13 instance) against the plain solve on the card, f64."""
    model, params, *args = _rcs_model(nu, cuda, 40)
    cp = params["cost"]
    solver = FastBatchSolver(model, 40, 3)
    before = _b13_counts()
    out = solver.solve(params, *args, cp.q_ref, cp.xi_ref)
    assert _b13_counts() == (before[0], before[1], before[2] + 3)
    solver.plain = True
    ref = solver.solve(params, *args, cp.q_ref, cp.xi_ref)
    torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
    torch.testing.assert_close(out.J_opt, ref.J_opt, rtol=1e-12, atol=0)


def test_al_fast_large_nu_kernel_solve_matches_plain_solve(cuda):
    """`ALFastSolver` at nu = 16 (rcs16) with the input box +-3 (it binds),
    B = 33, N = 20, through B13's large-nu instance against the plain
    solve on the card, f64: us at 1e-9, the same outer iterations."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import (
        ALFastSolver,
    )

    model, params, q0s, xi0s, us0, con = _rcs_model(16, cuda, 20, box=3.0)
    solver = ALFastSolver(FastBatchSolver(model, 20, 4), con, tol_constr=1e-2)
    before = _b13_counts()
    out = solver.solve(params, q0s, xi0s, us0, n_al_iters=6)
    moved = _b13_counts()
    assert moved[:2] == before[:2] and moved[2] > before[2]
    solver.inner.plain = True
    ref = solver.solve(params, q0s, xi0s, us0, n_al_iters=6)
    assert (out.us.abs() >= 3.0 - 1e-3).sum() >= 4, "the box does not bind"
    torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-9)
    assert out.outer_iterations == ref.outer_iterations


# B13's runtime-shape instance through backward_lane: a small shape on its
# (12, 6) instance, the (12, 3) solve's batch (128 blocks), more Q_uu rows
# than V_xx rows on its (12, 12) instance
@pytest.mark.parametrize("nx,nu,B_", [(6, 2, 33), (12, 3, 1024), (3, 12, 33)],
                         ids=["6x2-B33", "12x3-B1024", "3x12-B33"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_launches_at_a_shape_no_tuned_instance_has(cuda, dtype, nx, nu, B_):
    """(nx, nu) = (6, 2), (12, 3) and (3, 12) through backward_lane launch
    B13's runtime-shape instance and agree with the plain version within
    the kernel's gate."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    s = riccati_inputs(nx, nu, B_, 20, dtype, cuda)
    args = tuple(s[n] for n in READS["B13"])
    launches = (RC.backward_lane.launches, RC.backward_lane_any.launches)
    kern = RC.backward_lane(*args)
    assert (RC.backward_lane.launches, RC.backward_lane_any.launches) == (
        launches[0], launches[1] + 1)
    plain = RC.backward_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= GATES["fast"][dtype]["B13"], name


@pytest.mark.parametrize("nx,nu", [(12, 6), (12, 4), (6, 3)], ids=["12x6", "12x4", "6x3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_tuned_shapes_launch_their_instances(cuda, dtype, nx, nu):
    """At the tuned shapes backward_lane launches its tuned instance, never
    the runtime-shape one, and agrees with the plain version."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    assert (nx, nu) in RC.SHAPES
    s = riccati_inputs(nx, nu, 33, 20, dtype, cuda)
    args = tuple(s[n] for n in READS["B13"])
    launches = (RC.backward_lane.launches, RC.backward_lane_any.launches)
    kern = RC.backward_lane(*args)
    assert (RC.backward_lane.launches, RC.backward_lane_any.launches) == (
        launches[0] + 1, launches[1])
    plain = RC.backward_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= GATES["fast"][dtype]["B13"], name


# B3 (rollout phase, then B1's kernel on the new trajectory) and B4 at their
# edges: one problem, a ragged block of one warp (7), a ragged second block
# (33), a ragged fifth block (129), a ragged last block (257), nu = 6 and 4,
# gravity off and on (nu = 6 with gravity: the rigid body).
@pytest.mark.parametrize("B_", [1, 7, 33, 129, 257])
@pytest.mark.parametrize("gravity", [False, True], ids=["no_gravity", "gravity"])
@pytest.mark.parametrize("nu", [6, 4], ids=["nu6", "nu4_drone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rollout_b3_b4_edges(cuda, dtype, nu, gravity, B_):
    dyn, cost, q0s, xi0s, us0 = _problem(dtype, cuda, nu == 4, B_)
    if nu == 6 and gravity:
        dyn = rigid_body_params(dyn.J, dyn.dt)
    solver = P.PipelineSolver(H, 2, float(dyn.dt), gravity=gravity,
                              exact_gravity_jacobian=gravity)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0)
    errs = compare(s, dt=solver.dt, gravity=gravity, exact_grav=gravity)
    torch.cuda.synchronize()
    for name in ("B3", "B4"):
        assert errs[name]["max_rel"] <= GATES[dtype][name], (name, errs[name]["per_output"])


def test_fast_and_rollout_launchers_refuse_what_they_do_not_take(cuda):
    """(nx, nu) = (12, 5) reaches B13's launcher and nu = MAX_NU + 1 the
    rollout's (the kernel calls' shape checks pass), which return an error
    that the kernel calls raise, with no fallback to the plain versions."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    N_, B_, nx, nu = 2, 3, 12, 5
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64).to(cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fn = _build.function("fast", "fast_riccati", "f64", RC._ARGS)
    with pytest.raises(RuntimeError, match="fast_riccati"):
        RC._backward_kernel(fn, stream, r(N_, nx, nx, B_), r(N_, nx, nu, B_), r(N_, nx, B_),
                            r(N_ + 1, nx, B_), r(N_, nu, B_), r(N_ + 1, nx, nx, B_),
                            r(N_, nu, nx, B_), r(N_, nu, nu, B_))
    nu = _MAX_NU + 1
    lin = dict(d=r(N_, 12, B_), fqR=r(N_, 3, 3, B_), fqp=r(N_, 3, B_), fxi=r(N_, 6, B_))
    consts = dict(J=r(6, 6), Jinv=r(6, 6), Pu=r(6, nu), mg=0.0)
    for unit, name in (("pipeline", "rollout"), ("pipeline_nu", "rollout_nu")):
        fn = _build.function(unit, name, "f64", P._ROLLOUT_ARGS)
        with pytest.raises(RuntimeError, match="rollout"):
            P._rollout_kernel(fn, stream, r(N_ + 1, 3, 3, B_), r(N_ + 1, 3, B_),
                              r(N_ + 1, 6, B_), r(N_, nu, B_), r(N_, nu, B_),
                              r(N_, nu, 12, B_), lin, None, consts, dt=0.01, gravity=False,
                              exact_grav=False, fused=False)


# -- the constrained path and the MPC drivers: kernel path against plain path
# on the same card inputs, B = 33 (a ragged one-warp block), N = 16 -----------

AL_B, AL_BOX = 33, 9.0


def _al_case(dtype, device):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import build_al1400

    params, _, _, q0, xi0, _, _ = build_al1400(dtype, H, device)
    q0s, xi0s = screw_batch(q0, xi0, AL_B, seed=1)
    return params["dyn"], params["cost"], q0s, xi0s, torch.zeros((AL_B, H, 6), dtype=dtype,
                                                                 device=device)


def _al_solve(args, plain, iterations=4, n_al_iters=10):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
        ALPipelineSolver,
    )

    pipe = P.PipelineSolver(H, iterations, 0.01, plain=plain)
    return ALPipelineSolver(pipe, -AL_BOX, AL_BOX).solve(*args, n_al_iters=n_al_iters)


def test_al_pipeline_kernel_matches_plain(cuda):
    """f64: the same outer count and convergence, controls at 1e-9."""
    args = _al_case(torch.float64, cuda)
    kern, plain = _al_solve(args, False), _al_solve(args, True)
    assert kern.outer_iterations == plain.outer_iterations > 1
    assert kern.constr_converged == plain.constr_converged
    assert (kern.us.abs() >= AL_BOX - 1e-3).any(), "the box does not bind"
    assert (kern.us - plain.us).abs().max().item() <= 1e-9
    assert (kern.lmbd - plain.lmbd).abs().max().item() <= 1e-9 * max(1.0, plain.lmbd.abs().max().item())


def test_al_polish_device_kernel_matches_plain(cuda):
    """The device-ascent polish of one f32 AL result with B5-B9 and with
    their plain versions: the controls at the kernel-vs-plain polish
    agreement of chip_smoke.py (1e-5), the f32 multipliers alike."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
        al_polish_device,
    )

    dyn, cost, q0s, xi0s, us0 = _al_case(torch.float64, cuda)
    res = _al_solve((dyn, cost, q0s.float(), xi0s.float(), us0.float()), False, 8)
    outs = []
    for plain in (False, True):
        mx = DM.MixedDFPipelineSolver(H, 0.01, f32_iterations=8, df_iterations=2, plain=plain)
        outs.append(al_polish_device(mx, {"dyn": dyn, "cost": cost}, -AL_BOX, AL_BOX, res,
                                     q0s, xi0s))
    (ok, lk, ik), (op, lp, ip) = outs
    assert (join_us(ok) - join_us(op)).abs().max().item() <= 1e-5
    assert ((lk - lp).abs().max() / lp.abs().max().clamp(min=1.0)).item() <= 1e-5
    assert torch.equal(ik == 0, ip == 0)


@pytest.mark.parametrize("constrained", [False, True], ids=["unconstrained", "box"])
def test_mpc_kernel_matches_plain(cuda, constrained):
    """Both MPC drivers, f64, T = 3 steps of 3 iterations (the box driver:
    +-5 and 2 AL outers a step, from the AL problem's offset start)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc

    T_ = 3
    model, params, q0, xi0 = screw200_model(torch.float64, cuda, horizon=T_ + H)
    cp = params["cost"]
    start = (q0, xi0) if constrained else (cp.q_ref[0], cp.xi_ref[0])
    q0s, xi0s = screw_batch(*start, AL_B, seed=4)
    res = []
    for plain in (False, True):
        pipe = P.PipelineSolver(H, 3, 0.01, plain=plain)
        run = (mpc.make_closed_loop_batch_constrained(pipe, model, T_, -5.0, 5.0, n_al_iters=2)
               if constrained else mpc.make_closed_loop_batch(pipe, model, T_))
        out = run(params["dyn"], cp, q0s, xi0s)
        res.append(out[0] if constrained else out)
    assert (res[0].us - res[1].us).abs().max().item() <= 1e-9
    assert (res[0].qs - res[1].qs).abs().max().item() <= 1e-9
    if constrained:
        assert res[0].us.abs().max().item() == 5.0


# -- the full-precision refiner and the anchored tier (kernel path against the
# plain path on the same card inputs) --------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_pipeline_warm_start_f64_kernel_matches_plain(cuda, fused):
    """`PipelineSolver.solve_lane`'s warm start in fp64 (the refiner's
    phase: B1, B2, B3 or B4 in fp64) from an f32 handoff: the kernel path
    against the plain one, controls at 1e-9; and the refiner's launches."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
    )

    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, cuda, False)
    handoff = DFPipelineSolver(H, 0.01, f32_iterations=4)._solve_f32(dyn, cost, q0s, xi0s, us0)
    init = tuple(x.double() for x in handoff)
    outs = [P.PipelineSolver(H, 3, 0.01, fused=fused, plain=plain).solve_lane(
        dyn, cost, None, None, None, init=init) for plain in (False, True)]
    assert outs[0]["us"].dtype == torch.float64
    assert (outs[0]["us"] - outs[1]["us"]).abs().max().item() <= 1e-9
    assert (outs[0]["J"] - outs[1]["J"]).abs().max().item() <= 1e-9 * outs[1]["J"].abs().max()
    for w in P.KERNELS.values():
        w.launches = 0
    DFPipelineSolver(H, 0.01, f32_iterations=4, df_iterations=3, fused=fused).solve(
        dyn, cost, q0s, xi0s, us0)
    launches = {k: w.launches for k, w in P.KERNELS.items()}
    want = (dict(B1=2, B2=8, B3=7, B4=0) if fused else dict(B1=5, B2=8, B3=4, B4=3))
    assert launches == {**{k: 0 for k in P.KERNELS}, **want}, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_anchored_inputs(cuda, dtype):
    """B13 at (12, 6) on a real anchored iterate (near-identity poses)
    against its plain version, at the fast tier's gates."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
        anchored_inputs,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.anchored import (
        AnchoredFastSolver,
        build_anchored,
    )

    dyn, cost, q0s, xi0s, us0 = _problem(torch.float64, "cpu", False)
    Q = torch.block_diag(cost.Q1, cost.Q2)
    P_ = torch.block_diag(cost.P1, cost.P2)
    prob = build_anchored(dyn.J, dyn.dt, Q, cost.R, P_, cost.q_ref, cost.xi_ref, dtype=dtype,
                          device=cuda)
    q0_locs = torch.linalg.inv(cost.q_ref[0])[None] @ q0s
    s = anchored_inputs(AnchoredFastSolver(prob, H, 2), q0_locs.to(cuda), xi0s.to(cuda),
                        us0.to(cuda))
    err = fast_compare(s)["B13"]
    assert err["max_rel"] <= GATES["fast"][dtype]["B13"], err


@pytest.mark.parametrize("ls", [False, True], ids=["full-step", "line-search"])
def test_lie_ilqr_b14_rollout_matches_loop(cuda, ls):
    """`LieILQR` with its MS rollout on B14 (f64) against the same solver's
    loop over stages on the card: the same iterations, controls at 1e-9."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )

    model, params, q0, xi0 = screw200_model(torch.float64, cuda, horizon=H)
    q0s, xi0s = screw_batch(q0, xi0, AL_B, seed=1)
    us0 = torch.zeros((AL_B, H, 6), dtype=torch.float64, device=cuda)
    # with the line search, to 1e-5: below, its accept test stalls on roundoff
    cfg = SolverConfig(N=H, tol_grad_norm=1e-5 if ls else 1e-8, max_iterations=30,
                       line_search=ls)
    loop = LieILQR(model, cfg).solve(params, (q0s, xi0s), us0)
    kern = LieILQR(model, cfg, pallas_rollout_dt=0.01).solve(params, (q0s, xi0s), us0)
    assert kern.iteration.tolist() == loop.iteration.tolist()
    assert (kern.us - loop.us).abs().max().item() <= 1e-9


def test_lie_ilqr_graphed_rollout_matches_eager(cuda):
    """`LieILQR`'s nonlinear rollout replayed from its CUDA graph
    (`solvers/graph.GraphCache`) against the same loop run eagerly, on the
    drone (no kernel) in f64, twice with different inputs (the replay reads
    the new ones), every candidate of the alpha ladder at once."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
        alpha_ladder,
    )

    model, params, q0, xi0 = screw200_model(torch.float64, cuda, horizon=H, drone=True)
    solver = LieILQR(model, SolverConfig(N=H, multiple_shooting=True))
    alphas = alpha_ladder(5, device=cuda)
    for seed in (1, 2):
        q0s, xi0s = screw_batch(q0, xi0, AL_B, seed=seed)
        st = solver.init_state(params, (q0s, xi0s),
                               torch.zeros((AL_B, H, 4), dtype=torch.float64, device=cuda))
        gen = torch.Generator(device=cuda).manual_seed(seed)
        st = st._replace(k=1e-2 * torch.randn(st.k.shape, generator=gen, device=cuda,
                                              dtype=torch.float64),
                         K=1e-2 * torch.randn(st.K.shape, generator=gen, device=cuda,
                                              dtype=torch.float64))
        lin = solver._linearize(params, st.qs, st.xis, st.us)
        graphed = solver._rollout_nonlinear(params, lin, st, alphas)
        eager = solver._rollout_loop(params, lin["d"], lin["fq"], lin["fxi"], st.qs, st.xis,
                                     st.us, st.k, st.K, alphas)
        for a, b in zip(graphed, eager):
            assert (a - b).abs().max().item() <= 1e-12
    assert len(solver._graphs._entries) == 1


def test_ilqr_graphed_loops_match_eager(cuda):
    """The Euclidean `ILQR`'s linearization, backward pass, gradient norm
    and candidate rollout replayed from their CUDA graphs against the same
    functions run eagerly (the cartpole, N = 40, f64), on two iterates."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import cartpole

    solver = cartpole.build(N=40, dtype=torch.float64, device=cuda)
    x0 = torch.tensor([[9.0, 0.0, 0.0, 0.0]] * 3, dtype=torch.float64, device=cuda)
    st = solver.init_state(x0, 0.1 * torch.ones((3, 40, 1), dtype=torch.float64, device=cuda))
    alphas = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64, device=cuda)
    for _ in range(2):
        lin = solver._linearize(st.xs, st.us)
        eager_lin = solver._linearize_ops(st.xs, st.us)
        pairs = [(tuple(lin[k] for k in sorted(lin)), tuple(eager_lin[k] for k in sorted(lin))),
                 (solver._backward(lin, st.mu), solver._backward_loop(lin, st.mu)),
                 ((solver._grad_norm(lin),), (solver._grad_norm_loop(lin),))]
        k, K = pairs[1][0]
        pairs.append((solver._control(st.xs, st.us, k, K, alphas),
                      solver._control_loop(st.xs, st.us, k, K, alphas)))
        for graphed, eager in pairs:
            for a, b in zip(graphed, eager):
                assert (a - b).abs().max().item() <= 1e-12
        st = solver._step(st, torch.ones(3, dtype=torch.bool, device=cuda))
    # linearize, backward, grad_norm, and control with these 3 alphas and
    # with the 10 of fit
    assert len(solver._graphs._entries) == 5


def test_graph_cache_follows_closure_tensors(cuda):
    """A graph reads a closure tensor where it lay at capture: changed in
    place, the replay sees the new values; replaced, the function is
    captured anew.  The cache keeps its `MAX_ENTRIES` newest graphs."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.graph import (
        MAX_ENTRIES,
        GraphCache,
    )

    class Holder:
        def __init__(self):
            self.w = torch.ones(3, dtype=torch.float64, device=cuda)

        def f(self, x):
            return x * self.w

    h, cache = Holder(), GraphCache()
    x = torch.arange(3, dtype=torch.float64, device=cuda)
    assert torch.equal(cache("f", h.f, x), x)
    h.w.mul_(2.0)
    assert torch.equal(cache("f", h.f, x), 2.0 * x) and len(cache._entries) == 1
    h.w = torch.full((3,), 5.0, dtype=torch.float64, device=cuda)
    assert torch.equal(cache("f", h.f, x), 5.0 * x) and len(cache._entries) == 2
    for n in range(MAX_ENTRIES + 2):
        assert torch.equal(cache(f"f{n}", h.f, x + n), 5.0 * (x + n))
    assert len(cache._entries) == MAX_ENTRIES


# The runtime-nu instances of B1-B6 (csrc/nu.cuh) at every nu from 1 to 12
# (nu = 6 and 4 on the tuned instances) and the large-nu ones
# (csrc/nu_large.cuh) at 13, 16, 24 and MAX_NU, on the rigid body driven
# through `al_bench.nu_pu(nu)` (g = 0, the rigid-body family), against their
# plain versions; the launches go to the runtime-nu and large-nu instances,
# never to a plain version.
NUS = [pytest.param(nu, id=f"nu{nu}") for nu in (*range(1, 13), 13, 16, 24, _MAX_NU)]


def _nu_problem(dtype, device, nu, B_=B, H_=H):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.nu_pu(nu), dtype, device,
                                                    horizon=H_)
    q0s, xi0s = screw_batch(q0, xi0, B_, seed=1)
    return dyn, cost, q0s, xi0s, torch.zeros((B_, H_, nu), dtype=dtype, device=device)


def _counts():
    return {k: w.launches for k, w in {**P.KERNELS, **DM.KERNELS}.items()}


def _launched(before, keys, nu):
    """The kernels of ``keys`` launched since ``before``: the tuned ones' at
    nu = 6 and 4, the runtime-nu instances' at every other nu up to 12, the
    large-nu ones' past it, and no other of B1-B6."""
    now = _counts()
    moved = {k for k in now if now[k] != before[k]}
    want = {k if nu in (4, 6) else k + ("nu" if nu <= 12 else "nuL") for k in keys}
    assert want <= moved and not (moved - want) & set(
        [k for k in now if k.endswith(("nu", "nuL"))] + ["B1", "B2", "B3", "B4", "B5", "B6"]
    ), moved


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_nu_kernels_match_plain(cuda, dtype, nu):
    """B1-B4 (B2 also with the AL diagonal) at nu on a real iterate, each
    within its gate of the plain version (kernel_check.GATES)."""
    dyn, cost, q0s, xi0s, us0 = _nu_problem(dtype, cuda, nu)
    solver = P.PipelineSolver(H, 2, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    before = _counts()
    errs = compare(s, dt=solver.dt, gravity=True, exact_grav=True)
    torch.cuda.synchronize()
    _launched(before, ("B1", "B2", "B3", "B4"), nu)
    for name, e in errs.items():
        assert e["max_rel"] <= GATES[dtype][name], (name, e["per_output"])


# B2's and B5's large-nu Riccati step (csrc/riccati_large.cuh: a lane holds
# rows l, l + 16, l + 32 of the nu-long arrays) at its first nu, the rcs16 and
# rcs24 problems', the lane edges (17: a second row on lane 0 alone; 32: two
# rows on every lane; 33: a third row on lane 0, the pitch nu | 1 equal to
# nu) and MAX_NU; B = 33 ends a ragged last block of 8 and of 4 problems.
@pytest.mark.parametrize("nu", [13, 16, 17, 24, 32, 33, _MAX_NU], ids=lambda nu: f"nu{nu}")
def test_large_riccati_kernels_match_plain(cuda, nu):
    """B2nuL (f32, fp64) and B5nuL, with and without the AL diagonal, on a
    real iterate at B = 33, N = 8, each output within its gate of the plain
    version, one launch of the large-nu instance a call and none of
    another."""
    B_, H_ = 33, 8
    for dtype in (torch.float32, torch.float64):
        dyn, cost, q0s, xi0s, us0 = _nu_problem(dtype, cuda, nu, B_, H_)
        solver = P.PipelineSolver(H_, 2, float(dyn.dt), gravity=True,
                                  exact_gravity_jacobian=True)
        s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
        bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
        for al in (None, s["luu_al"]):
            before = _counts()
            kern = P.backward_lane(*bargs, glow=True, luu_al=al)
            torch.cuda.synchronize()
            now = _counts()
            assert {k for k in now if now[k] != before[k]} == {"B2nuL"}
            assert now["B2nuL"] == before["B2nuL"] + 1
            plain = P.backward_plain(*bargs, glow=True, luu_al=al)
            for name, a, b in zip(("k", "K", "gvec", "lN"), kern, plain, strict=True):
                assert rel_err(a, b) <= GATES[dtype]["B2"], (dtype, name, al is not None)
    dyn, cost, q0s, xi0s, us0 = _nu_problem(torch.float64, cuda, nu, B_, H_)
    mx = DM.MixedDFPipelineSolver(H_, float(dyn.dt), 7, 1, gravity=True,
                                  exact_gravity_jacobian=True)
    s = polish_inputs(mx, dyn, cost, q0s, xi0s, us0, luu_al=True)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    for al in (None, s["luu_al"]):
        before = _counts()
        kern = DM.backward_mx_lane(*bargs, glow=True, luu_al=al)
        torch.cuda.synchronize()
        now = _counts()
        assert {k for k in now if now[k] != before[k]} == {"B5nuL"}
        plain = DM.backward_mx_plain(*bargs, glow=True, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec"), kern, plain, strict=True):
            assert rel_err(a, b) <= GATES["mixed"]["B5"][name], (name, al is not None)


# B3's and B4's large-nu rollout (csrc/nu_large.cuh): u_t, k_t and K_t
# copied ahead into a feedback slot of the thread's shared-memory column
# while the whole batch is resident at once, else read from device memory;
# the feedback in feedback_pu's order either way.  Over a whole horizon,
# where a drift of the feedback would show.
@pytest.mark.parametrize("nu", [13, 16, _MAX_NU], ids=lambda nu: f"nu{nu}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_large_rollout_kernels_match_plain_over_n200(cuda, dtype, nu):
    """B3nuL and B4nuL on a real iterate at B = 33, N = 200, each output
    within its gate of the plain version, one launch of each a call, each
    on the feedback slot's instance."""
    B_, H_ = 33, 200
    dyn, cost, q0s, xi0s, us0 = _nu_problem(dtype, cuda, nu, B_, H_)
    solver = P.PipelineSolver(H_, 2, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0)
    pairs = calls(s, dt=solver.dt, gravity=True, exact_grav=True)
    for name in ("B3", "B4"):
        before, inst = _counts(), P.rollout_large_instances(dtype)
        kern = pairs[name][0]()
        torch.cuda.synchronize()
        now = _counts()
        assert {k for k in now if now[k] != before[k]} == {name + "nuL"}
        assert now[name + "nuL"] == before[name + "nuL"] + 1
        assert P.rollout_large_instances(dtype) == {"slot": inst["slot"] + 1,
                                                   "device": inst["device"]}
        plain = pairs[name][1]()
        for out, a, b in zip(OUTPUTS[name], _flat(kern), _flat(plain), strict=True):
            assert rel_err(a, b) <= GATES[dtype][name], (name, out, rel_err(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_large_rollout_device_memory_feedback_matches_plain(cuda, dtype):
    """One problem past what the feedback slot's blocks hold at once (nu =
    MAX_NU: f32 three blocks of 32 problems an SM, fp64 one) the large-nu
    rollout reads its feedback from device memory: B3nuL and B4nuL at N =
    40 each take that instance and are within their gates of the plain
    versions."""
    occ = _build.function("pipeline_nu", "occupancy_nu", _build.suffix(dtype),
                          [_build.INT] * 3)(1, _MAX_NU, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert occ > 0
    B_, H_ = occ * sms * 32 + 1, 40
    dyn, cost, q0s, xi0s, us0 = _nu_problem(dtype, cuda, _MAX_NU, B_, H_)
    solver = P.PipelineSolver(H_, 2, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, kernel_gains=True)
    pairs = calls(s, dt=solver.dt, gravity=True, exact_grav=True)
    for name in ("B3", "B4"):
        inst = P.rollout_large_instances(dtype)
        kern = pairs[name][0]()
        assert P.rollout_large_instances(dtype) == {"slot": inst["slot"],
                                                   "device": inst["device"] + 1}
        plain = pairs[name][1]()
        torch.cuda.synchronize()
        for out, a, b in zip(OUTPUTS[name], _flat(kern), _flat(plain), strict=True):
            assert rel_err(a, b) <= GATES[dtype][name], (name, out, rel_err(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_large_nu_matches_plain_over_n200(cuda, dtype):
    """B13's large-nu instance at (12, 16), B = 33, N = 200 against the
    plain version within the kernel's gate."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC

    s = riccati_inputs(12, 16, 33, 200, dtype, cuda, seed=28)
    args = tuple(s[n] for n in READS["B13"])
    before = _b13_counts()
    kern = RC.backward_lane(*args)
    assert _b13_counts() == (before[0], before[1], before[2] + 1)
    plain = RC.backward_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= GATES["fast"][dtype]["B13"], (name, rel_err(a, b))


@pytest.mark.parametrize("B_", [1, 257], ids=["B1", "B257"])
@pytest.mark.parametrize("nu", [1, 5, 12, 13, _MAX_NU], ids=lambda nu: f"nu{nu}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_nu_kernels_edges(cuda, dtype, nu, B_):
    """B1-B4 at nu with one problem and with a ragged last block of every
    block size (257), one stage, against their plain versions."""
    dyn, cost, q0s, xi0s, us0 = _nu_problem(dtype, cuda, nu, B_, 1)
    solver = P.PipelineSolver(1, 2, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    errs = compare(s, dt=solver.dt, gravity=True, exact_grav=True)
    torch.cuda.synchronize()
    for name, e in errs.items():
        assert e["max_rel"] <= GATES[dtype][name], (name, e["per_output"])


@pytest.mark.parametrize("nu", NUS)
def test_nu_polish_kernels_match_plain(cuda, nu):
    """B5 (and its AL branch), B6 and B7-B9 at nu on a real polish iterate,
    each output within its gate (kernel_check.GATES["mixed"])."""
    dyn, cost, q0s, xi0s, us0 = _nu_problem(torch.float64, cuda, nu)
    solver = DM.MixedDFPipelineSolver(H, float(dyn.dt), 7, 1, gravity=True,
                                      exact_gravity_jacobian=True)
    s = polish_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)
    before = _counts()
    errs = polish_compare(s, solver)
    torch.cuda.synchronize()
    _launched(before, ("B5", "B6"), nu)
    for name, e in errs.items():
        for out, err in e["per_output"].items():
            assert err <= GATES["mixed"][name][out], (name, out, err)


@pytest.mark.parametrize("nu", [1, 3, 5, 8, 12, 16, _MAX_NU], ids=lambda nu: f"nu{nu}")
def test_nu_solvers_match_plain_solves(cuda, nu):
    """`PipelineSolver` (f64, fused and unfused), `MixedDFPipelineSolver` and
    `DFPipelineSolver` at nu through the kernels against the same solvers
    on their plain versions: us at 1e-10 (f64 pipeline) and 1e-5 (the
    polish, a tenth of its accuracy gate: its f32 phases differ by f32
    rounding), the refiner's fp64 phase from one f32 handoff at 1e-9."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
    )

    dyn, cost, q0s, xi0s, us0 = _nu_problem(torch.float64, cuda, nu)
    grav = dict(gravity=True, exact_gravity_jacobian=True)
    dt = float(dyn.dt)
    ref = P.PipelineSolver(H, 3, dt, plain=True, **grav).solve(dyn, cost, q0s, xi0s, us0)
    for fused in (True, False):
        out = P.PipelineSolver(H, 3, dt, fused=fused, **grav).solve(dyn, cost, q0s, xi0s, us0)
        torch.testing.assert_close(out.us, ref.us, rtol=0, atol=1e-10)
    mk = lambda plain: DM.MixedDFPipelineSolver(H, dt, 4, 2, plain=plain, **grav)
    out, ref = (mk(plain).solve(dyn, cost, q0s, xi0s, us0) for plain in (False, True))
    torch.testing.assert_close(join_us(out), join_us(ref), rtol=0, atol=1e-5)
    mk = lambda plain: DFPipelineSolver(H, dt, 4, 2, plain=plain, **grav)
    handoff = mk(False)._solve_f32(dyn, cost, q0s, xi0s, us0)
    out, ref = (mk(plain).refine(dyn, cost, *handoff) for plain in (False, True))
    torch.testing.assert_close(join_us(out), join_us(ref), rtol=0, atol=1e-9)


@pytest.mark.parametrize("nu", [0, _MAX_NU + 1], ids=lambda nu: f"nu{nu}")
def test_nu_wrappers_refuse_out_of_range(cuda, nu):
    """On CUDA tensors at nu = 0 and MAX_NU + 1 B1's, B4's and B6's wrappers
    raise ValueError naming the range before any launch."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape, dtype=torch.float64: torch.randn(
        shape, generator=g, dtype=torch.float64).to(dtype=dtype, device=cuda)
    N_, B_ = 2, 3
    traj = (r(N_ + 1, 3, 3, B_), r(N_ + 1, 3, B_), r(N_ + 1, 6, B_), r(N_, nu, B_))
    lin = dict(d=r(N_, 12, B_), fqR=r(N_, 3, 3, B_), fqp=r(N_, 3, B_), fxi=r(N_, 6, B_))
    before = _counts()
    for call in (lambda: P.linearize_lane(*traj, {}, {}, dt=0.01),
                 lambda: P.rollout_lane(*traj, r(N_, nu, B_), r(N_, nu, 12, B_), lin, {},
                                        dt=0.01),
                 lambda: DM.rollout_mx_lane(*traj, r(N_, nu, B_, dtype=torch.float32),
                                            r(N_, nu, 12, B_, dtype=torch.float32), lin, {},
                                            dt=0.01, gravity=False)):
        with pytest.raises(ValueError, match=rf"1\.\.{_MAX_NU}$"):
            call()
    assert _counts() == before
