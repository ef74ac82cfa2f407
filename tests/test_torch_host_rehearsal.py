"""The kernels that exchange through shared memory or copy their inputs
ahead into it, run by the host rehearsal (tests/host_rehearsal.py: each
thread of a block an OS thread, real barriers, the block's shared memory a
buffer) on CPU tensors, against their plain versions: the group Riccati
kernels B2 and B5 (csrc/riccati_group.cuh); B13 and B14 (csrc/fast.cu: at
nx = 12 B13 is the same group design on a dense step, at (6, 3) a thread
per problem copying stage t - 1's inputs ahead, at any other shape the
group design with the shape a runtime argument, past nu = 12 its
large-nu instance (csrc/fast_large.cuh: Q_uu, its factor and the solves
in the group's shared memory, the problems a block chosen at launch), and
B14 a thread per problem copying stage t + 1's inputs ahead); the rollouts B4 and B3
(csrc/pipeline.cu: a thread per problem copying stage t + 1's inputs
ahead, then, for B3, B1's kernel on the new trajectory), the SO(3)
kernels B11 and B12 (csrc/so3.cu: a thread per problem copying the next
stage's inputs ahead, then, for B12, B10's kernel on the new trajectory),
and the instances of B1-B6 at any other input dimension nu up to 12
(csrc/nu.cuh) and past it (csrc/nu_large.cuh: B2 and B5 a cooperative
Cholesky factorization in the group's shared memory, csrc/riccati_large.cuh),
built as csrc/pipeline_nu.cu and csrc/polish_nu.cu.

This runs the kernels' own code, barriers and shared-memory exchanges
included, which the CPU tests of the wrappers cannot reach (on CPU tensors
they take the plain versions).  Without FMA contraction and with the
host's libm it agrees with the card to rounding: within the card's gates
(kernel_check.GATES).  Skips where no host C++20 compiler is found.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

import host_rehearsal as HR
from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    FAST_OUTPUTS,
    FAST_ROLLOUT_ARGS,
    GATES,
    OUTPUTS,
    POLISH_OUTPUTS,
    READS,
    SO3_OUTPUTS,
    _flat,
    fast_inputs,
    kernel_inputs,
    polish_inputs,
    rel_err,
    riccati_inputs,
    so3_inputs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    drone_params,
    rigid_body_params,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import rollout as RO
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import FastBatchSolver
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import linearize as LN
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    build_screw200_nu,
    nu_pu,
    rcs12_pu,
    screw200_model,
    screw_batch,
)

UNITS = {"f32": ("pipeline", "f32", "float"), "f64": ("pipeline", "f64", "double"),
         "mx": ("polish", "mx", None), "fast_f32": ("fast", "f32", "float"),
         "fast_f64": ("fast", "f64", "double"), "so3_f32": ("so3", "f32", "float"),
         "so3_f64": ("so3", "f64", "double"), "nu_f32": ("pipeline_nu", "f32", "float"),
         "nu_f64": ("pipeline_nu", "f64", "double"), "nu_mx": ("polish_nu", "mx", None)}
# one problem in a block of 8; a ragged last block with rows not 16-byte
# aligned (odd B)
SHAPES = [pytest.param(1, 1, id="B1-N1"), pytest.param(9, 3, id="B9-N3")]
# B2 also at B = 33 and 129: a ragged last block whichever of 8, 4 or 32
# problems a block the group kernels take
B2_SHAPES = SHAPES + [pytest.param(33, 3, id="B33-N3"), pytest.param(129, 3, id="B129-N3")]
MODELS = [pytest.param(False, id="nu6"), pytest.param(True, id="nu4_drone")]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if HR.compiler() is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_rehearsal")
    jobs = {k: HR.build(*u, out) for k, u in UNITS.items()}
    for k, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {UNITS[k][0]}.cu failed:\n{log}")
    return {k: lib for k, (lib, _) in jobs.items()}


def _problem(dtype, drone, B, N):
    dyn, cost, q0, xi0 = build_screw200(dtype, "cpu", horizon=N)
    nu = 6
    if drone:
        dyn = drone_params(dyn.J, dyn.dt)
        cost.R = 1e-2 * torch.eye(4, dtype=dtype)
        nu = 4
    q0s, xi0s = screw_batch(q0, xi0, B, seed=1)
    return dyn, cost, q0s, xi0s, torch.zeros((B, N, nu), dtype=dtype)


@pytest.mark.parametrize("B,N", B2_SHAPES)
@pytest.mark.parametrize("drone", MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b2_host_rehearsal_matches_plain(libs, dtype, drone, B, N):
    """B2's kernel, with and without the AL diagonal on Q_uu, within its
    card gate of the plain version; f64 to 1e-12."""
    args = _problem(dtype, drone, B, N)
    solver = P.PipelineSolver(N, 2, float(args[0].dt), gravity=drone,
                              exact_gravity_jacobian=drone)
    s = kernel_inputs(solver, *args, luu_al=True)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[tag], f"riccati_{tag}", P._RICCATI_ARGS)
    bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
    gate = {torch.float32: GATES[torch.float32]["B2"], torch.float64: 1e-12}[dtype]
    for al in (None, s["luu_al"]):
        kern = P._backward_kernel(fn, None, *bargs, glow=drone, luu_al=al)
        plain = P.backward_plain(*bargs, glow=drone, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec", "lN"), kern, plain, strict=True):
            assert rel_err(a, b) <= gate, (name, al is not None, rel_err(a, b))


@pytest.mark.parametrize("B,N", SHAPES)
@pytest.mark.parametrize("drone", MODELS)
def test_b5_host_rehearsal_matches_plain(libs, drone, B, N):
    """B5's kernel, with and without the AL diagonal, within its per-output
    card gates of the plain version."""
    args = _problem(torch.float64, drone, B, N)
    solver = DM.MixedDFPipelineSolver(N, float(args[0].dt), 2, 1, gravity=drone,
                                      exact_gravity_jacobian=drone)
    s = polish_inputs(solver, *args, luu_al=True)
    fn = HR.function(libs["mx"], "riccati_mx", DM._RICCATI_ARGS)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    for al in (None, s["luu_al"]):
        kern = DM._backward_mx_kernel(fn, None, *bargs, glow=drone, luu_al=al)
        plain = DM.backward_mx_plain(*bargs, glow=drone, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec"), kern, plain, strict=True):
            gate = GATES["mixed"]["B5"][name]
            assert rel_err(a, b) <= gate, (name, al is not None, rel_err(a, b))


def test_riccati_launchers_refuse_what_they_do_not_take(libs):
    """nu = 13 reaches B2's and B5's launchers (the kernel calls' shape
    checks pass), which return an error that the kernel calls raise."""
    N, B, nu = 2, 3, 13
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    lin = dict(Fx=r(N, 12, 12, B), d=r(N, 12, B), lx=r(N, 12, B), lxx=r(N, 12, 12, B))
    refs = dict(RbiR=r(N + 1, 3, 3), Rbip=r(N + 1, 3), Adb=r(N + 1, 6, 6), xib=r(N + 1, 6))
    consts = dict(W1N=r(6, 6), W2N=r(6, 6), fu2=r(6, nu), Luu=r(nu, nu))
    fn = HR.function(libs["f64"], "riccati_f64", P._RICCATI_ARGS)
    with pytest.raises(RuntimeError, match="riccati"):
        P._backward_kernel(fn, None, lin, r(N, nu, B), r(N + 1, 3, 3, B), r(N + 1, 3, B),
                           r(N + 1, 6, B), refs, consts, glow=False, luu_al=None)
    f32 = torch.float32
    lin_mx = dict(Fx=lin["Fx"], d=lin["d"], lx=lin["lx"], lxx32=lin["lxx"].to(f32))
    fn = HR.function(libs["mx"], "riccati_mx", DM._RICCATI_ARGS)
    with pytest.raises(RuntimeError, match="riccati_mx"):
        DM._backward_mx_kernel(fn, None, lin_mx, r(N, nu, B), r(12, B), r(12, 12, B).to(f32),
                               consts, dict(fu2=consts["fu2"].to(f32), Luu=consts["Luu"].to(f32)),
                               glow=False, luu_al=None)


# B13 at nx = 12 (a group per problem): one problem in a block of 8 groups,
# a ragged block of 7, a ragged second block (9); at (6, 3) (a thread per
# problem on one-warp blocks) also a ragged second block of one warp (33).
FAST_CASES = [pytest.param(kind, B_, N_, id=f"{kind}-B{B_}-N{N_}")
              for kind in ("free_body", "drone", "so3")
              for B_ in (1, 7, 9) + ((33,) if kind == "so3" else ()) for N_ in (1, 3)]


def _fast_inputs(kind, dtype, B, N):
    """A real FastBatchSolver iterate (2 iterations, plain) of the free body
    (12, 6; with B14's inputs: its solver rolls out as B14 does), the drone
    (12, 4) or the free attitude (6, 3)."""
    kw = {}
    if kind == "so3":
        model, params, q0, xi0 = so3_bench.so3_track249_model(dtype, "cpu", horizon=N)
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed=1)
    else:
        model, params, q0, xi0 = screw200_model(dtype, "cpu", horizon=N,
                                                drone=kind == "drone")
        q0s, xi0s = screw_batch(q0, xi0, B, seed=1)
        if kind == "free_body":
            kw = dict(pallas_rollout_dt=float(params["dyn"].dt), use_pallas_linearize=True)
    us0 = torch.zeros((B, N, model.nu), dtype=dtype)
    return fast_inputs(FastBatchSolver(model, N, 2, **kw), params, q0s, xi0s, us0)


@pytest.mark.parametrize("kind,B,N", FAST_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_host_rehearsal_matches_plain(libs, dtype, kind, B, N):
    """B13 at (12, 6), (12, 4) and (6, 3) within its card gate of the plain
    version (f32); f64 to 1e-12."""
    s = _fast_inputs(kind, dtype, B, N)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"fast_{tag}"], f"fast_riccati_{tag}", RC._ARGS)
    args = tuple(s[n] for n in READS["B13"])
    kern, plain = RC._backward_kernel(fn, None, *args), RC.backward_plain(*args)
    gate = GATES["fast"][dtype]["B13"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))


# B13 at shapes no tuned instance has (the runtime-shape instance, a group
# per problem, its (12, 6) instance for nu <= 6 and its (12, 12) one past
# it): the one-lane group and 1 x 1 Cholesky (1, 1), more Q_uu rows than
# V_xx rows (3, 12), nu just past the smaller instance (12, 7), the largest
# (12, 12); a ragged block (9), a ragged seventeenth block (129).
ANY_SHAPES = [pytest.param(nx, nu, id=f"{nx}x{nu}")
              for nx, nu in ((1, 1), (3, 12), (6, 2), (9, 3), (12, 3), (12, 7), (12, 12))]


@pytest.mark.parametrize("B", [9, 129], ids=["B9", "B129"])
@pytest.mark.parametrize("nx,nu", ANY_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_any_shape_host_rehearsal_matches_plain(libs, dtype, nx, nu, B):
    """B13's runtime-shape instance at (1, 1), (3, 12), (6, 2), (9, 3),
    (12, 3), (12, 7) and (12, 12) on a random problem
    (`kernel_check.riccati_inputs`, N = 3) within its card gate of the
    plain version (f32); f64 to 1e-12."""
    s = riccati_inputs(nx, nu, B, 3, dtype, seed=nx + nu)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"fast_{tag}"], f"fast_riccati_any_{tag}", RC._ARGS)
    args = tuple(s[n] for n in READS["B13"])
    kern, plain = RC._backward_kernel(fn, None, *args), RC.backward_plain(*args)
    gate = GATES["fast"][dtype]["B13"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))


def test_b13_any_shape_launcher_refuses_past_its_bound(libs):
    """(nx, nu) = (13, 3) and (6, MAX_NU + 1) reach the runtime-shape
    instance's launcher (the call's shape checks pass), which returns an
    error that the kernel call raises; (6, 13), past the runtime-shape
    instance's 12, launches (the large-nu instance)."""
    fn = HR.function(libs["fast_f64"], "fast_riccati_any_f64", RC._ARGS)
    for nx, nu in ((13, 3), (6, _build.MAX_NU + 1)):
        s = riccati_inputs(nx, nu, 3, 2)
        with pytest.raises(RuntimeError, match="fast_riccati"):
            RC._backward_kernel(fn, None, *(s[n] for n in READS["B13"]))
    s = riccati_inputs(6, 13, 3, 2)
    args = tuple(s[n] for n in READS["B13"])
    for a, b in zip(RC._backward_kernel(fn, None, *args), RC.backward_plain(*args), strict=True):
        assert rel_err(a, b) <= 1e-12


# B13's large-nu instance (csrc/fast_large.cuh, a group per problem, Q_uu,
# its factor and the solves in the group's shared memory, 8, 4 or 2 problems
# a block) through the entry backward_lane_any calls: its first nu (12, 13),
# the rcs16 and rcs24 problems' (12, 16) and (12, 24), the largest
# (12, MAX_NU), a small state (6, 24); a ragged block of every block size
# (3), a ragged seventeenth or ninth block (33).
LARGE_SHAPES = [pytest.param(nx, nu, id=f"{nx}x{nu}")
                for nx, nu in ((12, 13), (12, 16), (12, 24), (12, _build.MAX_NU), (6, 24))]
# and the lane edges of the step (a lane holds rows l, l + 16, l + 32 of
# the nu-long arrays: 17, 32, 33), states padded to 12 (3, 13) and
# (6, MAX_NU); one problem (B = 1)
LARGE_SHAPES += [pytest.param(nx, nu, id=f"{nx}x{nu}")
                 for nx, nu in ((12, 17), (12, 32), (12, 33), (3, 13), (6, _build.MAX_NU))]


@pytest.mark.parametrize("B", [1, 3, 33], ids=["B1", "B3", "B33"])
@pytest.mark.parametrize("nx,nu", LARGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b13_large_host_rehearsal_matches_plain(libs, dtype, nx, nu, B):
    """B13's large-nu instance on a random problem
    (`kernel_check.riccati_inputs`, N = 3) within its card gate of the
    plain version (f32); f64 to 1e-12."""
    s = riccati_inputs(nx, nu, B, 3, dtype, seed=nx + nu)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"fast_{tag}"], f"fast_riccati_any_{tag}", RC._ARGS)
    args = tuple(s[n] for n in READS["B13"])
    kern, plain = RC._backward_kernel(fn, None, *args), RC.backward_plain(*args)
    gate = GATES["fast"][dtype]["B13"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(FAST_OUTPUTS["B13"], kern, plain, strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))


@pytest.mark.parametrize("nx,nu", [(1, 1), (3, 12), (12, 6)], ids=["1x1", "3x12", "12x6"])
def test_b13_large_entry_takes_any_nu(libs, nx, nu):
    """The direct entry `fast_riccati_large` (what scripts time) launches the
    large-nu instance at shapes the other instances take, within 1e-12 of
    the plain version in f64; past (12, MAX_NU) it refuses."""
    fn = HR.function(libs["fast_f64"], "fast_riccati_large_f64", RC._ARGS)
    s = riccati_inputs(nx, nu, 9, 3, seed=nx + nu)
    args = tuple(s[n] for n in READS["B13"])
    for a, b in zip(RC._backward_kernel(fn, None, *args), RC.backward_plain(*args), strict=True):
        assert rel_err(a, b) <= 1e-12
    for nx_, nu_ in ((13, nu), (nx, _build.MAX_NU + 1)):
        s = riccati_inputs(nx_, nu_, 3, 2)
        with pytest.raises(RuntimeError, match="fast_riccati"):
            RC._backward_kernel(fn, None, *(s[n] for n in READS["B13"]))


@pytest.mark.parametrize("nx,nu", [(13, 3), (6, _build.MAX_NU + 1), (6, 13)],
                         ids=["13x3", f"6x{_build.MAX_NU + 1}", "6x13"])
def test_b13_wrapper_refuses_past_its_bounds_before_any_launch(nx, nu):
    """On a device tensor (here the meta device: no data, no kernel) past
    nx = 12 or nu = MAX_NU, backward_lane raises ValueError naming both
    bounds before it looks for a kernel and counts no launch; at (6, 13)
    (the large-nu instance's) it gets as far as the device."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
        KERNELS as FK,
    )

    m = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")
    N, B = 2, 3
    args = (m(N, nx, nx, B), m(N, nx, nu, B), m(N, nx, B), m(N + 1, nx, B), m(N, nu, B),
            m(N + 1, nx, nx, B), m(N, nu, nx, B), m(N, nu, nu, B))
    before = {k: w.launches for k, w in FK.items()}
    if (nx, nu) == (6, 13):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            RC.backward_lane(*args)
    else:
        with pytest.raises(ValueError, match=rf"\({nx}, {nu}\): the kernels take nx in 1\.\.12 "
                                             rf"and nu in 1\.\.{_build.MAX_NU}$"):
            RC.backward_lane(*args)
    assert {k: w.launches for k, w in FK.items()} == before


@pytest.mark.parametrize("B", [1, 9, 33], ids=["B1", "B9", "B33"])
@pytest.mark.parametrize("N", [1, 3], ids=["N1", "N3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b14_host_rehearsal_matches_plain(libs, dtype, N, B):
    """B14 on the free body (one problem in a block of 32 threads, a ragged
    one (9), a ragged second block (33)) within its card gate of the plain
    version (f32); f64 to 1e-12."""
    s = _fast_inputs("free_body", dtype, B, N)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"fast_{tag}"], f"fast_rollout_{tag}", RO._ARGS)
    args = tuple(s[n] for n in FAST_ROLLOUT_ARGS)
    kern = RO._rollout_kernel(fn, None, *args, dt=s["dt"])
    plain = RO.rollout_plain(*args, dt=s["dt"])
    gate = GATES["fast"][dtype]["B14"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(FAST_OUTPUTS["B14"], kern, plain, strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))


# B3/B4: one problem in a block of 32 threads, a ragged one (9), a ragged
# second block (33), a ragged third block (65)
ROLL_SHAPES = [pytest.param(B_, N_, id=f"B{B_}-N{N_}")
               for B_, N_ in ((1, 1), (9, 3), (33, 3), (65, 3))]


@pytest.mark.parametrize("B,N", ROLL_SHAPES)
@pytest.mark.parametrize("gravity", [False, True], ids=["no_gravity", "gravity"])
@pytest.mark.parametrize("drone", MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b3_b4_host_rehearsal_match_plain(libs, dtype, drone, gravity, B, N):
    """B3 (the rollout phase, then B1's kernel on its trajectory) and B4
    (the rollout alone), nu = 6 and 4, gravity off and on (nu = 6 with
    gravity: the rigid body), within their card gates of the plain versions
    (f32); f64 to 1e-12."""
    dyn, cost, q0s, xi0s, us0 = _problem(dtype, drone, B, N)
    if gravity and not drone:
        dyn = rigid_body_params(dyn.J, dyn.dt)
    solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=gravity,
                              exact_gravity_jacobian=gravity)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, us0)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[tag], f"rollout_{tag}", P._ROLLOUT_ARGS)
    traj = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"])
    kw = dict(dt=solver.dt, gravity=gravity)
    for name, fused in (("B3", True), ("B4", False)):
        kern = P._rollout_kernel(fn, None, *traj, s["refs"], s["consts"], fused=fused,
                                 exact_grav=gravity, **kw)
        if fused:
            plain = P.rollout_linearize_plain(*traj, s["refs"], s["consts"],
                                              exact_grav=gravity, **kw)
        else:
            kern, plain = kern[:4], P.rollout_plain(*traj, s["consts"], **kw)
        gate = GATES[dtype][name] if dtype == torch.float32 else 1e-12
        for out, a, b in zip(OUTPUTS[name], _flat(kern), _flat(plain), strict=True):
            assert rel_err(a, b) <= gate, (name, out, rel_err(a, b))


def test_fast_and_rollout_launchers_refuse_what_they_do_not_take(libs):
    """(nx, nu) = (12, 5) reaches B13's launcher and nu = 13 the rollout's
    (the calls' shape checks pass), which return an error that the kernel
    calls raise."""
    N, B, nx = 2, 3, 12
    nu = 5
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    fn = HR.function(libs["fast_f64"], "fast_riccati_f64", RC._ARGS)
    with pytest.raises(RuntimeError, match="fast_riccati"):
        RC._backward_kernel(fn, None, r(N, nx, nx, B), r(N, nx, nu, B), r(N, nx, B),
                            r(N + 1, nx, B), r(N, nu, B), r(N + 1, nx, nx, B),
                            r(N, nu, nx, B), r(N, nu, nu, B))
    nu = 13
    lin = dict(d=r(N, 12, B), fqR=r(N, 3, 3, B), fqp=r(N, 3, B), fxi=r(N, 6, B))
    consts = dict(J=r(6, 6), Jinv=r(6, 6), Pu=r(6, nu), mg=0.0)
    fn = HR.function(libs["f64"], "rollout_f64", P._ROLLOUT_ARGS)
    with pytest.raises(RuntimeError, match="rollout"):
        P._rollout_kernel(fn, None, r(N + 1, 3, 3, B), r(N + 1, 3, B), r(N + 1, 6, B),
                          r(N, nu, B), r(N, nu, B), r(N, nu, 12, B), lin, None, consts,
                          dt=0.01, gravity=False, exact_grav=False, fused=False)


# The runtime-nu instances of B1-B6 (csrc/nu.cuh: pipeline_nu.cu, polish_nu.cu)
# at nu = 1, 3, 5, 8 and 12 (the instance of maximum 6, and of 12), on the
# rigid body driven through `al_bench.nu_pu(nu)` (g = 0, the rigid-body
# family); N = 3; the group kernels at B = 9 (a ragged second block of 8),
# the rollouts at B = 33 (a ragged second block of 32).
NUS = [pytest.param(nu, id=f"nu{nu}") for nu in (1, 3, 5, 8, 12)]


def _nu_problem(dtype, nu, B, N):
    dyn, cost, q0, xi0 = build_screw200_nu(nu_pu(nu), dtype, "cpu", horizon=N)
    q0s, xi0s = screw_batch(q0, xi0, B, seed=1)
    return dyn, cost, q0s, xi0s, torch.zeros((B, N, nu), dtype=dtype)


def _nu_inputs(dtype, nu, B, N):
    """A real pipeline iterate (2 iterations, plain) at nu, and its solver."""
    args = _nu_problem(dtype, nu, B, N)
    solver = P.PipelineSolver(N, 2, float(args[0].dt), gravity=True,
                              exact_gravity_jacobian=True)
    return kernel_inputs(solver, *args, luu_al=True), solver


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b2_nu_host_rehearsal_matches_plain(libs, dtype, nu):
    """B2's runtime-nu instance, with and without the AL diagonal on Q_uu,
    within its card gate of the plain version (f32); f64 to 1e-12."""
    s, _ = _nu_inputs(dtype, nu, 9, 3)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"nu_{tag}"], f"riccati_nu_{tag}", P._RICCATI_NU_ARGS)
    bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
    gate = {torch.float32: GATES[torch.float32]["B2"], torch.float64: 1e-12}[dtype]
    for al in (None, s["luu_al"]):
        kern = P._backward_kernel(fn, None, *bargs, glow=True, luu_al=al, hand=True)
        plain = P.backward_plain(*bargs, glow=True, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec", "lN"), kern, plain, strict=True):
            assert rel_err(a, b) <= gate, (name, al is not None, rel_err(a, b))


def test_b2_nu_f64_hand_off_stays_in_its_own_array(libs):
    """fp64 B2 at nu = 1, N = 1: K holds 12 values a problem, fewer than the
    48 of the terminal quadratization's hand-off, which therefore has an
    array of its own; the memory after K (a guard) stays untouched, and K
    matches the plain version."""
    s, _ = _nu_inputs(torch.float64, 1, 9, 1)
    fn = HR.function(libs["nu_f64"], "riccati_nu_f64", P._RICCATI_NU_ARGS)
    N, nu, B = s["lu"].shape
    guard = 1000
    K_mem = torch.full((N * nu * 12 * B + guard,), 7.25, dtype=torch.float64)

    def fn_guarded(*args):  # K (argument 19) into the guarded memory
        args = list(args)
        args[19] = ctypes.c_void_p(K_mem.data_ptr())
        return fn(*args)

    bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
    P._backward_kernel(fn_guarded, None, *bargs, glow=True, luu_al=None, hand=True)
    plain = P.backward_plain(*bargs, glow=True)
    assert (K_mem[N * nu * 12 * B:] == 7.25).all()
    assert rel_err(K_mem[:N * nu * 12 * B].reshape(plain[1].shape), plain[1]) <= 1e-12


@pytest.mark.parametrize("nu", NUS)
def test_b5_nu_host_rehearsal_matches_plain(libs, nu):
    """B5's runtime-nu instance, with and without the AL diagonal, within its
    per-output card gates of the plain version."""
    N, B = 3, 9
    args = _nu_problem(torch.float64, nu, B, N)
    solver = DM.MixedDFPipelineSolver(N, float(args[0].dt), 2, 1, gravity=True,
                                      exact_gravity_jacobian=True)
    s = polish_inputs(solver, *args, luu_al=True)
    fn = HR.function(libs["nu_mx"], "riccati_nu_mx", DM._RICCATI_ARGS)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    for al in (None, s["luu_al"]):
        kern = DM._backward_mx_kernel(fn, None, *bargs, glow=True, luu_al=al)
        plain = DM.backward_mx_plain(*bargs, glow=True, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec"), kern, plain, strict=True):
            gate = GATES["mixed"]["B5"][name]
            assert rel_err(a, b) <= gate, (name, al is not None, rel_err(a, b))
    # B6's runtime-nu instance on the same iterate, every output at its gate
    fn = HR.function(libs["nu_mx"], "rollout_nu_mx", DM._ROLLOUT_ARGS)
    rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["consts"])
    kw = dict(dt=solver.dt, gravity=True)
    kern = DM._rollout_mx_kernel(fn, None, *rargs, **kw)
    plain = DM.rollout_mx_plain(*rargs, **kw)
    flat = lambda out: [*out[:4], *out[4]]
    for name, a, b in zip(POLISH_OUTPUTS["B6"], flat(kern), flat(plain), strict=True):
        assert rel_err(a, b) <= GATES["mixed"]["B6"][name], (name, rel_err(a, b))


@pytest.mark.parametrize("nu", [pytest.param(nu, id=f"nu{nu}") for nu in (4, 6)])
def test_b5_nu_instance_is_its_tuned_twin_on_a_rough_iterate(libs, nu):
    """At nu = 4 and 6, which both instances of B5 take, the runtime-nu one
    gives the tuned one's k, K and gvec bit for bit on the same iterate,
    here a rough one (2 f32 iterations on the first nu thrusters of
    `rcs12_pu`: under-actuated), where both stay far from plain's gvec (the
    card gate's small-residual premise fails: scripts/nu_instances.py)."""
    N, B = 3, 9
    dyn, cost, q0, xi0 = build_screw200_nu(rcs12_pu()[:, :nu], torch.float64, "cpu",
                                           horizon=N)
    q0s, xi0s = screw_batch(q0, xi0, B, seed=1)
    solver = DM.MixedDFPipelineSolver(N, float(dyn.dt), 2, 1, gravity=True,
                                      exact_gravity_jacobian=True)
    s = polish_inputs(solver, dyn, cost, q0s, xi0s,
                      torch.zeros((B, N, nu), dtype=torch.float64), luu_al=True)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    tuned = HR.function(libs["mx"], "riccati_mx", DM._RICCATI_ARGS)
    nu_fn = HR.function(libs["nu_mx"], "riccati_nu_mx", DM._RICCATI_ARGS)
    for al in (None, s["luu_al"]):
        a = DM._backward_mx_kernel(tuned, None, *bargs, glow=True, luu_al=al)
        b = DM._backward_mx_kernel(nu_fn, None, *bargs, glow=True, luu_al=al)
        for name, x, y in zip(("k", "K", "gvec"), a, b, strict=True):
            assert torch.equal(x, y), (name, al is not None, rel_err(x, y))


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b1_b3_b4_nu_host_rehearsal_match_plain(libs, dtype, nu):
    """B1's, B3's and B4's runtime-nu instances within their card gates of
    the plain versions (f32); f64 to 1e-12; no launch of the large-nu
    rollout."""
    s, solver = _nu_inputs(dtype, nu, 33, 3)
    tag = "f32" if dtype == torch.float32 else "f64"
    gate = lambda name: GATES[dtype][name] if dtype == torch.float32 else 1e-12
    traj = (s["qR"], s["qp"], s["xi"], s["us"])
    lkw = dict(dt=solver.dt, gravity=True, exact_grav=True)
    fn = HR.function(libs[f"nu_{tag}"], f"linearize_nu_{tag}", LN._LINEARIZE_ARGS)
    kern = LN._linearize_kernel(fn, None, *traj, s["refs"], s["consts"], **lkw)
    plain = LN.linearize_plain(*traj, s["refs"], s["consts"], **lkw)
    for out, a, b in zip(OUTPUTS["B1"], _flat(kern), _flat(plain), strict=True):
        assert rel_err(a, b) <= gate("B1"), ("B1", out, rel_err(a, b))
    fn = HR.function(libs[f"nu_{tag}"], f"rollout_nu_{tag}", P._ROLLOUT_ARGS)
    count = HR.function(libs[f"nu_{tag}"], f"rollout_large_launches_{tag}", [ctypes.c_int])
    rargs = (*traj, s["k"], s["K"], s["lin"])
    kw = dict(dt=solver.dt, gravity=True)
    for name, fused in (("B3", True), ("B4", False)):
        before = count(0), count(1)
        kern = P._rollout_kernel(fn, None, *rargs, s["refs"], s["consts"], fused=fused,
                                 exact_grav=True, **kw)
        assert (count(0), count(1)) == before  # no large-nu rollout launched
        if fused:
            plain = P.rollout_linearize_plain(*rargs, s["refs"], s["consts"],
                                              exact_grav=True, **kw)
        else:
            kern, plain = kern[:4], P.rollout_plain(*rargs, s["consts"], **kw)
        for out, a, b in zip(OUTPUTS[name], _flat(kern), _flat(plain), strict=True):
            assert rel_err(a, b) <= gate(name), (name, out, rel_err(a, b))


# The large-nu instances of B1-B6 (csrc/nu_large.cuh, csrc/riccati_large.cuh)
# at nu = 13, 16, 24 and _build.MAX_NU on the rigid body driven through
# `al_bench.nu_pu(nu)`; N = 3; B = 3 (one block) and 33 (a ragged last block
# of every block size: 8 and 4 problems for B2 and B5, 32 and 128 for the
# rollouts and B1).  B2 and B5 also at the lane edges of the Riccati step
# (a lane holds rows l, l + 16, l + 32 of the nu-long arrays): nu = 17 (a
# second row on lane 0 alone), 32 (two rows on every lane) and 33 (a third
# row on lane 0; the pitch nu | 1 equal to nu).
NUS_LARGE = [pytest.param(nu, id=f"nu{nu}") for nu in (13, 16, 24, _build.MAX_NU)]
NUS_LARGE_STEP = NUS_LARGE + [pytest.param(nu, id=f"nu{nu}") for nu in (17, 32, 33)]
B_LARGE = [pytest.param(3, id="B3"), pytest.param(33, id="B33")]
# the rollouts also at one problem, and past the host's 64 resident
# problems (tests/cuda_host: two SMs), where the rollout reads its feedback
# from device memory instead of its shared-memory slot
B_LARGE_ROLLOUT = [pytest.param(1, id="B1")] + B_LARGE + [pytest.param(65, id="B65")]
HOST_RESIDENT = 64


@pytest.mark.parametrize("B", B_LARGE)
@pytest.mark.parametrize("nu", NUS_LARGE_STEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b2_large_host_rehearsal_matches_plain(libs, dtype, nu, B):
    """B2's large-nu instance (its cooperative Cholesky between the group's
    barriers), with and without the AL diagonal on Q_uu, within its card
    gate of the plain version (f32); f64 to 1e-12."""
    s, _ = _nu_inputs(dtype, nu, B, 3)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"nu_{tag}"], f"riccati_nu_{tag}", P._RICCATI_NU_ARGS)
    bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
    gate = {torch.float32: GATES[torch.float32]["B2"], torch.float64: 1e-12}[dtype]
    for al in (None, s["luu_al"]):
        kern = P._backward_kernel(fn, None, *bargs, glow=True, luu_al=al, hand=True)
        plain = P.backward_plain(*bargs, glow=True, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec", "lN"), kern, plain, strict=True):
            assert rel_err(a, b) <= gate, (name, al is not None, rel_err(a, b))


@pytest.mark.parametrize("B", B_LARGE)
@pytest.mark.parametrize("nu", NUS_LARGE_STEP)
def test_b5_b6_large_host_rehearsal_match_plain(libs, nu, B):
    """B5's and B6's large-nu instances, B5 with and without the AL
    diagonal, within their per-output card gates of the plain versions."""
    N = 3
    args = _nu_problem(torch.float64, nu, B, N)
    solver = DM.MixedDFPipelineSolver(N, float(args[0].dt), 2, 1, gravity=True,
                                      exact_gravity_jacobian=True)
    s = polish_inputs(solver, *args, luu_al=True)
    fn = HR.function(libs["nu_mx"], "riccati_nu_mx", DM._RICCATI_ARGS)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    for al in (None, s["luu_al"]):
        kern = DM._backward_mx_kernel(fn, None, *bargs, glow=True, luu_al=al)
        plain = DM.backward_mx_plain(*bargs, glow=True, luu_al=al)
        for name, a, b in zip(("k", "K", "gvec"), kern, plain, strict=True):
            assert rel_err(a, b) <= GATES["mixed"]["B5"][name], (name, al is not None,
                                                                 rel_err(a, b))
    fn = HR.function(libs["nu_mx"], "rollout_nu_mx", DM._ROLLOUT_ARGS)
    rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["consts"])
    kw = dict(dt=solver.dt, gravity=True)
    kern = DM._rollout_mx_kernel(fn, None, *rargs, **kw)
    plain = DM.rollout_mx_plain(*rargs, **kw)
    flat = lambda out: [*out[:4], *out[4]]
    for name, a, b in zip(POLISH_OUTPUTS["B6"], flat(kern), flat(plain), strict=True):
        assert rel_err(a, b) <= GATES["mixed"]["B6"][name], (name, rel_err(a, b))


@pytest.mark.parametrize("B", B_LARGE_ROLLOUT)
@pytest.mark.parametrize("nu", NUS_LARGE_STEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b1_b3_b4_large_host_rehearsal_match_plain(libs, dtype, nu, B):
    """B1's, B3's and B4's large-nu instances within their card gates of the
    plain versions (f32); f64 to 1e-12.  Each rollout launch takes the
    feedback slot's instance while the batch is resident at once, the
    device-memory one past it (the entry's per-instance launch counts)."""
    s, solver = _nu_inputs(dtype, nu, B, 3)
    tag = "f32" if dtype == torch.float32 else "f64"
    gate = lambda name: GATES[dtype][name] if dtype == torch.float32 else 1e-12
    traj = (s["qR"], s["qp"], s["xi"], s["us"])
    lkw = dict(dt=solver.dt, gravity=True, exact_grav=True)
    fn = HR.function(libs[f"nu_{tag}"], f"linearize_nu_{tag}", LN._LINEARIZE_ARGS)
    kern = LN._linearize_kernel(fn, None, *traj, s["refs"], s["consts"], **lkw)
    plain = LN.linearize_plain(*traj, s["refs"], s["consts"], **lkw)
    for out, a, b in zip(OUTPUTS["B1"], _flat(kern), _flat(plain), strict=True):
        assert rel_err(a, b) <= gate("B1"), ("B1", out, rel_err(a, b))
    fn = HR.function(libs[f"nu_{tag}"], f"rollout_nu_{tag}", P._ROLLOUT_ARGS)
    count = HR.function(libs[f"nu_{tag}"], f"rollout_large_launches_{tag}", [ctypes.c_int])
    rargs = (*traj, s["k"], s["K"], s["lin"])
    kw = dict(dt=solver.dt, gravity=True)
    for name, fused in (("B3", True), ("B4", False)):
        before = count(0), count(1)
        kern = P._rollout_kernel(fn, None, *rargs, s["refs"], s["consts"], fused=fused,
                                 exact_grav=True, **kw)
        slot = B <= HOST_RESIDENT
        assert (count(0), count(1)) == (before[0] + (not slot), before[1] + slot)
        if fused:
            plain = P.rollout_linearize_plain(*rargs, s["refs"], s["consts"],
                                              exact_grav=True, **kw)
        else:
            kern, plain = kern[:4], P.rollout_plain(*rargs, s["consts"], **kw)
        for out, a, b in zip(OUTPUTS[name], _flat(kern), _flat(plain), strict=True):
            assert rel_err(a, b) <= gate(name), (name, out, rel_err(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_large_instances_at_nu12_match_plain(libs, dtype):
    """The large-nu instances of B2, B4, B5 and B6 launched at nu = 12 through
    their direct entries (`riccati_large`, `rollout_large`: what
    scripts/nu_instances.py times against the runtime-nu instances of
    maximum 12) within their gates of the plain versions (f32; f64 1e-12)."""
    s, solver = _nu_inputs(dtype, 12, 9, 3)
    tag = "f32" if dtype == torch.float32 else "f64"
    gate = lambda name: GATES[dtype][name] if dtype == torch.float32 else 1e-12
    bargs = (s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"])
    fn = HR.function(libs[f"nu_{tag}"], f"riccati_large_{tag}", P._RICCATI_NU_ARGS)
    kern = P._backward_kernel(fn, None, *bargs, glow=True, luu_al=None, hand=True)
    for a, b in zip(kern, P.backward_plain(*bargs, glow=True), strict=True):
        assert rel_err(a, b) <= gate("B2")
    fn = HR.function(libs[f"nu_{tag}"], f"rollout_large_{tag}", P._ROLLOUT_ARGS)
    rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"])
    kern = P._rollout_kernel(fn, None, *rargs, None, s["consts"], dt=solver.dt, gravity=True,
                             exact_grav=True, fused=False)[:4]
    for a, b in zip(kern, P.rollout_plain(*rargs, s["consts"], dt=solver.dt, gravity=True),
                    strict=True):
        assert rel_err(a, b) <= gate("B4")
    if dtype == torch.float32:
        return
    mx = DM.MixedDFPipelineSolver(3, solver.dt, 2, 1, gravity=True, exact_gravity_jacobian=True)
    s = polish_inputs(mx, *_nu_problem(torch.float64, 12, 9, 3))
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    fn = HR.function(libs["nu_mx"], "riccati_large_mx", DM._RICCATI_ARGS)
    kern = DM._backward_mx_kernel(fn, None, *bargs, glow=True, luu_al=None)
    for name, a, b in zip(("k", "K", "gvec"), kern, DM.backward_mx_plain(*bargs, glow=True),
                          strict=True):
        assert rel_err(a, b) <= GATES["mixed"]["B5"][name], name
    fn = HR.function(libs["nu_mx"], "rollout_large_mx", DM._ROLLOUT_ARGS)
    rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["consts"])
    kern = DM._rollout_mx_kernel(fn, None, *rargs, dt=mx.dt, gravity=True)
    plain = DM.rollout_mx_plain(*rargs, dt=mx.dt, gravity=True)
    for name, a, b in zip(POLISH_OUTPUTS["B6"], [*kern[:4], *kern[4]], [*plain[:4], *plain[4]],
                          strict=True):
        assert rel_err(a, b) <= GATES["mixed"]["B6"][name], name


def test_large_layout_matches_the_build_count():
    """`_build.riccati_large_bytes`, from which MAX_NU comes, counts the
    layout of csrc/riccati_large.cuh that the kernels lay out at launch: the
    unit's own count (large_layout, compiled on the host) at every nu from
    13 to MAX_NU + 1 in each scalar, and the unit's static_assert that
    MAX_NU fits (it compiled)."""
    if HR.compiler() is None:
        pytest.skip("no host C++ compiler")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        src = f"{d}/layout.cpp"
        with open(src, "w") as f:
            f.write('#define TRAOPT_SUFFIX f64\n#include "riccati_large.cuh"\n'
                    'extern "C" long large_bytes(int nu, int kind) {\n'
                    '  using namespace traopt;\n'
                    '  return (long)(kind == 0 ? large_layout<float, float, 8>(nu).bytes\n'
                    '                : kind == 1 ? large_layout<float, double, 8>(nu).bytes\n'
                    '                : large_layout<double, double, 4>(nu).bytes);\n}\n')
        lib = f"{d}/layout.so"
        subprocess.run([HR.compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                        "-I", str(HR.STUB), "-I", str(HR.CSRC), "-o", lib, src], check=True)
        fn = ctypes.CDLL(lib).large_bytes
        fn.restype = ctypes.c_long
        for nu in range(13, _build.MAX_NU + 2):
            for kind, (tp, tr) in enumerate(((4, 4), (4, 8), (8, 8))):
                assert fn(nu, kind) == _build.riccati_large_bytes(nu, tp, tr), (nu, kind)
    assert _build.MAX_NU >= 34


def test_fast_large_layout_matches_the_build_count():
    """`_build.fast_large_bytes` and `_build.fast_large_problems` count the
    layout of csrc/fast_large.cuh that B13's large-nu instance lays out at
    launch, and its choice of problems a block: the header's own counts
    (compiled on the host) at nx = 1, 6 and 12, every nu from 1 to
    MAX_NU + 1, 8, 4 and 2 problems a block, in each scalar; and at every nu
    up to MAX_NU some block fits (the header's static_assert holds)."""
    if HR.compiler() is None:
        pytest.skip("no host C++ compiler")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        for h in HR.CSRC.glob("*.cuh"):  # the kernel and its launch rewritten for the host
            with open(f"{d}/{h.name}", "w") as f:
                f.write(HR.host_source(h.read_text()))
        src = f"{d}/layout.cpp"
        with open(src, "w") as f:
            f.write('#define TRAOPT_SUFFIX f64\n#include "fast_large.cuh"\n'
                    'extern "C" long fast_bytes(int nx, int nu, int f64, int P) {\n'
                    '  using namespace traopt;\n'
                    '  return (long)(f64 ? fast_large_layout<double>(nx, nu, P).bytes\n'
                    '                    : fast_large_layout<float>(nx, nu, P).bytes);\n}\n'
                    'extern "C" int fast_problems(int nx, int nu, int f64) {\n'
                    '  using namespace traopt;\n'
                    '  return f64 ? fast_large_problems<double>(nx, nu)\n'
                    '             : fast_large_problems<float>(nx, nu);\n}\n')
        lib = f"{d}/layout.so"
        subprocess.run([HR.compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                        f"-DTRAOPT_MAX_NU={_build.MAX_NU}", "-I", str(HR.STUB),
                        "-I", d, "-o", lib, src], check=True)
        so = ctypes.CDLL(lib)
        so.fast_bytes.restype = ctypes.c_long
        for f64, tp in ((0, 4), (1, 8)):
            for nx in (1, 6, 12):
                for nu in range(1, _build.MAX_NU + 2):
                    for P in _build.FAST_LARGE_PROBLEMS:
                        assert so.fast_bytes(nx, nu, f64, P) == _build.fast_large_bytes(
                            nx, nu, tp, P), (nx, nu, tp, P)
                    assert so.fast_problems(nx, nu, f64) == (
                        _build.fast_large_problems(nx, nu, tp) or 0), (nx, nu, tp)
            assert all(_build.fast_large_problems(12, nu, tp)
                       for nu in range(1, _build.MAX_NU + 1))


def test_nu_launchers_refuse_past_their_bound(libs):
    """nu = 0 and MAX_NU + 1 reach the runtime-nu instances' launchers of
    B1-B6 (the kernel calls' shape checks pass), which return an error that
    the kernel calls raise; at nu = 13 (random inputs) each launches."""
    N, B = 2, 3
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    f32 = torch.float32

    def calls(nu):
        """(name, kernel call) of each launcher of B1-B6 at nu."""
        lin = dict(Fx=r(N, 12, 12, B), d=r(N, 12, B), lx=r(N, 12, B), lxx=r(N, 12, 12, B),
                   fqR=r(N, 3, 3, B), fqp=r(N, 3, B), fxi=r(N, 6, B))
        refs = dict(RbiR=r(N + 1, 3, 3), Rbip=r(N + 1, 3), Adb=r(N + 1, 6, 6),
                    xib=r(N + 1, 6))
        consts = dict(W1N=r(6, 6), W2N=r(6, 6), W1=r(6, 6), W2=r(6, 6), J=r(6, 6),
                      Jinv=r(6, 6), fu2=r(6, nu), Luu=r(nu, nu), Pu=r(6, nu), mg=0.0)
        traj = (r(N + 1, 3, 3, B), r(N + 1, 3, B), r(N + 1, 6, B), r(N, nu, B))
        lin_mx = dict(Fx=lin["Fx"], d=lin["d"], lx=lin["lx"], lxx32=lin["lxx"].to(f32),
                      fqR=lin["fqR"], fqp=lin["fqp"], fxi=lin["fxi"])
        consts32 = dict(fu2=consts["fu2"].to(f32), Luu=consts["Luu"].to(f32))
        fn = lambda lib, name, args: HR.function(libs[lib], name, args)
        yield "linearize", lambda: LN._linearize_kernel(
            fn("nu_f64", "linearize_nu_f64", LN._LINEARIZE_ARGS), None, *traj, refs, consts,
            dt=0.01, gravity=True, exact_grav=True)
        yield "riccati", lambda: P._backward_kernel(
            fn("nu_f64", "riccati_nu_f64", P._RICCATI_NU_ARGS), None, lin, r(N, nu, B),
            *traj[:3], refs, consts, glow=True, luu_al=None, hand=True)
        yield "rollout", lambda: P._rollout_kernel(
            fn("nu_f64", "rollout_nu_f64", P._ROLLOUT_ARGS), None, *traj, r(N, nu, B),
            r(N, nu, 12, B), lin, None, consts, dt=0.01, gravity=True, exact_grav=True,
            fused=False)
        yield "riccati_mx", lambda: DM._backward_mx_kernel(
            fn("nu_mx", "riccati_nu_mx", DM._RICCATI_ARGS), None, lin_mx, r(N, nu, B),
            r(12, B), r(12, 12, B).to(f32), consts, consts32, glow=True, luu_al=None)
        yield "rollout_mx", lambda: DM._rollout_mx_kernel(
            fn("nu_mx", "rollout_nu_mx", DM._ROLLOUT_ARGS), None, *traj,
            r(N, nu, B).to(f32), r(N, nu, 12, B).to(f32), lin_mx, consts, dt=0.01,
            gravity=True)

    for nu in (0, _build.MAX_NU + 1):
        for name, call in calls(nu):
            with pytest.raises(RuntimeError, match=name):
                call()
    assert len([call() for _, call in calls(13)]) == 5


@pytest.mark.parametrize("nu", [0, 13, _build.MAX_NU + 1],
                         ids=["nu0", "nu13", f"nu{_build.MAX_NU + 1}"])
def test_wrappers_refuse_nu_out_of_range_before_any_launch(nu):
    """On a device tensor (here the meta device: no data, no kernel) at nu = 0
    or MAX_NU + 1, every wrapper of B1-B6 raises ValueError naming the range
    1..MAX_NU before it looks for a kernel, and counts no launch (neither its
    own count nor its runtime-nu or large-nu instance's); at nu = 3 and 13
    (the large-nu instances' first) it gets as far as the device."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
        KERNELS as PK,
    )

    def calls(nu):
        m = lambda *shape, dtype=torch.float64: torch.empty(shape, dtype=dtype,
                                                             device="meta")
        N, B = 2, 3
        traj = (m(N + 1, 3, 3, B), m(N + 1, 3, B), m(N + 1, 6, B), m(N, nu, B))
        lin = dict(Fx=m(N, 12, 12, B), d=m(N, 12, B), lx=m(N, 12, B), lxx=m(N, 12, 12, B),
                   lxx32=m(N, 12, 12, B, dtype=torch.float32), fqR=m(N, 3, 3, B),
                   fqp=m(N, 3, B), fxi=m(N, 6, B))
        gains = (m(N, nu, B), m(N, nu, 12, B))
        kw = dict(dt=0.01, gravity=True)
        bargs = (lin, m(N, nu, B), *traj[:3], {}, {})
        margs = (lin, m(N, nu, B), m(12, B), m(12, 12, B), {}, {})
        yield lambda: LN.linearize_lane(*traj, {}, {}, **kw)
        yield lambda: P.backward_lane(*bargs, glow=True)
        yield lambda: P.rollout_lane(*traj, *gains, lin, {}, **kw)
        yield lambda: P.rollout_linearize_lane(*traj, *gains, lin, {}, {}, **kw)
        yield lambda: DM.backward_mx_lane(*margs, glow=True)
        yield lambda: DM.rollout_mx_lane(*traj, *gains, lin, {}, **kw)

    counters = {**PK, **DM.KERNELS}
    before = {k: w.launches for k, w in counters.items()}
    n = 0
    for call in calls(nu):
        if nu == 13:
            with pytest.raises(ValueError, match="no kernel for device meta"):
                call()
        else:
            with pytest.raises(ValueError,
                               match=rf"nu = -?\d+: the kernels take nu in 1\.\.{_build.MAX_NU}$"):
                call()
        n += 1
    assert n == 6
    assert {k: w.launches for k, w in counters.items()} == before
    for call in calls(3):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


# B11 and B12 on both SO(3) families at SHAPES: one problem, a ragged block
# of one warp.
FAMILIES = [pytest.param(False, id="free_attitude"), pytest.param(True, id="pendulum")]


def _so3_inputs(pendulum, dtype, B, N):
    """A real SO3PipelineSolver iterate (2 iterations, plain) of a family,
    and its dt."""
    build = so3_bench.build_pendulum_swingup80 if pendulum else so3_bench.build_so3_track249
    dyn, cost, q0, xi0 = build(dtype, "cpu", horizon=N)
    q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed=1)
    solver = S.SO3PipelineSolver(N, 2, float(dyn.dt), pendulum=pendulum)
    us0 = torch.zeros((B, N, 3), dtype=dtype)
    return so3_inputs(solver, dyn, cost, q0s, xi0s, us0), solver.dt


@pytest.mark.parametrize("B,N", SHAPES)
@pytest.mark.parametrize("pendulum", FAMILIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b11_host_rehearsal_matches_plain(libs, dtype, pendulum, B, N):
    """B11 on both families within its card gate of the plain version (f32);
    f64 to 1e-12."""
    s, _ = _so3_inputs(pendulum, dtype, B, N)
    tag = "f32" if dtype == torch.float32 else "f64"
    fn = HR.function(libs[f"so3_{tag}"], f"riccati_so3_{tag}", S._RICCATI_ARGS)
    bargs = (s["lin"], s["lu"], s["qR"], s["xi"], s["refs"], s["consts"])
    kern = S._backward_so3_kernel(fn, None, *bargs, pendulum=pendulum)
    plain = S.backward_so3_plain(*bargs, pendulum=pendulum)
    gate = GATES["so3"][dtype]["B11"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(SO3_OUTPUTS["B11"], kern, plain, strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))


@pytest.mark.parametrize("B,N", SHAPES)
@pytest.mark.parametrize("pendulum", FAMILIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_b12_host_rehearsal_matches_plain(libs, dtype, pendulum, B, N):
    """B12 (the rollout phase, then B10's kernel on its trajectory) on both
    families within its card gate of the plain version (f32), f64 to 1e-12;
    and equal, bit for bit, to the rollout phase alone followed by B10's
    entry point on the new trajectory."""
    s, dt = _so3_inputs(pendulum, dtype, B, N)
    tag = "f32" if dtype == torch.float32 else "f64"
    lib = libs[f"so3_{tag}"]
    fn = HR.function(lib, f"rollout_so3_{tag}", S._ROLLOUT_ARGS)
    rargs = (s["qR"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"], s["consts"])
    kw = dict(dt=dt, pendulum=pendulum)
    kern = S._rollout_so3_kernel(fn, None, *rargs, **kw)
    plain = S.rollout_linearize_so3_plain(*rargs, **kw)
    gate = GATES["so3"][dtype]["B12"] if dtype == torch.float32 else 1e-12
    for name, a, b in zip(SO3_OUTPUTS["B12"], _flat(kern, S.LIN), _flat(plain, S.LIN),
                          strict=True):
        assert rel_err(a, b) <= gate, (name, rel_err(a, b))
    oR, oxi, ou, empty = S._rollout_so3_kernel(fn, None, *rargs, linearize=False, **kw)
    assert empty == {}
    lin_fn = HR.function(lib, f"linearize_so3_{tag}", S._LINEARIZE_ARGS)
    new = S._linearize_so3_kernel(lin_fn, None, oR, oxi, ou, s["refs"], s["consts"], **kw)
    for name, a, b in zip(SO3_OUTPUTS["B12"], _flat(kern, S.LIN),
                          _flat((oR, oxi, ou, new), S.LIN), strict=True):
        assert torch.equal(a, b), name


def test_so3_launchers_refuse_what_they_do_not_take(libs):
    """An empty horizon (N = 0) reaches B11's and B12's launchers (the
    calls' shape checks pass), which return an error that the kernel calls
    raise."""
    N, B = 0, 3
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    lin = dict(Fx=r(N, 6, 6, B), fu2=r(N, 3, 3, B), d=r(N, 6, B), lx=r(N, 6, B),
               lxx=r(N, 6, 6, B), fqR=r(N, 3, 3, B), fxi=r(N, 3, B))
    refs = dict(RbiR=r(N + 1, 3, 3), xib=r(N + 1, 3))
    consts = {k: r(3, 3) for k in ("J", "Jinv", "W1", "W2", "W1vN", "W2vN", "W1hN", "W2hN",
                                   "Luu")}
    consts.update(mgr=r(3), mr=r(3))
    fn = HR.function(libs["so3_f64"], "riccati_so3_f64", S._RICCATI_ARGS)
    with pytest.raises(RuntimeError, match="riccati_so3"):
        S._backward_so3_kernel(fn, None, lin, r(N, 3, B), r(N + 1, 3, 3, B), r(N + 1, 3, B),
                               refs, consts, pendulum=False)
    fn = HR.function(libs["so3_f64"], "rollout_so3_f64", S._ROLLOUT_ARGS)
    with pytest.raises(RuntimeError, match="rollout_so3"):
        S._rollout_so3_kernel(fn, None, r(N + 1, 3, 3, B), r(N + 1, 3, B), r(N, 3, B),
                              r(N, 3, B), r(N, 3, 6, B), lin, refs, consts, dt=0.01,
                              pendulum=False)


def test_f64_trig_within_an_ulp_of_libm(tmp_path):
    """lie.cuh's sin and cos in double (TRAOPT_F64_TRIG, the fp64 kernels of
    pipeline.cu) on the host: within 1 ulp of numpy's over |x| <= 1e4, tiny
    and signed-zero arguments, multiples of pi / 4 and a few large ones;
    NaN for NaN and infinity."""
    if HR.compiler() is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "trig.cpp"
    src.write_text('#define TRAOPT_F64_TRIG\n#include "lie.cuh"\n'
                   'extern "C" void sincos_f64(const double* x, double* s, double* c, int n) {\n'
                   '  for (int i = 0; i < n; ++i) traopt::xsincos(x[i], s[i], c[i]);\n}\n')
    lib = tmp_path / "trig.so"
    subprocess.run([HR.compiler(), "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(HR.CSRC), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).sincos_f64
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4.0, 4.0, 100_000), rng.uniform(-1e4, 1e4, 100_000),
                        rng.uniform(-1e-4, 1e-4, 10_000), np.pi / 4 * np.arange(-40, 41),
                        [0.0, -0.0, 1e-300, -5e-324, 1e5, -3e5, 1e6]])
    s, c = np.empty_like(x), np.empty_like(x)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    fn(ptr(x), ptr(s), ptr(c), len(x))
    for got, want in ((s, np.sin(x)), (c, np.cos(x))):
        assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    bad = np.array([np.nan, np.inf, -np.inf])
    s, c = np.empty_like(bad), np.empty_like(bad)
    fn(ptr(bad), ptr(s), ptr(c), len(bad))
    assert np.isnan(s).all() and np.isnan(c).all()


def test_f32_frameless_trig_within_2_ulp(tmp_path):
    """lie.cuh's sin and cos in float without the library's slow path
    (xsin_shift, the large-nu rollout's FramelessTrig) on the host:
    within 2 ulp of the float64 sin and cos over |x| <= 1e4, tiny and
    signed-zero arguments and multiples of pi / 4; NaN for NaN and
    infinity."""
    if HR.compiler() is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "trig.cpp"
    src.write_text('#include "lie.cuh"\n'
                   'extern "C" void sincos_f32(const float* x, float* s, float* c, int n) {\n'
                   '  for (int i = 0; i < n; ++i) {\n'
                   '    s[i] = traopt::FramelessTrig::sin(x[i]);\n'
                   '    c[i] = traopt::FramelessTrig::cos(x[i]);\n  }\n}\n')
    lib = tmp_path / "trig.so"
    subprocess.run([HR.compiler(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(HR.CSRC), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).sincos_f32
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4.0, 4.0, 100_000), rng.uniform(-1e4, 1e4, 100_000),
                        rng.uniform(-1e-4, 1e-4, 10_000), np.pi / 4 * np.arange(-40, 41),
                        [0.0, -0.0, 1e-38, -1e-45]]).astype(np.float32)
    s, c = np.empty_like(x), np.empty_like(x)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    fn(ptr(x), ptr(s), ptr(c), len(x))
    for got, want in ((s, np.sin(x.astype(np.float64))), (c, np.cos(x.astype(np.float64)))):
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got.astype(np.float64) - want) <= 2 * ulp).all()
    bad = np.array([np.nan, np.inf, -np.inf], dtype=np.float32)
    s, c = np.empty_like(bad), np.empty_like(bad)
    fn(ptr(bad), ptr(s), ptr(c), len(bad))
    assert np.isnan(s).all() and np.isnan(c).all()


def test_chip_smoke_cli_phase_on_the_cpu(monkeypatch):
    """`chip_smoke.py`'s `cli` phase rehearsed on the CPU at the CLI's CPU
    sizes and engines (the plain versions; no kernel launches, so the
    launch counts, which `chip_smoke.check_cli_launches` holds on the card,
    are not checked here): the task lines and every gate of the phase on
    the tasks below (the f64 exact tasks, the three batch tasks with
    mpc_batch against a direct `make_closed_loop_batch` call on the same draws,
    dynamics_sim, and cost_landscape's grids against the CPU's)."""
    import chip_smoke as CS
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity

    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import records

    monkeypatch.setattr(parity, "RESULTS_DIR", parity.RESULTS_DIR)
    monkeypatch.setattr(records, "DEFAULT_PATH", records.DEFAULT_PATH)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)

    def counted(fn):
        return fn(), 0.0, {}

    names = ("se3_tracking_ms", "pendulum3d_ms", "mpc_batch", "mpc_batch_constrained",
             "al_batch", "dynamics_sim", "cost_landscape")
    tasks = [t for t in CS.CLI_TASKS if t[0] in names]
    try:
        runs = CS.cli_phase(torch.device("cpu"), "cpu", counted, tasks)
    finally:
        torch.set_num_threads(prev)
    assert sorted(runs) == sorted(names)
