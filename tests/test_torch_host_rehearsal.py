"""The group Riccati kernels B2 and B5 (csrc/riccati_group.cuh) run by the
host rehearsal (tests/host_rehearsal.py: each thread of a block an OS thread,
real barriers, the block's shared memory a buffer) on CPU tensors, against
their plain versions.

This runs the kernels' own code, barriers and shared-memory exchanges
included, which the CPU tests of the wrappers cannot reach (on CPU tensors
they take the plain versions).  Without FMA contraction and with the
host's libm it agrees with the card to rounding: within the card's gates
(kernel_check.GATES).  Skips where no host C++20 compiler is found.
"""

import pytest
import torch

import host_rehearsal as HR
from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    GATES,
    kernel_inputs,
    polish_inputs,
    rel_err,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import drone_params
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    screw_batch,
)

UNITS = {"f32": ("pipeline", "f32", "float"), "f64": ("pipeline", "f64", "double"),
         "mx": ("polish", "mx", None)}
# one problem in a block of 8; a ragged last block with rows not 16-byte
# aligned (odd B)
SHAPES = [pytest.param(1, 1, id="B1-N1"), pytest.param(9, 3, id="B9-N3")]
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


@pytest.mark.parametrize("B,N", SHAPES)
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
    """nu = 5 reaches B2's and B5's launchers (the wrappers' shape checks
    pass), which return an error that the kernel calls raise."""
    N, B, nu = 2, 3, 5
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
