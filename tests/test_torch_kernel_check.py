"""The card-check plumbing on the CPU: the build's library table, the ptxas
report parser and `kernel_check`'s pairing of each kernel wrapper with its
plain version.

On CPU tensors every wrapper takes its plain version, so `compare` must
report exact agreement; what is tested is the wiring (argument order,
output order, the AL branch), which the card run relies on.
"""

import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    FAST_OUTPUTS,
    GATES,
    HBM_BYTES_PER_S,
    OUTPUTS,
    PEAK_OPS_PER_S,
    POLISH_OUTPUTS,
    SO3_OUTPUTS,
    TAIL,
    bound_ms,
    calls,
    compare,
    fast_calls,
    fast_compare,
    fast_inputs,
    kernel_inputs,
    polish_calls,
    polish_compare,
    polish_inputs,
    so3_calls,
    so3_compare,
    so3_inputs,
    work,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import so3_bench
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
    build_screw200_nu,
    nu_pu,
    screw200_model,
    screw_batch,
)

# An -Xptxas -v log of the f64 pipeline build for sm_90a: after each entry
# ptxas reports the double-precision trig reduction helper, whose zero
# stack frame must not be taken for the entry's.
F64_LOG = """\
ptxas info    : 272 bytes gmem
ptxas info    : Compiling entry function '_ZN6traopt14rollout_kernelIdLi6EEEvNS_11RolloutArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN6traopt14rollout_kernelIdLi6EEEvNS_11RolloutArgsIT_EE
    480 bytes stack frame, 440 bytes spill stores, 440 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 480 bytes cumulative stack size
ptxas info    : Compile time = 397.465 ms
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN6traopt14riccati_kernelIdLi6EEEvNS_11RiccatiArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN6traopt14riccati_kernelIdLi6EEEvNS_11RiccatiArgsIT_EE
    36576 bytes stack frame, 106048 bytes spill stores, 151312 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 36576 bytes cumulative stack size
ptxas info    : Compile time = 6450.950 ms
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_each_unit_is_built_once_per_scalar_and_the_polish_once():
    """linearize, pipeline, so3, fast and pipeline_nu (B1-B4 at any nu) are
    built for f32 and f64; the mixed-precision polish unit and polish_nu
    (B5, B6 at any nu) once, under their own suffix, with no scalar macro;
    every library is named {unit}_{suffix}_{hash}.so in the build
    directory."""
    assert _build.LIBS == (("linearize", "f32", "float"), ("linearize", "f64", "double"),
                           ("pipeline", "f32", "float"), ("pipeline", "f64", "double"),
                           ("polish", "mx", None), ("so3", "f32", "float"),
                           ("so3", "f64", "double"), ("fast", "f32", "float"),
                           ("fast", "f64", "double"), ("pipeline_nu", "f32", "float"),
                           ("pipeline_nu", "f64", "double"), ("polish_nu", "mx", None))
    for unit, sfx, _ in _build.LIBS:
        path = _build._lib_path(unit, sfx)
        assert path.parent == _build.BUILD_DIR
        assert path.name == f"{unit}_{sfx}_{_build._digest()}.so"
        assert (_build.CSRC / f"{unit}.cu").is_file()


def test_parse_ptxas_attributes_each_block_to_its_entry():
    rows = dict(_build.parse_ptxas(F64_LOG))
    assert rows == {
        "_ZN6traopt14rollout_kernelIdLi6EEEvNS_11RolloutArgsIT_EE":
            dict(stack_frame=480, spill_stores=440, spill_loads=440, registers=255),
        "_ZN6traopt14riccati_kernelIdLi6EEEvNS_11RiccatiArgsIT_EE":
            dict(stack_frame=36576, spill_stores=106048, spill_loads=151312,
                 registers=32),
    }


H, B = 6, 3


@pytest.fixture(scope="module")
def inputs():
    dyn, cost, q0, xi0 = build_screw200(torch.float64, device="cpu", horizon=H)
    q0s, xi0s = screw_batch(q0, xi0, B, seed=3)
    solver = P.PipelineSolver(H, 1, float(dyn.dt))
    us0 = torch.zeros((B, H, 6), dtype=torch.float64)
    return solver, kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)


def test_compare_on_cpu_is_exact_and_covers_every_output(inputs):
    solver, s = inputs
    errs = compare(s, dt=solver.dt)
    assert set(errs) == {"B1", "B2", "B2_al", "B3", "B4"} == set(GATES[torch.float64])
    for name, e in errs.items():
        assert set(e["per_output"]) == set(OUTPUTS[name])
        assert e["max_rel"] == 0.0 and e["max_abs"] == 0.0, name


def test_al_diagonal_reaches_the_backward_pass(inputs):
    solver, s = inputs
    assert s["luu_al"].shape == s["lu"].shape and (s["luu_al"] > 0).all()
    pairs = calls(s, dt=solver.dt)
    k, K, _, _ = pairs["B2"][1]()
    k_al, K_al, _, _ = pairs["B2_al"][1]()
    assert (k - k_al).abs().max() > 1e-3 * k.abs().max()
    assert (K - K_al).abs().max() > 1e-3 * K.abs().max()


@pytest.fixture(scope="module")
def polish_case():
    dyn, cost, q0, xi0 = build_screw200(torch.float64, device="cpu", horizon=H)
    q0s, xi0s = screw_batch(q0, xi0, B, seed=3)
    solver = DM.MixedDFPipelineSolver(H, float(dyn.dt), 2, 1)
    us0 = torch.zeros((B, H, 6), dtype=torch.float64)
    return solver, polish_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=True)


def test_polish_compare_on_cpu_is_exact_and_covers_every_output(polish_case):
    solver, s = polish_case
    errs = polish_compare(s, solver)
    assert set(errs) == {"B5", "B5_al", "B6", "B7", "B8", "B9"} == set(GATES["mixed"])
    for name, e in errs.items():
        outs = TAIL.get(name, POLISH_OUTPUTS.get(name))
        assert set(e["per_output"]) == set(outs) == set(GATES["mixed"][name])
        assert e["max_rel"] == 0.0 and e["max_abs"] == 0.0, name


def test_polish_inputs_are_a_real_iterate(polish_case):
    """The polish kernels' inputs: fp64 residuals and trajectory, f32 gains
    and Hessians, and the AL diagonal changes B5's gains."""
    solver, s = polish_case
    assert s["qR"].dtype == s["lin"]["Fx"].dtype == s["lin"]["d"].dtype == torch.float64
    assert s["k"].dtype == s["lin"]["lxx32"].dtype == s["VxxN"].dtype == torch.float32
    pairs = polish_calls(s, solver)
    k, K, _ = pairs["B5"][1]()
    k_al, K_al, _ = pairs["B5_al"][1]()
    assert (k - k_al).abs().max() > 1e-3 * k.abs().max()
    assert (K - K_al).abs().max() > 1e-3 * K.abs().max()


@pytest.mark.parametrize("pendulum", [False, True], ids=["free_attitude", "pendulum"])
def test_so3_compare_on_cpu_is_exact_and_covers_every_output(pendulum):
    """B10-B12's wiring: on CPU tensors each wrapper takes its plain
    version, so kernel and plain agree exactly, on every output."""
    build = (so3_bench.build_pendulum_swingup80 if pendulum
             else so3_bench.build_so3_track249)
    dyn, cost, q0, xi0 = build(torch.float64, device="cpu", horizon=H)
    q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed=3)
    solver = S.SO3PipelineSolver(H, 1, float(dyn.dt), pendulum=pendulum)
    s = so3_inputs(solver, dyn, cost, q0s, xi0s,
                   torch.zeros((B, H, 3), dtype=torch.float64))
    errs = so3_compare(s, dt=solver.dt, pendulum=pendulum)
    assert set(errs) == {"B10", "B11", "B12"} == set(GATES["so3"][torch.float64])
    for name, e in errs.items():
        assert set(e["per_output"]) == set(SO3_OUTPUTS[name])
        assert e["max_rel"] == 0.0 and e["max_abs"] == 0.0, name


@pytest.fixture(scope="module")
def so3_case():
    dyn, cost, q0, xi0 = so3_bench.build_so3_track249(torch.float64, device="cpu",
                                                      horizon=H)
    q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed=3)
    solver = S.SO3PipelineSolver(H, 1, float(dyn.dt))
    return solver, so3_inputs(solver, dyn, cost, q0s, xi0s,
                              torch.zeros((B, H, 3), dtype=torch.float64))


FAST_KINDS = ("free_body", "drone", "so3")


@pytest.fixture(scope="module")
def fast_cases():
    """{kind: inputs of `fast_inputs`} for the free body (B1, B13, B14), the
    drone and the free attitude (B13), f64, one FastBatchSolver iteration."""
    out = {}
    for kind in FAST_KINDS:
        if kind == "so3":
            model, params, q0, xi0 = so3_bench.so3_track249_model(
                torch.float64, device="cpu", horizon=H)
            q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed=3)
            kw = {}
        else:
            model, params, q0, xi0 = screw200_model(torch.float64, device="cpu", horizon=H,
                                                    drone=kind == "drone")
            q0s, xi0s = screw_batch(q0, xi0, B, seed=3)
            kw = {} if kind == "drone" else dict(pallas_rollout_dt=float(params["dyn"].dt),
                                                 use_pallas_linearize=True)
        us0 = torch.zeros((B, H, model.nu), dtype=torch.float64)
        out[kind] = fast_inputs(FastBatchSolver(model, H, 1, **kw), params, q0s, xi0s, us0)
    return out


@pytest.mark.parametrize("kind", FAST_KINDS)
def test_fast_compare_on_cpu_is_exact_and_covers_every_output(kind, fast_cases):
    """B13's and B14's wiring: on CPU tensors each wrapper takes its plain
    version, so kernel and plain agree exactly, on every output; B14 only
    where its inputs are (the free body)."""
    errs = fast_compare(fast_cases[kind])
    assert set(errs) == ({"B13", "B14"} if kind == "free_body" else {"B13"})
    assert set(GATES["fast"][torch.float64]) == {"B13", "B14"}
    for name, e in errs.items():
        assert set(e["per_output"]) == set(FAST_OUTPUTS[name])
        assert e["max_rel"] == 0.0 and e["max_abs"] == 0.0, name


# Values per problem and stage that B13 reads at (nx, nu): Fx nx^2, Fu nx nu,
# d nx, Lx nx, Lu nu, Lxx nx^2, Lux nu nx, Luu nu^2 (Lx and Lxx also once at
# the terminal stage), and writes: k nu, K nu nx, Vx1 nx, Vxx1 nx^2.  B14
# reads qR 9, qp 3, xi 6 (N+1 stages each), us 6, k 6, K 72, d's twist rows
# 6 (Exp(d_q) comes precomputed), fxi 6, Exp(d) 9 + 3 and f^-1 9 + 3, and
# writes 9 + 3 + 6 + 6.
FAST_IO = {("B13", "free_body"): (498, 156, 234), ("B13", "drone"): (428, 156, 208),
           ("B13", "so3"): (132, 42, 63), ("B14", "free_body"): (138, 18, 24)}


@pytest.mark.parametrize("name,kind", list(FAST_IO), ids=[f"{n}-{k}" for n, k in FAST_IO])
def test_fast_work_counts_each_array_once(name, kind, fast_cases):
    """`work` for B13 at (12, 6), (12, 4) and (6, 3) and for B14 against a
    hand count per problem and stage: the arrays each kernel reads and its
    outputs, each once.  The operation estimate sets no bound."""
    s = fast_cases[kind]
    wk = work(name, s, fast_calls(s)[name][1]())
    reads, once, writes = FAST_IO[(name, kind)]
    assert wk["bytes"] == 8 * B * ((reads + writes) * H + once)
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in wk["ops"].items())
    assert wk["bytes"] / HBM_BYTES_PER_S >= 2 * t_ops > 0
    assert bound_ms(wk)[1] == "bytes"


# Elements per problem that each kernel reads plus those it writes, at
# horizon N, as (fp64, f32): the trajectory has N + 1 stages; the
# linearization, gains and controls N; the Riccati kernels read the terminal
# state alone.  An SE(3) linearization is 331 values per stage (fqR 9, fqp 3,
# fxi 6, d 12, Fx 144, lx 12, lxx 144, l 1), an SO(3) one 106 (fqR 9, fxi 3,
# d 6, Fx 36, fu2 9, lx 6, lxx 36, l 1); nu = 6 (SE(3)) and 3 (SO(3)).
IO = {
    "B1": lambda N: (24 * N + 18 + 331 * N, 0),
    "B2": lambda N: (318 * N + 18 + 84 * N + 1, 0),
    "B2_al": lambda N: (324 * N + 18 + 84 * N + 1, 0),
    "B3": lambda N: (132 * N + 18 + 355 * N + 18, 0),
    "B4": lambda N: (132 * N + 18 + 24 * N + 18, 0),
    "B5": lambda N: (174 * N + 12 + 6 * N, 144 * N + 144 + 78 * N),
    "B5_al": lambda N: (174 * N + 12 + 6 * N, 150 * N + 144 + 78 * N),
    "B6": lambda N: (18 * (N + 1) + 36 * N + 18 * (N + 1) + 24 * N, 78 * N),
    "tail": lambda N: (18 * (N + 1) + 18 * N + 168 * N, 145 * N),
    "B10": lambda N: (15 * N + 12 + 106 * N, 0),
    "B11": lambda N: (96 * N + 12 + 24 * N + 1, 0),
    "B12": lambda N: (54 * N + 12 + 121 * N + 12, 0),
}


@pytest.mark.parametrize("name", list(IO))
def test_work_counts_what_each_kernel_reads_and_writes_once(name, request):
    """`work` on each kernel's inputs and outputs: every array it reads and
    every output once.  Arrays a kernel is handed but does not read (the
    nominal Fx, lx, lxx and l in B3 and B12, all but the terminal stage of
    the trajectory in B2 and B11) and inputs passed through as outputs (the
    tail's dynamics evaluations) count nothing.  The operation estimate sets
    no bound: the bytes take at least twice as long."""
    if name in ("B10", "B11", "B12"):
        solver, s = request.getfixturevalue("so3_case")
        pairs = so3_calls(s, dt=solver.dt, pendulum=False)
    elif name in ("B5", "B5_al", "B6", "tail"):
        solver, s = request.getfixturevalue("polish_case")
        pairs = polish_calls(s, solver)
    else:
        solver, s = request.getfixturevalue("inputs")
        pairs = calls(s, dt=solver.dt)
    wk = work(name, s, pairs[name][1]())
    n64, n32 = IO[name](H)
    assert wk["bytes"] == B * (8 * n64 + 4 * n32)
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in wk["ops"].items())
    assert wk["bytes"] / HBM_BYTES_PER_S >= 2 * t_ops > 0
    assert bound_ms(wk)[1] == "bytes"


# B2's and B4's elements per problem at input dimension nu (fp64): B2 reads
# Fx, d, lx, lu, lxx (312 + nu a stage) and the terminal state, writes k, K
# and gvec (14 nu a stage) and lN; B4 reads the trajectory (18 a stage, N + 1
# stages), us, k, K (14 nu), d, fqR, fqp, fxi (30) and writes the trajectory
# and us.  At nu = 6 these are `IO`'s.
IO_NU = {"B2": lambda N, nu: (312 + nu) * N + 18 + 14 * nu * N + 1,
         "B4": lambda N, nu: 18 * (N + 1) + (14 * nu + 30) * N + 18 * (N + 1) + nu * N}


@pytest.mark.parametrize("nu", [6, 16, _build.MAX_NU], ids=lambda nu: f"nu{nu}")
@pytest.mark.parametrize("name", list(IO_NU))
def test_work_counts_the_nu_sized_arrays_at_every_nu(name, nu):
    """`work` of B2 and B4 at nu = 6, 16 and MAX_NU (the large-nu
    instances' rows in `chip_smoke.py`'s kernels_nu): every array once at
    its nu, and the bound the larger of the bytes' and the operations'
    times (the Riccati step's operations grow as nu^3 / 3, its bytes as
    nu)."""
    dyn, cost, q0, xi0 = build_screw200_nu(nu_pu(nu), torch.float64, "cpu", horizon=H)
    q0s, xi0s = screw_batch(q0, xi0, B, seed=3)
    solver = P.PipelineSolver(H, 1, float(dyn.dt), gravity=True, exact_gravity_jacobian=True)
    s = kernel_inputs(solver, dyn, cost, q0s, xi0s, torch.zeros((B, H, nu), dtype=torch.float64))
    wk = work(name, s, calls(s, dt=solver.dt, gravity=True)[name][1]())
    assert wk["bytes"] == B * 8 * IO_NU[name](H, nu)
    assert IO_NU[name](H, 6) == sum(IO[name](H))
    t_bytes = wk["bytes"] / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in wk["ops"].items())
    assert bound_ms(wk) == (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# Values per problem that B13 reads and writes at any (nx, nu) over N
# stages: Fx, Fu, d, Lu, Lux, Luu and the outputs k, K, Vx1, Vxx1 a stage,
# Lx and Lxx N + 1 stages.
B13_IO = lambda N, nx, nu: (N * (2 * nx * nx + 3 * nx * nu + 2 * nx + 2 * nu + nu * nu)
                            + (N + 1) * (nx + nx * nx))


@pytest.mark.parametrize("nx,nu", [(3, 12), (12, 16), (6, 24), (12, _build.MAX_NU)],
                         ids=lambda v: str(v))
def test_b13_work_counts_each_array_once_at_any_shape(nx, nu):
    """`work` and `bound_ms` of B13 on `riccati_inputs` at a runtime shape
    and at the large-nu instance's (`chip_smoke.py`'s kernels_b13_any rows):
    every array once at its (nx, nu), the operations `_fast_riccati_ops`'
    per problem and stage, in the inputs' dtype; at (12, 16), f32,
    B = 8192, N = 200 the bytes bound is 2.607 ms."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
        READS,
        _fast_riccati_ops,
        riccati_inputs,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.riccati import backward_plain

    N_, B_ = 3, 5
    s = riccati_inputs(nx, nu, B_, N_, torch.float32, seed=1)
    wk = work("B13", s, backward_plain(*(s[n] for n in READS["B13"])))
    assert wk["bytes"] == B_ * 4 * B13_IO(N_, nx, nu)
    assert wk["ops"] == {torch.float32: _fast_riccati_ops(nx, nu) * N_ * B_}
    big = {"bytes": 8192 * 4 * B13_IO(200, 12, 16),
           "ops": {torch.float32: _fast_riccati_ops(12, 16) * 200 * 8192}}
    ms, by = bound_ms(big)
    assert by == "bytes" and abs(ms - 2.6073155) < 1e-6


def test_bound_ms_takes_the_larger_time():
    ms, by = bound_ms({"bytes": 3.35e9, "ops": {torch.float64: 68e9}})
    assert by == "operations" and abs(ms - 2.0) < 1e-12
    ms, by = bound_ms({"bytes": 6.7e9, "ops": {torch.float32: 67e9}})
    assert by == "bytes" and abs(ms - 2.0) < 1e-12
