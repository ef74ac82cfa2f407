"""The card-check plumbing on the CPU: the ptxas report parser and
`kernel_check`'s pairing of each kernel wrapper with its plain version.

On CPU tensors every wrapper takes its plain version, so `compare` must
report exact agreement; what is tested is the wiring (argument order,
output order, the AL branch), which the card run relies on.
"""

import pytest
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
from trajectory_optimization_matrix_lie_groups_tpu_torch.kernel_check import (
    GATES,
    OUTPUTS,
    calls,
    compare,
    kernel_inputs,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (
    build_screw200,
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
    dyn, cost, q0, xi0 = build_screw200(torch.float64, horizon=H)
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
