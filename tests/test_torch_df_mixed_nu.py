"""The mixed-precision polish at an input dimension other than 6 and 4: the
port's `MixedDFPipelineSolver` (plain path, fp64 residuals) against the JAX
one (interpret mode, double-f32 residuals) on the same numpy inputs, the
way tests/test_torch_df_mixed.py holds it at nu = 6: one JAX solve compiled
in a module fixture, H = 8, B = 4, 4 f32 + 2 polish iterations, on the rigid
body driven by three torques (Pu = [I3; 0], nu = 3, g = 0;
tests/test_torch_pipeline_nu.py's `nu_problem`).

Tolerances: that file's, us 6e-7 on the solve and 1e-6 on the polish of the
JAX handoff, J rtol 1e-6, the poses 1e-6; the gradient norm (~2e-8 here,
the f32 preconditioner's floor, which the JAX package returns in f32) at
1e-8 absolute on the solve (measured 5.8e-9) and 1e-9 on the polish of the
handoff.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.solvers import df_mixed as jdm
from trajectory_optimization_matrix_lie_groups_tpu.solvers.df_pipeline import (
    join_us as jax_join_us,
    split_pytree,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    lane_state_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as dm

from test_torch_df_mixed import _check_state, x64_off
from test_torch_pipeline_nu import GRAV, nu_problem
from torch_port_cases import initial_batch, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

HM, BM, F32_IT, DF_IT = 8, 4, 4, 2


@pytest.fixture(scope="module")
def handoff():
    """One JAX `MixedDFPipelineSolver` (fx_mode "df", interpret mode, so its
    polish is the plain XLA path) at nu = 3 compiled once: its f32 handoff,
    its polish of it and its `solve`, with the port's problem and inputs.
    (At nu = 12 its unrolled nu x nu Cholesky takes the XLA compile past two
    minutes.)"""
    nu = 3
    dp, cp, tdp, tcp, q0, xi0 = nu_problem(HM, nu)
    q0s, xi0s, us0 = initial_batch(q0, xi0, BM, HM, nu, seed=0, dtype=jnp.float64)
    np_params = jax.tree.map(np.asarray, {"dyn": dp, "cost": cp})
    mx = jdm.MixedDFPipelineSolver(N=HM, dt=float(dp.dt), f32_iterations=F32_IT,
                                   df_iterations=DF_IT, fx_mode="df", interpret=True,
                                   **GRAV)
    sp = split_pytree(np_params)
    f32 = lambda x: np.asarray(x, np.float32)
    with x64_off():
        ls = mx._f32_jit(sp, f32(q0s), f32(xi0s), f32(us0), None)
        polished = mx._df_jit(sp, *ls, None)
        solved = mx.solve(np_params, q0s, xi0s, us0)
    return dict(ls=[np.asarray(x) for x in ls], polished=polished, solved=solved,
                dyn=tdp, cost=tcp, dt=float(dp.dt),
                inputs=tuple(torch.as_tensor(x) for x in (q0s, xi0s, us0)))


def test_polish_nu3_from_the_jax_handoff(handoff):
    """The port's polish of the JAX f32 handoff against the JAX polish of it,
    two mixed iterations each (tests/test_torch_df_mixed.py's gates)."""
    port = dm.MixedDFPipelineSolver(HM, handoff["dt"], F32_IT, DF_IT, fx_mode="df", **GRAV)
    out = port.polish(handoff["dyn"], handoff["cost"],
                      *lane_state_from_numpy(*handoff["ls"]))
    _check_state(out, handoff["polished"], us_atol=1e-6, g_atol=1e-9)


def test_mixed_solve_nu3_matches_jax_solve(handoff):
    """The whole mixed solve against the JAX `solve` (f32 phase, then the
    polish): us at 6e-7, stage 0 equal (module docstring)."""
    port = dm.MixedDFPipelineSolver(HM, handoff["dt"], F32_IT, DF_IT, fx_mode="df", **GRAV)
    out = port.solve(handoff["dyn"], handoff["cost"], *handoff["inputs"])
    ref = handoff["solved"]
    _check_state(out, ref, us_atol=6e-7, g_atol=1e-8)
    np.testing.assert_array_equal(out.qs[:, 0].numpy(), np.asarray(ref.qs)[:, 0])
    assert np.abs(jax_join_us(ref)).max() > 1e-3  # the controls move
