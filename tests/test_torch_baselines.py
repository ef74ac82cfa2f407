"""The port's embedded-Euclidean baselines (`baselines/embedded.py`) against
the JAX package's on the stand-in problems (`tasks/golden/standin/`), the
cases of `tests/test_baselines.py` at a short horizon (H = 16, f64 on the
CPU): the SU(2)/R^13 baseline, the four rotation-matrix/R^18 families and
the SO(3) families (free attitude and pendulum).  The same iterations, J
history rel 1e-9, states and controls to 1e-8; and the embedded methods'
characteristic drift (nonzero, bounded) as the JAX tests check it."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.baselines import embedded as jemb
from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines import embedded
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import load_benchmark_pickle
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.metrics import (
    quat_norm_violation,
)

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H, ITERS = 16, 12
F64 = torch.float64


def _slice(name):
    prob = load_benchmark_pickle(os.path.join(parity.STANDIN_DIR,
                                              parity.BENCHMARKS[name]["pkl"]))["prob"]
    d = 6 if np.asarray(prob["q_ref"]).shape[-1] == 4 else 3
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"]).reshape(-1, d)[: H + 1]
    return prob, q_ref, xi_ref


def _check(out, jout):
    xs, us, J, g, st = out
    jxs, jus, jJ, jg, jst = jout
    assert len(J) == len(jJ) and bool(st.converged) == bool(jst.converged)
    np.testing.assert_allclose(J, np.asarray(jJ), rtol=1e-9)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0, atol=1e-8)
    assert J[-1] < J[0]


def test_su2_baseline_matches_jax():
    prob, q_ref, xi_ref = _slice("se3_tracking")
    args = (prob["J"], float(prob["dt"]), q_ref, xi_ref, prob["Q"], prob["R"], prob["P"])
    x0 = (q_ref[0], xi_ref[0] + 0.05)
    out = embedded.solve_su2(*args, x0, torch.zeros((H, 6), dtype=F64), n_iterations=ITERS)
    jout = jemb.solve_su2(*args, (jnp.asarray(x0[0]), jnp.asarray(x0[1])),
                          jnp.zeros((H, 6)), n_iterations=ITERS)
    _check(out, jout)
    drift = quat_norm_violation(out[0])
    assert 0.0 < float(drift.max()) < 5e-2


@pytest.mark.parametrize("variant", ["dynconstr", "logcost", "stabilized",
                                     "stabilized_logcost"])
def test_se3_matrix_baselines_match_jax(variant):
    prob, q_ref, xi_ref = _slice("se3_tracking")
    args = (prob["J"], float(prob["dt"]), q_ref, xi_ref, prob["Q"], prob["R"], prob["P"])
    x0 = (q_ref[0], xi_ref[0] + 0.05)
    out = embedded.solve_se3_matrix(*args, x0, torch.zeros((H, 6), dtype=F64),
                                    variant=variant, n_iterations=ITERS)
    jout = jemb.solve_se3_matrix(*args, (jnp.asarray(x0[0]), jnp.asarray(x0[1])),
                                 jnp.zeros((H, 6)), variant=variant, n_iterations=ITERS)
    _check(out, jout)
    Rf = out[0][-1, :9].reshape(3, 3)
    assert float((Rf.T @ Rf - torch.eye(3, dtype=F64)).abs().max()) < 1e-8


@pytest.mark.parametrize("form,pendulum", [("su2", False), ("logcost", False),
                                           ("stabilized", False), ("dynconstr", True),
                                           ("stabilized_logcost", True)])
def test_so3_family_baselines_match_jax(form, pendulum):
    prob, R_ref, xi_ref = _slice("pendulum_swingup" if pendulum else "so3_tracking")
    kw = dict(m=float(prob["m"]), length=float(prob["length"])) if pendulum else {}
    args = (prob["J"], float(prob["dt"]), R_ref, xi_ref, prob["Q"], prob["R"], prob["P"],
            (R_ref[0], xi_ref[0] + 0.05))
    out = embedded.solve_so3_family(*args, torch.zeros((H, 3), dtype=F64), formulation=form,
                                    pendulum=pendulum, n_iterations=ITERS, **kw)
    jout = jemb.solve_so3_family(*args, np.zeros((H, 3)), formulation=form,
                                 pendulum=pendulum, n_iterations=ITERS, **kw)
    _check(out, jout)
    xs = out[0]
    if form == "su2":
        drift = (torch.linalg.norm(xs[:, :4], dim=-1) - 1.0).abs()
        assert float(drift.max()) < 0.2
    else:
        Rms = xs[:, :9].reshape(-1, 3, 3)
        viol = torch.linalg.matrix_norm(Rms @ Rms.transpose(-1, -2) - torch.eye(3, dtype=F64))
        assert float(viol.max()) < 0.2
