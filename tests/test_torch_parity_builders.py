"""The port's `tasks/parity.py` against the JAX package's on the stand-in
pickles (`tasks/golden/standin/`, `scripts/gen_torch_port_standin_pickles.py`).

For each stand-in and shooting mode `build_from_prob` gives the JAX
builder's parameters (to 1e-15), solver configuration, initial state and
solution key; a `cut_reference` (H = 20) `LieILQR` fit of each family
follows the JAX fit (the same iterations and flags, J history rel 1e-9);
`build_benchmark` reads `RESULTS_DIR` when it is called and names the
missing pickle.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.tasks import parity as jparity
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import load_benchmark_pickle

from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
STANDINS = ("se3_tracking", "so3_tracking", "pendulum_swingup", "drone_racing")
H, FIT_ITERS = 20, 8


def _prob(name):
    spec = parity.BENCHMARKS[name]
    return spec, load_benchmark_pickle(os.path.join(parity.STANDIN_DIR, spec["pkl"]))["prob"]


def _fields(p):
    """A parameter container's fields as numpy: the JAX NamedTuples and the
    port's dataclasses alike (flags kept as they are)."""
    items = (p._asdict().items() if hasattr(p, "_asdict")
             else ((f.name, getattr(p, f.name)) for f in dataclasses.fields(p)))
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else
                np.asarray(v) if hasattr(v, "shape") else v) for k, v in items}


@pytest.mark.parametrize("ms", [True, False], ids=["ms", "ss"])
@pytest.mark.parametrize("name", STANDINS)
def test_build_from_prob_matches_jax(name, ms):
    spec, prob = _prob(name)
    kw = dict(tol=spec["tol"], iters=spec["iters"])
    js, jp, jx0, jus0, jkey = jparity.build_from_prob(prob, spec["family"], ms, **kw)
    ts, tp, tx0, tus0, tkey = parity.build_from_prob(prob, spec["family"], ms, device=CPU,
                                                     **kw)
    assert tkey == jkey
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.model.nu == js.model.nu and ts.model.nx == js.model.nx
    assert ts.model.group.dim == js.model.group.dim
    # the free body's MS rollout takes kernel B14 (its plain version here)
    assert ts.pallas_rollout_dt == (float(prob["dt"]) if spec["family"] == "se3" else None)
    for part in ("dyn", "cost"):
        jf, tf = _fields(jp[part]), _fields(tp[part])
        assert set(tf) == set(jf), part
        for k, v in jf.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(tf[k], v, rtol=0, atol=1e-15, err_msg=f"{part}.{k}")
            else:
                assert tf[k] == v, f"{part}.{k}"
    np.testing.assert_array_equal(tx0[0][0].numpy(), np.asarray(jx0[0]))
    np.testing.assert_array_equal(tx0[1][0].numpy(), np.asarray(jx0[1]))
    assert tus0.shape == (1,) + jus0.shape and not tus0.any()
    assert tus0.dtype == torch.float64 and tus0.device == CPU


@pytest.mark.parametrize("name", STANDINS)
def test_cut_reference_fit_matches_jax(name):
    spec, prob = _prob(name)
    js, jp, jx0, _, _ = jparity.build_from_prob(prob, spec["family"], True)
    ts, tp, tx0, _, _ = parity.build_from_prob(prob, spec["family"], True, device=CPU)
    jp, tp = jparity.cut_reference(jp, H), parity.cut_reference(tp, H)
    assert tp["cost"].q_ref.shape[0] == H + 1 and tp["cost"].xi_ref.shape[0] == H + 1
    np.testing.assert_allclose(tp["cost"].Ad_ref.numpy(), np.asarray(jp["cost"].Ad_ref),
                               rtol=0, atol=1e-15)
    jsolver = type(js)(js.model, dataclasses.replace(js.cfg, N=H, max_iterations=FIT_ITERS))
    tsolver = type(ts)(ts.model, dataclasses.replace(ts.cfg, N=H, max_iterations=FIT_ITERS),
                       pallas_rollout_dt=ts.pallas_rollout_dt)
    nu = ts.model.nu
    _, jus, jJ, jg, _, jst = jsolver.fit(jp, jx0, jnp.zeros((H, nu)))
    _, tus, tJ, tg, _, tst = tsolver.fit(tp, tx0, torch.zeros((1, H, nu), dtype=torch.float64))
    tJ, tg = [h[0] for h in tJ], [h[0] for h in tg]
    assert len(tJ) == len(jJ)
    assert bool(tst.converged) == bool(jst.converged)
    np.testing.assert_allclose(tJ, jJ, rtol=1e-9)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tus[0].numpy(), np.asarray(jus), rtol=0, atol=1e-8)


def test_build_benchmark_reads_results_dir_when_called(monkeypatch, tmp_path):
    monkeypatch.setattr(parity, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="results_se3_tracking_benchmark.pkl"):
        parity.build_benchmark("se3_tracking", True, device=CPU)
    monkeypatch.setattr(parity, "RESULTS_DIR", parity.STANDIN_DIR)
    data, solver, params, x0, us0, key = parity.build_benchmark("so3_tracking", False,
                                                                device=CPU)
    assert key == "ss_so3" and set(data) == {"prob", "ms_so3", "ss_so3"}
    assert solver.cfg.tol_grad_norm == 1e-8 and solver.cfg.max_iterations == 50
    assert params["cost"].q_ref.device == CPU
    # the default: a directory of the port's own, inside the repository, that
    # waits for the reference's pickles (the JAX module reads its checkout's)
    monkeypatch.undo()
    package = os.path.dirname(os.path.abspath(parity.__file__))
    assert os.path.normpath(parity.RESULTS_DIR) == os.path.join(package, "golden", "reference")
    tail = os.path.join("reference", "visualization", "results_benchmark_2nd_draft")
    assert os.path.normpath(jparity.RESULTS_DIR).endswith(tail)
