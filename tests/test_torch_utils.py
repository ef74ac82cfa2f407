"""The port's `utils/` (file I/O, rotations, metrics, checkpoint, profiling,
records) against the JAX package's on the same numpy inputs.

Each package reads the other's reference triples and benchmark pickles;
`rotations` and `metrics` agree with JAX to 1e-12 in f64 on seeded inputs;
a checkpoint round-trips (a NamedTuple and a dataclass through a
template, devices and dtypes kept); `record` appends to a given path and
never raises; `trace` writes a Chrome trace.
"""

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu import utils as jutils
from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.ops import so3 as jso3
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.utils import metrics as jmetrics
from trajectory_optimization_matrix_lie_groups_tpu.utils import rotations as jrot
from trajectory_optimization_matrix_lie_groups_tpu_torch import utils
from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
    cost_from_numpy,
    dyn_from_numpy,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import (
    checkpoint,
    metrics,
    profiling,
    records,
    rotations,
)

RNG = np.random.default_rng(12)
T = lambda x: torch.as_tensor(np.array(x))
N = lambda x: np.asarray(x)


def _poses(n):
    """n random SE(3) poses (numpy f64)."""
    xi = RNG.standard_normal((n, 6))
    return np.asarray(jse3.exp(jnp.asarray(xi)))


# -- file I/O ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reference_triple_read_by_the_other_package(writer, tmp_path):
    q_ref, xi_ref, dt = _poses(5), RNG.standard_normal((5, 6)), 0.01
    path = tmp_path / "ref.npy"
    if writer == "jax":
        jutils.trajectories.save_reference_triple(path, jnp.asarray(q_ref), xi_ref, dt)
        q, xi, d = utils.load_reference_triple(path)
    else:
        utils.trajectories.save_reference_triple(path, T(q_ref), T(xi_ref), dt)
        q, xi, d = jutils.load_reference_triple(path)
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(xi, xi_ref)
    assert d == dt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_benchmark_pickle_read_by_the_other_package(writer, tmp_path):
    q_ref, xi_ref = _poses(4), RNG.standard_normal((4, 6))
    prob = dict(J=np.eye(6), dt=0.01, q_ref=q_ref, xi_ref=xi_ref,
                x0=(q_ref[0], xi_ref[0]), Q=np.eye(12), P=np.eye(12), R=np.eye(6))
    us = RNG.standard_normal((3, 6))
    solvers = {"ms_se3": dict(xs=dict(qs=q_ref, xis=xi_ref), us=us,
                              J_hist=[3.0, 2.0], grad_hist=[1.0, 0.5])}
    path = str(tmp_path / "bench.pkl")
    if writer == "jax":
        jprob = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                 for k, v in prob.items()}
        jutils.save_benchmark_pickle(path, jprob, solvers)
        data = utils.load_benchmark_pickle(path)
    else:
        tprob = {k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in prob.items()}
        tsolv = {"ms_se3": {**solvers["ms_se3"], "us": T(us),
                            "xs": dict(qs=T(q_ref), xis=T(xi_ref))}}
        utils.save_benchmark_pickle(path, tprob, tsolv)
        data = jutils.load_benchmark_pickle(path)
    assert set(data) == {"prob", "ms_se3"}
    for k, v in prob.items():
        if isinstance(v, np.ndarray):
            assert isinstance(data["prob"][k], np.ndarray)
            np.testing.assert_array_equal(data["prob"][k], v)
    assert isinstance(data["prob"]["x0"], tuple)
    np.testing.assert_array_equal(data["prob"]["x0"][0], q_ref[0])
    np.testing.assert_array_equal(data["ms_se3"]["us"], us)
    np.testing.assert_array_equal(data["ms_se3"]["xs"]["qs"], q_ref)
    assert data["ms_se3"]["J_hist"] == [3.0, 2.0]


# -- rotations and metrics ------------------------------------------------------------

def test_rotations_match_jax():
    rpy = RNG.uniform(-1.4, 1.4, (16, 3))
    Rs = np.asarray(jso3.exp(jnp.asarray(RNG.standard_normal((16, 3)))))
    Ts = _poses(16)
    x7 = np.concatenate([RNG.standard_normal((16, 4)), RNG.standard_normal((16, 3))], -1)
    x7[:, :4] /= np.linalg.norm(x7[:, :4], axis=-1, keepdims=True)
    pairs = [
        (rotations.euler_zyx_to_quat(T(rpy)), jrot.euler_zyx_to_quat(rpy)),
        (rotations.matrix_to_euler_zyx(T(Rs)), jrot.matrix_to_euler_zyx(Rs)),
        (rotations.rotation_angle(T(Rs)), jrot.rotation_angle(Rs)),
        (rotations.se3_rotation_angle(T(Ts)), jrot.se3_rotation_angle(Ts)),
        (rotations.matrix_to_quat(T(Rs)), jrot.matrix_to_quat(jnp.asarray(Rs))),
        (rotations.quat_to_matrix(T(x7[:, :4])), jrot.quat_to_matrix(jnp.asarray(x7[:, :4]))),
        (rotations.se3_to_quatpos(T(Ts)), jrot.se3_to_quatpos(jnp.asarray(Ts))),
        (rotations.quatpos_to_se3(T(x7)), jrot.quatpos_to_se3(jnp.asarray(x7))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), N(b), rtol=0, atol=1e-12)


def _screw_model(H):
    """The screw problem's first H stages in both packages (f64)."""
    dt = 0.01
    J = np.block([[np.diag([0.5, 0.7, 0.9]), np.zeros((3, 3))], [np.zeros((3, 3)), np.eye(3)]])
    xi_ref = np.broadcast_to(np.array([0.0, 0.0, 1.0, 2.0, 0.0, 0.2]), (H + 1, 6)).copy()
    step = N(jse3.exp(jnp.asarray(xi_ref[0] * dt)))
    q_ref = np.stack([np.linalg.matrix_power(step, i) for i in range(H + 1)])
    Q = np.diag([10.0] * 3 + [1.0] * 9)
    jdp = jdyn.se3_params(jnp.asarray(J), dt)
    jcp = jcosts.tracking_cost_params(JSE3, Q, 1e-3 * np.eye(6), 10 * Q, q_ref, xi_ref)
    jm, jp = jmake(jdyn.se3_dynamics(), jcosts.tracking_cost(JSE3, 6), jdp, jcp)
    fields = lambda p: {k: np.asarray(v) for k, v in p._asdict().items()}
    tm, tp = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6),
                        dyn_from_numpy(fields(jdp)), cost_from_numpy(fields(jcp)))
    return jm, jp, tm, tp


def test_metrics_match_jax():
    H = 12
    jm, jp, tm, tp = _screw_model(H)
    cp = jp["cost"]
    qs = N(cp.q_ref) @ N(jse3.exp(jnp.asarray(0.05 * RNG.standard_normal((H + 1, 6)))))
    xis = N(cp.xi_ref) + 0.1 * RNG.standard_normal((H + 1, 6))
    us = RNG.standard_normal((H, 6))
    bad = qs.copy()
    bad[:, :3, :3] += 1e-3 * RNG.standard_normal((H + 1, 3, 3))
    x13 = RNG.standard_normal((9, 13))
    tp_e, tv_e = metrics.tracking_errors(SE3, tp["cost"], T(qs), T(xis))
    jp_e, jv_e = jmetrics.tracking_errors(JSE3, cp, jnp.asarray(qs), jnp.asarray(xis))
    pairs = [
        (metrics.orthogonality_violation(T(bad)), jmetrics.orthogonality_violation(bad)),
        (metrics.dynamics_violation(tm, tp, T(qs), T(xis), T(us)),
         jmetrics.dynamics_violation(jm, jp, jnp.asarray(qs), jnp.asarray(xis),
                                     jnp.asarray(us))),
        (tp_e, jp_e), (tv_e, jv_e),
        (metrics.quat_norm_violation(T(x13)), jmetrics.quat_norm_violation(x13)),
    ]
    for a, b in pairs:
        assert a.shape == N(b).shape
        np.testing.assert_allclose(a.numpy(), N(b), rtol=0, atol=1e-12)


# -- checkpoint -----------------------------------------------------------------------

class _State(NamedTuple):
    us: torch.Tensor
    mu: torch.Tensor
    step: int


@dataclasses.dataclass
class _Box:
    lb: torch.Tensor
    ub: torch.Tensor


def test_checkpoint_roundtrip(tmp_path):
    st = _State(us=torch.randn(3, 4, 6, dtype=torch.float64), mu=torch.tensor(0.5), step=7)
    box = _Box(lb=-torch.ones(6, dtype=torch.float32), ub=torch.ones(6, dtype=torch.float32))
    state = {"solver": st, "box": box, "hist": [1.0, 2.0], "warm": np.arange(4.0)}
    path = checkpoint.save(str(tmp_path / "ck" / "state.pt"), state)
    assert os.path.isfile(path)
    raw = checkpoint.restore(path)
    assert set(raw) == {"solver", "box", "hist", "warm"}
    assert set(raw["solver"]) == {"us", "mu", "step"} and raw["solver"]["step"] == 7
    torch.testing.assert_close(raw["solver"]["us"], st.us, rtol=0, atol=0)
    template = {"solver": _State(torch.zeros(1, dtype=torch.float64),
                                 torch.zeros(()), 0),
                "box": _Box(torch.zeros(6, dtype=torch.float32),
                            torch.zeros(6, dtype=torch.float32)),
                "hist": [0.0, 0.0], "warm": np.zeros(4)}
    back = checkpoint.restore(path, template)
    assert isinstance(back["solver"], _State) and isinstance(back["box"], _Box)
    assert back["solver"].step == 7 and back["hist"] == [1.0, 2.0]
    torch.testing.assert_close(back["solver"].us, st.us, rtol=0, atol=0)
    assert back["box"].lb.dtype == torch.float32
    torch.testing.assert_close(back["box"].ub, box.ub, rtol=0, atol=0)
    np.testing.assert_array_equal(back["warm"], np.arange(4.0))


# -- records and profiling --------------------------------------------------------------

def test_record_appends_jsonl(tmp_path):
    path = str(tmp_path / "sub" / "records.jsonl")
    assert records.record("probe_a", {"value": 1.5, "x": np.float32(2.0),
                                      "arr": np.arange(3), "t": torch.tensor(4.0),
                                      "name": "collides"}, path=path) == path
    records.record("probe_b", {"value": 2.5}, path=path)
    lines = [json.loads(s) for s in open(path).read().splitlines()]
    assert [e["name"] for e in lines] == ["probe_a", "probe_b"]
    assert lines[0]["value"] == 1.5 and lines[0]["x"] == 2.0 and lines[0]["arr"] == [0, 1, 2]
    assert lines[0]["t"] == 4.0 and lines[0]["payload_name"] == "collides"
    assert "when" in lines[0] and "invocation" in lines[0]
    assert records.DEFAULT_PATH.endswith(os.path.join("bench_records", "records_torch.jsonl"))


def test_record_never_raises(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    # a directory that cannot be made, and a payload that is not a mapping
    records.record("probe", {"v": 1}, path=str(blocker / "records.jsonl"))
    records.record("probe", 3, path=str(tmp_path / "r.jsonl"))
    assert capsys.readouterr().err.count("could not write") == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    path = tmp_path / "tr" / "trace.json"
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
