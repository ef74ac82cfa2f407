"""The port's multi-device layer (`parallel/riccati_sharded.py`,
`parallel/pipeline_sharded.py`, `parallel/multihost.py`, the meshes of
`parallel/batch.py` and `parallel/sweep.py`) at world size 2: one job of
two CPU processes in a gloo group (`torch_dist_worker.py`) runs every
distributed check once; the JAX side runs here, on the same inputs, while
the job runs.  Tolerances:

  - `sharded_parallel_backward` against the JAX `riccati.parallel_backward`
    (f64, (N, n, m) = (13, 4, 2) and (31, 6, 3), B = 2, mu = 0.1):
    rtol = atol = 1e-9, the JAX tests' own; the adaptive sweep and the
    suffix scan against their one-device twins, 1e-12;
  - `LieILQR(backward="associative_sharded")` against the JAX `LieILQR`
    (`backward="associative"`; screw-200 cut to H = 20, f64, 4 iterations,
    two starts): the same iterations, controls atol 1e-8;
  - `ShardedPipelineSolver` (plain path, H = 16, B = 4, 4 iterations)
    against the JAX `PallasPipelineSolver(interpret=True)` at
    tests/test_pipeline.py:48's atol 5e-4 / rtol 1e-4, and against the
    port's one-device `PipelineSolver`: 1e-6 (f32) / 1e-12 (f64);
  - `BatchSolver(mesh)` against the JAX `BatchSolver(mesh=None)` on
    test_torch_sweep.py's case (B = 4): controls 1e-8, J and grad norm
    rtol 1e-8, the same iterations and flags;
  - `run_rollout_sweep(mesh=...)` against ``mesh=None``: 1e-12;
  - `distribute_batch` then `gather_to_all`: exact; a mesh that does not
    fit the group, a batch that does not divide over the ranks and an
    unpadded suffix scan refused;
  - the dry run of `__graft_entry__.dryrun_multichip` on the toy problem
    (N = 8, f32, 2 iterations): each sharded run against its one-device
    run, 1e-6;
  - every output that every rank holds (gathered or replicated): equal on
    both ranks, exactly (the one-device references are rank 0's alone).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs as jcosts
from trajectory_optimization_matrix_lie_groups_tpu.models import dynamics as jdyn
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model as jmake
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3 as JSE3
from trajectory_optimization_matrix_lie_groups_tpu.parallel.batch import (
    BatchSolver as JaxBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers import lie_ilqr as JL
from trajectory_optimization_matrix_lie_groups_tpu.solvers import riccati as jr
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep as tsweep
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

import torch_dist_worker as W
from torch_port_cases import initial_batch, problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE_H, PIPE_B, PIPE_ITERS = 16, 4, 4
JOB_TIMEOUT_S = 600


def _fields(p):
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def _starts(spec, H):
    """The JAX problem (model, params) of screw-200 cut to H and the starts
    ``spec`` (parameter, values), built as the worker builds them."""
    dp, cp = problem(H)[:2]
    jm, jp = jmake(jdyn.se3_dynamics(), jcosts.tracking_cost(JSE3, 6), dp, cp)
    t = lambda x: torch.as_tensor(np.array(x))
    q0s, xi0s = tsweep.build_x0_batch(spec[0], spec[1], t(cp.q_ref[0]), t(cp.xi_ref[0]))
    us0 = np.zeros((len(spec[1]), H, 6))
    return jm, jp, jnp.asarray(q0s.numpy()), jnp.asarray(xi0s.numpy()), jnp.asarray(us0)


def _jax_side(inputs):
    out = {}
    for N, n, m in W.LTV_CASES:
        sweep = jax.jit(jax.vmap(lambda *p: jr.parallel_backward(*p, mu=W.LTV_MU)))
        out[f"ltv_{N}_{n}_{m}"] = [np.asarray(x) for x in sweep(
            *(jnp.asarray(x) for x in W.ltv_batch(N, n, m)))]
    jm, jp, q0s, xi0s, us0 = _starts(W.LIE_STARTS, W.LIE_H)
    cfg = JL.SolverConfig(N=W.LIE_H, backward="associative", max_iterations=W.LIE_ITERS)
    out["lie"] = JaxBatchSolver(JL.LieILQR(jm, cfg)).solve_batch(jp, q0s, xi0s, us0)
    jm, jp, q0s, xi0s, us0 = _starts(W.SWEEP_STARTS, W.SWEEP_H)
    cfg = JL.SolverConfig(**dataclasses.asdict(EB.sweep_config(W.SWEEP_H)))
    out["batch"] = JaxBatchSolver(JL.LieILQR(jm, cfg)).solve_batch(jp, q0s, xi0s, us0)
    dp, cp = problem(PIPE_H, jnp.float32)[:2]
    g = lambda k: inputs[f"pipe_f32/{k}"]
    out["pipe"] = PallasPipelineSolver(N=PIPE_H, iterations=PIPE_ITERS, dt=float(dp.dt),
                                       interpret=True).solve(dp, cp, g("q0s"), g("xi0s"),
                                                             g("us0"))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX side's): the two-rank job
    started first, the JAX side computed while it runs."""
    d = tmp_path_factory.mktemp("dist")
    inputs = {}
    for tag, dtype in (("f32", jnp.float32), ("f64", jnp.float64)):
        dp, cp, _, _, q0, xi0, nu = problem(PIPE_H, dtype)
        q0s, xi0s, us0 = initial_batch(q0, xi0, PIPE_B, PIPE_H, nu, seed=0, dtype=dtype)
        inputs.update({f"pipe_{tag}/q0s": q0s, f"pipe_{tag}/xi0s": xi0s,
                       f"pipe_{tag}/us0": us0, f"pipe_{tag}/H": np.asarray(PIPE_H),
                       f"pipe_{tag}/iterations": np.asarray(PIPE_ITERS)})
        inputs.update({f"pipe_{tag}_dyn/{k}": v for k, v in _fields(dp).items()})
        inputs.update({f"pipe_{tag}_cost/{k}": v for k, v in _fields(cp).items()})
    np.savez(d / "inputs.npz", **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, W.__file__, str(d / "inputs.npz"),
                             str(d / "rank")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        jax_out = _jax_side(inputs)
        log = proc.communicate(timeout=JOB_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)]
    return ranks[0], ranks[1], jax_out


def test_meshes_span_both_ranks(job):
    r0 = job[0]
    assert r0["mesh_sizes"].tolist() == [2, 2, 2]


def test_refusals(job):
    """A mesh of 1 in a group of 2, a batch of 3 over 2 ranks, 15 elements
    over 2 ranks unpadded, a card mesh in the gloo group and a batch tensor
    off the mesh's device type each raise `ValueError`, on both ranks."""
    for r in range(W.WORLD):
        assert job[r]["refused"].tolist() == [True] * 5


@pytest.mark.parametrize("case", W.LTV_CASES, ids=[f"N{N}-n{n}-m{m}" for N, n, m in W.LTV_CASES])
def test_sharded_backward_matches_jax(job, case):
    key = "ltv_{}_{}_{}".format(*case)
    for name, ref in zip(("k", "K", "Vx", "Vxx"), job[2][key]):
        got = job[0][f"{key}/{name}"]
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9, err_msg=name)


def test_sharded_adaptive_matches_one_device(job):
    """The whole-sweep retry on a problem whose mu = 0 sweep is not positive
    definite: the same gains, value functions and per-problem mu, delta,
    exceeded as `riccati.parallel_backward_adaptive`."""
    r0 = job[0]
    for name in ("k", "K", "Vx", "Vxx", "mu", "delta"):
        np.testing.assert_allclose(r0[f"adaptive_sharded/{name}"], r0[f"adaptive_plain/{name}"],
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(r0["adaptive_sharded/exceeded"], r0["adaptive_plain/exceeded"])
    assert r0["adaptive_sharded/mu"][0] > 0.0  # problem 0 retried above mu = 0


def test_sharded_suffix_scan_matches_one_device(job):
    for i in range(5):
        np.testing.assert_allclose(job[0][f"suffix_sharded/{i}"], job[0][f"suffix_plain/{i}"],
                                   rtol=1e-12, atol=1e-12, err_msg=str(i))


def test_time_sharded_lie_ilqr_matches_jax(job):
    r0, js = job[0], job[2]["lie"]
    np.testing.assert_array_equal(r0["lie_associative_sharded/iteration"], np.asarray(js.iteration))
    np.testing.assert_allclose(r0["lie_associative_sharded/us"], np.asarray(js.us), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r0["lie_associative_sharded/J_opt"], np.asarray(js.J_opt),
                               rtol=1e-8)
    np.testing.assert_allclose(r0["lie_associative_sharded/us"], r0["lie_associative/us"],
                               rtol=0, atol=1e-12)


def test_sharded_pipeline_matches_jax(job):
    r0, jout = job[0], job[2]["pipe"]
    np.testing.assert_allclose(r0["pipe_f32_sharded/us"], np.asarray(jout.us), atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["pipe_f32_sharded/J_opt"], np.asarray(jout.J_opt), rtol=1e-4)
    assert r0["pipe_f32_sharded/us"].shape == (PIPE_B, PIPE_H, 6)


@pytest.mark.parametrize("tag,tol", [("f32", 1e-6), ("f64", 1e-12)])
def test_sharded_pipeline_matches_one_device(job, tag, tol):
    r0 = job[0]
    for f in ("qs", "xis", "us", "J_opt", "grad_norm"):
        a, b = r0[f"pipe_{tag}_sharded/{f}"], r0[f"pipe_{tag}_single/{f}"]
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f)


def test_batch_solver_mesh_matches_jax(job):
    r0, js = job[0], job[2]["batch"]
    np.testing.assert_allclose(r0["batch/us"], np.asarray(js.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(r0["batch/J_opt"], np.asarray(js.J_opt), rtol=1e-8)
    np.testing.assert_allclose(r0["batch/grad_norm"], np.asarray(js.grad_norm), rtol=1e-8,
                               atol=1e-13)
    for f in ("iteration", "converged", "failed"):
        np.testing.assert_array_equal(r0[f"batch/{f}"], np.asarray(getattr(js, f)), f)


def test_rollout_sweep_mesh_equals_one_device(job):
    r0 = job[0]
    for name in W.ROLLOUT_RANGES:
        for f in ("qs", "xis"):
            a, b = r0[f"rollout_mesh/{name}_{f}"], r0[f"rollout_single/{name}_{f}"]
            assert a.shape == b.shape == ((4, W.ROLLOUT_STEPS + 1, 4, 4) if f == "qs"
                                          else (4, W.ROLLOUT_STEPS + 1, 6))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_distribute_then_gather_round_trip(job):
    want = np.concatenate([np.arange(6.0).reshape(3, 2) + 100 * r for r in range(W.WORLD)])
    for r in range(W.WORLD):
        np.testing.assert_array_equal(job[r]["roundtrip"], want)


def test_a_torchrun_job_joins_from_its_environment(job):
    """With torchrun's variables set and no group, `make_batch_mesh` joins
    the job's group over ``env://``: both ranks, in rank order."""
    want = np.concatenate([np.arange(6.0).reshape(3, 2) + 100 * r for r in range(W.WORLD)])
    for r in range(W.WORLD):
        assert job[r]["env_mesh"].tolist() == [W.WORLD, r]
        np.testing.assert_array_equal(job[r]["env_roundtrip"], want)


@pytest.mark.parametrize("part", ["toy_batch", "toy_pipe"])
def test_toy_dry_run_batch_sharded(job, part):
    np.testing.assert_allclose(job[0][f"{part}/sharded"], job[0][f"{part}/single"], rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(job[0][f"{part}/sharded"]).all()


def test_toy_dry_run_time_sharded(job):
    a, b = job[0]["toy_time/associative_sharded"], job[0]["toy_time/associative"]
    assert a.shape == (1, W.TOY_N, 6)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_every_rank_holds_the_same(job):
    """Gathered and replicated outputs are equal on both ranks, exactly: the
    retry's branch and the results cannot differ between ranks."""
    r0, r1 = job[0], job[1]
    assert set(r1) <= set(r0) and len(r1) >= 40
    for k in r1:
        if k not in ("roundtrip", "env_mesh"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
