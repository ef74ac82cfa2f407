"""The port's time-sharded Riccati sweep (`parallel/riccati_sharded.py`) in
one process, f64.

The two-level algorithm with its blocks on one device
(`blocked_parallel_backward`, the gather a stack) against the port's
`riccati.parallel_backward`: n_blocks in {2, 3, 8}, N + 1 divisible or not
(identity padding; 8 blocks of 2 over N + 1 = 14 leave one block all
padding), per-problem mu, rtol = atol = 1e-10; at the AL task's horizon
(N = 1400, (n, m) = (12, 6), JAX `test_sharded_al_scale_horizon`'s size)
to 1e-8.  The padding is the combine's identity.  Through a one-process
gloo group (what a mesh constructor joins in a process with no group):
`LieILQR(backward="associative_sharded")` equals `backward="associative"`
(the same iterations, controls to 1e-12), `BatchSolver` and the sweeps on
the one-rank batch mesh equal their one-device runs to 1e-12, and a mesh
that does not fit the group and tensors on another device than the mesh
are refused (a batch that does not divide over the ranks and an unpadded
suffix scan: in the two-rank job).  The JAX side of these sweeps is in
test_torch_multidevice.py (two ranks against the JAX package).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from trajectory_optimization_matrix_lie_groups_tpu_torch import parallel
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import riccati_sharded as RS
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep as tsweep
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import toy

import torch_dist_worker as W
from torch_port_cases import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _batch(N, n, m):
    return tuple(torch.as_tensor(x) for x in W.ltv_batch(N, n, m))


def _close(got, want, tol):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("n_blocks", [2, 3, 8])
@pytest.mark.parametrize("case", [(13, 4, 2), (31, 6, 3)], ids=["N13-n4-m2", "N31-n6-m3"])
def test_blocked_backward_matches_one_device(case, n_blocks):
    prob = _batch(*case)
    mu = torch.tensor([0.1, 0.0], dtype=torch.float64)
    _close(RS.blocked_parallel_backward(*prob, n_blocks=n_blocks, mu=mu),
           riccati.parallel_backward(*prob, mu=mu), 1e-10)


@pytest.mark.parametrize("n_blocks", [2, 8])
def test_blocked_backward_at_the_al_horizon(n_blocks):
    prob = tuple(torch.as_tensor(x[:1]) for x in W.ltv_batch(1400, 12, 6))
    _close(RS.blocked_parallel_backward(*prob, n_blocks=n_blocks),
           riccati.parallel_backward(*prob), 1e-8)


def test_padding_is_the_identity():
    """Identity elements appended on the late-time end change no suffix."""
    elems = riccati.build_elements(*_batch(13, 4, 2), 0.1)
    padded = RS._pad_elements(elems, 3)
    assert padded[0].shape[1] == elems[0].shape[1] + 3
    full = riccati.doubling_scan(riccati.combine, padded, reverse=True)
    _close([x[:, :14] for x in full],
           riccati.doubling_scan(riccati.combine, elems, reverse=True), 1e-12)


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank batch and time meshes of a process with no group (a
    gloo group on the CPU, kept in memory); the group is left as found."""
    had = dist.is_initialized()
    yield parallel.make_batch_mesh(device="cpu"), RS.default_time_mesh(device="cpu")
    if not had:
        dist.destroy_process_group()


def test_a_mesh_joins_a_one_process_group(one_rank):
    bmesh, tmesh = one_rank
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert (bmesh.size(), tmesh.size()) == (1, 1)
    assert bmesh.mesh_dim_names == ("batch",) and tmesh.mesh_dim_names == ("time",)
    with pytest.raises(ValueError, match="needs 2 processes"):
        parallel.make_batch_mesh(n_devices=2)


@pytest.mark.parametrize("ls", [False, True], ids=["full-step", "line-search"])
def test_time_sharded_lie_ilqr_equals_associative(one_rank, ls):
    """The toy problem (N = 16, f64), three perturbed starts: the sweep
    through the group's all-gathers equals the one-device sweep."""
    tm, tp, q0, xi0, _, _, N = toy.toy_problem(16, torch.float64, "cpu")
    rng = np.random.default_rng(3)
    q0s = se3.normalize(q0[None] @ se3.exp(torch.as_tensor(0.05 * rng.standard_normal((3, 6)))))
    x0 = (q0s, xi0.expand(3, 6).contiguous())
    us0 = torch.zeros((3, N, 6), dtype=torch.float64)
    cfg = dict(N=N, max_iterations=12, tol_grad_norm=1e-8, line_search=ls)
    sharded = LieILQR(tm, SolverConfig(backward="associative_sharded", **cfg))
    out = sharded.solve(tp, x0, us0)
    ref = LieILQR(tm, SolverConfig(backward="associative", **cfg)).solve(tp, x0, us0)
    assert sharded.backward_mesh.mesh_dim_names == ("time",)
    assert out.iteration.tolist() == ref.iteration.tolist()
    np.testing.assert_allclose(out.us.numpy(), ref.us.numpy(), rtol=0, atol=1e-12)


def test_one_rank_batch_and_sweeps_equal_one_device(one_rank):
    """`BatchSolver`, `run_sweep` and `run_rollout_sweep` on the one-rank
    batch mesh: sharded results (`DTensor`) that gather to the one-device
    results."""
    from torch.distributed.tensor import DTensor

    bmesh = one_rank[0]
    bs, params, base_q0, base_xi0 = EB.build_sweep(torch.float64, "cpu", N=10)
    q0s, xi0s = tsweep.build_x0_batch("w_z", np.asarray([0.5, 1.5]), base_q0, base_xi0)
    us0 = torch.zeros((2, 10, 6), dtype=torch.float64)
    st = parallel.BatchSolver(bs.solver, mesh=bmesh).solve_batch(params, q0s, xi0s, us0)
    assert isinstance(st.us, DTensor)
    ref = bs.solve_batch(params, q0s, xi0s, us0)
    np.testing.assert_allclose(parallel.gather_to_all(st.us), ref.us.numpy(), rtol=0, atol=1e-12)
    ranges = {"w_z": np.asarray([0.5, 1.5])}
    a = tsweep.run_sweep(parallel.BatchSolver(bs.solver, mesh=bmesh), params, ranges,
                         base_q0, base_xi0)["w_z"]
    np.testing.assert_allclose(a.us, ref.us.numpy(), rtol=0, atol=1e-12)
    dyn, dp, bq0, bxi0, _ = EB.build_rollout_sweep(device="cpu")
    a = tsweep.run_rollout_sweep(dyn, dp, ranges, bq0, bxi0, N=20, mesh=bmesh)["w_z"]
    b = tsweep.run_rollout_sweep(dyn, dp, ranges, bq0, bxi0, N=20)["w_z"]
    np.testing.assert_allclose(a.qs, b.qs, rtol=0, atol=1e-12)


def test_tensors_off_the_mesh_device_are_refused(one_rank):
    with pytest.raises(ValueError, match="on 'cpu', the tensor on 'meta'"):
        RS.sharded_parallel_backward(*(x.to("meta") for x in _batch(13, 4, 2)),
                                     mesh=one_rank[1])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        parallel.initialize_multihost("127.0.0.1:1", 1, 0, device="meta")


def test_a_mesh_keeps_to_its_group_device(one_rank):
    """In a gloo group a mesh on the card is refused, and so is a batch
    tensor on another device type than the mesh's: nothing is copied
    quietly between the card and the CPU."""
    with pytest.raises(ValueError, match="runs on 'cpu' \\(gloo\\), not on 'cuda'"):
        parallel.make_batch_mesh(device="cuda")
    with pytest.raises(ValueError, match="runs on 'cpu'"):
        RS.default_time_mesh(device="cuda")
    assert parallel.make_batch_mesh().device_type == "cpu"
    with pytest.raises(ValueError, match="on 'cpu', the tensor on 'meta'"):
        multihost.shard_rows(torch.zeros((2, 6), device="meta"), one_rank[0])
    rows = multihost.shard_rows(np.ones((2, 6)), one_rank[0])
    assert rows.device.type == "cpu" and rows.shape == (2, 6)
