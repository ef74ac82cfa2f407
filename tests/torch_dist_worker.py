"""The two-rank job of tests/test_torch_multidevice.py: every distributed
check of the port's `parallel/` package, run once by two CPU processes in
one gloo group, the results written for the test functions to assert on.

    python tests/torch_dist_worker.py INPUTS.npz OUT_PREFIX

``INPUTS.npz`` holds the problems the test process built (numpy arrays,
keys "<problem>/<field>"); rank r writes ``OUT_PREFIX<r>.npz``; the
one-device references of the sharded runs are rank 0's alone.  Imports
no JAX: the test process computes the JAX side on the same inputs.  The
problems defined here (`random_ltv`, `SWEEP_STARTS`, ...) are numpy only,
so the test process makes the JAX side from the same numbers.
"""

import os
import socket
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# the time-sharded sweep: (N, n, m) as the JAX tests/test_riccati_sharded.py
# pairs them (13 elements + 1 over two ranks pads one identity; 31 + 1 none),
# two problems each, mu = 0.1
LTV_CASES = [(13, 4, 2), (31, 6, 3)]
LTV_MU = 0.1
# LieILQR on screw-200 cut to LIE_H, f64, two perturbed starts
LIE_H, LIE_ITERS = 20, 4
LIE_STARTS = ("v_x", np.asarray([1.5, 2.5]))
# BatchSolver on test_torch_sweep.py's case (the sweep task's solver), B = 4
SWEEP_H = 20
SWEEP_STARTS = ("v_x", np.asarray([1.5, 2.0, 2.5, 3.0]))
# the open-loop rollout sweep: two ranges of four, 50 steps
ROLLOUT_RANGES = {"w_z": np.asarray([0.5, 0.8, 1.2, 1.5]),
                  "th_z": np.asarray([-40.0, 0.0, 30.0, 60.0])}
ROLLOUT_STEPS = 50
# the dry run on the toy problem (`__graft_entry__.dryrun_multichip`'s N)
TOY_N, TOY_B, TOY_ITERS = 8, 4, 2


def random_ltv(N, n, m, seed):
    """A stable random LTV problem with positive definite cost blocks (the
    JAX tests/test_riccati_sharded.py's `_random_ltv`), float64 numpy."""
    rng = np.random.default_rng(seed)
    Fx = np.eye(n) + 0.02 * rng.normal(size=(N, n, n))
    Fu = 0.1 * rng.normal(size=(N, n, m))
    d = 0.01 * rng.normal(size=(N, n))
    Lx = rng.normal(size=(N + 1, n))
    Lu = rng.normal(size=(N, m))
    mk_pd = lambda k, s: np.einsum("nij,nkj->nik", s, s) + np.eye(k)
    Lxx = mk_pd(n, rng.normal(size=(N + 1, n, n)))
    Luu = mk_pd(m, rng.normal(size=(N, m, m)))
    Lux = 0.1 * rng.normal(size=(N, m, n))
    return (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)


def ltv_batch(N, n, m):
    """Two problems of `random_ltv`, stacked on a leading axis (seeds N, N+1)."""
    return tuple(np.stack(xs) for xs in zip(random_ltv(N, n, m, N), random_ltv(N, n, m, N + 1)))


def indefinite_ltv(N=15, n=4, m=2):
    """Two problems whose Quu loses definiteness at mu = 0 (a control
    penalty ~1e-5 and a terminal Hessian with one negative direction:
    tests/test_torch_riccati_scan.py's ``indefinite`` recipe), for the
    adaptive retry."""
    probs = []
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        rs = 1e-5
        Fx = np.eye(n) + 0.08 * rng.standard_normal((N, n, n))
        Fu = 0.3 * rng.standard_normal((N, n, m))
        d = 0.01 * rng.standard_normal((N, n))
        Lx = rng.standard_normal((N + 1, n))
        Lu = rs * rng.standard_normal((N, m))
        M = rng.standard_normal((N + 1, n, n))
        Lxx = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(n)
        Lux = rs * 0.1 * rng.standard_normal((N, m, n))
        Lm = rng.standard_normal((N, m, m))
        Luu = rs * (Lm @ np.swapaxes(Lm, -1, -2) + 0.5 * np.eye(m))
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Lxx[N] = (Q * np.array([-0.05, 0.01, 0.01, 0.01])) @ Q.T
        probs.append((Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu))
    return tuple(np.stack(xs) for xs in zip(*probs))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _refuses(fn):
    """Whether ``fn`` raises `ValueError`."""
    try:
        fn()
    except ValueError:
        return True
    return False


def _group(data, name):
    """The fields "<name>/<field>" of the inputs as a dict of numpy arrays."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}


def _rank(rank, port, env_port, inputs, prefix):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from trajectory_optimization_matrix_lie_groups_tpu_torch import parallel
    from trajectory_optimization_matrix_lie_groups_tpu_torch.convert import (
        cost_from_numpy,
        dyn_from_numpy,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import riccati_sharded as RS
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
        PipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import toy

    parallel.initialize_multihost(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    data = dict(np.load(inputs))
    res = {}
    f64 = torch.float64
    T = lambda x: torch.as_tensor(np.asarray(x))

    # -- meshes ---------------------------------------------------------------
    bmesh = parallel.make_batch_mesh(device="cpu")
    tmesh = RS.default_time_mesh(device="cpu")
    res["mesh_sizes"] = np.asarray([bmesh.size(), tmesh.size(),
                                    parallel.global_batch_mesh().size()])
    res["refused"] = np.asarray([
        _refuses(lambda: parallel.make_batch_mesh(n_devices=1)),
        _refuses(lambda: parallel.BatchSolver(None, mesh=bmesh).solve_batch(
            None, torch.zeros(3, 4, 4), torch.zeros(3, 6), torch.zeros(3, 2, 6), 0, 0)),
        _refuses(lambda: RS.sharded_suffix_scan(
            riccati.build_elements(*(T(x) for x in ltv_batch(14, 4, 2)), LTV_MU), tmesh)),
        _refuses(lambda: parallel.make_batch_mesh(device="cuda")),
        _refuses(lambda: multihost.shard_rows(torch.zeros((2, 6), device="meta"), bmesh))])

    # -- the time-sharded sweep -----------------------------------------------
    for N, n, m in LTV_CASES:
        out = RS.sharded_parallel_backward(*(T(x) for x in ltv_batch(N, n, m)), mesh=tmesh,
                                           mu=LTV_MU)
        for name, x in zip(("k", "K", "Vx", "Vxx"), out):
            res[f"ltv_{N}_{n}_{m}/{name}"] = x.numpy()
    prob = tuple(T(x) for x in indefinite_ltv())
    mu0 = torch.tensor([0.0, 1e-3], dtype=f64)
    outs = {"sharded": RS.sharded_backward_adaptive(*prob, mu0, 1.0, mesh=tmesh)}
    if rank == 0:
        outs["plain"] = riccati.parallel_backward_adaptive(*prob, mu0, 1.0)
    for tag, out in outs.items():
        for name, x in zip(("k", "K", "Vx", "Vxx", "mu", "delta", "exceeded"), out):
            res[f"adaptive_{tag}/{name}"] = x.numpy()
    elems = riccati.build_elements(*(T(x) for x in ltv_batch(13, 4, 2)), LTV_MU)
    elems = RS._pad_elements(elems, (-elems[0].shape[1]) % WORLD)
    scans = {"sharded": RS.sharded_suffix_scan(elems, tmesh)}
    if rank == 0:
        scans["plain"] = riccati.doubling_scan(riccati.combine, elems, reverse=True)
    for tag, s in scans.items():
        for i, x in enumerate(s):
            res[f"suffix_{tag}/{i}"] = x.numpy()

    # -- LieILQR with the time-sharded backward, screw-200 cut to LIE_H --------
    model, params, _, _ = al_bench.screw200_model(f64, "cpu", horizon=LIE_H)
    cp = params["cost"]
    q0s, xi0s = sweep.build_x0_batch(LIE_STARTS[0], LIE_STARTS[1], cp.q_ref[0], cp.xi_ref[0])
    us0 = torch.zeros((len(LIE_STARTS[1]), LIE_H, 6), dtype=f64)
    for bw in ("associative_sharded", "associative")[:2 - rank]:
        solver = LieILQR(model, SolverConfig(N=LIE_H, backward=bw, max_iterations=LIE_ITERS))
        st = solver.solve(params, (q0s, xi0s), us0)
        for f in ("us", "J_opt", "grad_norm", "iteration"):
            res[f"lie_{bw}/{f}"] = getattr(st, f).numpy()

    # -- the batch-sharded pipeline, H = 16, B = 4 ------------------------------
    for tag, dtype in (("f32", torch.float32), ("f64", f64)):
        g = _group(data, f"pipe_{tag}")
        dyn = dyn_from_numpy(_group(data, f"pipe_{tag}_dyn"), dtype=dtype)
        cost = cost_from_numpy(_group(data, f"pipe_{tag}_cost"), dtype=dtype)
        H, iters = int(g["H"]), int(g["iterations"])
        pipe = parallel.make_sharded_pipeline(H, iters, float(dyn.dt), mesh=bmesh)
        B = g["q0s"].shape[0]
        if tag == "f32":
            # the inputs as the global batch of each rank's rows
            rows = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
            q0s, xi0s, us0 = (parallel.distribute_batch(g[k][rows], bmesh)
                              for k in ("q0s", "xi0s", "us0"))
        else:
            q0s, xi0s, us0 = (T(g[k]) for k in ("q0s", "xi0s", "us0"))
        out = parallel.gather_to_all(pipe.solve(dyn, cost, q0s, xi0s, us0))
        for f in out._fields:
            res[f"pipe_{tag}_sharded/{f}"] = getattr(out, f)
        if rank == 0:
            ref = PipelineSolver(H, iters, float(dyn.dt)).solve(
                dyn, cost, *(T(g[k]) for k in ("q0s", "xi0s", "us0")))
            for f in out._fields:
                res[f"pipe_{tag}_single/{f}"] = getattr(ref, f).numpy()

    # -- BatchSolver over the batch mesh: the sweep task's solver ---------------
    bs, sp, base_q0, base_xi0 = EB.build_sweep(f64, "cpu", N=SWEEP_H)
    q0s, xi0s = sweep.build_x0_batch(SWEEP_STARTS[0], SWEEP_STARTS[1], base_q0, base_xi0)
    us0 = torch.zeros((len(SWEEP_STARTS[1]), SWEEP_H, 6), dtype=f64)
    st = multihost.gather_to_all(
        parallel.BatchSolver(bs.solver, mesh=bmesh).solve_batch(sp, q0s, xi0s, us0))
    for f in ("us", "J_opt", "grad_norm", "iteration", "converged", "failed"):
        res[f"batch/{f}"] = getattr(st, f)

    # -- the rollout sweep over the batch mesh, and without ----------------------
    dyn, dp, bq0, bxi0, _ = EB.build_rollout_sweep(device="cpu")
    for tag, mesh in (("mesh", bmesh), ("single", None))[:2 - rank]:
        out = sweep.run_rollout_sweep(dyn, dp, ROLLOUT_RANGES, bq0, bxi0, N=ROLLOUT_STEPS,
                                      mesh=mesh)
        for name, r in out.items():
            res[f"rollout_{tag}/{name}_qs"], res[f"rollout_{tag}/{name}_xis"] = r.qs, r.xis

    # -- distribute_batch -> gather_to_all ---------------------------------------
    local = np.arange(6, dtype=np.float64).reshape(3, 2) + 100 * rank
    res["roundtrip"] = parallel.gather_to_all(parallel.distribute_batch(local, bmesh))

    # -- the dry run on the toy problem: batch-sharded LieILQR, the sharded
    #    pipeline, the time-sharded backward (each against its one-device run)
    tm, tp, q0, xi0, q_ref, xi_ref, N = toy.toy_problem(TOY_N, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    q0s = se3.normalize(q0[None] @ se3.exp(T(0.05 * rng.standard_normal((TOY_B, 6))).float()))
    xi0s = xi0.expand(TOY_B, 6).contiguous()
    us0 = torch.zeros((TOY_B, N, 6))
    cfg = SolverConfig(N=N, max_iterations=TOY_ITERS, tol_grad_norm=0.0, tol_d_norm=0.0)
    solver = LieILQR(tm, cfg)
    res["toy_batch/sharded"] = multihost.gather_to_all(
        parallel.BatchSolver(solver, mesh=bmesh).solve_batch(tp, q0s, xi0s, us0).us)
    pipe = parallel.make_sharded_pipeline(N, TOY_ITERS, float(tp["dyn"].dt), mesh=bmesh)
    res["toy_pipe/sharded"] = parallel.gather_to_all(
        pipe.solve(tp["dyn"], tp["cost"], q0s, xi0s, us0).J_opt)
    if rank == 0:
        res["toy_batch/single"] = parallel.BatchSolver(solver).solve_batch(
            tp, q0s, xi0s, us0).us.numpy()
        res["toy_pipe/single"] = PipelineSolver(N, TOY_ITERS, float(tp["dyn"].dt)).solve(
            tp["dyn"], tp["cost"], q0s, xi0s, us0).J_opt.numpy()
    for bw in ("associative_sharded", "associative")[:2 - rank]:
        ts = LieILQR(tm, SolverConfig(N=N, max_iterations=TOY_ITERS, tol_grad_norm=0.0,
                                      tol_d_norm=0.0, backward=bw))
        if bw == "associative_sharded":
            ts.backward_mesh = tmesh
        res[f"toy_time/{bw}"] = ts.solve(tp, (q0[None], xi0[None]), us0[:1]).us.numpy()

    # -- a torchrun-style job: a mesh constructor in a process with no group
    #    joins the job's group from the environment torchrun sets
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(env_port), WORLD_SIZE=str(WORLD),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    emesh = parallel.make_batch_mesh(device="cpu")
    res["env_mesh"] = np.asarray([emesh.size(), torch.distributed.get_rank()])
    res["env_roundtrip"] = parallel.gather_to_all(parallel.distribute_batch(local, emesh))

    np.savez(f"{prefix}{rank}.npz", **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main(inputs, prefix):
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(free_port(), free_port(), inputs, prefix), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
