"""Task runner: the reference's `main_*.py` scripts as one CLI (counterpart
of the JAX `tasks/run.py`, with its 25 tasks and its JSON lines).

Usage:
    python -m trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.run <task>
        [--plot DIR] [--x64] [--cpu]

Tasks mirror the reference scripts:
    cartpole            main_ddp.py
    so3_tracking        main_SO3ddp_tracking_exact.py (SS)
    so3_tracking_ms     main_SO3ddp_tracking_exact_ms.py (MS)
    pendulum3d_ms       main_pendulum3d_ddp_tracking_exact_ms.py
    se3_tracking        main_SE3ddp_tracking_exact.py (SS)
    se3_tracking_ms     main_SE3ddp_tracking_exact_ms.py (MS)
    drone_ms            main_drone_ddp_tracking_exact_ms.py
    rigid_body_ms       main_RigidBody_ddp_tracking_exact_ms.py (gravity)
    se3_al_ms           main_SE3ddp_tracking_exact_al_ms.py (input box +-100)
    errstate_tracking   main_SE3ddp_tracking_approx.py
    errstate_generate   main_errSE3ddp_nonlinear_rollout_generation.py
    errstate_generate_linear  main_errSE3ddp_linear_rollout_generation.py
    baseline_su2        main_SU2_SE3_baseline.py (embedded R^13 iLQR)
    baseline_embedded   baseline_SE3_nlpsol_embedded.py families (3 variants)
    dynamics_sim        main_SE3dynamics.py / main_errSE3dynamics.py
    cost_landscape      visualization/visual_cost_3d_fixed.py
    mpc                 closed-loop receding-horizon MPC demo
    mpc_native          the same closed loop on the native C++ runtime (host CPU)
    al_batch            batched input-constrained solves
    mpc_batch           Monte-Carlo closed-loop MPC on the pipeline
    mpc_batch_constrained  the same with an input box
    benchmark_compare   benchmark_SE3_tracking.py (cross-solver agreement)
    benchmark_compare_so3  benchmark_SO3_tracking.py + benchmark_pendulum_swingup.py
    sweep               visualization/perturb_all_compute.py (reduced ranges)
    rollout_sweep       visualization/rollout_all_compute.py

Benchmark problems are rebuilt from the reference pickles in
`tasks/parity.RESULTS_DIR` (by default `tasks/golden/reference/`, which
waits for them; a caller points it at `parity.STANDIN_DIR`, the stand-ins
in the reference's schema, to run on those); the AL and error-state tasks
use the reference script constants.

Device and precision.  A task runs on the card; ``--cpu`` runs it on the
CPU instead (without a card and without ``--cpu`` the CLI exits with a
message: it never falls back to the CPU).  ``--x64`` computes in float64
where the JAX CLI computes in the JAX default float (float64 under its
``--x64``); without it those tasks run in float32, as the JAX CLI does
without x64.  The tasks that the JAX CLI runs in float32 explicitly
(`mpc_batch`, `mpc_batch_constrained`, and `al_batch`'s pipeline on the
accelerator) do so here too.  On the card the batch tasks take the JAX
CLI's accelerator sizes and engines: `mpc_batch` and
`mpc_batch_constrained` B, H, T = 1024, 40, 100 on `PipelineSolver`
(kernels B1-B3), `al_batch` on `ALPipelineSolver`; on the CPU the JAX CLI's
CPU sizes (4, 10, 5) and `al_batch` on `FastBatchSolver(use_pallas=False)`
with `ALFastSolver`.  The performance record (`utils.records`) is written
only on the card, as the JAX CLI writes it only on the TPU.

Random draws.  `dynamics_sim`, `al_batch`, `mpc_batch` and
`mpc_batch_constrained` draw their perturbations through `draw_normal`, a
`torch.Generator` seeded with the JAX CLI's PRNG key seed: the streams
differ from `jax.random`'s, so the tests replace `draw_normal` with the JAX
draws to give both CLIs the same inputs.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"


def draw_normal(seed, shape, dtype, device):
    """Standard normal draws of ``shape`` for a task's perturbations, from a
    `torch.Generator` seeded with ``seed`` (made on the CPU in float64, then
    cast and moved to ``device``)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(device=device,
                                                                     dtype=dtype)


def _flat(hist):
    """A batch-native history (a list of B = 1 lists) as a list of floats."""
    return [h[0] if isinstance(h, list) else h for h in hist]


def _summary(name, J_hist, grad_hist, state=None, extra=None):
    out = dict(task=name, iterations=len(J_hist),
               J_first=J_hist[0] if J_hist else None,
               J_final=J_hist[-1] if J_hist else None,
               grad_final=grad_hist[-1] if grad_hist else None)
    if state is not None and hasattr(state, "converged"):
        out["converged"] = bool(state.converged)
    if extra:
        out.update(extra)
    print(json.dumps(out))
    return out


def _cast(p, dtype):
    """A parameter container (dataclass) with its floating tensors cast to
    ``dtype`` (the JAX CLI's ``to32``)."""
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(dtype) for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)
        and getattr(p, f.name).is_floating_point()})


def _cut(cp, H):
    """The cost params' reference cut to its first H + 1 entries."""
    cut = lambda a: a[: H + 1]
    return dataclasses.replace(cp, q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                               Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))


def _benchmark(name, ms, args):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.parity import (
        build_benchmark,
    )

    return build_benchmark(name, ms, dtype=args.dtype, device=args.device)


def _t(args, x):
    """An array-like as a tensor in the run's dtype on its device."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(device=args.device, dtype=args.dtype)


def _sync(args):
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)


def run_cartpole(args):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import cartpole

    xs, us, J_hist, grad_hist, state = cartpole.run(n_iterations=200, dtype=args.dtype,
                                                    device=args.device)
    J_hist, grad_hist = _flat(J_hist), _flat(grad_hist)
    res = _summary("cartpole", J_hist, grad_hist, state,
                   {"final_state": xs[0, -1].tolist()})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import plots

        plots.convergence(J_hist, grad_hist, f"{args.plot}/cartpole_convergence.png")
    return res


def run_benchmark_task(name, bench_name, ms, args):
    data, solver, params, x0, us0, sol_key = _benchmark(bench_name, ms, args)
    _sync(args)
    t0 = time.perf_counter()
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(params, x0, us0)
    wall = time.perf_counter() - t0
    J_hist, grad_hist, defect_hist = _flat(J_hist), _flat(grad_hist), _flat(defect_hist)
    us_ref = np.asarray(data[sol_key]["us"])
    err = float(np.max(np.abs(us[0].cpu().numpy() - us_ref)))
    res = _summary(name, J_hist, grad_hist, state,
                   {"wall_s": round(wall, 2), "us_vs_reference_max_err": err})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import plots

        plots.convergence(J_hist, grad_hist, f"{args.plot}/{name}_convergence.png",
                          defect_hist=defect_hist)
        plots.trajectory_3d(qs[0], params["cost"].q_ref, f"{args.plot}/{name}_trajectory.png")
    return res


def run_al(args):
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import (
        constraints as cs,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_ilqr import ALILQR
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )

    data, _, _, _, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H = 200
    q_ref = _t(args, np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = _t(args, np.asarray(prob["xi_ref"])[: H + 1])
    dp = dynamics.se3_params(_t(args, prob["J"]), _t(args, float(prob["dt"])))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, _t(args, prob["Q"]), _t(args, prob["R"]),
                                    _t(args, prob["P"]), q_ref, xi_ref)
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(torch.tensor(-100.0, dtype=args.dtype), 100.0, 6,
                                   device=args.device)
    model_c, _ = make_model(dynamics.se3_dynamics(), costs.al_cost(cd, constr), dp, None)
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size, mu0=1e-2,
                               dtype=args.dtype, device=args.device)
    # the PD-safe parallel-prefix Riccati (solvers/riccati.
    # parallel_backward_adaptive): O(log N)-depth backward with the
    # whole-sweep batched LM retry, on the constrained task whose AL penalty
    # escalation (mu up to 1e8 on Quu) is where PD safety earns its keep
    cfg = SolverConfig(N=H, multiple_shooting=True, rollout="nonlinear",
                       tol_grad_norm=1e-8, max_iterations=100, backward="associative")
    al = ALILQR(LieILQR(model_c, cfg), constr, tol_constr=1e-2)
    q0 = SE3.normalize(q_ref[0] @ SE3.exp(_t(args, [0.02, -0.01, 0.03, 0.05, -0.02, 0.01])))
    xi0 = xi_ref[0] + 0.05
    res = al.fit({"dyn": dp, "cost": alp}, (q0[None], xi0[None]),
                 torch.zeros((1, H, 6), dtype=args.dtype, device=args.device),
                 n_al_iters=20, n_ilqr_iters=100)
    print(json.dumps(dict(
        task="se3_al_ms", outer_iterations=res.outer_iterations,
        constr_converged=bool(res.constr_converged),
        max_violation=float(torch.max(res.constr_eval)),
        u_range=[float(torch.min(res.us)), float(torch.max(res.us))],
    )))


def _errstate_task(name, key, args):
    """One of the three error-state CLI problems (`tasks/errstate_bench.py`,
    the JAX CLI's constants) and its summary line."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

    prob = EB.PROBLEMS[name](args.dtype, args.device)
    state, J_hist, grad_hist, _ = prob.solver.fit(prob.cost_params, prob.params, prob.us0,
                                                  x0=prob.x0)
    _summary(name, J_hist, grad_hist, state, {key: EB.final_error(prob, state)})


def run_errstate(args):
    _errstate_task("errstate_generate", "final_goal_err_norm", args)


def run_errstate_tracking(args):
    """Error-state approximate tracking (ref `main_SE3ddp_tracking_approx.py`,
    `iLQR_Tracking_ErrorState_Approx` at traopt_controller.py:3300)."""
    _errstate_task("errstate_tracking", "final_err_norm", args)


def run_errstate_linear(args):
    """Error-state goal generation with LTV (linear) rollout
    (ref `main_errSE3ddp_linear_rollout_generation.py:34-130`)."""
    _errstate_task("errstate_generate_linear", "final_goal_err_norm", args)


def sweep_problem(args):
    """The `sweep` task's solver and problem: (LieILQR, params, base_q0,
    base_xi0), the SE3 benchmark cut to N = 200, 10 iterations at mu = 0."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR

    data, solver, params, x0, us0, _ = _benchmark("se3_tracking", True, args)
    cfg = dataclasses.replace(solver.cfg, N=200, max_iterations=10, tol_grad_norm=0.0,
                              tol_d_norm=0.0, backward="sequential_fixed")
    solver = LieILQR(solver.model, cfg, pallas_rollout_dt=solver.pallas_rollout_dt)
    cp = _cut(params["cost"], 200)
    return solver, {**params, "cost": cp}, cp.q_ref[0], cp.xi_ref[0]


def run_sweep_task(args):
    import torch.distributed as dist

    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import (
        BatchSolver,
        make_batch_mesh,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.sweep import run_sweep
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.errstate_bench import (
        SWEEP_RANGES,
    )

    solver, params, q0, xi0 = sweep_problem(args)
    # the batch mesh over the job's ranks (one device a rank; a plain process
    # joins a one-process group on its device, left again at the end), as
    # the JAX CLI's
    joined = not dist.is_initialized()
    bs = BatchSolver(solver, mesh=make_batch_mesh(device=args.device))
    try:
        _sync(args)
        t0 = time.perf_counter()
        out = run_sweep(bs, params, SWEEP_RANGES, q0, xi0, nu=6)
        wall = time.perf_counter() - t0
    finally:
        if joined:
            dist.destroy_process_group()
    total = sum(len(v.values) for v in out.values())
    print(json.dumps(dict(task="sweep", n_solves=total, wall_s=round(wall, 2),
                          solves_per_s=round(total / wall, 1),
                          params={k: dict(n=len(v.values),
                                          J_min=float(v.J_opt.min()),
                                          J_max=float(v.J_opt.max()))
                                  for k, v in out.items()})))


def run_rigid_body(args):
    """SE(3) rigid body under gravity tracking the SE3 task's path
    (ref `main_RigidBody_ddp_tracking_exact_ms.py:101-158`: same path and
    weights as the SE3 task, `RigidBodyDynamics` with g=9.8)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )

    data, _, _, _, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H = 200
    q_ref = _t(args, np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = _t(args, np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dp = dynamics.rigid_body_params(_t(args, prob["J"]), float(prob["dt"]), g=9.8)
    cp = costs.tracking_cost_params(SE3, _t(args, prob["Q"]), _t(args, prob["R"]),
                                    _t(args, prob["P"]), q_ref, xi_ref)
    model, params = make_model(dynamics.rigid_body_dynamics(), costs.tracking_cost(SE3, 6),
                               dp, cp)
    cfg = SolverConfig(N=H, multiple_shooting=True, rollout="nonlinear", n_alphas=20,
                       tol_grad_norm=1e-6, tol_d_norm=1e-4, max_iterations=100)
    solver = LieILQR(model, cfg)
    _sync(args)
    t0 = time.perf_counter()
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(
        params, (q_ref[:1], xi_ref[:1]),
        torch.zeros((1, H, 6), dtype=args.dtype, device=args.device))
    wall = time.perf_counter() - t0
    J_hist, grad_hist, defect_hist = _flat(J_hist), _flat(grad_hist), _flat(defect_hist)
    res = _summary("rigid_body_ms", J_hist, grad_hist, state,
                   {"wall_s": round(wall, 2),
                    "defect_final": defect_hist[-1] if defect_hist else None})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import plots

        plots.convergence(J_hist, grad_hist, f"{args.plot}/rigid_body_ms_convergence.png",
                          defect_hist=defect_hist)
        plots.trajectory_3d(qs[0], q_ref, f"{args.plot}/rigid_body_ms_trajectory.png")
    return res


def _errstate_circle_reference(args, N=400, dt=0.01):
    """Twist-integrated reference mirroring the error-state scripts'
    construction (ref `main_SE3ddp_tracking_approx.py:52-66`: constant twist
    from an euler/position target divided by the horizon)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import (
        errorstate as es,
    )

    t = lambda x: _t(args, x)
    J = t(np.block([[np.diag([0.5, 0.7, 0.9]), np.zeros((3, 3))],
                    [np.zeros((3, 3)), np.eye(3)]]))
    w_ref = np.array([math.pi / 4, math.pi / 4, math.pi / 2]) / (N * dt)
    v_ref = np.array([10.0, 10.0, 10.0]) / (N * dt)
    xi0 = t(np.concatenate([w_ref, v_ref]))
    p0 = es.errorstate_params(J, dt, t(np.zeros((N + 1, 4, 4))), t(np.zeros((N + 1, 6))))
    qs, xis = es.rollout_nominal(p0, t(np.eye(4)), xi0, t(np.zeros((N, 6))))
    return es.reanchor(p0, qs, xis), J, xi0


def run_baseline_su2(args):
    """Embedded-Euclidean SU(2) baseline on the SE3 tracking slice
    (ref `main_SU2_SE3_baseline.py`, `EmbeddedEuclideanSU2_SE3:642`)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines.embedded import (
        solve_su2,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.metrics import (
        quat_norm_violation,
    )

    data, _, _, _, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H = 200
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    xs, us, J_hist, grad_hist, st = solve_su2(
        prob["J"], float(prob["dt"]), q_ref, xi_ref, prob["Q"], prob["R"], prob["P"],
        (q_ref[0], xi_ref[0].reshape(6) + 0.05),
        torch.zeros((H, 6), dtype=args.dtype, device=args.device), n_iterations=100)
    drift = quat_norm_violation(xs)
    _summary("baseline_su2", J_hist, grad_hist, st,
             {"quat_norm_violation_max": float(drift.max())})


def run_baseline_embedded(args):
    """The three embedded rotation-matrix baseline families (ref
    `traopt_baseline.py` EmbeddedEuclidean*_DynamicsConstr{,_LogCost},
    ConstraintStabilization*) on the SE3 tracking slice."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines.embedded import (
        solve_se3_matrix,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.metrics import (
        orthogonality_violation,
    )

    data, _, _, _, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H = 120
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    x0 = (q_ref[0], xi_ref[0].reshape(6) + 0.05)
    out = {}
    for variant in ("dynconstr", "logcost", "stabilized"):
        xs, us, J_hist, grad_hist, st = solve_se3_matrix(
            prob["J"], float(prob["dt"]), q_ref, xi_ref, prob["Q"], prob["R"], prob["P"],
            x0, torch.zeros((H, 6), dtype=args.dtype, device=args.device),
            variant=variant, n_iterations=60)
        viol = orthogonality_violation(xs[:, :9].reshape(-1, 3, 3))
        out[variant] = dict(J_final=float(J_hist[-1]),
                            orthogonality_violation_max=float(viol.max()))
    print(json.dumps(dict(task="baseline_embedded", variants=out)))


def run_dynamics_sim(args):
    """Open-loop dynamics comparison (ref `main_SE3dynamics.py`,
    `main_errSE3dynamics.py`): exact SE(3) rollout vs error-state
    linearized propagation about the nominal, report divergence."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import errorstate as es
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3

    N = 200
    params, J, xi0 = _errstate_circle_reference(args, N=N)
    us = 0.1 * draw_normal(0, (N, 6), args.dtype, args.device)
    # exact group rollout with the input sequence
    qs_exact, xis_exact = es.rollout_nominal(params, _t(args, np.eye(4)), xi0, us)
    # error-state propagation of the same inputs about the (zero-input) nominal
    x = torch.zeros(12, dtype=args.dtype, device=args.device)
    x[6:] = xi0
    xs_es = []
    for i in range(N):
        x = es.step_euler(params, x, us[i], i)
        xs_es.append(x)
    xs_es = torch.stack(xs_es)
    # reconstruct the group trajectory from the error state and compare
    qs_es = params.q_ref[1:] @ se3.exp(xs_es[:, :6])
    pose_div = torch.linalg.norm(se3.log(se3.inverse(qs_es) @ qs_exact[1:]), dim=-1)
    vel_div = torch.linalg.norm(xs_es[:, 6:] - xis_exact[1:], dim=-1)

    # open-loop 3-D pendulum swing (ref main_pendulum3d_dynamics.py:7-35:
    # J=diag(.5,.7,.9), m=1, l=0.5, dt=0.01, 10-degree initial tilt, u=0)
    pp = dynamics.pendulum3d_params(_t(args, np.diag([0.5, 0.7, 0.9])), 1.0, 0.5, 0.01)
    pend = dynamics.pendulum3d_dynamics()
    q0p = SO3.exp(_t(args, [math.radians(10.0), 0.0, 0.0]))
    q, xi = q0p, torch.zeros(3, dtype=args.dtype, device=args.device)
    zero = torch.zeros(3, dtype=args.dtype, device=args.device)
    tilt = []
    for i in range(320):
        q, xi = pend.step(pp, q, xi, zero, i)
        tilt.append(torch.linalg.norm(SO3.log(q)))
    tilt = torch.stack(tilt)
    # released from rest at 10 deg it swings through the hanging equilibrium:
    # tilt dips toward 0 and stays bounded near the release amplitude
    # (slight Euler energy drift allowed).
    t0 = float(torch.linalg.norm(SO3.log(q0p)))  # release tilt
    print(json.dumps(dict(
        task="dynamics_sim", N=N,
        pose_divergence_final=float(pose_div[-1]),
        pose_divergence_max=float(pose_div.max()),
        vel_divergence_max=float(vel_div.max()),
        pendulum_tilt_initial=t0,
        pendulum_tilt_min=float(torch.min(tilt)),
        pendulum_tilt_max=float(torch.max(tilt)),
        pendulum_swings=bool((torch.min(tilt) < 0.25 * t0) & (torch.max(tilt) < 1.5 * t0)),
    )))


def run_cost_landscape(args):
    """SE(3) cost-landscape grid (ref `visualization/visual_cost_3d_fixed.py`:
    left/right-error cost over a (theta_z, theta_y) rotation grid)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.viz.cost_landscape import (
        plot_landscape,
        pose_error_grid,
    )

    data, _, params, _, _, _ = _benchmark("se3_tracking", True, args)
    cp = params["cost"]
    th = np.linspace(-180.0, 180.0, 73)
    out = {}
    for left in (True, False):
        Z, _, _ = pose_error_grid(cp.q_ref[0], th, th, cp.Q1, left=left)
        name = "left" if left else "right"
        out[name] = dict(min=float(Z.min()), max=float(Z.max()))
        if args.plot:
            plot_landscape(Z, th, th, f"{args.plot}/cost_landscape_{name}.png",
                           title=f"SE(3) {name}-error cost landscape")
    print(json.dumps(dict(task="cost_landscape", grids=out)))


def _mpc_start(cp, args):
    """The MPC tasks' initial pose: the reference's first pose perturbed by
    Exp([0.05, -0.03, 0.08, 0.3, -0.2, 0.25])."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

    dq = torch.tensor([0.05, -0.03, 0.08, 0.3, -0.2, 0.25], dtype=torch.float64)
    return SE3.normalize(cp.q_ref[0] @ SE3.exp(dq.to(cp.xi_ref)))


def run_mpc(args):
    """Closed-loop receding-horizon MPC on the SE3 tracking path (the
    BASELINE.json north-star workload, H=40 window)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.mpc import (
        make_closed_loop,
    )

    data, solver, params, x0, us0, _ = _benchmark("se3_tracking", True, args)
    H, T = 40, 150
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=4, tol_grad_norm=0.0,
                              tol_d_norm=0.0, backward="sequential_fixed", line_search=False)
    solver = LieILQR(solver.model, cfg, pallas_rollout_dt=solver.pallas_rollout_dt)
    run = make_closed_loop(solver, T)
    cp = params["cost"]
    q0 = _mpc_start(cp, args)
    _sync(args)
    t0 = time.perf_counter()
    res = run(params, q0[None], cp.xi_ref[:1])
    _sync(args)
    wall = time.perf_counter() - t0
    track_err = torch.linalg.norm(se3.log(se3.inverse(cp.q_ref[: T + 1]) @ res.qs[0]), dim=-1)
    print(json.dumps(dict(
        task="mpc", horizon=H, steps=T, wall_s=round(wall, 2),
        solves_per_s=round(T / wall, 1),
        tracking_err_initial=float(track_err[0]),
        tracking_err_final=float(track_err[-1]),
        tracking_err_shrink_ratio=float(track_err[-1] / track_err[0]),
    )))
    if args.plot:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import plots

        plots.trajectory_3d(res.qs[0], cp.q_ref[: T + 1], f"{args.plot}/mpc_trajectory.png")


def run_rollout_sweep_task(args):
    """Open-loop rollout sweeps (ref `visualization/rollout_all_compute.py`:
    J=diag(.5,.7,.9)+I, dt=0.01, 14 s horizon, zero controls, 12 initial-
    condition parameters swept one at a time; here the JAX CLI's four)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.sweep import (
        run_rollout_sweep,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

    dyn, dp, base_q0, base_xi0, nsim = EB.build_rollout_sweep(args.dtype, args.device)
    _sync(args)
    t0 = time.perf_counter()
    out = run_rollout_sweep(dyn, dp, EB.ROLLOUT_RANGES, base_q0, base_xi0, N=nsim)
    wall = time.perf_counter() - t0
    total = sum(len(v.values) for v in out.values())
    print(json.dumps(dict(
        task="rollout_sweep", n_rollouts=total, steps=nsim,
        wall_s=round(wall, 2),
        params={k: dict(
            n=len(v.values),
            all_finite=bool(np.all(np.isfinite(v.qs)) and np.all(np.isfinite(v.xis))),
            final_pos_spread=float(np.ptp(v.qs[:, -1, :3, 3], axis=0).max()),
        ) for k, v in out.items()})))


def run_mpc_native(args):
    """Closed-loop MPC on the native C++ runtime (the host CPU, no device in
    the loop): the deployable-controller counterpart of the `mpc` task, same
    window/budget/warm-start semantics (native.NativeMPC)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import native
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3

    if native.LIB is None:
        print(json.dumps(dict(task="mpc_native", error="no native toolchain")))
        return
    data, _, params, x0, us0, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    cp = params["cost"]
    H, T = 40, 150
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"], prob["P"],
                               cp.q_ref, cp.xi_ref, iterations=4)
    mpc = native.NativeMPC(s, H)
    q0 = _mpc_start(cp, args)
    t0 = time.perf_counter()
    qs, xis, us, J_pred = mpc.run(q0, cp.xi_ref[0], T)
    wall = time.perf_counter() - t0
    q_ref = cp.q_ref[: T + 1].cpu().double()
    track_err = torch.linalg.norm(se3.log(se3.inverse(q_ref) @ qs), dim=-1)
    print(json.dumps(dict(
        task="mpc_native", horizon=H, steps=T, wall_s=round(wall, 3),
        solves_per_s=round(T / wall, 1),
        ms_per_solve=round(wall / T * 1e3, 3),
        tracking_err_initial=float(track_err[0]),
        tracking_err_final=float(track_err[-1]),
        tracking_err_shrink_ratio=float(track_err[-1] / track_err[0]),
    )))


def _save_compare_pickle(args, prob, cp, q0, xi0, artifacts):
    """The reference-format result artifact (benchmark_SE3_tracking.py:272-345)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import (
        save_benchmark_pickle,
    )

    path = f"{args.plot}/results_benchmark_compare.pkl"
    save_benchmark_pickle(
        path, dict(J=prob["J"], dt=prob["dt"], q_ref=cp.q_ref, xi_ref=cp.xi_ref,
                   x0=(q0, xi0), Q=prob["Q"], P=prob["P"], R=prob["R"]),
        artifacts)
    return path


def run_benchmark_compare(args):
    """Cross-solver agreement benchmark (ref `benchmark_SE3_tracking.py`):
    MS-iLQR vs SS-iLQR vs the embedded baselines on one SE(3) tracking
    slice, with the reference's metrics — manifold violation
    ||R^T R - I|| (:414-418), dynamics violation via one-step re-simulation
    (:453-457), and final tracking error (:832-848)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines.embedded import (
        solve_se3_matrix,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import metrics

    data, solver_ms, params, x0, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H = 120
    cp = _cut(params["cost"], H)
    params = {**params, "cost": cp}
    q0 = SE3.normalize(cp.q_ref[0] @ SE3.exp(_t(args, [0.02, -0.01, 0.03, 0.05, -0.02, 0.01])))
    xi0 = cp.xi_ref[0] + 0.05
    us0 = torch.zeros((1, H, 6), dtype=args.dtype, device=args.device)
    model = solver_ms.model
    out, artifacts = {}, {}

    for name, ms in (("ms_ilqr", True), ("ss_ilqr", False)):
        cfg = dataclasses.replace(solver_ms.cfg, N=H, multiple_shooting=ms, max_iterations=100)
        s = LieILQR(model, cfg, pallas_rollout_dt=solver_ms.pallas_rollout_dt)
        (qs, xis), us, J_hist, grad_hist, defect_hist, _ = s.fit(
            params, (q0[None], xi0[None]), us0)
        qs, xis, us = qs[0], xis[0], us[0]
        J_hist = _flat(J_hist)
        out[name] = dict(
            J_final=float(J_hist[-1]),
            orthogonality_violation_max=float(metrics.orthogonality_violation(qs).max()),
            dynamics_violation_max=float(
                metrics.dynamics_violation(model, params, qs, xis, us).max()),
            tracking_err_final=float(metrics.tracking_errors(SE3, cp, qs, xis)[0][-1]),
        )
        artifacts[name] = dict(xs=dict(qs=qs, xis=xis), us=us, J_hist=J_hist,
                               grad_hist=_flat(grad_hist), defect_hist=_flat(defect_hist))

    for variant in ("dynconstr", "logcost", "stabilized", "stabilized_logcost"):
        xs, us, J_hist, grad_hist, st = solve_se3_matrix(
            prob["J"], float(prob["dt"]), cp.q_ref, cp.xi_ref, prob["Q"], prob["R"],
            prob["P"], (q0, xi0), us0[0], variant=variant, n_iterations=60)
        out[f"baseline_{variant}"] = dict(
            J_final=float(J_hist[-1]),
            orthogonality_violation_max=float(
                metrics.orthogonality_violation(xs[:, :9].reshape(-1, 3, 3)).max()),
        )
        artifacts[f"{variant}_euc"] = dict(xs=xs, us=us, J_hist=J_hist, grad_hist=grad_hist)
    # cross-solver agreement: the Lie solvers must agree closely
    out["ms_ss_J_gap"] = abs(out["ms_ilqr"]["J_final"] - out["ss_ilqr"]["J_final"])
    if args.plot:
        out["pickle"] = _save_compare_pickle(args, prob, cp, q0, xi0, artifacts)
    print(json.dumps(dict(task="benchmark_compare", horizon=H, solvers=out)))


def run_benchmark_compare_so3(args):
    """SO(3)-family cross-solver agreement (ref `benchmark_SO3_tracking.py`
    and `benchmark_pendulum_swingup.py`): MS-iLQR vs SS-iLQR vs the
    embedded SU(2) baseline and all four embedded-matrix mechanism
    families, on the SO(3) attitude-tracking slice AND the 3-D pendulum
    swing-up, with the reference's agreement metrics."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.baselines.embedded import (
        solve_so3_family,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import metrics

    results = {}
    for bench_name, pendulum, H in (("so3_tracking", False, 80),
                                    ("pendulum_swingup", True, 80)):
        data, solver_ms, params, x0, _, _ = _benchmark(bench_name, True, args)
        prob = data["prob"]
        H = min(H, params["cost"].q_ref.shape[0] - 1)
        cp = _cut(params["cost"], H)
        params = {**params, "cost": cp}
        q0 = SO3.normalize(cp.q_ref[0] @ SO3.exp(_t(args, [0.02, -0.01, 0.03])))
        xi0 = cp.xi_ref[0] + 0.05
        us0 = torch.zeros((1, H, 3), dtype=args.dtype, device=args.device)
        model = solver_ms.model
        out = {}
        for name, ms in (("ms_ilqr", True), ("ss_ilqr", False)):
            cfg = dataclasses.replace(solver_ms.cfg, N=H, multiple_shooting=ms,
                                      max_iterations=100)
            (qs, xis), us, J_hist, *_ = LieILQR(model, cfg).fit(
                params, (q0[None], xi0[None]), us0)
            qs, xis, us = qs[0], xis[0], us[0]
            out[name] = dict(
                J_final=float(_flat(J_hist)[-1]),
                orthogonality_violation_max=float(metrics.orthogonality_violation(qs).max()),
                dynamics_violation_max=float(
                    metrics.dynamics_violation(model, params, qs, xis, us).max()),
                tracking_err_final=float(metrics.tracking_errors(SO3, cp, qs, xis)[0][-1]),
            )
        pend_kw = {}
        if pendulum:
            pend_kw = dict(m=float(prob["m"]), length=float(prob["length"]),
                           g=float(prob.get("g", 9.8)))
        for form in ("su2", "dynconstr", "logcost", "stabilized", "stabilized_logcost"):
            xs, us_b, J_hist, grad_hist, st = solve_so3_family(
                prob["J"], float(prob["dt"]), cp.q_ref, cp.xi_ref, prob["Q"], prob["R"],
                prob["P"], (q0, xi0), us0[0], formulation=form, pendulum=pendulum,
                n_iterations=60, **pend_kw)
            rec = dict(J_final=float(J_hist[-1]))
            if form == "su2":
                rec["quat_norm_violation_max"] = float(torch.max(torch.abs(
                    torch.linalg.norm(xs[:, :4], dim=-1) - 1.0)))
            else:
                rec["orthogonality_violation_max"] = float(
                    metrics.orthogonality_violation(xs[:, :9].reshape(-1, 3, 3)).max())
            out[f"baseline_{form}"] = rec
        out["ms_ss_J_gap"] = abs(out["ms_ilqr"]["J_final"] - out["ss_ilqr"]["J_final"])
        results[bench_name] = dict(horizon=H, solvers=out)
    print(json.dumps(dict(task="benchmark_compare_so3", **results)))


def run_al_batch(args):
    """Batched input-constrained SE(3) tracking: the AL outer loop over a
    batch of perturbed starts (the reference solves one constrained problem
    per process)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import (
        constraints as cs,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

    data, _, _, _, _, _ = _benchmark("se3_tracking", True, args)
    prob = data["prob"]
    H, B = 60, 32
    q_ref = _t(args, np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = _t(args, np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dp = dynamics.se3_params(_t(args, prob["J"]), _t(args, float(prob["dt"])))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, _t(args, prob["Q"]), _t(args, prob["R"]),
                                    _t(args, prob["P"]), q_ref, xi_ref)
    lb, ub = -100.0, 100.0
    dq = 0.03 * draw_normal(2, (B, 6), args.dtype, args.device)
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = xi_ref[0].expand(B, 6) + 0.05
    us0 = torch.zeros((B, H, 6), dtype=args.dtype, device=args.device)

    _sync(args)
    if args.device.type == "cuda":
        # the pipeline with in-loop AL terms (B1-B3), f32 on the card
        from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
            ALPipelineSolver,
        )
        from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
            PipelineSolver,
        )

        f32 = torch.float32
        pipe = PipelineSolver(N=H, iterations=25, dt=float(prob["dt"]))
        al = ALPipelineSolver(pipe, lb=np.full(6, lb), ub=np.full(6, ub), tol_constr=1e-2)
        t0 = time.perf_counter()
        res = al.solve(_cast(dp, f32), _cast(cp, f32), q0s.to(f32), xi0s.to(f32),
                       us0.to(f32), n_al_iters=15)
        _sync(args)
        wall = time.perf_counter() - t0
        engine = "al_pipeline (PipelineSolver: kernels B1-B3)"
    else:
        from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import (
            ALFastSolver,
        )
        from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (
            FastBatchSolver,
        )

        constr = cs.input_box(12, 6)
        constr_p = cs.input_box_params(torch.tensor(lb, dtype=args.dtype), ub, 6,
                                       device=args.device)
        model_c, _ = make_model(dynamics.se3_dynamics(), costs.al_cost(cd, constr), dp, None)
        alp = costs.al_init_params(cp, constr_p, H, constr.constr_size, mu0=1e-2,
                                   dtype=args.dtype, device=args.device)
        inner = FastBatchSolver(model_c, N=H, iterations=25, use_pallas=False)
        al = ALFastSolver(inner, constr, tol_constr=1e-2)
        t0 = time.perf_counter()
        res = al.solve({"dyn": dp, "cost": alp}, q0s, xi0s, us0, q_ref=q_ref,
                       xi_ref=xi_ref, n_al_iters=15, rescue=True)
        wall = time.perf_counter() - t0
        engine = "al_fast (plain) + batched line-searched rescue"
    mv = res.max_violation.cpu().numpy()
    print(json.dumps(dict(
        task="al_batch", batch=B, horizon=H, engine=engine,
        outer_iterations=res.outer_iterations,
        constr_converged=bool(res.constr_converged),
        lanes_converged=int((mv < 1e-2).sum()),
        max_violation=float(mv.max()),
        u_max=float(torch.max(res.us)), u_min=float(torch.min(res.us)),
        wall_s=round(wall, 2),
    )))


def _batch_mpc_setup(args):
    """The batch MPC tasks' problem in f32 (the JAX CLI's ``to32``), sizes
    and pipeline: (model, dp, cp, B, H, T, pipe)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
        PipelineSolver,
    )

    data, solver_full, params, _, _, _ = _benchmark("se3_tracking", True, args)
    cp, dp = (_cast(params[k], torch.float32) for k in ("cost", "dyn"))
    B, H, T = (1024, 40, 100) if args.device.type == "cuda" else (4, 10, 5)
    pipe = PipelineSolver(N=H, iterations=4, dt=float(dp.dt))
    return solver_full.model, dp, cp, B, H, T, pipe


def mpc_batch_starts(cp, B, seed, device):
    """The batch MPC tasks' start batch of ``seed``: the reference's first
    pose perturbed by Exp(0.05 n), n from `draw_normal` (f32)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

    dq = 0.05 * draw_normal(seed, (B, 6), torch.float32, device)
    return SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))


def _timed_runs(run, cp, B, reps, args):
    """The JAX CLI's timing: a first run on start batch 0, then the best
    wall of ``reps`` runs on start batches 1..reps, each ended by reading
    the last controls to the host.  ``run(q0s, xi0s)`` returns (a
    `BatchMPCResult`, extra).  Returns (the last run's output, wall)."""
    q0_batches = [mpc_batch_starts(cp, B, s, args.device) for s in range(reps + 1)]
    xi0s = cp.xi_ref[0].expand(B, 6).contiguous()
    out = run(q0_batches[0], xi0s)
    _ = out[0].us[:, -1, :].cpu()
    wall = math.inf
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        out = run(q0_batches[r], xi0s)
        _ = out[0].us[:, -1, :].cpu()
        wall = min(wall, time.perf_counter() - t0)
    return out, wall


def _err_to(q_ref_t, qs):
    """||Log(q_ref_t^-1 q)|| of each pose of the batch qs (B, 4, 4)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3

    return torch.linalg.norm(se3.log(se3.inverse(q_ref_t)[None] @ qs), dim=-1)


def run_mpc_batch(args):
    """Monte-Carlo closed-loop MPC: B perturbed plants track the SE(3) path
    simultaneously, every step solved by the lane-layout pipeline (on the
    card kernels B1-B3)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.mpc import (
        make_closed_loop_batch,
    )

    model, dp, cp, B, H, T, pipe = _batch_mpc_setup(args)
    run = make_closed_loop_batch(pipe, model, T)
    (res, _), wall = _timed_runs(lambda q0s, xi0s: (run(dp, cp, q0s, xi0s), None), cp, B,
                                 3, args)
    err0 = _err_to(cp.q_ref[0], res.qs[:, 0])
    errT = _err_to(cp.q_ref[T], res.qs[:, -1])
    result = dict(
        task="mpc_batch", batch=B, horizon=H, steps=T,
        wall_s=round(wall, 3),
        mpc_solves_per_s=round(B * T / wall, 1),
        tracking_err_mean_initial=float(torch.mean(err0)),
        tracking_err_mean_final=float(torch.mean(errT)),
        shrink_ratio=float(torch.mean(errT) / torch.mean(err0)),
    )
    print(json.dumps(result))
    if args.device.type == "cuda":
        from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.records import record

        record("mpc_batch", result)


def run_mpc_batch_constrained(args):
    """Monte-Carlo closed-loop MPC with input box constraints: every plant
    step runs a fixed AL outer budget around the pipeline solve and applies
    a saturated first control (see
    solvers/mpc.make_closed_loop_batch_constrained)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.mpc import (
        make_closed_loop_batch_constrained,
    )

    model, dp, cp, B, H, T, pipe = _batch_mpc_setup(args)
    lb, ub = -300.0, 300.0
    run = make_closed_loop_batch_constrained(pipe, model, T, lb, ub, n_al_iters=4)
    (res, maxv), wall = _timed_runs(lambda q0s, xi0s: run(dp, cp, q0s, xi0s), cp, B, 2,
                                    args)
    errT = _err_to(cp.q_ref[T], res.qs[:, -1])
    result = dict(
        task="mpc_batch_constrained", batch=B, horizon=H, steps=T,
        bounds=[lb, ub], wall_s=round(wall, 3),
        mpc_solves_per_s=round(B * T / wall, 1),
        u_max=float(res.us.max()), u_min=float(res.us.min()),
        planned_violation_mean=float(torch.mean(maxv)),
        tracking_err_mean_final=float(torch.mean(errT)),
    )
    print(json.dumps(result))
    if args.device.type == "cuda":
        from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.records import record

        record("mpc_batch_constrained", result)


TASKS = {
    "cartpole": run_cartpole,
    "so3_tracking": lambda a: run_benchmark_task("so3_tracking", "so3_tracking", False, a),
    "so3_tracking_ms": lambda a: run_benchmark_task("so3_tracking_ms", "so3_tracking", True, a),
    "pendulum3d_ms": lambda a: run_benchmark_task("pendulum3d_ms", "pendulum_swingup", True, a),
    "se3_tracking": lambda a: run_benchmark_task("se3_tracking", "se3_tracking", False, a),
    "se3_tracking_ms": lambda a: run_benchmark_task("se3_tracking_ms", "se3_tracking", True, a),
    "drone_ms": lambda a: run_benchmark_task("drone_ms", "drone_racing", True, a),
    "rigid_body_ms": run_rigid_body,
    "se3_al_ms": run_al,
    "errstate_tracking": run_errstate_tracking,
    "errstate_generate": run_errstate,
    "errstate_generate_linear": run_errstate_linear,
    "baseline_su2": run_baseline_su2,
    "baseline_embedded": run_baseline_embedded,
    "dynamics_sim": run_dynamics_sim,
    "cost_landscape": run_cost_landscape,
    "mpc": run_mpc,
    "mpc_native": run_mpc_native,
    "al_batch": run_al_batch,
    "mpc_batch": run_mpc_batch,
    "mpc_batch_constrained": run_mpc_batch_constrained,
    "benchmark_compare": run_benchmark_compare,
    "benchmark_compare_so3": run_benchmark_compare_so3,
    "sweep": run_sweep_task,
    "rollout_sweep": run_rollout_sweep_task,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("--plot", default=None, help="directory for output figures")
    ap.add_argument("--x64", action="store_true",
                    help="compute in float64 where the JAX CLI computes in its default "
                         "float (float32 without this flag)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = torch.device("cpu")
    elif torch.cuda.is_available():
        args.device = torch.device("cuda", torch.cuda.current_device())
    else:
        sys.exit(f"{PKG}.tasks.run: no CUDA device; the tasks run on the card "
                 "(pass --cpu to run them on the CPU)")
    args.dtype = torch.float64 if args.x64 else torch.float32
    if args.plot:
        os.makedirs(args.plot, exist_ok=True)
    TASKS[args.task](args)


if __name__ == "__main__":
    main()
