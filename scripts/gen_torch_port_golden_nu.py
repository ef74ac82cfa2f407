"""Generate the f64 goldens and the solver schedules of the PyTorch port's four
problems at input dimensions other than 6 and 4.

Each is the screw-200 tracking problem (`tasks/al_bench.build_al1400`'s
first 200 stages, no input box) on a rigid body with g = 0 and the exact
gravity Jacobian (zero at g = 0), driven through an input projection Pu
(6, nu), with R = 1e-2 I:

  screw200_torques3  Pu = [I3; 0]: three body torques (nu = 3);
  screw200_rcs12     a 12-thruster reaction-control layout (nu = 12): for
                     each axis a in (x, y, z), each sign s in (+1, -1) and
                     each offset o in (+0.5, -0.5) along axis b = (a + 1) mod
                     3, in that order, the thruster of direction d = s e_a at
                     r = o e_b, column [r x d; d] (rank 6);
  screw200_rcs16     four quads of four thrusters (nu = 16, the Apollo
                     Service Module's pattern): quads at r = +0.5 e_y,
                     -0.5 e_y, +0.5 e_z, -0.5 e_z, each firing along +e_x,
                     -e_x, + and - the third axis (e_z for the quads on y,
                     e_y for those on z), in that order;
  screw200_rcs24     rcs12's construction with four offsets (nu = 24): for
                     each axis a and sign s, the thrusters of direction s e_a
                     at r = +0.5 e_b, -0.5 e_b, +0.5 e_c, -0.5 e_c (b = (a +
                     1) mod 3, c = (a + 2) mod 3), in that order.

Steps for each (JAX on the CPU; no part of the port is imported):
  1. solve lane 0 (the unperturbed x0) with the XLA f64 engine
     (`FastBatchSolver(use_pallas=False)`), one jitted iteration at a time,
     until the gradient norm falls below 1e-10, then two more iterations:
     the golden;
  2. run the JAX f32 pipeline (`PallasPipelineSolver(interpret=True)`,
     gravity family) for F32_ITERS iterations and record its lane-0 control
     error against the golden (the port's f32 solve is gated at 10 x it);
  3. the schedules: the fewest polish iterations of POLISH_ITERS, and with
     them the fewest f32 iterations of F32_COUNTS (see `fewest`), at which
     the JAX
     `MixedDFPipelineSolver(fx_mode="df", interpret=True)` brings lane 0
     within POLISH_GATE of the golden; likewise the fewest fp64 iterations
     of DF_ITERS, and f32 iterations, at which the JAX f32 pipeline followed
     by step 1's f64 engine from its iterate brings lane 0 within DF_GATE:
     the port's refiner (`DFPipelineSolver`) is the f32 pipeline, then its
     fp64 pipeline from the handoff.  (The JAX `DFPipelineSolver` refines in
     double-f32: on screw200_torques3 its error levels off above DF_GATE,
     and at nu = 12 its compile on the CPU takes over an hour.)  Past ~16
     f32 iterations the f32 phase's own floor is reached, so F32_COUNTS
     ends at 32.

Writes `trajectory_optimization_matrix_lie_groups_tpu_torch/tasks/golden/
{name}_us.npy` (200, nu) and `{name}_meta.json` for each problem.

With ``--fast`` (past nu = 12: screw200_rcs16 and screw200_rcs24 by
default) only one more step runs, on the committed golden, which it leaves
as it is:
  4. solve lane 0 with the JAX fast tier in f32 (`FastBatchSolver(use_pallas=
     False)`, its XLA path, B = 1) for each iteration count of FAST_TRIED
     and record its lane-0 control error against the golden in the
     problem's `_meta.json` as ``jax_f32_fast``, at FAST_ITERS (the count
     the port's fast solve on the card runs; its gate is 10 x that error).

Run from the repository root (all four, or the problems named):
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_nu.py [name ...]
    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_nu.py --fast [name ...]
"""
import contextlib
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu.ops.group import SE3
from trajectory_optimization_matrix_lie_groups_tpu.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.df_mixed import (
    MixedDFPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.df_pipeline import (
    join_us,
    split_pytree,
)
from trajectory_optimization_matrix_lie_groups_tpu.solvers.pipeline import (
    PallasPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu.tasks.al_bench import (
    build_al1400,
)

H = 200
R_WEIGHT = 1e-2
GRAD_TOL = 1e-10
MAX_ITERS = 80
F32_ITERS = 12
POLISH_GATE, DF_GATE = 1e-4, 1e-6
POLISH_ITERS, DF_ITERS = (2, 3, 4, 6), (2, 3, 4, 6)
F32_COUNTS = (4, 6, 8, 10, 12, 16, 20, 24, 28, 32)
FAST_ITERS, FAST_TRIED = 12, (8, 12, 16)
COMMAND = "JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden_nu.py"


def torques3_pu():
    return np.vstack([np.eye(3), np.zeros((3, 3))])


def rcs12_pu():
    eye = np.eye(3)
    cols = [np.concatenate([np.cross(o * eye[(a + 1) % 3], s * eye[a]), s * eye[a]])
            for a in range(3) for s in (1.0, -1.0) for o in (0.5, -0.5)]
    return np.stack(cols, axis=1)


def _thruster(r, d):
    return np.concatenate([np.cross(r, d), d])


def rcs16_pu():
    eye = np.eye(3)
    cols = [_thruster(o * eye[b], d)
            for b, c in ((1, 2), (2, 1)) for o in (0.5, -0.5)
            for d in (eye[0], -eye[0], eye[c], -eye[c])]
    return np.stack(cols, axis=1)


def rcs24_pu():
    eye = np.eye(3)
    cols = [_thruster(o * eye[b], s * eye[a])
            for a in range(3) for s in (1.0, -1.0)
            for b in ((a + 1) % 3, (a + 2) % 3) for o in (0.5, -0.5)]
    return np.stack(cols, axis=1)


PROBLEMS = {"screw200_torques3": torques3_pu, "screw200_rcs12": rcs12_pu,
            "screw200_rcs16": rcs16_pu, "screw200_rcs24": rcs24_pu}


def golden(dp, cp, q0, xi0, q_ref, xi_ref, nu):
    """Step 1: (us (H, nu), J and gradient-norm histories, the jitted f64
    iteration and its model parameters)."""
    model, mp = make_model(dynamics.rigid_body_dynamics()._replace(nu=nu),
                           costs.tracking_cost(SE3, nu), dp, cp)
    fast = FastBatchSolver(model, N=H, iterations=1, use_pallas=False)
    step = jax.jit(fast._iteration)
    qs = jnp.concatenate([q0[None, None], q_ref[None, 1:]], axis=1)
    xis = jnp.concatenate([xi0[None, None], xi_ref[None, 1:]], axis=1)
    us = jnp.zeros((1, H, nu), jnp.float64)
    hist, extra = [], None
    for it in range(1, MAX_ITERS + 1):
        qs, xis, us, J, g = step(mp, qs, xis, us)
        hist.append((float(J[0]), float(g[0])))
        if extra is None and hist[-1][1] < GRAD_TOL:
            extra = it + 2
        if extra is not None and it >= extra:
            break
    assert hist[-1][1] < GRAD_TOL, hist
    return np.asarray(us[0], np.float64), hist, step, mp


def fewest(errs, gate):
    """The fewest f32 iterations n of F32_COUNTS (errs: {n: lane-0 error})
    whose error is within ``gate`` at n and at every larger count, one at
    least: the f32 phase's iterate carries f32 noise, so a single lucky
    count does not fix a schedule.  None if there is none."""
    ns = sorted(errs)
    for i, n in enumerate(ns[:-1]):
        if all(errs[m] <= gate for m in ns[i:]):
            return n
    return None


@contextlib.contextmanager
def x64_off():
    """The JAX polish solvers are traced with x64 off, as their `solve`
    runs them."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def schedule(make, gate, inner, np_params, q0, xi0, us_golden, nu):
    """Step 3 for the polish: {"f32_iterations", "inner_iterations",
    "lane0_us_max_abs_err", "gate", "tried"}.  ``make(n_inner)`` makes the
    solver; its refinement phase (`_df_jit`) is compiled once per inner
    count and its f32 phase once per f32 count (a new `_f32_jit`), as its
    `solve` runs them (x64 off, inputs rounded to f32)."""
    sp = split_pytree(np_params)
    f32 = lambda x: np.asarray(x, np.float32)
    args = (f32(np.asarray(q0)[None]), f32(np.asarray(xi0)[None]),
            np.zeros((1, H, nu), np.float32))
    out = {}
    for n_in in inner:
        drv, errs = make(n_in), {}
        for n in F32_COUNTS:
            t0 = time.perf_counter()
            drv.f32_iterations = n
            drv._f32_jit = jax.jit(drv._solve_f32)
            with x64_off():
                st = drv._df_jit(sp, *drv._f32_jit(sp, *args, None), None)
            errs[n] = float(np.abs(np.asarray(join_us(st))[0] - us_golden).max())
            print(json.dumps({"inner": n_in, "f32": n, "err": errs[n],
                              "s": time.perf_counter() - t0}), flush=True)
        out[str(n_in)] = {str(k): v for k, v in errs.items()}
        n = fewest(errs, gate)
        if n is not None:
            return {"f32_iterations": n, "inner_iterations": n_in,
                    "lane0_us_max_abs_err": errs[n], "gate": gate, "tried": out}
    raise RuntimeError(f"no schedule reaches {gate}: {out}")


def refine_schedule(step, mp, dp32, cp32, q0, xi0, us_golden, nu):
    """Step 3 for the fp64 refiner: {"f32_iterations", "inner_iterations",
    "lane0_us_max_abs_err", "gate", "tried"}.  The refinement is the f64
    engine of step 1 (one jitted MS-iLQR iteration at a time) from the JAX
    f32 pipeline's iterate, as the port's refiner runs its fp64 pipeline
    from its f32 phase's handoff; for each f32 count tried, the error after
    every f64 iteration up to max(DF_ITERS)."""
    def run(n):
        t0 = time.perf_counter()
        pipe = PallasPipelineSolver(N=H, iterations=n, dt=float(dp32.dt), gravity=True,
                                    exact_gravity_jacobian=True, interpret=True)
        st = pipe.solve(dp32, cp32, jnp.asarray(q0, jnp.float32)[None],
                        jnp.asarray(xi0, jnp.float32)[None], jnp.zeros((1, H, nu), jnp.float32))
        qs, xis, us = (jnp.asarray(x, jnp.float64) for x in (st.qs, st.xis, st.us))
        errs = []
        for _ in range(max(DF_ITERS)):
            qs, xis, us, _, _ = step(mp, qs, xis, us)
            errs.append(float(np.abs(np.asarray(us[0], np.float64) - us_golden).max()))
        print(json.dumps({"refine_f32": n, "errs": errs, "s": time.perf_counter() - t0}),
              flush=True)
        return errs

    errs = {n: run(n) for n in F32_COUNTS}
    out = {}
    for n_in in DF_ITERS:
        at = {n: e[n_in - 1] for n, e in errs.items()}
        out[str(n_in)] = {str(k): v for k, v in at.items()}
        n = fewest(at, DF_GATE)
        if n is not None:
            return {"f32_iterations": n, "inner_iterations": n_in,
                    "lane0_us_max_abs_err": at[n], "gate": DF_GATE, "tried": out}
    raise RuntimeError(f"no schedule reaches {DF_GATE}: {out}")


def fast_f32(gd, name):
    """Step 4 for ``name``: ``jax_f32_fast`` added to its `_meta.json`."""
    us_golden = np.load(os.path.join(gd, f"{name}_us.npy"))
    Pu = PROBLEMS[name]()
    nu = Pu.shape[1]
    params, _, _, q0, xi0, q_ref, xi_ref = build_al1400(jnp.float32, H)
    dp = dynamics.rigid_body_params(params["dyn"].J, params["dyn"].dt, g=0.0,
                                    Pu=jnp.asarray(Pu, jnp.float32),
                                    exact_gravity_jacobian=True)
    cp = params["cost"]._replace(R=R_WEIGHT * jnp.eye(nu, dtype=jnp.float32))
    model, mp = make_model(dynamics.rigid_body_dynamics()._replace(nu=nu),
                           costs.tracking_cost(SE3, nu), dp, cp)
    errs, secs = {}, {}
    for n in FAST_TRIED:
        t0 = time.perf_counter()
        with x64_off():
            out = FastBatchSolver(model, N=H, iterations=n, use_pallas=False).solve(
                mp, q0[None], xi0[None], jnp.zeros((1, H, nu), jnp.float32), q_ref, xi_ref)
            assert out.us.dtype == jnp.float32, out.us.dtype
        errs[n] = float(np.max(np.abs(np.asarray(out.us[0], np.float64) - us_golden)))
        secs[n] = time.perf_counter() - t0
        print(json.dumps({"problem": name, "fast_f32": n, "err": errs[n], "s": secs[n]}),
              flush=True)
    path = os.path.join(gd, f"{name}_meta.json")
    with open(path) as f:
        meta = json.load(f)
    meta["jax_f32_fast"] = dict(
        iterations=FAST_ITERS, lane0_us_max_abs_err=errs[FAST_ITERS],
        tried={str(n): e for n, e in errs.items()},
        solver="FastBatchSolver(use_pallas=False), f32, B=1",
        cpu_seconds=secs[FAST_ITERS], command=f"{COMMAND} --fast")
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def main():
    gd = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch",
                      "tasks", "golden")
    os.makedirs(gd, exist_ok=True)
    if sys.argv[1:2] == ["--fast"]:
        for name in sys.argv[2:] or ["screw200_rcs16", "screw200_rcs24"]:
            fast_f32(gd, name)
        return
    names = sys.argv[1:] or list(PROBLEMS)
    for name in names:
        Pu = PROBLEMS[name]()
        nu = Pu.shape[1]
        params, _, _, q0, xi0, q_ref, xi_ref = build_al1400(jnp.float64, H)
        dp = dynamics.rigid_body_params(params["dyn"].J, params["dyn"].dt, g=0.0,
                                        Pu=jnp.asarray(Pu), exact_gravity_jacobian=True)
        cp = params["cost"]._replace(R=R_WEIGHT * jnp.eye(nu, dtype=jnp.float64))
        t0 = time.perf_counter()
        us_golden, hist, step, mp = golden(dp, cp, q0, xi0, q_ref, xi_ref, nu)
        t_golden = time.perf_counter() - t0
        first_below = next(i + 1 for i, (_, g) in enumerate(hist) if g < GRAD_TOL)

        # 2. the JAX f32 pipeline's own lane-0 error at the f32 path's budget
        to32 = lambda t: jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
        pipe = PallasPipelineSolver(N=H, iterations=F32_ITERS, dt=float(dp.dt),
                                    gravity=True, exact_gravity_jacobian=True,
                                    interpret=True)
        t0 = time.perf_counter()
        out = pipe.solve(to32(dp), to32(cp), jnp.asarray(q0, jnp.float32)[None],
                         jnp.asarray(xi0, jnp.float32)[None],
                         jnp.zeros((1, H, nu), jnp.float32))
        t32 = time.perf_counter() - t0
        err32 = float(np.max(np.abs(np.asarray(out.us[0], np.float64) - us_golden)))

        # 3. the schedules of the polish and of the fp64 refiner
        np_params = jax.tree.map(np.asarray, {"dyn": dp, "cost": cp})
        kw = dict(N=H, dt=float(dp.dt), gravity=True, exact_gravity_jacobian=True,
                  interpret=True)
        polish = schedule(lambda m: MixedDFPipelineSolver(
            f32_iterations=1, df_iterations=m, fx_mode="df", **kw),
            POLISH_GATE, POLISH_ITERS, np_params, q0, xi0, us_golden, nu)
        refine = refine_schedule(step, mp, to32(dp), to32(cp), q0, xi0, us_golden, nu)

        meta = dict(
            problem=(f"tasks/al_bench.build_al1400(horizon=200), no input box, on "
                     f"dynamics.rigid_body_params(J, dt, g=0, Pu={name.split('_')[1]}, "
                     f"exact_gravity_jacobian=True), R = 1e-2 I{nu}"),
            H=H, nu=nu, R_weight=R_WEIGHT, Pu=Pu.tolist(),
            J_f64=hist[-1][0], grad_norm_f64=hist[-1][1],
            iterations_f64=len(hist), first_iteration_below_tol=first_below,
            grad_tol=GRAD_TOL, f64_seconds=t_golden,
            J_hist_f64=[j for j, _ in hist], grad_hist_f64=[g for _, g in hist],
            jax_f32_pipeline=dict(
                iterations=F32_ITERS, lane0_us_max_abs_err=err32,
                J=float(out.J_opt[0]), grad_norm=float(out.grad_norm[0]),
                solver=("PallasPipelineSolver(gravity=True, exact_gravity_jacobian=True, "
                        "interpret=True), f32, B=1"),
                cpu_seconds=t32),
            polish_schedule=dict(polish, solver=(
                "MixedDFPipelineSolver(gravity=True, exact_gravity_jacobian=True, "
                "fx_mode='df', interpret=True), B=1")),
            refine_schedule=dict(refine, solver=(
                "PallasPipelineSolver(gravity=True, exact_gravity_jacobian=True, "
                "interpret=True), f32, then the f64 engine of the golden from its "
                "iterate, B=1")),
            command=COMMAND,
        )
        np.save(os.path.join(gd, f"{name}_us.npy"), us_golden)
        with open(os.path.join(gd, f"{name}_meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.write("\n")
        print(json.dumps({k: v for k, v in meta.items()
                          if k not in ("J_hist_f64", "grad_hist_f64", "Pu")}), flush=True)


if __name__ == "__main__":
    main()
