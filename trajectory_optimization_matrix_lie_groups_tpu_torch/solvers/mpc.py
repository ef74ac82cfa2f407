"""Receding-horizon MPC (counterpart of the JAX `solvers/mpc.py`): the
closed loop over the reference-exact `LieILQR` (`make_closed_loop`) and the
batch drivers over the lane-layout pipeline.

`make_closed_loop` solves each window to convergence with `LieILQR`, from
the shifted previous solution, for B plants at once (B = 1 is the JAX
single-plant driver): a plant whose window has converged is frozen while
the others iterate, so each plant's trajectory is that of its own B = 1
loop.  Its steps read the solver's flags back (`LieILQR.solve`).

B plant instances track the same reference path in lockstep: at each plant
step the driver slices an H-step window of the reference, warm-starts from
the shifted previous solution, runs the pipeline's fixed iteration budget
(kernels B1, B2, B3 on the card) for all B instances, and applies each
instance's first control to its own plant.  The JAX drivers are one jitted
`lax.scan`; here the loop over plant steps is a Python loop whose steps
queue device work only: nothing inside a step or between steps reads a
device value back to the host (the optional rescue of the constrained
driver excepted, see `make_closed_loop_batch_constrained`).
"""

import dataclasses
from typing import NamedTuple

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs
from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs


def _window(cp: costs.TrackingCostParams, t, H):
    """The (H+1)-entry reference window starting at plant step t: slices of
    q_ref, q_ref_inv, Ad_ref and xi_ref, not recomputed."""
    sl = lambda a: a.narrow(0, t, H + 1)
    return dataclasses.replace(cp, q_ref=sl(cp.q_ref), q_ref_inv=sl(cp.q_ref_inv),
                               Ad_ref=sl(cp.Ad_ref), xi_ref=sl(cp.xi_ref))


class MPCResult(NamedTuple):
    qs: torch.Tensor      # (B, T+1, m, m) closed-loop plant trajectories
    xis: torch.Tensor     # (B, T+1, d)
    us: torch.Tensor      # (B, T, nu) applied controls
    J_pred: torch.Tensor  # (B, T) predicted cost per solve


class BatchMPCResult(NamedTuple):
    qs: torch.Tensor      # (B, T+1, 4, 4) closed-loop plant trajectories
    xis: torch.Tensor     # (B, T+1, 6)
    us: torch.Tensor      # (B, T, nu) applied controls
    J_pred: torch.Tensor  # (B, T) predicted cost per solve


def _result(q0s, xi0s, qs_t, xis_t, us_t, J_t):
    """Stack the per-step lists batch first, the initial state in front."""
    st = lambda xs: torch.stack(xs, dim=1)
    return BatchMPCResult(qs=torch.cat([q0s[:, None], st(qs_t)], dim=1),
                          xis=torch.cat([xi0s[:, None], st(xis_t)], dim=1),
                          us=st(us_t), J_pred=st(J_t))


def _shift(us):
    """Warm start for the next window: shift one step, repeat the tail."""
    return torch.cat([us[:, 1:], us[:, -1:]], dim=1)


def make_closed_loop(solver, T: int):
    """Closed-loop simulator over a `LieILQR` (the JAX `make_closed_loop`).

    Args:
      solver: a `LieILQR` with N = the window H; each plant step writes its
        (H+1)-entry reference window into ``params['cost']``.
      T: plant steps; the full reference needs at least T + H + 1 entries.

    Returns:
      run(params_full, q0s (B, m, m), xi0s (B, d)): ``params_full``'s cost
      holds the FULL reference path; returns an `MPCResult`.  At each step
      the window is solved to convergence (``solver.cfg``) from the shifted
      previous solution (zeros at t = 0), and its first control is applied
      to each plant.
    """
    H = solver.cfg.N
    model = solver.model

    def run(params_full, q0s, xi0s):
        cp_full = params_full["cost"]
        us_warm = torch.zeros((q0s.shape[0], H, model.nu), dtype=xi0s.dtype,
                              device=xi0s.device)
        qs, xis = q0s, xi0s
        out_t = ([], [], [], [])
        for t in range(T):
            cp_t = _window(cp_full, t, H)
            params_t = {**params_full, "cost": cp_t}
            state = solver.solve(params_t, (qs, xis), us_warm, cp_t.q_ref, cp_t.xi_ref)
            u0 = state.us[:, 0]
            qs, xis = model.step(params_t, qs, xis, u0, 0)
            us_warm = _shift(state.us)
            for lst, x in zip(out_t, (qs, xis, u0, state.J_opt)):
                lst.append(x)
        return MPCResult(*_result(q0s, xi0s, *out_t))

    return run


def make_closed_loop_batch(pipe, model, T: int):
    """Batched Monte-Carlo closed-loop MPC on the lane-layout pipeline.

    Args:
      pipe: `PipelineSolver` with N = horizon H (its ``gravity`` flag must
        match ``model``); ``pipe.iterations`` is the per-step budget.
      model: the `LieModel` of the same family (plant stepping).
      T: closed-loop steps; the full reference needs >= T + H + 1 entries.

    Returns:
      run(dp, cp_full, q0s, xi0s, noise_generator=None, noise_sigma=0.0) ->
      BatchMPCResult.  With a `torch.Generator`, every plant step adds
      i.i.d. twist disturbances sigma N(0, 1) per instance, drawn up front
      as one (T, B, 6) array on the generator's device (Monte-Carlo
      robustness evaluation: the solver never sees the noise, only its
      effect).  The solve runs on ``q0s``' device and dtype.
    """
    H = pipe.N

    def run(dp, cp_full, q0s, xi0s, noise_generator=None, noise_sigma=0.0):
        B = q0s.shape[0]
        params = {"dyn": dp, "cost": cp_full}
        dtp, dev = xi0s.dtype, xi0s.device
        if noise_generator is None:
            noise = torch.zeros((T, B, 6), dtype=dtp, device=dev)
        else:
            noise = noise_sigma * torch.randn(
                (T, B, 6), generator=noise_generator, dtype=dtp,
                device=noise_generator.device).to(dev)
        qs, xis = q0s, xi0s
        us_warm = torch.zeros((B, H, model.nu), dtype=dtp, device=dev)
        out_t = ([], [], [], [])
        for t in range(T):
            out = pipe.solve(dp, _window(cp_full, t, H), qs, xis, us_warm)
            u0 = out.us[:, 0]
            qs, xis = model.step(params, qs, xis, u0, 0)
            xis = xis + noise[t]
            us_warm = _shift(out.us)
            for lst, x in zip(out_t, (qs, xis, u0, out.J_opt)):
                lst.append(x)
        return _result(q0s, xi0s, *out_t)

    return run


def make_closed_loop_batch_constrained(pipe, model, T: int, lb, ub,
                                       n_al_iters: int = 4, mu0: float = 1e-2,
                                       mu_scale: float = 10.0,
                                       mu_max: float = 1e8,
                                       tol_constr: float = 1e-2,
                                       rescue=None, rescue_outers: int = 8):
    """Batched closed-loop MPC with input box constraints.

    Every plant step runs a fixed ``n_al_iters`` augmented-Lagrangian outer
    iterations around the pipeline solve (multiplier state rebuilt per
    window from mu0: the receding-horizon analog of
    `solvers/al_pipeline.ALPipelineSolver`, with the convergence break
    replaced by the fixed outer budget, so no step reads the device), and
    applies the first control clipped to the box (actuator saturation).

    ``rescue``: optional `solvers.al_fast.ALFastSolver` built on the
    matching al_cost model and input-box constraint.  When set, a window
    whose pipeline solve leaves a lane above ``tol_constr`` is re-solved by
    the line-searched AL loop on all lanes (`ALFastSolver._outer_loop_graph`,
    ``rescue_outers`` outers), and `torch.where` on the unconverged mask
    keeps the rescue result only for those lanes.

    Returns run(dp, cp_full, q0s, xi0s) -> (BatchMPCResult, maxv (B, T) the
    planned controls' max violation at each step).
    """
    H = pipe.N

    def run(dp, cp_full, q0s, xi0s):
        B = q0s.shape[0]
        nu = model.nu
        C = 2 * nu
        params = {"dyn": dp, "cost": cp_full}
        dtp, dev = xi0s.dtype, xi0s.device
        box = lambda b: torch.as_tensor(b, dtype=dtp).to(dev).broadcast_to((nu,))
        lb_a, ub_a = box(lb), box(ub)

        def violation(us):
            return torch.amax(torch.maximum(lb_a - us, us - ub_a), dim=(1, 2))

        def al_solve(cp_t, qs, xis, us_warm):
            lmbd = torch.zeros((B, H + 1, C), dtype=dtp, device=dev)
            imu = torch.full((B, H + 1, C), mu0, dtype=dtp, device=dev)
            mu = torch.full((B,), mu0, dtype=dtp, device=dev)
            out = None
            for _ in range(n_al_iters):
                out = pipe.solve(dp, cp_t, qs, xis, us_warm,
                                 al=(lb_a, ub_a, lmbd, imu))
                g = torch.cat([torch.cat([lb_a - out.us, out.us - ub_a], dim=-1),
                               torch.zeros((B, 1, C), dtype=dtp, device=dev)], dim=1)
                # shared update rule with per-problem freeze of
                # already-satisfied instances (costs.al_update_diag)
                lmbd, imu, mu = costs.al_update_diag(
                    lmbd, imu, mu, g, mu_scale, mu_max,
                    freeze=torch.amax(g, dim=(1, 2)) < tol_constr)
            return out

        qs, xis = q0s, xi0s
        us_warm = torch.zeros((B, H, nu), dtype=dtp, device=dev)
        out_t, maxv_t = ([], [], [], []), []
        for t in range(T):
            cp_t = _window(cp_full, t, H)
            out = al_solve(cp_t, qs, xis, us_warm)
            if rescue is not None:
                bad = torch.clamp(violation(out.us), min=0.0) >= tol_constr
                # The JAX driver computes the rescue for every lane and keeps
                # it where a lane is bad; when no lane is bad that leaves the
                # solve unchanged, so the rescue solve is skipped then.  This
                # check is the one host read of a step, and only with rescue.
                if bool(bad.any()):
                    alp0 = costs.al_init_params(
                        cp_t, cs.input_box_params(lb_a, ub_a, nu), H, C,
                        mu0=mu0, dtype=dtp, device=dev)
                    _, _, _, us_r, J_r, _, _ = rescue._outer_loop_graph(
                        rescue._ls_solver(), dp, rescue._broadcast_al(alp0, B),
                        qs, xis, us_warm, cp_t.q_ref, cp_t.xi_ref, rescue_outers)
                    out = out._replace(
                        us=torch.where(bad[:, None, None], us_r, out.us),
                        J_opt=torch.where(bad, J_r, out.J_opt))
            u0 = torch.minimum(torch.maximum(out.us[:, 0], lb_a), ub_a)
            maxv_t.append(torch.clamp(violation(out.us), min=0.0))
            qs, xis = model.step(params, qs, xis, u0, 0)
            us_warm = _shift(out.us)
            for lst, x in zip(out_t, (qs, xis, u0, out.J_opt)):
                lst.append(x)
        return _result(q0s, xi0s, *out_t), torch.stack(maxv_t, dim=1)

    return run
