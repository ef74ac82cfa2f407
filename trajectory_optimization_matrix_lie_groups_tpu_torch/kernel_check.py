"""Each CUDA kernel of the pipeline against its plain version, on the same
inputs: the check that `chip_smoke.py` and the card tests run.

The error of one output tensor is max |kernel - plain| / max(1, max |plain|).
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    linearize_lane,
    linearize_plain,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P

# Gates on the per-output error: f32 is looser for the sequential recursions
# (B3, B4: a 200-stage rollout; B2: a 200-stage Riccati recursion through a
# Cholesky), f64 checks the kernel math itself.  "B2_al" is B2 with the
# augmented-Lagrangian diagonal added to Quu.
GATES = {torch.float32: {"B1": 1e-5, "B2": 1e-3, "B2_al": 1e-3, "B3": 1e-4,
                         "B4": 1e-4},
         torch.float64: {"B1": 1e-9, "B2": 1e-9, "B2_al": 1e-9, "B3": 1e-9,
                         "B4": 1e-9}}

LIN = ("fqR", "fqp", "fxi", "d", "Fx", "lx", "lxx", "l")
TRAJ = ("qR", "qp", "xi", "us")
OUTPUTS = {"B1": LIN, "B2": ("k", "K", "gvec", "lN"),
           "B3": TRAJ + tuple("new_" + n for n in LIN), "B4": TRAJ}
OUTPUTS["B2_al"] = OUTPUTS["B2"]


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def _flat(out):
    """A kernel's outputs as one list of tensors, in `OUTPUTS` order."""
    if isinstance(out, dict):
        return [out[n] for n in LIN]
    return [t for x in out for t in ([x[n] for n in LIN] if isinstance(x, dict)
                                      else [x])]


def kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=False, seed=0):
    """A real iterate in lane layout: the trajectory and linearization after
    ``solver.iterations`` fused iterations, and the gains of its backward
    pass (plain version), i.e. every input B1-B4 take.  With ``luu_al``,
    also a positive (N, nu, B) AL diagonal for Quu, drawn from ``seed``."""
    s = solver.solve_lane(dyn, cost, q0s, xi0s, us0)
    s["lu"] = 2.0 * torch.einsum("ij,nj...->ni...", s["consts"]["R"],
                                 s["us"]).contiguous()
    s["k"], s["K"], _, _ = P.backward_plain(
        s["lin"], s["lu"], s["qR"], s["qp"], s["xi"], s["refs"], s["consts"],
        glow=solver.gravity)
    if luu_al:
        diag = np.random.default_rng(seed).uniform(0.5, 2.0, tuple(s["lu"].shape))
        s["luu_al"] = torch.as_tensor(diag).to(s["lu"])
    return s


def calls(s, *, dt, gravity=False, exact_grav=False):
    """{kernel: (kernel_call, plain_call)}: zero-argument callables that run
    each kernel's wrapper and its plain version on the inputs ``s`` of
    `kernel_inputs`; "B2_al" only when ``s`` holds ``luu_al``."""
    traj = (s["qR"], s["qp"], s["xi"], s["us"])
    refs, consts, lin = s["refs"], s["consts"], s["lin"]
    kw = dict(dt=dt, gravity=gravity)
    bargs = (lin, s["lu"], s["qR"], s["qp"], s["xi"], refs, consts)
    rargs = (*traj, s["k"], s["K"], lin)
    out = {
        "B1": (lambda: linearize_lane(*traj, refs, consts, exact_grav=exact_grav, **kw),
               lambda: linearize_plain(*traj, refs, consts, exact_grav=exact_grav, **kw)),
        "B2": (lambda: P.backward_lane(*bargs, glow=gravity),
               lambda: P.backward_plain(*bargs, glow=gravity)),
        "B3": (lambda: P.rollout_linearize_lane(*rargs, refs, consts,
                                                exact_grav=exact_grav, **kw),
               lambda: P.rollout_linearize_plain(*rargs, refs, consts,
                                                 exact_grav=exact_grav, **kw)),
        "B4": (lambda: P.rollout_lane(*rargs, consts, **kw),
               lambda: P.rollout_plain(*rargs, consts, **kw)),
    }
    if s.get("luu_al") is not None:
        al = s["luu_al"]
        out["B2_al"] = (lambda: P.backward_lane(*bargs, glow=gravity, luu_al=al),
                        lambda: P.backward_plain(*bargs, glow=gravity, luu_al=al))
    return out


def compare(s, **kw):
    """{kernel: {"max_rel", "max_abs", "per_output": {output: rel error}}}
    for every pair of `calls` (keyword arguments as there)."""
    out = {}
    for name, (kern, plain) in calls(s, **kw).items():
        a, b = _flat(kern()), _flat(plain())
        per = {n: rel_err(x, y) for n, x, y in zip(OUTPUTS[name], a, b)}
        out[name] = {"max_rel": max(per.values()),
                     "max_abs": max((x - y).abs().max().item() for x, y in zip(a, b)),
                     "per_output": per}
    return out
