"""Each CUDA kernel against its plain version, on the same inputs: the check
that `chip_smoke.py` and the card tests run.  B1-B4 (the f32 pipeline, in
f32 and f64) on a real pipeline iterate (`kernel_inputs`, `calls`,
`compare`); B5-B9 (the mixed-precision polish) on a real polish iterate
(`polish_inputs`, `polish_calls`, `polish_compare`); B10-B12 (the SO(3)
pipeline, in f32 and f64) on a real SO(3) iterate (`so3_inputs`,
`so3_calls`, `so3_compare`); B13 and B14 (the generic fast tier, in f32 and
f64) on a real `FastBatchSolver` iterate (`fast_inputs`, `fast_calls`,
`fast_compare`), B13 also on a real anchored iterate (`anchored_inputs`:
near-identity poses, `solvers/anchored.py`).

The error of one output tensor is max |kernel - plain| / max(1, max |plain|).

`work` counts what a kernel must move and compute (the bytes of the arrays
it reads, `READS`, and of the outputs it returns, each once, and its dense
products by dtype), and `bound_ms` turns that into the least time an H100
could take for it.
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.linearize import (
    linearize_lane,
    linearize_plain,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import rollout as RO
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S

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

# The polish kernels have one gate per output (GATES["mixed"][kernel][output]).
# B7-B9 are one kernel ("tail"); each keeps its own outputs and gates.
POLISH_OUTPUTS = {"B5": ("k", "K", "gvec"),
                  "B6": TRAJ + ("fqR", "fqp", "fxi"),
                  "tail": ("d", "Fx", "lx", "lxx32", "l32")}
POLISH_OUTPUTS["B5_al"] = POLISH_OUTPUTS["B5"]
TAIL = {"B7": ("d",), "B8": ("Fx",), "B9": ("lx", "lxx32", "l32")}
# Every fp64 output at 1e-9, the f32 outputs at the grade of their f32
# pipeline twins (k, K as B2; lxx32, l32 as B1).  An f32 rounding does reach
# B5's gvec (V_xx d and the V_x corrections) and all of B6's outputs (the
# feedback k + K xs_err), and kernel and plain version sum those in other
# orders, but only multiplied by residuals (d, k, Q_u, xs_err) that are
# small at a real polish iterate: at the main path's handoff they differ by
# 4e-13 (gvec) and 2e-12 (us) on an H100 (PERF.md).
GATES["mixed"] = {
    "B5": {"k": 1e-3, "K": 1e-3, "gvec": 1e-9},
    "B6": {n: 1e-9 for n in POLISH_OUTPUTS["B6"]},
    "B7": {"d": 1e-9}, "B8": {"Fx": 1e-9},
    "B9": {"lx": 1e-9, "lxx32": 1e-5, "l32": 1e-5}}
GATES["mixed"]["B5_al"] = GATES["mixed"]["B5"]

# The SO(3) pipeline's kernels, gated as their SE(3) twins: B10 and B12 as
# B3 (B12 is a 249-stage rollout; B10 shares its stage math), B11 as B2.
GATES["so3"] = {torch.float32: {"B10": 1e-4, "B11": 1e-3, "B12": 1e-4},
                torch.float64: {"B10": 1e-9, "B11": 1e-9, "B12": 1e-9}}
SO3_OUTPUTS = {"B10": S.LIN, "B11": ("k", "K", "gvec", "lN"),
               "B12": ("qR", "xi", "us") + tuple("new_" + n for n in S.LIN)}

# The generic fast tier's kernels: B13 as B2 (a long recursion through a
# Cholesky), B14 as B4.
GATES["fast"] = {torch.float32: {"B13": 1e-3, "B14": 1e-4},
                 torch.float64: {"B13": 1e-9, "B14": 1e-9}}
FAST_OUTPUTS = {"B13": ("k", "K", "Vx1", "Vxx1"), "B14": ("qR", "qp", "xi", "us")}


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def _flat(out, lin=LIN):
    """A kernel's outputs as one list of tensors, in `OUTPUTS` order (the
    linearization dicts in ``lin`` order)."""
    if isinstance(out, dict):
        return [out[n] for n in lin]
    return [t for x in out for t in ([x[n] for n in lin] if isinstance(x, dict)
                                      else [x])]


def kernel_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=False, seed=0,
                  kernel_gains=False):
    """A real iterate in lane layout: the trajectory and linearization after
    ``solver.iterations`` fused iterations, and the gains of its backward
    pass (plain version, or with ``kernel_gains`` B2's, for shapes at which
    the plain recursion on the card takes tens of seconds), i.e. every
    input B1-B4 take.  With ``luu_al``, also a positive (N, nu, B) AL
    diagonal for Quu, drawn from ``seed``."""
    s = solver.solve_lane(dyn, cost, q0s, xi0s, us0)
    s["lu"] = 2.0 * torch.einsum("ij,nj...->ni...", s["consts"]["R"],
                                 s["us"]).contiguous()
    backward = P.backward_lane if kernel_gains else P.backward_plain
    s["k"], s["K"], _, _ = backward(
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


def _compare(pairs, outputs, lin=LIN):
    """{kernel: {"max_rel", "max_abs", "per_output": {output: rel error}}}
    for every (kernel_call, plain_call) pair, the outputs named by
    ``outputs[kernel]`` (linearization dicts flattened in ``lin`` order)."""
    out = {}
    for name, (kern, plain) in pairs.items():
        a, b = _flat(kern(), lin), _flat(plain(), lin)
        per = {n: rel_err(x, y) for n, x, y in zip(outputs[name], a, b, strict=True)}
        out[name] = {"max_rel": max(per.values()),
                     "max_abs": max((x - y).abs().max().item() for x, y in zip(a, b)),
                     "per_output": per}
    return out


def compare(s, **kw):
    """`_compare` of every pair of `calls` (keyword arguments as there)."""
    return _compare(calls(s, **kw), OUTPUTS)


def polish_inputs(solver, dyn, cost, q0s, xi0s, us0, luu_al=False, seed=0,
                  kernel_gains=False, polished=False):
    """A real polish iterate in lane layout: the handoff of ``solver``'s f32
    phase (a `MixedDFPipelineSolver`) promoted to fp64 (with ``polished``,
    the iterate after ``solver``'s polish of it), its dynamics evaluations
    and linearization, lu, the terminal carry and the gains of its backward
    pass (plain versions, or with ``kernel_gains`` B7-B9's and B5's), i.e.
    every input B5-B9 take.  With ``luu_al``, also a positive (N, nu, B) f32
    AL diagonal for Q_uu, drawn from ``seed``."""
    qR, qp, xi, us = (x.double() for x in
                      solver._solve_f32(dyn, cost, q0s, xi0s, us0))
    if polished:
        st = solver.polish(dyn, cost, qR, qp, xi, us)
        tl = lambda x: x.movedim(0, -1).contiguous()   # (B, ...) -> (..., B)
        qR, qp, xi = tl(st.qs[:, :, :3, :3]), tl(st.qs[:, :, :3, 3]), tl(st.xis)
        us = tl(st.us_hi.double() + st.us_lo)
    consts, refs, consts32 = solver._df_setup(dyn, cost, us.device)
    kw = dict(dt=solver.dt, gravity=solver.gravity)
    evals = DM.dyn_evals_mx(qR, qp, xi, us, consts, **kw)
    tail = DM.linearize_tail_mx_lane if kernel_gains else DM.linearize_tail_mx_plain
    lin = tail(qR, qp, xi, evals, refs, consts, exact_grav=solver.exact_grav, **kw)
    s = dict(qR=qR, qp=qp, xi=xi, us=us, evals=evals, lin=lin, refs=refs,
             consts=consts, consts32=consts32,
             lu=2.0 * torch.einsum("ij,nj...->ni...", consts["R"], us).contiguous())
    s["VxN"], s["VxxN"] = solver._terminal(qR, qp, xi, refs, consts, consts32)
    backward = DM.backward_mx_lane if kernel_gains else DM.backward_mx_plain
    s["k"], s["K"], _ = backward(
        lin, s["lu"], s["VxN"], s["VxxN"], consts, consts32, glow=solver.gravity)
    if luu_al:
        diag = np.random.default_rng(seed).uniform(0.5, 2.0, tuple(us.shape))
        s["luu_al"] = torch.as_tensor(diag, dtype=torch.float32, device=us.device)
    return s


def polish_calls(s, solver):
    """{kernel: (kernel_call, plain_call)} for B5, B6 and the tail (B7-B9)
    on the inputs ``s`` of `polish_inputs`; "B5_al" only when ``s`` holds
    ``luu_al``."""
    kw = dict(dt=solver.dt, gravity=solver.gravity)
    bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
    rargs = (s["qR"], s["qp"], s["xi"], s["us"], s["k"], s["K"], s["lin"],
             s["consts"])
    targs = (s["qR"], s["qp"], s["xi"], s["evals"], s["refs"], s["consts"])
    tkw = dict(exact_grav=solver.exact_grav, **kw)
    out = {
        "B5": (lambda: DM.backward_mx_lane(*bargs, glow=solver.gravity),
               lambda: DM.backward_mx_plain(*bargs, glow=solver.gravity)),
        "B6": (lambda: DM.rollout_mx_lane(*rargs, **kw),
               lambda: DM.rollout_mx_plain(*rargs, **kw)),
        "tail": (lambda: DM.linearize_tail_mx_lane(*targs, **tkw),
                 lambda: DM.linearize_tail_mx_plain(*targs, **tkw)),
    }
    if s.get("luu_al") is not None:
        al = s["luu_al"]
        out["B5_al"] = (
            lambda: DM.backward_mx_lane(*bargs, glow=solver.gravity, luu_al=al),
            lambda: DM.backward_mx_plain(*bargs, glow=solver.gravity, luu_al=al))
    return out


def _leaves(x):
    return [y for z in x for y in _leaves(z)] if isinstance(x, tuple) else [x]


def _named(out, names):
    """A kernel's outputs as {name: tensor}: a dict by key, a (nested) tuple
    in order."""
    if isinstance(out, dict):
        return {n: out[n] for n in names}
    return dict(zip(names, _leaves(out), strict=True))


def polish_compare(s, solver):
    """{kernel: {"max_rel", "max_abs", "per_output": {output: rel error}}}
    for B5 (and B5_al), B6, B7, B8 and B9, each pair of `polish_calls` run
    once (B7-B9 share the tail's run)."""
    per, absd = {}, {}
    for name, (kern, plain) in polish_calls(s, solver).items():
        names = POLISH_OUTPUTS[name]
        a, b = _named(kern(), names), _named(plain(), names)
        per[name] = {n: rel_err(a[n], b[n]) for n in names}
        absd[name] = {n: (a[n].double() - b[n].double()).abs().max().item()
                      for n in names}
    for name, outs in TAIL.items():
        per[name] = {n: per["tail"][n] for n in outs}
        absd[name] = {n: absd["tail"][n] for n in outs}
    del per["tail"], absd["tail"]
    return {name: {"max_rel": max(per[name].values()),
                   "max_abs": max(absd[name].values()),
                   "per_output": per[name]} for name in per}


def so3_inputs(solver, dyn, cost, q0s, xi0s, us0):
    """A real SO(3) iterate in lane layout: the trajectory and linearization
    after ``solver.iterations`` iterations of ``solver`` (an
    `SO3PipelineSolver`), lu, and the gains of its backward pass (plain
    version), i.e. every input B10-B12 take."""
    s = solver.solve_lane(dyn, cost, q0s, xi0s, us0)
    s["lu"] = 2.0 * torch.einsum("ij,nj...->ni...", s["consts"]["R"],
                                 s["us"]).contiguous()
    s["k"], s["K"], _, _ = S.backward_so3_plain(
        s["lin"], s["lu"], s["qR"], s["xi"], s["refs"], s["consts"],
        pendulum=solver.pendulum)
    return s


def so3_calls(s, *, dt, pendulum):
    """{kernel: (kernel_call, plain_call)} for B10-B12 on the inputs ``s``
    of `so3_inputs`."""
    traj = (s["qR"], s["xi"], s["us"])
    refs, consts, lin = s["refs"], s["consts"], s["lin"]
    kw = dict(dt=dt, pendulum=pendulum)
    bargs = (lin, s["lu"], s["qR"], s["xi"], refs, consts)
    rargs = (*traj, s["k"], s["K"], lin, refs, consts)
    return {
        "B10": (lambda: S.linearize_so3_lane(*traj, refs, consts, **kw),
                lambda: S.linearize_so3_plain(*traj, refs, consts, **kw)),
        "B11": (lambda: S.backward_so3_lane(*bargs, pendulum=pendulum),
                lambda: S.backward_so3_plain(*bargs, pendulum=pendulum)),
        "B12": (lambda: S.rollout_linearize_so3_lane(*rargs, **kw),
                lambda: S.rollout_linearize_so3_plain(*rargs, **kw)),
    }


def so3_compare(s, **kw):
    """`_compare` of B10-B12 (keyword arguments as `so3_calls`)."""
    return _compare(so3_calls(s, **kw), SO3_OUTPUTS, S.LIN)


def fast_inputs(solver, params, q0s, xi0s, us0):
    """A real iterate of ``solver`` (a `FastBatchSolver`) in lane layout, the
    arrays the kernels read after their wrappers' transposes: the
    linearization of the trajectory after ``solver.iterations`` iterations
    (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu; Lx and Lxx with the terminal stage)
    and the gains of its backward pass (plain version), i.e. every input B13
    takes; with ``solver.pallas_rollout_dt`` set (the free body) also the
    trajectory, fxi, Exp(d_q) and f(x)^-1, i.e. every input B14 takes."""
    cp = params["cost"]
    st = solver.solve(params, q0s, xi0s, us0, cp.q_ref, cp.xi_ref)
    lin = solver._linearize(params, st.qs, st.xis, st.us)
    tl = lambda x: x.movedim(0, -1).contiguous()   # (B, N, ...) -> (N, ..., B)
    s = {n: tl(lin[n]) for n in ("Fx", "Fu", "d", "Lx", "Lu", "Lxx", "Lux", "Luu")}
    s["us"] = tl(st.us)
    s["k"], s["K"], _, _ = RC.backward_plain(*(s[n] for n in READS["B13"]))
    if solver.pallas_rollout_dt is not None:
        dp = params["dyn"]
        exp_d, fq_inv = se3.exp(lin["d"][..., :6]), se3.inverse(lin["fq"])
        s.update(qR=tl(st.qs[:, :, :3, :3]), qp=tl(st.qs[:, :, :3, 3]),
                 xi=tl(st.xis), fxi=tl(lin["fxi"]), edR=tl(exp_d[:, :, :3, :3]),
                 edp=tl(exp_d[:, :, :3, 3]), fiR=tl(fq_inv[:, :, :3, :3]),
                 fip=tl(fq_inv[:, :, :3, 3]), J=dp.J.contiguous(),
                 Jinv=dp.Jinv.contiguous(), dt=solver.pallas_rollout_dt)
    return s


def anchored_inputs(solver, q0_locs, xi0s, us0):
    """A real iterate of ``solver`` (an `AnchoredFastSolver`) in lane
    layout: the linearization of its trajectory after ``solver.iterations``
    iterations and the gains of its backward pass (plain version), every
    input B13 takes (`fast_calls` runs B13 on it)."""
    qs, xis, us, _, _ = solver.solve(q0_locs, xi0s, us0)
    lin = solver._linearize(qs, xis, us)
    tl = lambda x: x.movedim(0, -1).contiguous()   # (B, N, ...) -> (N, ..., B)
    s = {n: tl(lin[n]) for n in READS["B13"]}
    s["us"] = tl(us)
    s["k"], s["K"], _, _ = RC.backward_plain(*(s[n] for n in READS["B13"]))
    return s


def riccati_inputs(nx, nu, B, N, dtype=torch.float64, device="cpu", seed=0):
    """A random dense Riccati problem in lane layout, every input B13 takes
    at any (nx, nu), drawn on ``device`` by a torch generator seeded with
    ``seed`` (`fast_calls` runs B13 on it): Fx = 0.8 I plus noise of norm
    ~0.2 (a contraction, so the value function stays bounded over long
    horizons), small Fu and d, positive definite Lxx and Luu, and ``us``
    (zeros) for the shape.  Drawn in f64 and rounded to ``dtype``, one array
    at a time, W W^T a few stages at a time (at (12, 34), B = 8192, N = 200
    Luu's noise alone takes 15 GB in f64)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = lambda *shape: torch.randn(shape + (B,), generator=g, dtype=torch.float64,
                                   device=device)
    eye = lambda m: torch.eye(m, dtype=torch.float64, device=device)[..., None]

    def psd(W, m):
        """0.1 W W^T + I over each stage's lanes, in place of W's chunks."""
        out = torch.empty_like(W)
        for i in range(0, W.shape[0], 8):
            out[i:i + 8] = torch.einsum("...ikb,...jkb->...ijb", W[i:i + 8], W[i:i + 8])
        return out.mul_(0.1).add_(eye(m))

    r = lambda x: x.to(dtype).contiguous()
    return dict(
        Fx=r(0.8 * eye(nx) + 0.1 / nx ** 0.5 * n(N, nx, nx)), Fu=r(0.1 * n(N, nx, nu)),
        d=r(0.01 * n(N, nx)), Lx=r(n(N + 1, nx)), Lu=r(n(N, nu)),
        Lxx=r(psd(n(N + 1, nx, nx), nx)), Lux=r(0.1 * n(N, nu, nx)),
        Luu=r(psd(n(N, nu, nu), nu)),
        us=torch.zeros((N, nu, B), dtype=dtype, device=device))


# B14's positional arguments, entries of the inputs of `fast_inputs`
FAST_ROLLOUT_ARGS = ("qR", "qp", "xi", "us", "k", "K", "d", "fxi", "edR", "edp", "fiR", "fip",
                     "J", "Jinv")


def fast_calls(s):
    """{kernel: (kernel_call, plain_call)} for B13 (and B14 when ``s`` holds
    its inputs) on the inputs ``s`` of `fast_inputs`."""
    bargs = tuple(s[n] for n in READS["B13"])
    out = {"B13": (lambda: RC.backward_lane(*bargs), lambda: RC.backward_plain(*bargs))}
    if "edR" in s:
        rargs = tuple(s[n] for n in FAST_ROLLOUT_ARGS)
        out["B14"] = (lambda: RO.rollout_lane(*rargs, dt=s["dt"]),
                      lambda: RO.rollout_plain(*rargs, dt=s["dt"]))
    return out


def fast_compare(s):
    """`_compare` of B13 (and B14) on the inputs ``s`` of `fast_inputs`."""
    return _compare(fast_calls(s), FAST_OUTPUTS)


# -- the least time a call could take ---------------------------------------------

# H100 SXM data-sheet rates (700 W): HBM bandwidth, and the peak arithmetic
# rate outside the tensor cores by dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# The arrays each kernel reads, each once: entries of its inputs ``s`` (or
# of s["lin"]); "qR[N]" is the terminal stage alone (the Riccati kernels'
# terminal quadratization), "d_xi" the twist rows d[:, 6:] alone (B14 takes
# Exp(d_q) precomputed).  The references and model constants, shared by the
# batch (a few KB), are left out.
_ROLL = ("qR", "qp", "xi", "us", "k", "K", "d", "fqR", "fqp", "fxi")
READS = {"B1": ("qR", "qp", "xi", "us"),
         "B2": ("Fx", "d", "lx", "lu", "lxx", "qR[N]", "qp[N]", "xi[N]"),
         "B3": _ROLL, "B4": _ROLL,
         "B5": ("Fx", "d", "lx", "lu", "lxx32", "VxN", "VxxN"),
         "B6": _ROLL, "tail": ("qR", "qp", "xi", "evals"),
         "B10": ("qR", "xi", "us"),
         "B11": ("Fx", "fu2", "d", "lx", "lu", "lxx", "qR[N]", "xi[N]"),
         "B12": ("qR", "xi", "us", "k", "K", "d", "fqR", "fxi"),
         # the generic fast tier: Lx and Lxx hold the terminal stage
         "B13": ("Fx", "Fu", "d", "Lx", "Lu", "Lxx", "Lux", "Luu"),
         "B14": ("qR", "qp", "xi", "us", "k", "K", "d_xi", "fxi", "edR", "edp",
                 "fiR", "fip")}
READS["B2_al"] = READS["B2"] + ("luu_al",)
READS["B5_al"] = READS["B5"] + ("luu_al",)


def _riccati_ops(nx, nu, h):
    """The products of one Riccati stage (`solvers/pipeline.riccati_stage`)
    with Fx = [[A, Bb], [0, D]] in h x h blocks (nx = 2h) and Fu = [0; fu2]
    (fu2 h x nu), 2 operations per multiply-add: V_x + V_xx d, Fx^T and
    fu2^T of it; V_xx Fx and Fx^T of that, fu2^T of its lower half;
    fu2^T V_xx fu2; the Cholesky factor and its solves for K and k; K^T Q_uu,
    the three value-gradient terms, K^T Q_ux and K^T Q_uu K."""
    return (2 * (nx * nx + 3 * h * h + h * nu + 6 * nx * h * h + nu * h * nx
                 + h * h * nu + nu * nu * h + nu * nu * (nx + 1) + nx * nu * nu
                 + 3 * nx * nu + 2 * nx * nx * nu)
            + nu ** 3 // 3)


def _fast_riccati_ops(nx, nu):
    """The products of one dense Riccati stage (`ops/riccati.riccati_step`),
    2 operations per multiply-add: V_xx d, Fx^T and Fu^T of V_x + V_xx d;
    V_xx Fx, Fx^T and Fu^T of it; V_xx Fu and Fu^T of it; the Cholesky
    factor and its solves for K and k; K^T Q_uu, the three value-gradient
    terms, K^T Q_uu K, K^T Q_ux and Q_ux^T K."""
    return (2 * (2 * nx * nx + nx * nu + 2 * nx ** 3 + nu * nx * nx
                 + nx * nx * nu + nu * nu * nx + nu * nu * (nx + 1) + nx * nu * nu
                 + 3 * nx * nu + 3 * nx * nx * nu)
            + nu ** 3 // 3)


def _linearize_ops(h):
    """Four products of h x h blocks: two for Fx, two for the cost Hessian."""
    return 8 * h ** 3


def _rollout_ops(nx, nu):
    """The feedback K xs_err and three 3 x 3 rotation products."""
    return 2 * nu * nx + 3 * 54


def _ops(name, nu, nx):
    """(operations per problem and stage, dtype or None for the run's) of
    kernel ``name``: an estimate from its dense products (the kernels skip
    some of their zero blocks; the exponentials, logarithms and series are
    left out).  It decides no bound: every kernel's bytes take at least
    twice as long."""
    if name == "B13":
        return _fast_riccati_ops(nx, nu), None
    if name == "B14":
        return _rollout_ops(12, 6), None
    if name in ("B10", "B11", "B12"):
        return {"B10": _linearize_ops(3), "B11": _riccati_ops(6, 3, 3),
                "B12": _rollout_ops(6, 3) + _linearize_ops(3)}[name], None
    per = {"B1": _linearize_ops(6), "B2": _riccati_ops(12, nu, 6),
           "B3": _rollout_ops(12, nu) + _linearize_ops(6),
           "B4": _rollout_ops(12, nu),
           # the polish: B5's products are f32 (its fp64 V_x chain is
           # matrix-vector work), B6 and the tail are fp64
           "B5": _riccati_ops(12, nu, 6), "B6": _rollout_ops(12, nu),
           "tail": _linearize_ops(6)}[name.removesuffix("_al")]
    dtype = {"B5": torch.float32, "B6": torch.float64,
             "tail": torch.float64}.get(name.removesuffix("_al"))
    return per, dtype


def _array(s, name):
    if name.endswith("[N]"):
        return _array(s, name[:-3])[-1]
    if name == "d_xi":
        return _array(s, "d")[:, 6:]
    return s[name] if name in s else s["lin"][name]


def _tensors(x):
    if isinstance(x, dict):
        x = tuple(x.values())
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [] if x is None else [x]


def work(name, s, out):
    """What kernel ``name`` (a key of `calls`, `polish_calls`, `so3_calls`
    or `fast_calls`) must move and compute on the inputs ``s`` when it returns
    ``out``: {"bytes": the bytes of the arrays it reads (`READS`), each read
    once, plus those of the tensors it returns that are not among them,
    "ops": {dtype: operations}} (`_ops` per problem and stage)."""
    ins = _tensors([_array(s, n) for n in READS[name]])
    outs = [t for t in _tensors(out) if not any(t is x for x in ins)]
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    N, nu, B = s["us"].shape
    per, dtype = _ops(name, nu, _array(s, "d").shape[1])
    return {"bytes": nbytes, "ops": {dtype or s["us"].dtype: per * N * B}}


def bound_ms(wk):
    """(ms, "bytes" | "operations"): the least time an H100 could take for
    the work ``wk`` of `work`, the larger of its bytes over the HBM rate and
    its operations over the peak rate of their dtype."""
    t_bytes = wk["bytes"] / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in wk["ops"].items()
                if dt in PEAK_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
