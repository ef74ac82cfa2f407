"""The reference's N=1400 screw-tracking problem (counterpart of the JAX
`tasks/al_bench.py`), and its N=200 prefix that the port is measured on.

A constant-twist screw reference (w = (0, 0, 1), v = (2, 0, 0.2), dt = 0.01),
GN tracking cost with Q = diag(10, 10, 10, 1, ..., 1), P = 10 Q, R = 0,
input box u in [-10, 10]^6, initial offset p0 = (-1, -1, -0.2) with
xi0 = (0, 0, 0.1, 2, 0, 0.2).

The f64 golden of the full problem (`golden/al1400_us.npy`,
`golden/al1400_meta.json`: 11 AL outers, 31 controls railed at +10) is a
byte-for-byte copy of the JAX package's (`load_al1400_golden`).

`build_screw200` is the port's main-path problem: the first 200 stages with
R = 1e-3 I (the pipeline's Cholesky needs Quu > 0) and no box.  Its f64
golden (`golden/screw200_us.npy`, `golden/screw200_meta.json`) comes from
the JAX package's f64 engine (`scripts/gen_torch_port_golden.py`); the
JAX anchored tier's accuracy on it is in `golden/screw200_anchored_meta.json`.

`build_screw200_nu` puts the same tracking problem on a rigid body driven
through an input projection Pu (6, nu), with g = 0 and R = 1e-2 I: the
rigid-body family (`gravity=True` in the pipelines) is how Pu reaches the
solvers.  Its four named cases, with goldens from
`scripts/gen_torch_port_golden_nu.py` (`load_nu_golden`), are
`screw200_torques3` (three body torques, Pu = [I3; 0], nu = 3),
`screw200_rcs12` (a 12-thruster reaction-control layout, `rcs12_pu`,
nu = 12), `screw200_rcs16` (four quads of four thrusters, the pattern of
the Apollo Service Module, `rcs16_pu`, nu = 16) and `screw200_rcs24` (24
thrusters, `rcs24_pu`, nu = 24, as many as the Orion European Service
Module's attitude thrusters).  `screw200_nu_model` is the same problem as
the (model, params) pair of the generic fast tier.
"""

import json
import os

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

__all__ = ["build_al1400", "build_screw200", "screw200_model", "screw_batch",
           "load_screw200_golden", "load_screw200_anchored_meta", "load_al1400_golden",
           "torques3_pu", "rcs12_pu", "nu_pu", "build_screw200_nu", "screw200_nu_model",
           "NU_PROBLEMS", "load_nu_golden"]

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def build_al1400(dtype=torch.float64, horizon=1400, device=torch.device("cuda")):
    """Returns (params {dyn, cost}, lb, ub, q0, xi0, q_ref, xi_ref) on
    ``device`` (the card unless asked for another)."""
    dt = 0.01
    m = 1.0
    Ib = np.diag([0.5, 0.7, 0.9])
    J = np.block([[Ib, np.zeros((3, 3))], [np.zeros((3, 3)), m * np.eye(3)]])
    xi0_ref = np.concatenate([np.array([0.0, 0.0, 1.0]),
                              np.array([1.0, 0.0, 0.1]) * 2.0])
    # constant-twist screw reference X_{k+1} = X_k Exp(xi dt), built in f64
    step = SE3.exp(torch.as_tensor(xi0_ref * dt, dtype=torch.float64)).numpy()
    q_ref = np.zeros((horizon + 1, 4, 4))
    q_ref[0] = np.eye(4)
    for i in range(horizon):
        q_ref[i + 1] = q_ref[i] @ step
    xi_ref = np.broadcast_to(xi0_ref, (horizon + 1, 6)).copy()
    Q = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    P = Q * 10.0
    R = np.zeros((6, 6))

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    dp = dynamics.se3_params(t(J), t(dt))
    cp = costs.tracking_cost_params(SE3, t(Q), t(R), t(P), t(q_ref), t(xi_ref))
    q0 = np.eye(4)
    q0[:3, 3] = [-1.0, -1.0, -0.2]
    xi0 = np.array([0.0, 0.0, 0.1, 2.0, 0.0, 0.2])
    return ({"dyn": dp, "cost": cp}, -10.0, 10.0, t(q0), t(xi0), t(q_ref),
            t(xi_ref))


def build_screw200(dtype=torch.float64, device=torch.device("cuda"), horizon=200,
                   r=1e-3):
    """The main-path problem: `build_al1400`'s first ``horizon`` stages with
    R = r I and no box, on ``device`` (the card unless asked for another).
    Returns (dyn, cost, q0, xi0)."""
    params, _, _, q0, xi0, _, _ = build_al1400(dtype, horizon, device)
    cost = params["cost"]
    cost.R = r * torch.eye(6, dtype=dtype, device=device)
    return params["dyn"], cost, q0, xi0


def screw200_model(dtype=torch.float64, device=torch.device("cuda"), horizon=200,
                   drone=False):
    """`build_screw200` as the (model, params) pair of `make_model` that the
    generic `solvers/batched.FastBatchSolver` takes: the free body with the
    SE(3) tracking cost and R = 1e-3 I, or with ``drone`` the drone
    (`drone_params(J, dt)`: gravity, 3 torques + z-thrust) with R = 1e-2 I4.
    On ``device`` (the card unless asked for another).
    Returns (model, params, q0, xi0); the reference is params["cost"]'s."""
    dyn, cost, q0, xi0 = build_screw200(dtype, device, horizon)
    if drone:
        dyn = dynamics.drone_params(dyn.J, dyn.dt)
        cost.R = 1e-2 * torch.eye(4, dtype=dtype, device=device)
        model, params = make_model(dynamics.drone_dynamics(),
                                   costs.tracking_cost(SE3, 4), dyn, cost)
    else:
        model, params = make_model(dynamics.se3_dynamics(),
                                   costs.tracking_cost(SE3, 6), dyn, cost)
    return model, params, q0, xi0


def torques3_pu():
    """Pu = [I3; 0] (6, 3), f64 numpy: three body torques."""
    return np.vstack([np.eye(3), np.zeros((3, 3))])


def rcs12_pu():
    """A 12-thruster reaction-control layout (6, 12), f64 numpy: for each
    axis a in (x, y, z), each sign s in (+1, -1) and each offset o in
    (+0.5, -0.5) along axis b = (a + 1) mod 3, in that order, the thruster
    of direction d = s e_a at r = o e_b, column [r x d; d].  Rank 6."""
    eye = np.eye(3)
    cols = [np.concatenate([np.cross(o * eye[(a + 1) % 3], s * eye[a]), s * eye[a]])
            for a in range(3) for s in (1.0, -1.0) for o in (0.5, -0.5)]
    return np.stack(cols, axis=1)


def _thruster(r, d):
    """The column [r x d; d] of a thruster of direction d at r."""
    return np.concatenate([np.cross(r, d), d])


def rcs16_pu():
    """Four quads of four thrusters (6, 16), f64 numpy, the Apollo Service
    Module's pattern: quads at r = +0.5 e_y, -0.5 e_y, +0.5 e_z, -0.5 e_z, in
    that order, each firing along +e_x, -e_x, + and - the third axis (e_z
    for the quads on y, e_y for those on z).  Rank 6."""
    eye = np.eye(3)
    cols = [_thruster(o * eye[b], d)
            for b, c in ((1, 2), (2, 1)) for o in (0.5, -0.5)
            for d in (eye[0], -eye[0], eye[c], -eye[c])]
    return np.stack(cols, axis=1)


def rcs24_pu():
    """`rcs12_pu`'s construction with four offsets (6, 24), f64 numpy: for
    each axis a in (x, y, z) and each sign s in (+1, -1), the thrusters of
    direction s e_a at r = +0.5 e_b, -0.5 e_b, +0.5 e_c, -0.5 e_c with
    b = (a + 1) mod 3 and c = (a + 2) mod 3, in that order.  Rank 6."""
    eye = np.eye(3)
    cols = [_thruster(o * eye[b], s * eye[a])
            for a in range(3) for s in (1.0, -1.0)
            for b in ((a + 1) % 3, (a + 2) % 3) for o in (0.5, -0.5)]
    return np.stack(cols, axis=1)


def nu_pu(nu):
    """The input projection (6, nu), f64 numpy, that the checks at input
    dimension nu take: the first nu columns of I6 up to nu = 6 (nu = 3:
    `torques3_pu`), I6 and the first nu - 6 thrusters of `rcs12_pu` past it,
    `rcs12_pu` at nu = 12, and past 12 I6 and the first nu - 6 thrusters of
    `rcs24_pu`, repeated from the first past 30.  (The first 1, 5 or 8 thrusters alone act on
    too few directions: the polish does not converge on them, and at its
    iterates the f32 roundings that kernel and plain version order
    differently reach B5's Q_u at up to 1e-6, in the tuned instance (nu = 4,
    6) as in the runtime-nu one: `scripts/nu_instances.py`.)"""
    if nu == 12:
        return rcs12_pu()
    eye = np.eye(6)
    if nu <= 6:
        return eye[:, :nu]
    if nu < 12:
        return np.hstack([eye, rcs12_pu()[:, :nu - 6]])
    return np.hstack([eye, rcs24_pu()[:, np.arange(nu - 6) % 24]])


def build_screw200_nu(Pu, dtype=torch.float64, device=torch.device("cuda"), horizon=200):
    """`build_screw200`'s tracking problem on a rigid body driven through
    ``Pu`` (6, nu), with g = 0, the exact gravity Jacobian (zero at g = 0)
    and R = 1e-2 I (the value the goldens of `NU_PROBLEMS` were made with),
    on ``device`` (the card unless asked for another); solve it with
    ``gravity=True, exact_gravity_jacobian=True``.
    Returns (dyn, cost, q0, xi0)."""
    dyn, cost, q0, xi0 = build_screw200(dtype, device, horizon)
    Pu = torch.as_tensor(np.asarray(Pu), dtype=dtype, device=device)
    dyn = dynamics.rigid_body_params(dyn.J, dyn.dt, g=0.0, Pu=Pu,
                                     exact_gravity_jacobian=True)
    cost.R = 1e-2 * torch.eye(Pu.shape[1], dtype=dtype, device=device)
    return dyn, cost, q0, xi0


def screw200_nu_model(Pu, dtype=torch.float64, device=torch.device("cuda"), horizon=200):
    """`build_screw200_nu` as the (model, params) pair of `make_model` that
    the generic `solvers/batched.FastBatchSolver` and `solvers/al_fast.
    ALFastSolver` take: the rigid body (`rigid_body_dynamics` at nu =
    Pu.shape[1]) with the SE(3) tracking cost, on ``device`` (the card
    unless asked for another).  Returns (model, params, q0, xi0); the
    reference is params["cost"]'s."""
    dyn, cost, q0, xi0 = build_screw200_nu(Pu, dtype, device, horizon)
    nu = cost.R.shape[0]
    model, params = make_model(dynamics.rigid_body_dynamics()._replace(nu=nu),
                               costs.tracking_cost(SE3, nu), dyn, cost)
    return model, params, q0, xi0


# the named problems of `build_screw200_nu`: name -> input projection
NU_PROBLEMS = {"screw200_torques3": torques3_pu, "screw200_rcs12": rcs12_pu,
               "screw200_rcs16": rcs16_pu, "screw200_rcs24": rcs24_pu}


def load_nu_golden(name):
    """(us (200, nu) f64 numpy, meta dict) of the committed f64 golden of a
    problem of `NU_PROBLEMS`."""
    us = np.load(os.path.join(GOLDEN_DIR, f"{name}_us.npy"))
    with open(os.path.join(GOLDEN_DIR, f"{name}_meta.json")) as f:
        return us, json.load(f)


def screw_batch(q0, xi0, B, seed, scale=0.05):
    """A batch of B perturbed initial poses normalize(q0 Exp(scale n)), n
    from ``numpy.random.default_rng(seed)``, with lane 0 the unperturbed q0
    (the accuracy anchor), and xi0 for every lane.
    Returns (q0s (B, 4, 4), xi0s (B, 6)) in q0's dtype and device."""
    n = np.random.default_rng(seed).standard_normal((B, 6))
    dq = torch.as_tensor(scale * n, dtype=q0.dtype).to(q0.device)
    q0s = SE3.normalize(q0[None] @ SE3.exp(dq))
    q0s[0] = q0
    return q0s, xi0[None].expand(B, 6).contiguous()


def load_screw200_golden():
    """(us (200, 6) f64 numpy, meta dict) of the committed f64 golden."""
    us = np.load(os.path.join(GOLDEN_DIR, "screw200_us.npy"))
    with open(os.path.join(GOLDEN_DIR, "screw200_meta.json")) as f:
        return us, json.load(f)


def load_screw200_anchored_meta():
    """The JAX anchored tier's own accuracy on screw-200
    (`golden/screw200_anchored_meta.json`, from
    `scripts/gen_torch_port_golden_anchored.py`): its f32 lane-0 control
    error against `screw200_us.npy`, which the port's anchored solve is
    gated against."""
    with open(os.path.join(GOLDEN_DIR, "screw200_anchored_meta.json")) as f:
        return json.load(f)


def load_al1400_golden():
    """(us (1400, 6) f64 numpy, meta dict) of the committed f64 golden of the
    full N=1400 AL problem."""
    us = np.load(os.path.join(GOLDEN_DIR, "al1400_us.npy"))
    with open(os.path.join(GOLDEN_DIR, "al1400_meta.json")) as f:
        return us, json.load(f)
