"""Embedded-Euclidean baselines (counterpart of the JAX `baselines/embedded.py`).

The reference's baseline family (`traoptlibrary/traopt_baseline.py`, 18
classes) optimizes over raw quaternion/rotation entries with CasADi+IPOPT.
The same *formulations* are re-expressed as Euclidean iLQR models
(`models/autodiff.autodiff_model`, derivatives from `torch.func`) and solved
with the port's `solvers/ilqr.ILQR`:

  - `su2_model` — the "Embedded Euclidean SU(2)" formulation
    (`EmbeddedEuclideanSU2_SE3:642`): state x = [quat(4), pos(3), xi(6)] in
    R^13, quaternion kinematics with NO manifold constraint, chordal cost on
    the raw quaternion difference (`traopt_baseline.py:891-893`);
  - `se3_matrix_model` — the embedded rotation-entry families on R^18;
  - `su2_so3_model` / `so3_matrix_model` — the SO(3)-attitude families
    (free attitude and 3-D pendulum) on R^7 and R^12.

Deviation note (the JAX module's): the reference's velocity dynamics
constraint drops the `+ xi_k` integrator term (`traopt_baseline.py:866-867`)
— an apparent bug not replicated; ``xi_{k+1} = xi_k + dt J^-1(coad(xi) J xi
+ u)`` like every other model.  Nothing renormalizes the embedded attitude,
so the method's drift (quaternion norm, orthogonality) is preserved and
measured by `utils.metrics`.

The model functions take one sample (the solver maps them over problems
and stages with `torch.func.vmap`); a stage index ``i`` there is a batched
0-d tensor, so reference rows are taken with `_row`.  The ``solve_*``
functions keep the JAX signatures (one problem, x0 and us_init without a
batch axis) and return (xs (N+1, nx), us (N, nu), J_hist, grad_hist,
state), the histories lists of floats; they run on ``us_init``'s device and
dtype when it is a tensor, else on the card in ``us_init``'s dtype.
"""

import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.autodiff import (
    autodiff_model,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.ilqr import (
    ILQR,
    ILQRConfig,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
    solve_device,
)


def _row(x, i):
    """Row ``i`` of a per-stage table (N+1, ...); ``i`` an int or an index
    tensor (under `torch.func.vmap` a batched 0-d one, which plain indexing
    would read back with ``.item()``)."""
    if isinstance(i, torch.Tensor):
        return x[i.reshape(-1)].reshape(i.shape + x.shape[1:])
    return x[i]


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _quat_rotate(q, v):
    """Rotate v by (possibly non-unit) quaternion q, as the embedded method
    does — through the quaternion sandwich without normalization."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    qc = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return _quat_mul(_quat_mul(q, qv), qc)[..., 1:]


def _setup(dtype, device):
    """A converter of setup values (tensors, arrays or Python numbers) to
    ``dtype``/``device``; a Python number is taken in ``dtype`` directly
    (not through the default float32)."""
    return lambda x: (x.to(device=device, dtype=dtype) if isinstance(x, torch.Tensor)
                      else torch.as_tensor(x, dtype=dtype, device=device))


def su2_model(J, dt, q_ref, xi_ref, Q, R, P, nu=6, dtype=torch.float64, device=None):
    """Embedded SU(2)/R^13 model + cost, solved by Euclidean iLQR.

    q_ref: (N+1, 4, 4) SE(3) reference (converted to quat-pos here);
    weights follow the reference's slicing (`traopt_baseline.py:684-697`):
    alpha = Q[0,0] on the raw quaternion difference, Qp = Q[3:6,3:6] on
    position, Qw = Q[6:,6:] on the twist.
    """
    t = _setup(dtype, device)
    J = t(J)
    Jinv = torch.linalg.inv(J)
    quat_ref = se3.quatpos_from_matrix(t(q_ref))  # (N+1, 7)
    xi_ref = t(xi_ref).reshape(quat_ref.shape[0], 6)
    Qm, Pm = t(Q), t(P)
    alpha, alphaN = Qm[0, 0], Pm[0, 0]
    Qp, Pp = Qm[3:6, 3:6], Pm[3:6, 3:6]
    Qw, Pw = Qm[6:, 6:], Pm[6:, 6:]
    Rw = t(R)

    def f(x, u, i):
        q, p, xi = x[:4], x[4:7], x[7:]
        w, v = xi[:3], xi[3:]
        q_next = q + dt * 0.5 * _quat_mul(q, torch.cat([torch.zeros_like(w[:1]), w]))
        p_next = p + dt * _quat_rotate(q, v)
        wrench = se3.coad(xi) @ (J @ xi) + u
        xi_next = xi + dt * (Jinv @ wrench)
        return torch.cat([q_next, p_next, xi_next])

    def _stage(x, i, a, Wp, Ww):
        qr = _row(quat_ref, i)
        dq = x[:4] - qr[:4]
        dp = x[4:7] - qr[4:]
        dxi = x[7:] - _row(xi_ref, i)
        return a * dq @ dq + dp @ Wp @ dp + dxi @ Ww @ dxi

    def l(x, u, i):
        return _stage(x, i, alpha, Qp, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pp, Pw)

    return autodiff_model(f, l, l_terminal, 13, nu)


def _fit(model, x0_vec, us_init, n_iterations, tol_grad_norm):
    """One problem through the batch-native `ILQR`: the batch axis of 1
    added on the way in and dropped on the way out."""
    N = us_init.shape[0]
    cfg = ILQRConfig(N=int(N), tol_grad_norm=tol_grad_norm, max_iterations=n_iterations)
    xs, us, J_hist, grad_hist, state = ILQR(model, cfg).fit(
        x0_vec[None], us_init[None], n_iterations=n_iterations)
    return xs[0], us[0], [h[0] for h in J_hist], [h[0] for h in grad_hist], state


def _us(us_init, dtype=None):
    """``us_init`` as a tensor on its solve device (its own when it is a
    tensor, else the card)."""
    dev = solve_device(us_init)
    us = torch.as_tensor(us_init).to(device=dev)
    return us if dtype is None else us.to(dtype)


def solve_su2(J, dt, q_ref, xi_ref, Q, R, P, x0, us_init, nu=6,
              n_iterations=200, tol_grad_norm=1e-6):
    """Build and solve the embedded baseline; returns (xs, us, J_hist, ...)."""
    us0 = _us(us_init)
    t = _setup(us0.dtype, us0.device)
    model = su2_model(J, dt, q_ref, xi_ref, Q, R, P, nu=nu, dtype=us0.dtype,
                      device=us0.device)
    q0, xi0 = x0
    x0_vec = torch.cat([se3.quatpos_from_matrix(t(q0)), t(xi0).reshape(6)])
    return _fit(model, x0_vec, us0, n_iterations, tol_grad_norm)


# ---------------------------------------------------------------------------
# Embedded rotation-matrix families (R^18 state)
# ---------------------------------------------------------------------------

def _propagator(Rm, w, dt, variant, kappa):
    """The attitude step factor: Exp(w dt), plus the Baumgarte term
    kappa/2 ((R^T R)^-1 - I) for the stabilized variants."""
    E = so3.exp(w * dt)
    if variant in ("stabilized", "stabilized_logcost"):
        RtR = Rm.T @ Rm
        E = E + kappa / 2.0 * (torch.linalg.inv(RtR)
                               - torch.eye(3, dtype=Rm.dtype, device=Rm.device))
    return E


def _att_cost(Rm, R_ref_i, a, variant):
    if variant in ("logcost", "stabilized_logcost"):
        e = so3.log(Rm @ R_ref_i.T)
        return a * (e @ e)
    dR = Rm - R_ref_i
    return a * torch.sum(dR * dR)


def se3_matrix_model(J, dt, q_ref, xi_ref, Q, R, P, variant="dynconstr",
                     kappa=1.0, nu=6, dtype=torch.float64, device=None):
    """Embedded rotation-entry baselines as R^18 iLQR models.

    The optimizer works on raw rotation-matrix entries, with the manifold
    structure entering only through the chosen propagation/cost:

      - 'dynconstr':  exp-map propagation of R, chordal cost ||R - Rbar||_F^2
        (`EmbeddedEuclideanSE3_DynamicsConstr:4321`)
      - 'logcost':    exp-map propagation, geodesic cost ||Log(R Rbar^T)||^2
        (`EmbeddedEuclideanSE3_DynamicsConstr_LogCost:3553`)
      - 'stabilized': Baumgarte-style orthogonality-restoring propagation
        R' = R (Exp(w dt) + kappa/2 ((R^T R)^-1 - I)), chordal cost
        (`ConstraintStabilizationSE3_MatrixNorm:5420`)
      - 'stabilized_logcost': the same kappa-propagation with the geodesic
        cost (`ConstraintStabilizationSE3:5028`)

    State x = [vec(R) (9), p (3), xi (6)].
    """
    t = _setup(dtype, device)
    J = t(J)
    Jinv = torch.linalg.inv(J)
    q_ref = t(q_ref)
    R_ref = q_ref[:, :3, :3]
    p_ref = q_ref[:, :3, 3]
    xi_ref = t(xi_ref).reshape(q_ref.shape[0], 6)
    Qm, Pm = t(Q), t(P)
    alpha, alphaN = Qm[0, 0], Pm[0, 0]
    Qp, Pp = Qm[3:6, 3:6], Pm[3:6, 3:6]
    Qw, Pw = Qm[6:, 6:], Pm[6:, 6:]
    Rw = t(R)

    def f(x, u, i):
        Rm = x[:9].reshape(3, 3)
        p = x[9:12]
        xi = x[12:]
        w, v = xi[:3], xi[3:]
        R_next = Rm @ _propagator(Rm, w, dt, variant, kappa)
        p_next = p + dt * (Rm @ v)
        wrench = se3.coad(xi) @ (J @ xi) + u
        xi_next = xi + dt * (Jinv @ wrench)
        return torch.cat([R_next.reshape(9), p_next, xi_next])

    def _stage(x, i, a, Wp, Ww):
        Rm = x[:9].reshape(3, 3)
        dp = x[9:12] - _row(p_ref, i)
        dxi = x[12:] - _row(xi_ref, i)
        return _att_cost(Rm, _row(R_ref, i), a, variant) + dp @ Wp @ dp + dxi @ Ww @ dxi

    def l(x, u, i):
        return _stage(x, i, alpha, Qp, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pp, Pw)

    return autodiff_model(f, l, l_terminal, 18, nu)


def solve_se3_matrix(J, dt, q_ref, xi_ref, Q, R, P, x0, us_init,
                     variant="dynconstr", kappa=1.0, nu=6,
                     n_iterations=200, tol_grad_norm=1e-6):
    """Solve an embedded rotation-matrix baseline with Euclidean iLQR."""
    us0 = _us(us_init)
    t = _setup(us0.dtype, us0.device)
    model = se3_matrix_model(J, dt, q_ref, xi_ref, Q, R, P, variant=variant,
                             kappa=kappa, nu=nu, dtype=us0.dtype, device=us0.device)
    q0, xi0 = x0
    q0 = t(q0)
    x0_vec = torch.cat([q0[:3, :3].reshape(9), q0[:3, 3], t(xi0).reshape(6)])
    return _fit(model, x0_vec, us0, n_iterations, tol_grad_norm)


# ---------------------------------------------------------------------------
# SO(3)-family baselines: SU(2)/R^7 and rotation-matrix/R^12 states
# (free attitude + 3-D pendulum)
# ---------------------------------------------------------------------------

_DOWN3 = (0.0, 0.0, -1.0)


def _pend_torque(Rm, w, u, J, m, length, g):
    """Pendulum torque on the EMBEDDED rotation (raw entries, exactly the
    baselines' form, traopt_baseline.py:2375-2390): cross(J w, w) +
    cross(m g rho, R^T down) + cross(m rho, R^T u)."""
    # made on the device without a host copy: the model runs inside the
    # solver's CUDA graph capture on the card (`solvers/graph.py`)
    down = torch.zeros(3, dtype=w.dtype, device=w.device)
    down[2:].fill_(_DOWN3[2])
    rho = length / 2.0 * down
    g_term = torch.linalg.cross(m * g * rho, Rm.T @ down)
    M = torch.linalg.cross(m * rho, Rm.T @ u)
    return torch.linalg.cross(J @ w, w) + g_term + M


def _so3_setup(t, J, R_ref, xi_ref, Q, R, P, m, length, g):
    """The SO(3) baselines' constants as tensors; alpha = Q[0, 0] and
    alphaN = P[0, 0] on the attitude, the twist blocks Q[3:, 3:] and
    P[3:, 3:] (the reference's slicing, `traopt_baseline.py:684-697`)."""
    J, R_ref, Qm, Pm = t(J), t(R_ref), t(Q), t(P)
    xi_ref = t(xi_ref).reshape(R_ref.shape[0], 3)
    return (J, torch.linalg.inv(J), R_ref, xi_ref, Qm[0, 0], Pm[0, 0], Qm[3:, 3:], Pm[3:, 3:],
            t(R), t(m), t(length), t(g))


def _quat_of_rotation(R_ref):
    """Quaternions of rotations through the SE(3) quat-pos converter
    (p = 0), as the JAX module builds them."""
    T = torch.zeros(R_ref.shape[:-2] + (4, 4), dtype=R_ref.dtype, device=R_ref.device)
    T[..., :3, :3] = R_ref
    T[..., 3, 3] = 1.0
    return se3.quatpos_from_matrix(T)[..., :4]


def su2_so3_model(J, dt, R_ref, xi_ref, Q, R, P, pendulum=False,
                  m=1.0, length=1.0, g=9.8, dtype=torch.float64, device=None):
    """Embedded SU(2)/R^7 attitude baselines (`EmbeddedEuclideanSU2:15`,
    `_Pendulum3D:320`): state x = [quat(4), w(3)], quaternion kinematics
    q_next = q - dt/2 [0, w] (x) q (the reference's Omega-matrix left
    product, traopt_baseline.py:133-151,504) with NO manifold constraint,
    chordal cost alpha ||q - q_ref||^2.  The pendulum torque uses the
    NORMALIZED quaternion's rotation (traopt_baseline.py:511) while the
    kinematics never renormalizes."""
    t = _setup(dtype, device)
    J, Jinv, R_ref, xi_ref, alpha, alphaN, Qw, Pw, Rw, m, length, g = _so3_setup(
        t, J, R_ref, xi_ref, Q, R, P, m, length, g)
    quat_ref = _quat_of_rotation(R_ref)

    def _rot_of(q):
        qn = q / torch.sqrt(q @ q)
        qw, qx, qy, qz = qn[0], qn[1], qn[2], qn[3]
        return torch.stack([
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                         2 * (qx * qz + qw * qy)]),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                         2 * (qy * qz - qw * qx)]),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                         1 - 2 * (qx * qx + qy * qy)]),
        ])

    def f(x, u, i):
        q, w = x[:4], x[4:]
        # q - dt/2 Omega(w) q  ==  q - dt/2 [0, w] (x) q
        wq = torch.cat([torch.zeros_like(w[:1]), w])
        q_next = q - dt * 0.5 * _quat_mul(wq, q)
        if pendulum:
            torque = _pend_torque(_rot_of(q), w, u, J, m, length, g)
        else:
            torque = torch.linalg.cross(J @ w, w) + u
        w_next = w + dt * (Jinv @ torque)
        return torch.cat([q_next, w_next])

    def _stage(x, i, a, Ww):
        dq = x[:4] - _row(quat_ref, i)
        dw = x[4:] - _row(xi_ref, i)
        return a * dq @ dq + dw @ Ww @ dw

    def l(x, u, i):
        return _stage(x, i, alpha, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pw)

    return autodiff_model(f, l, l_terminal, 7, 3)


def so3_matrix_model(J, dt, R_ref, xi_ref, Q, R, P, variant="dynconstr",
                     kappa=1.0, pendulum=False, m=1.0, length=1.0, g=9.8,
                     dtype=torch.float64, device=None):
    """Embedded rotation-matrix attitude baselines as R^12 iLQR models.

    State x = [vec(R) (9), w (3)].  The (propagation x cost) grid covers
    the reference's four SO(3)-attitude mechanism families:

      - 'dynconstr':           exp-map propagation, chordal ||R - Rbar||_F^2
        (`EmbeddedEuclideanSO3_DynamicsConstr:1955`, pendulum `:2210`)
      - 'logcost':             exp-map propagation, geodesic ||Log(R Rbar^T)||^2
        (`..._LogCost:1402`, pendulum `:1672`)
      - 'stabilized_logcost':  Baumgarte kappa-propagation, geodesic cost
        (`ConstraintStabilizationSO3:2487`, pendulum `:2754`)
      - 'stabilized':          kappa-propagation, chordal cost
        (`ConstraintStabilizationSO3_MatrixNorm:3023`, pendulum `:3276`)

    ``pendulum`` switches the velocity dynamics to the pivot-actuated
    pendulum torque (raw embedded R in the gravity/input moments,
    traopt_baseline.py:2375-2390).
    """
    t = _setup(dtype, device)
    J, Jinv, R_ref, xi_ref, alpha, alphaN, Qw, Pw, Rw, m, length, g = _so3_setup(
        t, J, R_ref, xi_ref, Q, R, P, m, length, g)

    def f(x, u, i):
        Rm = x[:9].reshape(3, 3)
        w = x[9:]
        R_next = Rm @ _propagator(Rm, w, dt, variant, kappa)
        if pendulum:
            torque = _pend_torque(Rm, w, u, J, m, length, g)
        else:
            torque = torch.linalg.cross(J @ w, w) + u
        w_next = w + dt * (Jinv @ torque)
        return torch.cat([R_next.reshape(9), w_next])

    def _stage(x, i, a, Ww):
        Rm = x[:9].reshape(3, 3)
        dw = x[9:] - _row(xi_ref, i)
        return _att_cost(Rm, _row(R_ref, i), a, variant) + dw @ Ww @ dw

    def l(x, u, i):
        return _stage(x, i, alpha, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pw)

    return autodiff_model(f, l, l_terminal, 12, 3)


def solve_so3_family(J, dt, R_ref, xi_ref, Q, R, P, x0, us_init,
                     formulation="dynconstr", kappa=1.0, pendulum=False,
                     m=1.0, length=1.0, g=9.8, n_iterations=200,
                     tol_grad_norm=1e-6):
    """Build and solve any SO(3)-attitude baseline.

    ``formulation``: 'su2' (R^7) or an `so3_matrix_model` variant
    ('dynconstr' | 'logcost' | 'stabilized' | 'stabilized_logcost').
    ``x0`` = (R0 (3,3), w0 (3,)).
    """
    us0 = _us(us_init)
    t = _setup(us0.dtype, us0.device)
    kw = dict(pendulum=pendulum, m=m, length=length, g=g, dtype=us0.dtype, device=us0.device)
    R0, w0 = x0
    if formulation == "su2":
        model = su2_so3_model(J, dt, R_ref, xi_ref, Q, R, P, **kw)
        x0_vec = torch.cat([_quat_of_rotation(t(R0)), t(w0).reshape(3)])
    else:
        model = so3_matrix_model(J, dt, R_ref, xi_ref, Q, R, P, variant=formulation,
                                 kappa=kappa, **kw)
        x0_vec = torch.cat([t(R0).reshape(9), t(w0).reshape(3)])
    return _fit(model, x0_vec, us0, n_iterations, tol_grad_norm)
