"""Serial-numpy SE(3) MS-iLQR: execution-model mirror of the reference
(the port's own copy of the JAX package's `baselines/numpy_serial.py`).

The wall-clock baseline proxy for the bench's serial CPU rate.  The
reference (`traopt_controller.py:iLQR_Tracking_SE3_MS` +
`traopt_dynamics.py:SE3Dynamics` +
`traopt_cost.py:SE3TrackingQuadraticGaussNewtonCost`) runs one Python-level
loop iteration per stage per phase, with each stage doing a handful of small
C-backed calls (manif ops, numpy 6x6/12x12 linalg).  This module reproduces
that execution model: per-stage Python loops over small numpy ops,
closed-form numpy exp/log in place of manif, so its wall clock is an honest
stand-in for the reference's (manifpy is not a dependency).

Numerics match the solver engines (the same quirks replicated), so it
doubles as a third implementation for cross-checks.  Plain numpy: no torch.
"""

import numpy as np


# -- numpy SO(3)/SE(3) maps (mirror ops/so3.py, ops/se3.py) ------------------

def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def _so3_exp(w):
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-8:
        return np.eye(3) + W + 0.5 * W @ W
    return (np.eye(3) + np.sin(th) / th * W
            + (1.0 - np.cos(th)) / th**2 * W @ W)


def _so3_log(R):
    tr = np.trace(R)
    cos_th = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-8:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    if th > np.pi - 1e-6:
        # near pi: diagonal extraction
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        i = int(np.argmax(axis))
        axis = A[:, i] / max(axis[i], 1e-12)
        axis /= np.linalg.norm(axis)
        return th * axis
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _so3_Jl(w):
    th2 = w @ w
    W = _hat(w)
    if th2 < 1e-8:
        return np.eye(3) + 0.5 * W + W @ W / 6.0
    th = np.sqrt(th2)
    return (np.eye(3) + (1.0 - np.cos(th)) / th2 * W
            + (th - np.sin(th)) / (th2 * th) * W @ W)


def _so3_Jl_inv(w):
    th2 = w @ w
    W = _hat(w)
    if th2 < 1e-8:
        return np.eye(3) - 0.5 * W + W @ W / 12.0
    th = np.sqrt(th2)
    k = 1.0 / th2 - np.cos(th / 2.0) / (2.0 * th * np.sin(th / 2.0))
    return np.eye(3) - 0.5 * W + k * W @ W


def _se3_exp(xi):
    w, v = xi[:3], xi[3:]
    R = _so3_exp(w)
    p = _so3_Jl(w) @ v
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def _se3_log(T):
    w = _so3_log(T[:3, :3])
    v = _so3_Jl_inv(w) @ T[:3, 3]
    return np.concatenate([w, v])


def _normalize(T):
    """Quaternion round-trip re-orthonormalization (mirrors manif conversions)."""
    R = T[:3, :3]
    # Shepperd extraction
    tr = np.trace(R)
    m = [R[0,0], R[1,1], R[2,2], tr]
    i = int(np.argmax(m))
    if i == 3:
        s = np.sqrt(max(1.0 + tr, 1e-30)) * 2.0
        q = np.array([0.25*s, (R[2,1]-R[1,2])/s, (R[0,2]-R[2,0])/s, (R[1,0]-R[0,1])/s])
    elif i == 0:
        s = np.sqrt(max(1.0 + R[0,0] - R[1,1] - R[2,2], 1e-30)) * 2.0
        q = np.array([(R[2,1]-R[1,2])/s, 0.25*s, (R[0,1]+R[1,0])/s, (R[0,2]+R[2,0])/s])
    elif i == 1:
        s = np.sqrt(max(1.0 - R[0,0] + R[1,1] - R[2,2], 1e-30)) * 2.0
        q = np.array([(R[0,2]-R[2,0])/s, (R[0,1]+R[1,0])/s, 0.25*s, (R[1,2]+R[2,1])/s])
    else:
        s = np.sqrt(max(1.0 - R[0,0] - R[1,1] + R[2,2], 1e-30)) * 2.0
        q = np.array([(R[1,0]-R[0,1])/s, (R[0,2]+R[2,0])/s, (R[1,2]+R[2,1])/s, 0.25*s])
    q = q / np.linalg.norm(q)
    qw, qx, qy, qz = q
    Rn = np.array([
        [1-2*(qy*qy+qz*qz), 2*(qx*qy-qw*qz), 2*(qx*qz+qw*qy)],
        [2*(qx*qy+qw*qz), 1-2*(qx*qx+qz*qz), 2*(qy*qz-qw*qx)],
        [2*(qx*qz-qw*qy), 2*(qy*qz+qw*qx), 1-2*(qx*qx+qy*qy)],
    ])
    Tn = np.eye(4)
    Tn[:3, :3] = Rn
    Tn[:3, 3] = T[:3, 3]
    return Tn


def _se3_inv(T):
    Ti = np.eye(4)
    Rt = T[:3, :3].T
    Ti[:3, :3] = Rt
    Ti[:3, 3] = -Rt @ T[:3, 3]
    return Ti


def _se3_Ad(T):
    R = T[:3, :3]
    P = _hat(T[:3, 3])
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, :3] = P @ R
    A[3:, 3:] = R
    return A


def _coad(xi):
    w, v = xi[:3], xi[3:]
    A = np.zeros((6, 6))
    A[:3, :3] = _hat(w)
    A[3:, :3] = _hat(v)
    A[3:, 3:] = _hat(w)
    return A.T


def _Q_mat(w, v):
    th2 = w @ w
    W, V = _hat(w), _hat(v)
    if th2 < 1e-8:
        c1, c2, c3 = 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0
    else:
        th = np.sqrt(th2)
        s, c = np.sin(th), np.cos(th)
        c1 = (th - s) / (th2 * th)
        c2 = (th2 + 2.0 * c - 2.0) / (2.0 * th2 * th2)
        c3 = (2.0 * th - 3.0 * s + th * c) / (2.0 * th2 * th2 * th)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    return (0.5 * V + c1 * (WV + VW + WVW)
            + c2 * (W @ WV + VW @ W - 3.0 * WVW)
            + c3 * (WVW @ W + W @ WVW))


def _se3_Jr(xi):
    w, v = -xi[:3], -xi[3:]
    Jw = _so3_Jl(w)
    J = np.zeros((6, 6))
    J[:3, :3] = Jw
    J[3:, :3] = _Q_mat(w, v)
    J[3:, 3:] = Jw
    return J


def _se3_Jr_inv(xi):
    w, v = -xi[:3], -xi[3:]
    Jw_inv = _so3_Jl_inv(w)
    Q = _Q_mat(w, v)
    J = np.zeros((6, 6))
    J[:3, :3] = Jw_inv
    J[3:, :3] = -Jw_inv @ Q @ Jw_inv
    J[3:, 3:] = Jw_inv
    return J


# -- reference-style serial SE(3) MS-iLQR ------------------------------------

class SerialSE3MSiLQR:
    """Serial numpy MS-iLQR, one stage at a time (reference execution model)."""

    def __init__(self, J, dt, Q, R, P, q_ref, xi_ref, ref_coad_swap=True):
        self.J = np.asarray(J)
        self.Jinv = np.linalg.inv(self.J)
        self.Ib = self.J[:3, :3]
        self.mass = self.J[4, 4]
        self.dt = float(dt)
        self.Q1, self.Q2 = np.asarray(Q)[:6, :6], np.asarray(Q)[6:, 6:]
        self.P1, self.P2 = np.asarray(P)[:6, :6], np.asarray(P)[6:, 6:]
        self.R = np.asarray(R)
        self.q_ref = np.asarray(q_ref)
        self.xi_ref = np.asarray(xi_ref).reshape(len(q_ref), 6)
        self.q_ref_inv = np.array([_se3_inv(q) for q in self.q_ref])
        self.Ad_ref = np.array([_se3_Ad(q) for q in self.q_ref])
        self.N = len(q_ref) - 1
        self.ref_coad_swap = ref_coad_swap
        self.mu, self.delta = 1.0, 2.0
        self.mu_min, self.mu_max, self.delta_0 = 1e-6, 1e10, 2.0

    def step(self, q, xi, u):
        q_next = _normalize(q @ _se3_exp(xi * self.dt))
        xi_next = xi + self.Jinv @ (_coad(xi) @ self.J @ xi + u) * self.dt
        return q_next, xi_next

    def jac(self, q, xi, u):
        tau = xi * self.dt
        J_q_q = _se3_Ad(_se3_exp(-tau))
        J_q_xi = _se3_Jr(tau) * self.dt
        w, v = xi[:3], xi[3:]
        G = np.zeros((6, 6))
        G[:3, :3] = _hat(self.Ib @ w)
        G[:3, 3:] = self.mass * _hat(v)
        G[3:, :3] = self.mass * _hat(v)
        xi_h = np.concatenate([v, w]) if self.ref_coad_swap else xi
        H = self.Jinv @ (_coad(xi_h) @ self.J + G)
        Fx = np.zeros((12, 12))
        Fx[:6, :6] = J_q_q
        Fx[:6, 6:] = J_q_xi
        Fx[6:, 6:] = np.eye(6) + H * self.dt
        Fu = np.zeros((12, 6))
        Fu[6:, :] = self.Jinv * self.dt
        return Fx, Fu

    def quad(self, q, xi, u, i, terminal=False):
        W1, W2 = (self.P1, self.P2) if terminal else (self.Q1, self.Q2)
        e = _se3_log(q @ self.q_ref_inv[i])
        ev = xi - self.xi_ref[i]
        Jex = _se3_Jr_inv(e) @ self.Ad_ref[i]
        l = e @ W1 @ e + ev @ W2 @ ev
        lx = np.concatenate([2.0 * Jex.T @ W1 @ e, 2.0 * W2 @ ev])
        lxx = np.zeros((12, 12))
        lxx[:6, :6] = 2.0 * Jex.T @ W1 @ Jex
        lxx[6:, 6:] = 2.0 * W2
        if terminal:
            return l, lx, lxx, None, None
        l = l + u @ self.R @ u
        return l, lx, lxx, 2.0 * self.R @ u, 2.0 * self.R

    def iterate(self, qs, xis, us):
        """One full MS iteration (linearize -> backward -> rollout)."""
        N = self.N
        d = np.empty((N, 12))
        Fx = np.empty((N, 12, 12))
        Fu = np.empty((N, 12, 6))
        L = np.empty(N + 1)
        Lx = np.empty((N + 1, 12))
        Lu = np.empty((N, 6))
        Lxx = np.empty((N + 1, 12, 12))
        Luu = np.empty((N, 6, 6))
        fqs = [None] * N
        fxis = [None] * N
        for i in range(N):
            fq, fxi = self.step(qs[i], xis[i], us[i])
            fqs[i], fxis[i] = fq, fxi
            d[i, :6] = _se3_log(_se3_inv(qs[i + 1]) @ fq)
            d[i, 6:] = fxi - xis[i + 1]
            Fx[i], Fu[i] = self.jac(qs[i], xis[i], us[i])
            L[i], Lx[i], Lxx[i], Lu[i], Luu[i] = self.quad(qs[i], xis[i], us[i], i)
        L[N], Lx[N], Lxx[N], _, _ = self.quad(qs[N], xis[N], None, N, terminal=True)

        # backward (per-step adaptive mu, ref :1637-1694)
        V_x, V_xx = Lx[N], Lxx[N]
        k = np.empty((N, 6))
        K = np.empty((N, 6, 12))
        Vx_next = np.empty((N, 12))
        Vxx_next = np.empty((N, 12, 12))
        for i in range(N - 1, -1, -1):
            Vx_next[i], Vxx_next[i] = V_x, V_xx
            while True:
                reg = self.mu * np.eye(12)
                Qx = Lx[i] + Fx[i].T @ (V_x + V_xx @ d[i])
                Qu = Lu[i] + Fu[i].T @ (V_x + V_xx @ d[i])
                Qxx = Lxx[i] + Fx[i].T @ V_xx @ Fx[i]
                Qux = Fu[i].T @ (V_xx + reg) @ Fx[i]
                Quu = Luu[i] + Fu[i].T @ (V_xx + reg) @ Fu[i]
                try:
                    np.linalg.cholesky(Quu + Quu.T)
                    ok = True
                except np.linalg.LinAlgError:
                    ok = False
                if not ok:
                    self.delta = max(1.0, self.delta) * self.delta_0
                    self.mu = max(self.mu_min, self.mu * self.delta)
                    if self.mu >= self.mu_max:
                        break
                else:
                    self.delta = min(1.0, self.delta) / self.delta_0
                    self.mu *= self.delta
                    if self.mu <= self.mu_min:
                        self.mu = 0.0
                    break
            k[i] = -np.linalg.solve(Quu, Qu)
            K[i] = -np.linalg.solve(Quu, Qux)
            V_x = Qx + K[i].T @ Quu @ k[i] + K[i].T @ Qu + Qux.T @ k[i]
            V_xx = Qxx + K[i].T @ Quu @ K[i] + K[i].T @ Qux + Qux.T @ K[i]
            V_xx = 0.5 * (V_xx + V_xx.T)

        # gradient
        s = 0.0
        for t in range(N):
            g = Lu[t] + Fu[t].T @ (Vx_next[t] + Vxx_next[t].T @ d[t])
            s += np.linalg.norm(g)
        grad_norm = s / N

        # nonlinear gap-closing rollout, alpha = 1 (ref :2697-2718)
        qs_new = [qs[0]]
        xis_new = [xis[0]]
        us_new = np.empty_like(us)
        for i in range(N):
            xs_err = np.concatenate([
                _se3_log(_se3_inv(qs[i]) @ qs_new[i]), xis_new[i] - xis[i]])
            us_err = k[i] + K[i] @ xs_err
            us_new[i] = us[i] + us_err
            fq_new, fxi_new = self.step(qs_new[i], xis_new[i], us_new[i])
            q_nn = _normalize(qs[i + 1] @ _se3_exp(d[i, :6]) @ _se3_inv(fqs[i]) @ fq_new)
            xi_nn = xis[i + 1] + fxi_new - fxis[i] + d[i, 6:]
            qs_new.append(q_nn)
            xis_new.append(xi_nn)
        J_total = float(np.sum(L))
        return np.array(qs_new), np.array(xis_new), us_new, J_total, grad_norm

    def fit(self, q0, xi0, us_init, n_iterations=10):
        qs = np.concatenate([np.asarray(q0)[None], self.q_ref[1:]], axis=0)
        xis = np.concatenate([np.asarray(xi0)[None], self.xi_ref[1:]], axis=0)
        us = np.asarray(us_init).copy()
        J_hist, grad_hist = [], []
        for _ in range(n_iterations):
            qs, xis, us, J, g = self.iterate(qs, xis, us)
            J_hist.append(J)
            grad_hist.append(g)
        return qs, xis, us, J_hist, grad_hist
