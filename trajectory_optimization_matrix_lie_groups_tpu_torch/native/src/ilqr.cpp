// Serial multiple-shooting iLQR runtime (C++, double precision) on SO(3)
// and SE(3).
//
// Native executor for the MPC/throughput configuration of the framework's
// solvers (fixed iteration budget, mu = 0, alpha = 1 gap-closing rollout) —
// the same iterate sequence as solvers/batched.FastBatchSolver /
// backward='sequential_fixed' in solvers/lie_ilqr.py, so it cross-checks the
// JAX engines implementation-independently and serves as a deployable
// host/embedded runtime where a TPU is not attached.  The reference gets the
// equivalent role from Python loops over manif C++ calls
// (traoptlibrary/traopt_controller.py:2641-2821); here the whole hot loop is
// native.
//
// Models: SE(3) free rigid body, rigid body under gravity, and the 4-input
// drone (6x4 Pu projection) — semi-implicit Euler (traopt_dynamics.py:763,
// 1049, 1373) with the reference's f_x coadjoint-swap quirk
// (traopt_dynamics.py:819,832) and its gravity-Jacobian quirk (no m*g
// factor in J_xi_q, traopt_dynamics.py:1121-1134); SO(3) free attitude
// (traopt_dynamics.py:275-419) and the pivot-actuated 3-D pendulum
// (traopt_dynamics.py:421-627, gravity torque hat(m g rho) R^T e3, input
// moment hat(m rho) R^T u); see models/dynamics.py for the JAX twins.
// Cost: left-difference Gauss-Newton tracking (traopt_cost.py:578-702 SE3,
// :280-564 SO3 — including the SO(3) class's terminal Q/P inconsistency
// behind `term_quirk`, traopt_cost.py:433-438 vs :526-531).
//
// The solver loop is a single template over a group-ops/model pair; the
// SE(3) and SO(3) instantiations share every line of the Riccati backward
// pass and the gap-closing rollout.
#include <cstring>
#include <vector>

#include "lie.hpp"

namespace traopt {
namespace {

constexpr int NU_MAX = 6;

// ---- group-op shims --------------------------------------------------------

struct SO3Pose {
  double R[9];
};

struct SE3Ops {
  using Pose = SE3;
  static constexpr int D = 6;
  static void compose(Pose* C, const Pose& A, const Pose& B) {
    se3_compose(C, A, B);
  }
  static void inverse(Pose* I, const Pose& T) { se3_inverse(I, T); }
  static void exp(Pose* T, const double* xi) { se3_exp(T, xi); }
  static void log(double* xi, const Pose& T) { se3_log(xi, T); }
  static void normalize(Pose* T) { se3_normalize(T); }
};

struct SO3Ops {
  using Pose = SO3Pose;
  static constexpr int D = 3;
  static void compose(Pose* C, const Pose& A, const Pose& B) {
    double R[9];
    mat_mul(R, A.R, B.R, 3, 3, 3);
    std::memcpy(C->R, R, sizeof(R));
  }
  static void inverse(Pose* I, const Pose& T) { mat_T(I->R, T.R, 3, 3); }
  static void exp(Pose* T, const double* w) { so3_exp(T->R, w); }
  static void log(double* w, const Pose& T) { so3_log(w, T.R); }
  static void normalize(Pose* T) { so3_normalize(T->R); }
};

// ---- SE(3) model family (free body / gravity / drone) ----------------------

struct ModelSE3 {
  using Ops = SE3Ops;
  double J[36];
  double Jinv[36];
  double dt;
  double Q1[36], Q2[36], R[NU_MAX * NU_MAX], P1[36], P2[36];
  double Pu[6 * NU_MAX];  // (6, nu) input projection (identity for free body)
  double mg;              // m * g (0 disables the gravity wrench + Fx block)
  bool gravity;
  int nu;
  std::vector<SE3> q_ref, q_ref_inv;
  std::vector<double> Ad_ref;  // (N+1) * 36
  std::vector<double> xi_ref;  // (N+1) * 6
};

// R^T * (0,0,-1): body-frame down direction
void body_down(const SE3& q, double* out) {
  out[0] = -q.R[6];
  out[1] = -q.R[7];
  out[2] = -q.R[8];
}

// xi_next = xi + dt * Jinv (coad(xi) J xi + [0; m g R^T down] + Pu u)
// (models/dynamics.py:196 free body, :287 gravity/drone)
void twist_step(const ModelSE3& M, const SE3& q, const double* xi,
                const double* u, double* xi_next) {
  double Jxi[6], C[36], w[6];
  mat_vec(Jxi, M.J, xi, 6, 6);
  se3_coad(C, xi);
  mat_vec(w, C, Jxi, 6, 6);
  double pu_u[6];
  mat_vec(pu_u, M.Pu, u, 6, M.nu);
  for (int i = 0; i < 6; ++i) w[i] += pu_u[i];
  if (M.gravity) {
    double dwn[3];
    body_down(q, dwn);
    for (int i = 0; i < 3; ++i) w[3 + i] += M.mg * dwn[i];
  }
  double dxi[6];
  mat_vec(dxi, M.Jinv, w, 6, 6);
  for (int i = 0; i < 6; ++i) xi_next[i] = xi[i] + M.dt * dxi[i];
}

void pose_step(const ModelSE3& M, const SE3& q, const double* xi,
               SE3* q_next) {
  double tau[6];
  for (int i = 0; i < 6; ++i) tau[i] = xi[i] * M.dt;
  SE3 E;
  se3_exp(&E, tau);
  se3_compose(q_next, q, E);
  se3_normalize(q_next);
}

// Fx per models/dynamics.py:234 (with ref_coad_swap); the gravity family
// adds J_xi_q = Jinv [[0,0],[hat(R^T down),0]] dt (the reference omits the
// m*g factor — quirk #2, models/dynamics.py; traopt_dynamics.py:1121-1134)
void dynamics_jacobian(const ModelSE3& M, const SE3& q, const double* xi,
                       const double* u, double* Fx) {
  (void)u;
  constexpr int NX = 12;
  double tau[6], ntau[6];
  for (int i = 0; i < 6; ++i) { tau[i] = xi[i] * M.dt; ntau[i] = -tau[i]; }
  SE3 Einv;
  se3_exp(&Einv, ntau);
  double Jqq[36], Jqxi[36];
  se3_Ad(Jqq, Einv);                 // Ad(Exp(tau))^-1
  se3_right_jacobian(Jqxi, tau);     // * dt below
  // H = Jinv (coad(swap(xi)) J + G),  G = [[hat(Ib w), m hat(v)],[m hat(v),0]]
  double xi_sw[6] = {xi[3], xi[4], xi[5], xi[0], xi[1], xi[2]};
  double C[36], CJ[36], G[36], Gw[9], Gv[9], S[36], H[36];
  se3_coad(C, xi_sw);
  mat_mul(CJ, C, M.J, 6, 6, 6);
  double Ibw[3];
  // Ib = J[:3,:3]; m = J[4][4]
  for (int i = 0; i < 3; ++i) {
    Ibw[i] = 0.0;
    for (int j = 0; j < 3; ++j) Ibw[i] += M.J[i * 6 + j] * xi[j];
  }
  so3_hat(Gw, Ibw);
  double mv[3] = {M.J[28] * xi[3], M.J[28] * xi[4], M.J[28] * xi[5]};
  so3_hat(Gv, mv);
  std::memset(G, 0, sizeof(G));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      G[i * 6 + j] = Gw[i * 3 + j];
      G[i * 6 + (j + 3)] = Gv[i * 3 + j];
      G[(i + 3) * 6 + j] = Gv[i * 3 + j];
    }
  for (int i = 0; i < 36; ++i) S[i] = CJ[i] + G[i];
  mat_mul(H, M.Jinv, S, 6, 6, 6);
  std::memset(Fx, 0, NX * NX * sizeof(double));
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      Fx[i * NX + j] = Jqq[i * 6 + j];
      Fx[i * NX + (j + 6)] = Jqxi[i * 6 + j] * M.dt;
      Fx[(i + 6) * NX + (j + 6)] = (i == j ? 1.0 : 0.0) + M.dt * H[i * 6 + j];
    }
  if (M.gravity) {
    double dwn[3], hd[9], B6[36], L[36];
    body_down(q, dwn);
    so3_hat(hd, dwn);
    std::memset(B6, 0, sizeof(B6));
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) B6[(3 + r) * 6 + c] = hd[r * 3 + c];
    mat_mul(L, M.Jinv, B6, 6, 6, 6);
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) Fx[(i + 6) * NX + j] = M.dt * L[i * 6 + j];
  }
}

// Fu = [0; Jinv Pu] dt (state-independent for the SE(3) family,
// models/dynamics.py:246) — evaluated once per solve (see fu_state_dependent)
bool fu_state_dependent(const ModelSE3&) { return false; }

void input_jacobian(const ModelSE3& M, const SE3& q, double* Fu) {
  (void)q;
  constexpr int NX = 12;
  const int nu = M.nu;
  double JiPu[6 * NU_MAX];
  mat_mul(JiPu, M.Jinv, M.Pu, 6, 6, nu);
  std::memset(Fu, 0, NX * nu * sizeof(double));
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < nu; ++j)
      Fu[(i + 6) * nu + j] = JiPu[i * nu + j] * M.dt;
}

// GN tracking quadratization at stage i with weights (W1, W2)
// (models/costs.py:103: e = Log(q q_ref^-1), J_e_x = Jr^-1(e) Ad_ref)
void cost_quad_w(const ModelSE3& M, const SE3& q, const double* xi, int i,
                 const double* W1, const double* W2, double* l, double* lx,
                 double* lxx) {
  constexpr int NX = 12;
  SE3 Eq;
  se3_compose(&Eq, q, M.q_ref_inv[i]);
  double e[6], ev[6];
  se3_log(e, Eq);
  for (int k = 0; k < 6; ++k) ev[k] = xi[k] - M.xi_ref[i * 6 + k];
  double Jri[36], Jex[36], JT[36], JTW[36], He[36];
  se3_right_jacobian_inv(Jri, e);
  mat_mul(Jex, Jri, M.Ad_ref.data() + i * 36, 6, 6, 6);
  mat_T(JT, Jex, 6, 6);
  mat_mul(JTW, JT, W1, 6, 6, 6);
  mat_mul(He, JTW, Jex, 6, 6, 6);
  double W1e[6], W2ev[6], g1[6];
  mat_vec(W1e, W1, e, 6, 6);
  mat_vec(W2ev, W2, ev, 6, 6);
  mat_vec(g1, JT, W1e, 6, 6);
  std::memset(lxx, 0, NX * NX * sizeof(double));
  for (int a = 0; a < 6; ++a) {
    lx[a] = 2.0 * g1[a];
    lx[a + 6] = 2.0 * W2ev[a];
    for (int b = 0; b < 6; ++b) {
      lxx[a * NX + b] = 2.0 * He[a * 6 + b];
      lxx[(a + 6) * NX + (b + 6)] = 2.0 * W2[a * 6 + b];
    }
  }
  double s = 0.0;
  for (int a = 0; a < 6; ++a) s += e[a] * W1e[a] + ev[a] * W2ev[a];
  *l = s;
}

void cost_quad_stage(const ModelSE3& M, const SE3& q, const double* xi, int i,
                     double* l, double* lx, double* lxx) {
  cost_quad_w(M, q, xi, i, M.Q1, M.Q2, l, lx, lxx);
}

void cost_quad_term(const ModelSE3& M, const SE3& q, const double* xi, int i,
                    double* l, double* lx, double* lxx) {
  cost_quad_w(M, q, xi, i, M.P1, M.P2, l, lx, lxx);
}

// ---- SO(3) model family (free attitude / 3-D pendulum) ---------------------

struct ModelSO3 {
  using Ops = SO3Ops;
  double J[9];
  double Jinv[9];
  double dt;
  double Q1[9], Q2[9], R[NU_MAX * NU_MAX], P1[9], P2[9];
  bool pendulum;
  bool term_quirk;  // terminal value+grad from Q, Hessian from P (SO3 class)
  double m, l, g;   // pendulum mass, rod length, gravity
  int nu;
  std::vector<SO3Pose> q_ref, q_ref_inv;  // Ad(R) = R: q_ref doubles as Ad_ref
  std::vector<double> xi_ref;             // (N+1) * 3
};

// rho = (l/2) * down with down = (0,0,-1)  (models/dynamics.py:131)
inline void pend_rho(const ModelSO3& M, double scale, double* v) {
  v[0] = 0.0;
  v[1] = 0.0;
  v[2] = -scale * M.l / 2.0;
}

// free: xi_next = xi + dt Jinv (hat(xi)^T J xi + u)      (traopt_dynamics.py:369)
// pendulum: torque += hat(m g rho) R^T down + hat(m rho) R^T u, no raw u
// (traopt_dynamics.py:531-554, models/dynamics.py:136)
void twist_step(const ModelSO3& M, const SO3Pose& q, const double* xi,
                const double* u, double* xi_next) {
  double Jxi[3], t[3];
  mat_vec(Jxi, M.J, xi, 3, 3);
  cross3(t, Jxi, xi);  // hat(xi)^T (J xi) = (J xi) x xi
  if (M.pendulum) {
    double Rt[9], b[3], Rtu[3], gterm[3], Mu[3], mgr[3], mr[3];
    mat_T(Rt, q.R, 3, 3);
    double down[3] = {0.0, 0.0, -1.0};
    mat_vec(b, Rt, down, 3, 3);
    mat_vec(Rtu, Rt, u, 3, 3);
    pend_rho(M, M.m * M.g, mgr);
    pend_rho(M, M.m, mr);
    cross3(gterm, mgr, b);
    cross3(Mu, mr, Rtu);
    for (int i = 0; i < 3; ++i) t[i] += gterm[i] + Mu[i];
  } else {
    for (int i = 0; i < 3; ++i) t[i] += u[i];
  }
  double dxi[3];
  mat_vec(dxi, M.Jinv, t, 3, 3);
  for (int i = 0; i < 3; ++i) xi_next[i] = xi[i] + M.dt * dxi[i];
}

void pose_step(const ModelSO3& M, const SO3Pose& q, const double* xi,
               SO3Pose* q_next) {
  double tau[3], E[9], R[9];
  for (int i = 0; i < 3; ++i) tau[i] = xi[i] * M.dt;
  so3_exp(E, tau);
  mat_mul(R, q.R, E, 3, 3, 3);
  std::memcpy(q_next->R, R, sizeof(R));
  so3_normalize(q_next->R);
}

// Fx per models/dynamics.py:91 (free) / :148 (pendulum):
//   [[Exp(-tau), Jr(tau) dt], [L dt, I + H dt]]
//   H = Jinv (hat(xi)^T J + hat(J xi));
//   L = Jinv (hat(m g rho) R^T hat(down) R + hat(m rho) R^T hat(u) R)
void dynamics_jacobian(const ModelSO3& M, const SO3Pose& q, const double* xi,
                       const double* u, double* Fx) {
  constexpr int NX = 6;
  double tau[3], ntau[3];
  for (int i = 0; i < 3; ++i) { tau[i] = xi[i] * M.dt; ntau[i] = -tau[i]; }
  double Jqq[9], Jqxi[9];
  so3_exp(Jqq, ntau);                // Ad(Exp(tau))^-1 = Exp(-tau)
  so3_left_jacobian(Jqxi, ntau);     // Jr(tau) = Jl(-tau); * dt below
  double W[9], WT[9], WTJ[9], Jxi[3], G[9], S[9], H[9];
  so3_hat(W, xi);
  mat_T(WT, W, 3, 3);
  mat_mul(WTJ, WT, M.J, 3, 3, 3);
  mat_vec(Jxi, M.J, xi, 3, 3);
  so3_hat(G, Jxi);
  for (int i = 0; i < 9; ++i) S[i] = WTJ[i] + G[i];
  mat_mul(H, M.Jinv, S, 3, 3, 3);
  std::memset(Fx, 0, NX * NX * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Fx[i * NX + j] = Jqq[i * 3 + j];
      Fx[i * NX + (j + 3)] = Jqxi[i * 3 + j] * M.dt;
      Fx[(i + 3) * NX + (j + 3)] = (i == j ? 1.0 : 0.0) + M.dt * H[i * 3 + j];
    }
  if (M.pendulum) {
    double Rt[9], hd[9], hu[9], mgr[3], mr[3], hmgr[9], hmr[9];
    double T1[9], T2[9], L1[9], L2[9], SL[9], L[9];
    mat_T(Rt, q.R, 3, 3);
    double down[3] = {0.0, 0.0, -1.0};
    so3_hat(hd, down);
    so3_hat(hu, u);
    pend_rho(M, M.m * M.g, mgr);
    pend_rho(M, M.m, mr);
    so3_hat(hmgr, mgr);
    so3_hat(hmr, mr);
    mat_mul(T1, Rt, hd, 3, 3, 3);
    mat_mul(T2, T1, q.R, 3, 3, 3);
    mat_mul(L1, hmgr, T2, 3, 3, 3);
    mat_mul(T1, Rt, hu, 3, 3, 3);
    mat_mul(T2, T1, q.R, 3, 3, 3);
    mat_mul(L2, hmr, T2, 3, 3, 3);
    for (int i = 0; i < 9; ++i) SL[i] = L1[i] + L2[i];
    mat_mul(L, M.Jinv, SL, 3, 3, 3);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Fx[(i + 3) * NX + j] = M.dt * L[i * 3 + j];
  }
}

// free: Fu = [0; Jinv] dt; pendulum: Fu = [0; Jinv hat(m rho) R^T] dt
// (models/dynamics.py:168, traopt_dynamics.py:592-611)
bool fu_state_dependent(const ModelSO3& M) { return M.pendulum; }

void input_jacobian(const ModelSO3& M, const SO3Pose& q, double* Fu) {
  constexpr int NX = 6;
  const int nu = M.nu;  // always 3
  double bt[9];
  if (M.pendulum) {
    double Rt[9], mr[3], hmr[9], T[9];
    mat_T(Rt, q.R, 3, 3);
    pend_rho(M, M.m, mr);
    so3_hat(hmr, mr);
    mat_mul(T, hmr, Rt, 3, 3, 3);
    mat_mul(bt, M.Jinv, T, 3, 3, 3);
  } else {
    std::memcpy(bt, M.Jinv, sizeof(bt));
  }
  std::memset(Fu, 0, NX * nu * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < nu; ++j) Fu[(i + 3) * nu + j] = bt[i * 3 + j] * M.dt;
}

// GN tracking quadratization, d = 3 (traopt_cost.py:280-564):
// e = Log(R R_ref^T), J_e_x = Jr^-1(e) Ad(R_ref) = Jr^-1(e) R_ref
void cost_quad_w(const ModelSO3& M, const SO3Pose& q, const double* xi, int i,
                 const double* W1, const double* W2, double* l, double* lx,
                 double* lxx) {
  constexpr int NX = 6;
  SO3Pose Eq;
  SO3Ops::compose(&Eq, q, M.q_ref_inv[i]);
  double e[3], ev[3], ne[3];
  so3_log(e, Eq.R);
  for (int k = 0; k < 3; ++k) {
    ev[k] = xi[k] - M.xi_ref[i * 3 + k];
    ne[k] = -e[k];
  }
  double Jri[9], Jex[9], JT[9], JTW[9], He[9];
  so3_left_jacobian_inv(Jri, ne);  // Jr^-1(e) = Jl^-1(-e)
  mat_mul(Jex, Jri, M.q_ref[i].R, 3, 3, 3);
  mat_T(JT, Jex, 3, 3);
  mat_mul(JTW, JT, W1, 3, 3, 3);
  mat_mul(He, JTW, Jex, 3, 3, 3);
  double W1e[3], W2ev[3], g1[3];
  mat_vec(W1e, W1, e, 3, 3);
  mat_vec(W2ev, W2, ev, 3, 3);
  mat_vec(g1, JT, W1e, 3, 3);
  std::memset(lxx, 0, NX * NX * sizeof(double));
  for (int a = 0; a < 3; ++a) {
    lx[a] = 2.0 * g1[a];
    lx[a + 3] = 2.0 * W2ev[a];
    for (int b = 0; b < 3; ++b) {
      lxx[a * NX + b] = 2.0 * He[a * 3 + b];
      lxx[(a + 3) * NX + (b + 3)] = 2.0 * W2[a * 3 + b];
    }
  }
  double s = 0.0;
  for (int a = 0; a < 3; ++a) s += e[a] * W1e[a] + ev[a] * W2ev[a];
  *l = s;
}

void cost_quad_stage(const ModelSO3& M, const SO3Pose& q, const double* xi,
                     int i, double* l, double* lx, double* lxx) {
  cost_quad_w(M, q, xi, i, M.Q1, M.Q2, l, lx, lxx);
}

void cost_quad_term(const ModelSO3& M, const SO3Pose& q, const double* xi,
                    int i, double* l, double* lx, double* lxx) {
  if (!M.term_quirk) {
    cost_quad_w(M, q, xi, i, M.P1, M.P2, l, lx, lxx);
    return;
  }
  // reference SO(3) quirk: value + gradient from Q, Hessian from P
  cost_quad_w(M, q, xi, i, M.Q1, M.Q2, l, lx, lxx);
  double lq;
  double lxq[6];
  cost_quad_w(M, q, xi, i, M.P1, M.P2, &lq, lxq, lxx);
  (void)lq;
  (void)lxq;
}

// ---- group-generic MS-iLQR (fixed budget, mu = 0) ---------------------------

// Optional augmented-Lagrangian input-box terms (models/constraints.py:
// g = [lb - u; u - ub] <= 0, terminal g = 0; models/costs.al_cost):
// l += lam.g + 1/2 g.Imu.g, lu += gu^T(lam + Imu g), luu += gu^T Imu gu
// with diagonal Imu, so only the u-blocks of the quadratization change.
struct ALBox {
  const double* lb;    // (nu)
  const double* ub;    // (nu)
  const double* lmbd;  // (N+1, 2 nu) multipliers, [lo | hi] per stage
  const double* imu;   // (N+1, 2 nu) diagonal active-set penalties
};

template <class M>
int solve_one(const M& Mdl, int N, int iters,
              const typename M::Ops::Pose& q0, const double* xi0, double* us,
              double* J_out, double* grad_out, const ALBox* al = nullptr) {
  using Ops = typename M::Ops;
  using Pose = typename Ops::Pose;
  constexpr int D = Ops::D;
  constexpr int NX = 2 * D;
  const int nu = Mdl.nu;

  // state-independent Fu (SE(3) family, free SO(3) body) is evaluated once
  // and shared by every stage; the pendulum's depends on R, so per stage
  const bool fu_sd = fu_state_dependent(Mdl);
  std::vector<Pose> qs(N + 1), fq(N);
  std::vector<double> xis((N + 1) * D), fxi(N * D), Fx(N * NX * NX),
      Fu((fu_sd ? N : 1) * NX * nu), d(N * NX), lx((N + 1) * NX),
      lxx((N + 1) * NX * NX), lu(N * nu), k(N * nu), K(N * nu * NX), l(N + 1);
  if (!fu_sd) input_jacobian(Mdl, q0, &Fu[0]);

  // init: x0 + reference tail (solvers/batched.py:221)
  qs[0] = q0;
  std::memcpy(&xis[0], xi0, D * sizeof(double));
  for (int i = 1; i <= N; ++i) {
    qs[i] = Mdl.q_ref[i];
    std::memcpy(&xis[i * D], &Mdl.xi_ref[i * D], D * sizeof(double));
  }
  double Luu[NU_MAX * NU_MAX];
  for (int i = 0; i < nu * nu; ++i) Luu[i] = 2.0 * Mdl.R[i];
  // per-stage diagonal Quu additions from the AL penalty (Imu varies by stage)
  std::vector<double> luu_al(al ? N * nu : 0);

  double J_total = 0.0, grad_mean = 0.0;
  for (int it = 0; it < iters; ++it) {
    // ---- linearize ----------------------------------------------------
    J_total = 0.0;
    for (int i = 0; i < N; ++i) {
      const Pose& q = qs[i];
      const double* xi = &xis[i * D];
      const double* u = &us[i * nu];
      pose_step(Mdl, q, xi, &fq[i]);
      twist_step(Mdl, q, xi, u, &fxi[i * D]);
      dynamics_jacobian(Mdl, q, xi, u, &Fx[i * NX * NX]);
      if (fu_sd) input_jacobian(Mdl, q, &Fu[i * NX * nu]);
      // defect d = [Log(q_{i+1}^-1 fq), fxi - xi_{i+1}]
      Pose qn_inv, Dp;
      Ops::inverse(&qn_inv, qs[i + 1]);
      Ops::compose(&Dp, qn_inv, fq[i]);
      Ops::log(&d[i * NX], Dp);
      for (int a = 0; a < D; ++a)
        d[i * NX + D + a] = fxi[i * D + a] - xis[(i + 1) * D + a];
      cost_quad_stage(Mdl, q, xi, i, &l[i], &lx[i * NX], &lxx[i * NX * NX]);
      double Ru[NU_MAX];
      mat_vec(Ru, Mdl.R, u, nu, nu);
      for (int a = 0; a < nu; ++a) {
        lu[i * nu + a] = 2.0 * Ru[a];
        l[i] += u[a] * Ru[a];
      }
      if (al) {
        const double* lm = al->lmbd + i * 2 * nu;
        const double* im = al->imu + i * 2 * nu;
        for (int a = 0; a < nu; ++a) {
          double glo = al->lb[a] - u[a];
          double ghi = u[a] - al->ub[a];
          l[i] += lm[a] * glo + lm[nu + a] * ghi +
                  0.5 * (im[a] * glo * glo + im[nu + a] * ghi * ghi);
          // gu rows: lo -> -e_a, hi -> +e_a
          lu[i * nu + a] += -(lm[a] + im[a] * glo) +
                            (lm[nu + a] + im[nu + a] * ghi);
          luu_al[i * nu + a] = im[a] + im[nu + a];
        }
      }
      J_total += l[i];
    }
    cost_quad_term(Mdl, qs[N], &xis[N * D], N, &l[N], &lx[N * NX],
                   &lxx[N * NX * NX]);
    J_total += l[N];

    // ---- Riccati backward (mu = 0) --------------------------------------
    double Vx[NX], Vxx[NX * NX];
    std::memcpy(Vx, &lx[N * NX], sizeof(Vx));
    std::memcpy(Vxx, &lxx[N * NX * NX], sizeof(Vxx));
    double grad_sum = 0.0;
    for (int i = N - 1; i >= 0; --i) {
      const double* fx = &Fx[i * NX * NX];
      const double* fu = &Fu[(fu_sd ? i : 0) * NX * nu];
      const double* dd = &d[i * NX];
      double Vmod[NX];
      mat_vec(Vmod, Vxx, dd, NX, NX);
      for (int a = 0; a < NX; ++a) Vmod[a] += Vx[a];
      double Qx[NX], Qu[NU_MAX], fxT[NX * NX], fuT[NU_MAX * NX];
      mat_T(fxT, fx, NX, NX);
      mat_T(fuT, fu, NX, nu);
      mat_vec(Qx, fxT, Vmod, NX, NX);
      mat_vec(Qu, fuT, Vmod, nu, NX);
      for (int a = 0; a < NX; ++a) Qx[a] += lx[i * NX + a];
      for (int a = 0; a < nu; ++a) Qu[a] += lu[i * nu + a];
      // gradient bookkeeping: g_i = lu + Fu^T (Vx1 + Vxx1 d)
      {
        double n = 0.0;
        for (int a = 0; a < nu; ++a) n += Qu[a] * Qu[a];
        grad_sum += std::sqrt(n);
      }
      double VF[NX * NX], Qxx[NX * NX], Qux[NU_MAX * NX], Quu[NU_MAX * NU_MAX];
      mat_mul(VF, Vxx, fx, NX, NX, NX);
      mat_mul(Qxx, fxT, VF, NX, NX, NX);
      mat_mul(Qux, fuT, VF, nu, NX, NX);
      double VFu[NX * NU_MAX];
      mat_mul(VFu, Vxx, fu, NX, NX, nu);
      mat_mul(Quu, fuT, VFu, nu, NX, nu);
      for (int a = 0; a < NX * NX; ++a) Qxx[a] += lxx[i * NX * NX + a];
      for (int a = 0; a < nu * nu; ++a) Quu[a] += Luu[a];
      if (al)
        for (int a = 0; a < nu; ++a) Quu[a * nu + a] += luu_al[i * nu + a];
      double* k_i = &k[i * nu];
      double* K_i = &K[i * nu * NX];
      if (!chol_solve(K_i, Quu, Qux, nu, NX)) return 1;
      double ksol[NU_MAX];
      if (!chol_solve(ksol, Quu, Qu, nu, 1)) return 1;
      for (int a = 0; a < nu * NX; ++a) K_i[a] = -K_i[a];
      for (int a = 0; a < nu; ++a) k_i[a] = -ksol[a];
      // Vx  = Qx + K^T Quu k + K^T Qu + Qux^T k
      // Vxx = Qxx + K^T Quu K + K^T Qux + Qux^T K   (symmetrized)
      double KT[NX * NU_MAX], KTQ[NX * NU_MAX], QuxT[NX * NU_MAX];
      mat_T(KT, K_i, nu, NX);
      mat_mul(KTQ, KT, Quu, NX, nu, nu);
      mat_T(QuxT, Qux, nu, NX);
      double t1[NX], t2[NX], t3[NX];
      mat_vec(t1, KTQ, k_i, NX, nu);
      mat_vec(t2, KT, Qu, NX, nu);
      mat_vec(t3, QuxT, k_i, NX, nu);
      for (int a = 0; a < NX; ++a) Vx[a] = Qx[a] + t1[a] + t2[a] + t3[a];
      double M1[NX * NX], M2[NX * NX], M3[NX * NX];
      mat_mul(M1, KTQ, K_i, NX, nu, NX);
      mat_mul(M2, KT, Qux, NX, nu, NX);
      mat_mul(M3, QuxT, K_i, NX, nu, NX);
      for (int a = 0; a < NX; ++a)
        for (int b = 0; b < NX; ++b)
          Vxx[a * NX + b] = Qxx[a * NX + b] + M1[a * NX + b] + M2[a * NX + b] +
                            M3[a * NX + b];
      for (int a = 0; a < NX; ++a)
        for (int b = a + 1; b < NX; ++b) {
          double s = 0.5 * (Vxx[a * NX + b] + Vxx[b * NX + a]);
          Vxx[a * NX + b] = Vxx[b * NX + a] = s;
        }
    }
    grad_mean = grad_sum / N;

    // ---- gap-closing rollout, alpha = 1 (solvers/batched.py:176) --------
    // Every stage reads the OLD trajectory (qs, xis); the new one goes into
    // separate buffers and is swapped in afterwards.
    std::vector<Pose> qs_new(N + 1);
    std::vector<double> xis_new((N + 1) * D);
    qs_new[0] = qs[0];
    std::memcpy(&xis_new[0], &xis[0], D * sizeof(double));
    Pose q_new = qs[0];
    double xi_new[D];
    std::memcpy(xi_new, &xis[0], sizeof(xi_new));
    for (int i = 0; i < N; ++i) {
      double xs_err[NX];
      Pose qi_inv, Eq;
      Ops::inverse(&qi_inv, qs[i]);
      Ops::compose(&Eq, qi_inv, q_new);
      Ops::log(xs_err, Eq);
      for (int a = 0; a < D; ++a)
        xs_err[D + a] = xi_new[a] - xis[i * D + a];
      double u_new[NU_MAX];
      mat_vec(u_new, &K[i * nu * NX], xs_err, nu, NX);
      for (int a = 0; a < nu; ++a)
        u_new[a] += us[i * nu + a] + k[i * nu + a];
      Pose fq_new;
      double fxi_new[D];
      pose_step(Mdl, q_new, xi_new, &fq_new);
      twist_step(Mdl, q_new, xi_new, u_new, fxi_new);
      // q_nn = normalize(q_{i+1} Exp(d_q) fq_old^-1 fq_new)
      Pose Ed, fq_inv, A, B, q_nn;
      Ops::exp(&Ed, &d[i * NX]);
      Ops::inverse(&fq_inv, fq[i]);
      Ops::compose(&A, qs[i + 1], Ed);
      Ops::compose(&B, A, fq_inv);
      Ops::compose(&q_nn, B, fq_new);
      Ops::normalize(&q_nn);
      double xi_nn[D];
      for (int a = 0; a < D; ++a)
        xi_nn[a] = xis[(i + 1) * D + a] + fxi_new[a] - fxi[i * D + a] +
                   d[i * NX + D + a];
      std::memcpy(&us[i * nu], u_new, nu * sizeof(double));
      q_new = q_nn;
      std::memcpy(xi_new, xi_nn, sizeof(xi_nn));
      qs_new[i + 1] = q_nn;
      std::memcpy(&xis_new[(i + 1) * D], xi_nn, sizeof(xi_nn));
    }
    qs.swap(qs_new);
    xis.swap(xis_new);
  }
  if (J_out) *J_out = J_total;
  if (grad_out) *grad_out = grad_mean;
  return 0;
}

// Dynamics-only fields (shared by the solver builder and the bare plant-step
// entry): g = 0 + Pu = null selects the free body (identity projection,
// nu = 6); g > 0 enables the gravity wrench + Fx block; Pu (6 x nu) drone.
void init_dynamics_se3(ModelSE3* M, const double* J6, double dt, double g,
                       const double* Pu, int nu) {
  std::memcpy(M->J, J6, sizeof(M->J));
  double I6[36];
  std::memset(I6, 0, sizeof(I6));
  for (int i = 0; i < 6; ++i) I6[i * 6 + i] = 1.0;
  chol_solve(M->Jinv, J6, I6, 6, 6);
  M->dt = dt;
  M->nu = nu;
  // m = J[3,3] (translational block is m*I, models/dynamics.py:268)
  M->mg = J6[3 * 6 + 3] * g;
  M->gravity = g != 0.0;
  std::memset(M->Pu, 0, sizeof(M->Pu));
  if (Pu) {
    std::memcpy(M->Pu, Pu, 6 * nu * sizeof(double));
  } else {
    for (int i = 0; i < 6 && i < nu; ++i) M->Pu[i * nu + i] = 1.0;
  }
}

void build_model(ModelSE3* M, const double* J6, double dt, double g,
                 const double* Pu, int nu, const double* Q12,
                 const double* Rnu, const double* P12, const double* q_ref,
                 const double* xi_ref, int N) {
  init_dynamics_se3(M, J6, dt, g, Pu, nu);
  for (int a = 0; a < 6; ++a)
    for (int b = 0; b < 6; ++b) {
      M->Q1[a * 6 + b] = Q12[a * 12 + b];
      M->Q2[a * 6 + b] = Q12[(a + 6) * 12 + (b + 6)];
      M->P1[a * 6 + b] = P12[a * 12 + b];
      M->P2[a * 6 + b] = P12[(a + 6) * 12 + (b + 6)];
    }
  std::memcpy(M->R, Rnu, nu * nu * sizeof(double));
  M->q_ref.resize(N + 1);
  M->q_ref_inv.resize(N + 1);
  M->Ad_ref.resize((N + 1) * 36);
  M->xi_ref.assign(xi_ref, xi_ref + (N + 1) * 6);
  for (int i = 0; i <= N; ++i) {
    const double* T = q_ref + i * 16;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) M->q_ref[i].R[r * 3 + c] = T[r * 4 + c];
      M->q_ref[i].p[r] = T[r * 4 + 3];
    }
    se3_inverse(&M->q_ref_inv[i], M->q_ref[i]);
    se3_Ad(M->Ad_ref.data() + i * 36, M->q_ref[i]);
  }
}

// Dynamics-only fields: pendulum = 0 selects the free attitude body (raw
// torque input); pendulum = 1 the pivot-actuated pendulum with (m, l, g).
void init_dynamics_so3(ModelSO3* M, const double* J3, double dt, int pendulum,
                       double m, double l, double g) {
  std::memcpy(M->J, J3, sizeof(M->J));
  double I3[9];
  std::memset(I3, 0, sizeof(I3));
  I3[0] = I3[4] = I3[8] = 1.0;
  chol_solve(M->Jinv, J3, I3, 3, 3);
  M->dt = dt;
  M->nu = 3;
  M->pendulum = pendulum != 0;
  M->m = m;
  M->l = l;
  M->g = g;
}

void build_model_so3(ModelSO3* M, const double* J3, double dt, int pendulum,
                     double m, double l, double g, int term_quirk,
                     const double* Q6, const double* R3, const double* P6,
                     const double* q_ref, const double* xi_ref, int N) {
  init_dynamics_so3(M, J3, dt, pendulum, m, l, g);
  M->term_quirk = term_quirk != 0;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      M->Q1[a * 3 + b] = Q6[a * 6 + b];
      M->Q2[a * 3 + b] = Q6[(a + 3) * 6 + (b + 3)];
      M->P1[a * 3 + b] = P6[a * 6 + b];
      M->P2[a * 3 + b] = P6[(a + 3) * 6 + (b + 3)];
    }
  std::memcpy(M->R, R3, 9 * sizeof(double));
  M->q_ref.resize(N + 1);
  M->q_ref_inv.resize(N + 1);
  M->xi_ref.assign(xi_ref, xi_ref + (N + 1) * 3);
  for (int i = 0; i <= N; ++i) {
    std::memcpy(M->q_ref[i].R, q_ref + i * 9, 9 * sizeof(double));
    SO3Ops::inverse(&M->q_ref_inv[i], M->q_ref[i]);
  }
}

}  // namespace
}  // namespace traopt

extern "C" {

// Solve one rigid-body tracking MS-iLQR problem (free body: g = 0,
// Pu = null, nu = 6; gravity: g > 0; drone: Pu 6x4, nu = 4).  Layout:
// row-major doubles; q_ref (N+1)x4x4 homogeneous, us Nxnu in/out.
int traopt_rb_ms_ilqr_solve(const double* J6, double dt, double g,
                            const double* Pu, int nu, const double* Q12,
                            const double* Rnu, const double* P12,
                            const double* q_ref, const double* xi_ref, int N,
                            int iters, const double* q0_16, const double* xi0,
                            double* us, double* J_out, double* grad_out) {
  traopt::ModelSE3 M;
  traopt::build_model(&M, J6, dt, g, Pu, nu, Q12, Rnu, P12, q_ref, xi_ref, N);
  traopt::SE3 q0;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) q0.R[r * 3 + c] = q0_16[r * 4 + c];
    q0.p[r] = q0_16[r * 4 + 3];
  }
  return traopt::solve_one(M, N, iters, q0, xi0, us, J_out, grad_out);
}

// Batch front-end: B independent problems sharing the model/reference.
int traopt_rb_ms_ilqr_solve_batch(const double* J6, double dt, double g,
                                  const double* Pu, int nu,
                                  const double* Q12, const double* Rnu,
                                  const double* P12, const double* q_ref,
                                  const double* xi_ref, int N, int iters,
                                  int B, const double* q0s_16,
                                  const double* xi0s, double* us,
                                  double* J_outs, double* grad_outs) {
  traopt::ModelSE3 M;
  traopt::build_model(&M, J6, dt, g, Pu, nu, Q12, Rnu, P12, q_ref, xi_ref, N);
  int rc = 0;
  // problems are independent: fan out over host cores (the native analog of
  // the reference's joblib.Parallel sweep, perturb_all_compute.py:245)
#pragma omp parallel for schedule(dynamic) reduction(max : rc)
  for (int b = 0; b < B; ++b) {
    traopt::SE3 q0;
    const double* T = q0s_16 + b * 16;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) q0.R[r * 3 + c] = T[r * 4 + c];
      q0.p[r] = T[r * 4 + 3];
    }
    int r1 = traopt::solve_one(M, N, iters, q0, xi0s + b * 6,
                               us + b * N * nu,
                               J_outs ? J_outs + b : nullptr,
                               grad_outs ? grad_outs + b : nullptr);
    if (r1 > rc) rc = r1;
  }
  return rc;
}

// Back-compat free-body entry points (identity Pu, nu = 6, g = 0).
int traopt_se3_ms_ilqr_solve(const double* J6, double dt, const double* Q12,
                             const double* R6, const double* P12,
                             const double* q_ref, const double* xi_ref, int N,
                             int iters, const double* q0_16, const double* xi0,
                             double* us, double* J_out, double* grad_out) {
  return traopt_rb_ms_ilqr_solve(J6, dt, 0.0, nullptr, 6, Q12, R6, P12,
                                 q_ref, xi_ref, N, iters, q0_16, xi0, us,
                                 J_out, grad_out);
}

int traopt_se3_ms_ilqr_solve_batch(const double* J6, double dt,
                                   const double* Q12, const double* R6,
                                   const double* P12, const double* q_ref,
                                   const double* xi_ref, int N,
                                   int iters, int B, const double* q0s_16,
                                   const double* xi0s, double* us,
                                   double* J_outs, double* grad_outs) {
  return traopt_rb_ms_ilqr_solve_batch(J6, dt, 0.0, nullptr, 6, Q12, R6, P12,
                                       q_ref, xi_ref, N, iters, B, q0s_16,
                                       xi0s, us, J_outs, grad_outs);
}

// Solve one SO(3) attitude tracking MS-iLQR problem (free attitude:
// pendulum = 0; 3-D pendulum: pendulum = 1 with mass m, rod length l,
// gravity g).  term_quirk selects the reference SO(3) cost class's terminal
// Q/P inconsistency.  Layout: row-major doubles; q_ref (N+1)x3x3 rotation
// matrices, xi_ref (N+1)x3, us Nx3 in/out.
int traopt_so3_ms_ilqr_solve(const double* J3, double dt, int pendulum,
                             double m, double l, double g, int term_quirk,
                             const double* Q6, const double* R3,
                             const double* P6, const double* q_ref,
                             const double* xi_ref, int N, int iters,
                             const double* q0_9, const double* xi0,
                             double* us, double* J_out, double* grad_out) {
  traopt::ModelSO3 M;
  traopt::build_model_so3(&M, J3, dt, pendulum, m, l, g, term_quirk, Q6, R3,
                          P6, q_ref, xi_ref, N);
  traopt::SO3Pose q0;
  std::memcpy(q0.R, q0_9, 9 * sizeof(double));
  return traopt::solve_one(M, N, iters, q0, xi0, us, J_out, grad_out);
}

int traopt_so3_ms_ilqr_solve_batch(const double* J3, double dt, int pendulum,
                                   double m, double l, double g,
                                   int term_quirk, const double* Q6,
                                   const double* R3, const double* P6,
                                   const double* q_ref, const double* xi_ref,
                                   int N, int iters, int B,
                                   const double* q0s_9, const double* xi0s,
                                   double* us, double* J_outs,
                                   double* grad_outs) {
  traopt::ModelSO3 M;
  traopt::build_model_so3(&M, J3, dt, pendulum, m, l, g, term_quirk, Q6, R3,
                          P6, q_ref, xi_ref, N);
  int rc = 0;
#pragma omp parallel for schedule(dynamic) reduction(max : rc)
  for (int b = 0; b < B; ++b) {
    traopt::SO3Pose q0;
    std::memcpy(q0.R, q0s_9 + b * 9, 9 * sizeof(double));
    int r1 = traopt::solve_one(M, N, iters, q0, xi0s + b * 3,
                               us + b * N * 3,
                               J_outs ? J_outs + b : nullptr,
                               grad_outs ? grad_outs + b : nullptr);
    if (r1 > rc) rc = r1;
  }
  return rc;
}

// Augmented-Lagrangian outer loop around the SE(3)-family batch solver with
// input box constraints lb <= u <= ub (ref AL_iLQR_Tracking_SE3_MS,
// traopt_controller.py:3139-3293; same iterate sequence as
// solvers/al_fast.ALFastSolver: per-problem multipliers, inner solves
// restarting from the caller's us each outer iteration, first-order
// multiplier ascent + active-set penalty rebuild, collective stop when every
// problem's max violation < tol).  us is in/out; maxv_outs (B) gets each
// problem's final max violation; *outer_out the outer iterations used.
int traopt_rb_al_ms_ilqr_solve_batch(
    const double* J6, double dt, double g, const double* Pu, int nu,
    const double* Q12, const double* Rnu, const double* P12,
    const double* q_ref, const double* xi_ref, int N, int iters,
    const double* lb, const double* ub, int n_al_iters, double mu0,
    double mu_scale, double mu_max, double tol, int B,
    const double* q0s_16, const double* xi0s, double* us, double* J_outs,
    double* grad_outs, double* maxv_outs, int* outer_out) {
  traopt::ModelSE3 M;
  traopt::build_model(&M, J6, dt, g, Pu, nu, Q12, Rnu, P12, q_ref, xi_ref, N);
  const int C = 2 * nu;
  std::vector<double> lmbd((size_t)B * (N + 1) * C, 0.0);
  std::vector<double> imu((size_t)B * (N + 1) * C, mu0);
  std::vector<double> mu(B, mu0);
  std::vector<double> us0(us, us + (size_t)B * N * nu);
  int rc = 0, outer = 0;
  for (outer = 1; outer <= n_al_iters; ++outer) {
#pragma omp parallel for schedule(dynamic) reduction(max : rc)
    for (int b = 0; b < B; ++b) {
      traopt::SE3 q0;
      const double* T = q0s_16 + b * 16;
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) q0.R[r * 3 + c] = T[r * 4 + c];
        q0.p[r] = T[r * 4 + 3];
      }
      std::memcpy(us + (size_t)b * N * nu, &us0[(size_t)b * N * nu],
                  (size_t)N * nu * sizeof(double));
      traopt::ALBox al{lb, ub, &lmbd[(size_t)b * (N + 1) * C],
                       &imu[(size_t)b * (N + 1) * C]};
      int r1 = traopt::solve_one(M, N, iters, q0, xi0s + b * 6,
                                 us + (size_t)b * N * nu,
                                 J_outs ? J_outs + b : nullptr,
                                 grad_outs ? grad_outs + b : nullptr, &al);
      if (r1 > rc) rc = r1;
    }
    if (rc) return rc;
    // per-problem max violation; terminal g = 0 so the max is >= 0
    double maxv_all = 0.0;
    for (int b = 0; b < B; ++b) {
      double mv = 0.0;
      for (int i = 0; i < N; ++i)
        for (int a = 0; a < nu; ++a) {
          double u = us[((size_t)b * N + i) * nu + a];
          if (lb[a] - u > mv) mv = lb[a] - u;
          if (u - ub[a] > mv) mv = u - ub[a];
        }
      maxv_outs[b] = mv;
      if (mv > maxv_all) maxv_all = mv;
    }
    if (maxv_all < tol) break;
    // lmbd <- clip(lmbd + Imu g, 0, inf); mu <- min(mu*scale, mu_max);
    // Imu <- (g < 0 and lmbd == 0) ? 0 : mu   (models/costs.al_update_params)
    // — per problem, frozen once that problem satisfies the tolerance
    // (keeps the collective loop from escalating penalties on problems
    // already on the constraint boundary until they destabilize)
    for (int b = 0; b < B; ++b) {
      if (maxv_outs[b] < tol) continue;
      double mu_new = std::min(mu[b] * mu_scale, mu_max);
      for (int i = 0; i <= N; ++i)
        for (int c = 0; c < C; ++c) {
          size_t idx = ((size_t)b * (N + 1) + i) * C + c;
          double gval = 0.0;
          if (i < N) {
            int a = c % nu;
            double u = us[((size_t)b * N + i) * nu + a];
            gval = (c < nu) ? lb[a] - u : u - ub[a];
          }
          double lnew = lmbd[idx] + imu[idx] * gval;
          if (lnew < 0.0) lnew = 0.0;
          lmbd[idx] = lnew;
          imu[idx] = (gval < 0.0 && lnew == 0.0) ? 0.0 : mu_new;
        }
      mu[b] = mu_new;
    }
  }
  if (outer > n_al_iters) outer = n_al_iters;
  if (outer_out) *outer_out = outer;
  return 0;
}

// One SE(3)-family plant step (semi-implicit Euler, pose renormalized):
// q in/out as 4x4 homogeneous row-major.  For embedded/receding-horizon use.
int traopt_rb_step(const double* J6, double dt, double g, const double* Pu,
                   int nu, const double* q_16, const double* xi,
                   const double* u, double* q_out_16, double* xi_out) {
  traopt::ModelSE3 M;
  traopt::init_dynamics_se3(&M, J6, dt, g, Pu, nu);
  traopt::SE3 q, qn;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) q.R[r * 3 + c] = q_16[r * 4 + c];
    q.p[r] = q_16[r * 4 + 3];
  }
  traopt::pose_step(M, q, xi, &qn);
  traopt::twist_step(M, q, xi, u, xi_out);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) q_out_16[r * 4 + c] = qn.R[r * 3 + c];
    q_out_16[r * 4 + 3] = qn.p[r];
    q_out_16[12 + r] = 0.0;
  }
  q_out_16[15] = 1.0;
  return 0;
}

// One SO(3)-family plant step; q in/out as 3x3 rotation row-major.
int traopt_so3_step(const double* J3, double dt, int pendulum, double m,
                    double l, double g, const double* q_9, const double* xi,
                    const double* u, double* q_out_9, double* xi_out) {
  traopt::ModelSO3 M;
  traopt::init_dynamics_so3(&M, J3, dt, pendulum, m, l, g);
  traopt::SO3Pose q, qn;
  std::memcpy(q.R, q_9, 9 * sizeof(double));
  traopt::pose_step(M, q, xi, &qn);
  traopt::twist_step(M, q, xi, u, xi_out);
  std::memcpy(q_out_9, qn.R, 9 * sizeof(double));
  return 0;
}
}
