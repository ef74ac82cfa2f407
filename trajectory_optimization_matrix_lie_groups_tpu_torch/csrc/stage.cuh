// Per-stage math of the MS-iLQR pipeline for one problem held by one
// thread: dynamics evaluation, dynamics Jacobian, GN cost quadratization,
// the defect-aware Riccati step and the gap-closing rollout step.  The plain
// versions are ops/linearize.py (stage_dynamics_eval, stage_jacobian,
// stage_cost_quad), solvers/pipeline.py (riccati_stage, rollout_stage) and,
// for the mixed-precision polish, solvers/df_mixed.py (stage_cost_quad_mx,
// riccati_stage_mx, rollout_stage_mx); all follow the JAX package's lane
// kernels formula by formula.  The steps that the polish shares take a
// second scalar type for the preconditioner part (see each step).
//
// Arrays are batch-last: entry e of stage t of an (N, ne, B) array sits at
// (t * ne + e) * B + b, so a warp's 32 neighbouring problems read 32
// neighbouring addresses.  Per-stage references (RbiR, Rbip, Adb, xib) and the
// model constants (J, Jinv, weights, Pu, fu2, Luu) are shared by the whole
// batch and read as uniform loads of small row-major arrays.
#pragma once

#include <type_traits>

#include "lie.cuh"

namespace traopt {

// One problem's view of a batch-last array: entry e at p[e * B].
template <typename T>
struct Lane {
  T* p;
  long long B;
  __device__ __forceinline__ T& operator[](int e) const { return p[(long long)e * B]; }
};

// The lane of problem b, stage t, in an array with ne entries per stage.
template <int ne, typename T>
__device__ __forceinline__ Lane<T> lane(T* base, int t, int B, int b) {
  return Lane<T>{base + ((long long)t * ne) * B + b, B};
}

template <int ne, typename T, typename Src>
__device__ __forceinline__ void load(T* dst, const Src& src) {
#pragma unroll
  for (int e = 0; e < ne; ++e) dst[e] = src[e];
}

template <int ne, typename T, typename Dst>
__device__ __forceinline__ void store(const Dst& dst, const T* src) {
#pragma unroll
  for (int e = 0; e < ne; ++e) dst[e] = src[e];
}

// Model constants, row-major, shared by the batch.
template <typename T>
struct Consts {
  const T* J;     // (6, 6)
  const T* Jinv;  // (6, 6)
  const T* W1;    // (6, 6) stage pose weight Q1
  const T* W2;    // (6, 6) stage twist weight Q2
  const T* W1N;   // (6, 6) terminal pose weight P1
  const T* W2N;   // (6, 6) terminal twist weight P2
  const T* Pu;    // (6, nu) input projection
  const T* fu2;   // (6, nu) bottom block of Fu = [0; Jinv Pu dt]
  const T* Luu;   // (nu, nu) = 2 R
  T mg;           // m g (gravity families)
  T dt;
  int gravity;    // rigid body / drone: gravity wrench and J_xi_q block
  int exact_grav; // J_xi_q with the m g factor (reference omits it)
};

// Per-stage references, (N+1, ...) row-major, shared by the batch.
template <typename T>
struct Refs {
  const T* RbiR;  // (N+1, 3, 3) rotation of q_ref^-1
  const T* Rbip;  // (N+1, 3) translation of q_ref^-1
  const T* Adb;   // (N+1, 6, 6) Ad(q_ref)
  const T* xib;   // (N+1, 6) twist reference
};

// fq = normalize(q Exp(xi dt)); fxi = xi + dt Jinv (coad(xi) J xi
// [+ m g R^T down] + Pu u)  (models/dynamics.py free body / rigid body),
// the input wrench Pu u from pu_u(w), which writes it into the 6-vector w
// where the sum needs it; the exponential's trigonometry Trig (lie.cuh).
template <typename Trig = LibTrig, typename T, typename PuU>
__device__ __forceinline__ void stage_dynamics_eval_with(
    T* fqR, T* fqp, T* fxi, const T* R, const T* p, const T* xi, PuU&& pu_u,
    const Consts<T>& c) {
  T tau[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) tau[i] = xi[i] * c.dt;
  T Re[9], pe[3];
  se3_exp<Trig>(Re, pe, tau);
  se3_compose(fqR, fqp, R, p, Re, pe);
  so3_normalize(fqR);
  T Jxi[6], c1[3], c2[3], c3[3], Puu[6], wrench[6], Jw[6];
  mat_vec<6, 6>(Jxi, c.J, xi);
  cross3(c1, xi, Jxi);
  cross3(c2, xi + 3, Jxi + 3);
  cross3(c3, xi, Jxi + 3);
  pu_u(Puu);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wrench[i] = (-c1[i] - c2[i]) + Puu[i];
    wrench[i + 3] = -c3[i] + Puu[i + 3];
  }
  if (c.gravity) {
    // down = (0, 0, -1): R^T down = -(third row of R)
#pragma unroll
    for (int i = 0; i < 3; ++i) wrench[i + 3] += -c.mg * R[6 + i];
  }
  mat_vec<6, 6>(Jw, c.Jinv, wrench);
#pragma unroll
  for (int i = 0; i < 6; ++i) fxi[i] = xi[i] + c.dt * Jw[i];
}

// stage_dynamics_eval_with the wrench Pu u of the nu = NU inputs u.
template <typename T, int NU>
__device__ __forceinline__ void stage_dynamics_eval(
    T* fqR, T* fqp, T* fxi, const T* R, const T* p, const T* xi, const T* u,
    const Consts<T>& c) {
  stage_dynamics_eval_with(fqR, fqp, fxi, R, p, xi,
                           [&](T* w) { mat_vec<6, NU>(w, c.Pu, u); }, c);
}

// Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [J_xi_q, I + H dt]], tau = xi dt, with
// the reference's coad-swap quirk in H (always applied, as in the JAX lane
// kernels) and its gravity quirk (no m g factor unless exact_grav).  The
// mass is read as J[4, 4]: J = diag(Ib, m I).
template <typename T, typename Out>
__device__ __forceinline__ void stage_jacobian(const Out& Fx, const T* R,
                                               const T* xi, const Consts<T>& c) {
  const T dt = c.dt;
  T tau[6], ntau[6], M[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    tau[i] = xi[i] * dt;
    ntau[i] = -tau[i];
  }
  {
    T ReN[9], peN[3];
    se3_exp(ReN, peN, ntau);
    se3_Ad(M, ReN, peN);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) Fx[i * 12 + j] = M[i * 6 + j];
  }
  se3_right_jacobian(M, tau, dt);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) Fx[i * 12 + 6 + j] = M[i * 6 + j];

  // coad_sw = [[-hat(v), -hat(w)], [0, -hat(v)]]; G = [[hat(Ib w), m hat(v)],
  // [m hat(v), 0]]; H = Jinv (coad_sw J + G)
  const T* w = xi;
  const T* v = xi + 3;
  T hv[9], hw[9], CJ[36];
  so3_hat(hv, v);
  so3_hat(hw, w);
  T Ibw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Ibw[i] = c.J[i * 6] * w[0] + c.J[i * 6 + 1] * w[1] + c.J[i * 6 + 2] * w[2];
  const T m = c.J[4 * 6 + 4];
  T Gw[9];
  so3_hat(Gw, Ibw);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      // row i of coad_sw
      T s = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T cs;
        if (i < 3) cs = k < 3 ? -hv[i * 3 + k] : -hw[i * 3 + k - 3];
        else cs = k < 3 ? T(0) : -hv[(i - 3) * 3 + k - 3];
        s = k == 0 ? cs * c.J[k * 6 + j] : s + cs * c.J[k * 6 + j];
      }
      T g;
      if (i < 3) g = j < 3 ? Gw[i * 3 + j] : m * hv[i * 3 + j - 3];
      else g = j < 3 ? m * hv[(i - 3) * 3 + j] : T(0);
      CJ[i * 6 + j] = s + g;
    }
  mat_mul<6, 6, 6>(M, c.Jinv, CJ);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Fx[(6 + i) * 12 + 6 + j] = (i == j ? T(1) : T(0)) + M[i * 6 + j] * dt;

  if (c.gravity) {
    // J_xi_q = Jinv [[0, 0], [hat(grow), 0]] dt, grow = -R^T down-row
    T grow[3], hg[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) grow[i] = c.exact_grav ? -(c.mg * R[6 + i]) : -R[6 + i];
    so3_hat(hg, grow);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T s = T(0);
        if (j < 3) {
          s = c.Jinv[i * 6 + 3] * hg[j];
#pragma unroll
          for (int k = 1; k < 3; ++k) s += c.Jinv[i * 6 + 3 + k] * hg[k * 3 + j];
        }
        Fx[(6 + i) * 12 + j] = s * dt;
      }
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) Fx[(6 + i) * 12 + j] = T(0);
  }
}

// GN tracking quadratization (models/costs.py): e = Log(q q_ref^-1),
// J_e_x = Jr^-1(e) Ad(q_ref); lx = [2 J^T W1 e; 2 W2 ev],
// lxx = blk(2 J^T W1 J, 0, 0, 2 W2), l = e W1 e + ev W2 ev.
// The gradient lx is computed in T; the Gauss-Newton Hessian lxx and the
// value l in Tp from the Tp roundings of J_e_x, e, W1 e, ev, W2 ev and the
// weights.  The f32 pipeline runs <T, T>; the mixed polish <double, float>
// (solvers/df_mixed.py stage_cost_quad_mx: lxx only preconditions).
template <typename Tp, typename T, typename OutV, typename OutM>
__device__ __forceinline__ Tp stage_cost_quad(
    const OutV& lx, const OutM& lxx, const T* R, const T* p, const T* xi,
    const T* RbiR, const T* Rbip, const T* Adb, const T* xib, const T* W1,
    const T* W2) {
  T Reb[9], peb[3], e[6], ev[6];
  se3_compose(Reb, peb, R, p, RbiR, Rbip);
  se3_log(e, Reb, peb);
#pragma unroll
  for (int i = 0; i < 6; ++i) ev[i] = xi[i] - xib[i];
  T Jri[36], Jex[36];
  se3_right_jacobian_inv(Jri, e);
  mat_mul<6, 6, 6>(Jex, Jri, Adb);
  T W1e[6], W2ev[6];
  mat_vec<6, 6>(W1e, W1, e);
  mat_vec<6, 6>(W2ev, W2, ev);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = T(2) * Jex[i] * W1e[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) s += T(2) * Jex[k * 6 + i] * W1e[k];
    lx[i] = s;
    lx[6 + i] = T(2) * W2ev[i];
  }
  // JT2W1 = (2 Jex^T) W1, H_e = JT2W1 Jex
  Tp JT2W1p[36];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Tp s = Tp(2) * Tp(Jex[i]) * Tp(W1[j]);
#pragma unroll
      for (int k = 1; k < 6; ++k) s += Tp(2) * Tp(Jex[k * 6 + i]) * Tp(W1[k * 6 + j]);
      JT2W1p[i * 6 + j] = s;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Tp s = JT2W1p[i * 6] * Tp(Jex[j]);
#pragma unroll
      for (int k = 1; k < 6; ++k) s += JT2W1p[i * 6 + k] * Tp(Jex[k * 6 + j]);
      lxx[i * 12 + j] = s;
      lxx[i * 12 + 6 + j] = Tp(0);
      lxx[(6 + i) * 12 + j] = Tp(0);
      lxx[(6 + i) * 12 + 6 + j] = Tp(2) * Tp(W2[i * 6 + j]);
    }
  Tp s1 = Tp(e[0]) * Tp(W1e[0]), s2 = Tp(ev[0]) * Tp(W2ev[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) {
    s1 += Tp(e[i]) * Tp(W1e[i]);
    s2 += Tp(ev[i]) * Tp(W2ev[i]);
  }
  return s1 + s2;
}

// Defect-aware Riccati step (solvers/pipeline.py riccati_stage) with the
// block structure Fu = [0; fu2], Lux = 0, Fx = [[A, Bb], [C, D]], C = 0
// unless glow, on a state of 2 H entries (pose half H: 6 for SE(3), 3 for
// SO(3)).  (Vx, V) hold V_x, V_xx of stage t+1 on entry and of stage t on
// exit; V is reused in place for V F and then Q_xx.  The nu x nu Cholesky
// stores its diagonal as 1 / sqrt(pivot).
//
// Two scalar types.  Tr carries the residual (adjoint) chain: Fx, d, lx,
// lu, V_x, Q_x, Q_u = gvec.  Tp carries the preconditioner: V_xx, Q_xx, Q_ux,
// Q_uu, the Cholesky, the gains and the vanishing V_x corrections, from the
// Tp roundings of Fx, d and Q_u.  The SO(3) pipeline (B11) runs
// <T, T, 3, 3>; B2 and B5 run the same step with H = 6 on a group of 16
// threads per problem (riccati_group.cuh, <T, T> and <float, double>).
// fu2 (H x nu, row-major) is given in both types (fu2r: Tr, fu2: Tp),
// loaded by the caller for each stage (B11).
template <typename Tp, typename Tr, int NU, int H>
__device__ __forceinline__ void riccati_stage(
    Tr* Vx, Tp* V, const Lane<const Tr>& Fxl, const Lane<const Tr>& ddl,
    const Lane<const Tr>& lxl, const Lane<const Tr>& lul,
    const Lane<const Tp>& lxxl, const Lane<const Tp>* luual, const Tr* fu2r,
    const Tp* fu2, const Tp* Luu, bool glow, const Lane<Tp>& k_out,
    const Lane<Tp>& K_out, const Lane<Tr>& g_out) {
  constexpr bool kMixed = !std::is_same<Tp, Tr>::value;
  constexpr int NX = 2 * H;
  Tr F[NX * NX];
  load<NX * NX>(F, Fxl);
  Tr Vmod[NX];
  {
    Tr dd[NX];
    load<NX>(dd, ddl);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Tp s = V[i * NX] * Tp(dd[0]);
#pragma unroll
      for (int j = 1; j < NX; ++j) s += V[i * NX + j] * Tp(dd[j]);
      Vmod[i] = Vx[i] + Tr(s);
    }
  }
  // Quu = Luu + fu2^T (V[H:, H:] fu2) [+ diag(luual)]
  Tp Quu[NU * NU];
  {
    Tp tmp[H * NU];
#pragma unroll
    for (int i = 0; i < H; ++i)
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Tp s = V[(H + i) * NX + H] * fu2[a];
#pragma unroll
        for (int k = 1; k < H; ++k) s += V[(H + i) * NX + H + k] * fu2[k * NU + a];
        tmp[i * NU + a] = s;
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int b2 = 0; b2 < NU; ++b2) {
        Tp s = fu2[a] * tmp[b2];
#pragma unroll
        for (int k = 1; k < H; ++k) s += fu2[k * NU + a] * tmp[k * NU + b2];
        Quu[a * NU + b2] = Luu[a * NU + b2] + s;
      }
    if (luual) {
#pragma unroll
      for (int a = 0; a < NU; ++a) Quu[a * NU + a] += (*luual)[a];
    }
  }
  // V <- V F  (row by row; F = [[A, Bb], [C, D]])
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Tp row[NX];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      Tp s = V[i * NX] * Tp(F[j]);
#pragma unroll
      for (int k = 1; k < H; ++k) s += V[i * NX + k] * Tp(F[k * NX + j]);
      if (glow) {
#pragma unroll
        for (int k = 0; k < H; ++k) s += V[i * NX + H + k] * Tp(F[(H + k) * NX + j]);
      }
      row[j] = s;
      Tp r = V[i * NX] * Tp(F[H + j]);
#pragma unroll
      for (int k = 1; k < H; ++k) r += V[i * NX + k] * Tp(F[k * NX + H + j]);
#pragma unroll
      for (int k = 0; k < H; ++k) r += V[i * NX + H + k] * Tp(F[(H + k) * NX + H + j]);
      row[H + j] = r;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i * NX + j] = row[j];
  }
  // Qx = lx + F^T Vmod, Qu = lu + fu2^T Vmod[H:]
  Tr Qx[NX], Qu[NU];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    Tr s = F[i] * Vmod[0];
#pragma unroll
    for (int k = 1; k < H; ++k) s += F[k * NX + i] * Vmod[k];
    if (glow) {
#pragma unroll
      for (int k = 0; k < H; ++k) s += F[(H + k) * NX + i] * Vmod[H + k];
    }
    Tr r = F[H + i] * Vmod[0];
#pragma unroll
    for (int k = 1; k < H; ++k) r += F[k * NX + H + i] * Vmod[k];
#pragma unroll
    for (int k = 0; k < H; ++k) r += F[(H + k) * NX + H + i] * Vmod[H + k];
    Qx[i] = lxl[i] + s;
    Qx[H + i] = lxl[H + i] + r;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    Tr s = fu2r[a] * Vmod[H];
#pragma unroll
    for (int k = 1; k < H; ++k) s += fu2r[k * NU + a] * Vmod[H + k];
    Qu[a] = lul[a] + s;
  }
  // Qux = fu2^T (V F)[H:, :]   (Lux = 0)
  Tp Qux[NU * NX];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      Tp s = fu2[a] * V[H * NX + j];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2[k * NU + a] * V[(H + k) * NX + j];
      Qux[a * NX + j] = s;
    }
  // V <- Qxx = lxx + F^T (V F)  (column by column)
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    Tp col[NX];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      Tp s = Tp(F[i]) * V[j];
#pragma unroll
      for (int k = 1; k < H; ++k) s += Tp(F[k * NX + i]) * V[k * NX + j];
      if (glow) {
#pragma unroll
        for (int k = 0; k < H; ++k) s += Tp(F[(H + k) * NX + i]) * V[(H + k) * NX + j];
      }
      col[i] = s;
      Tp r = Tp(F[H + i]) * V[j];
#pragma unroll
      for (int k = 1; k < H; ++k) r += Tp(F[k * NX + H + i]) * V[k * NX + j];
#pragma unroll
      for (int k = 0; k < H; ++k) r += Tp(F[(H + k) * NX + H + i]) * V[(H + k) * NX + j];
      col[H + i] = r;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) V[i * NX + j] = lxxl[i * NX + j] + col[i];
  }
  // Cholesky Quu = L L^T, diagonal stored as 1 / sqrt(pivot)
  Tp L[NU * NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    Tp sv = Quu[j * NU + j];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) sv = sv - L[j * NU + kk] * L[j * NU + kk];
    const Tp inv = Tp(1) / xsqrt(sv);
    L[j * NU + j] = inv;
#pragma unroll
    for (int i2 = j + 1; i2 < NU; ++i2) {
      Tp s2 = Quu[i2 * NU + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i2 * NU + kk] * L[j * NU + kk];
      L[i2 * NU + j] = s2 * inv;
    }
  }
  // K = -Quu^-1 Qux (column NX is k = -Quu^-1 Qu, from Qu's Tp rounding)
  constexpr int NC = NX + 1;
  Tp K[NU * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    Tp Y[NU];
#pragma unroll
    for (int i2 = 0; i2 < NU; ++i2) {
      Tp sv = c < NX ? Qux[i2 * NX + c] : Tp(Qu[i2]);
#pragma unroll
      for (int kk = 0; kk < i2; ++kk) sv = sv - L[i2 * NU + kk] * Y[kk];
      Y[i2] = sv * L[i2 * NU + i2];
    }
#pragma unroll
    for (int i2 = NU - 1; i2 >= 0; --i2) {
      Tp sv = Y[i2];
#pragma unroll
      for (int kk = i2 + 1; kk < NU; ++kk) sv = sv - L[kk * NU + i2] * K[kk * NC + c];
      K[i2 * NC + c] = sv * L[i2 * NU + i2];
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) K[a * NC + c] = -K[a * NC + c];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int j = 0; j < NX; ++j) K_out[a * NX + j] = K[a * NC + j];
    k_out[a] = K[a * NC + NX];
    g_out[a] = Qu[a];
  }
  // KTQuu = K^T Quu (NX x NU)
  Tp KTQuu[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      Tp s = K[i] * Quu[a];
#pragma unroll
      for (int b2 = 1; b2 < NU; ++b2) s += K[b2 * NC + i] * Quu[b2 * NU + a];
      KTQuu[i * NU + a] = s;
    }
  // Vx = Qx + KTQuu k + K^T Qu + Qux^T k; mixed: the three corrections
  // (all proportional to k and Qu) are summed in Tp and added once
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Tp s1 = KTQuu[i * NU] * K[NX], s2 = K[i] * Tp(Qu[0]), s3 = Qux[i] * K[NX];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s1 += KTQuu[i * NU + a] * K[a * NC + NX];
      s2 += K[a * NC + i] * Tp(Qu[a]);
      s3 += Qux[a * NX + i] * K[a * NC + NX];
    }
    if constexpr (kMixed) {
      Vx[i] = Qx[i] + Tr((s1 + s2) + s3);
    } else {
      Vx[i] = ((Qx[i] + s1) + s2) + s3;
    }
  }
  // V_xx = (S + S^T) / 2 + M + M^T, S = Qxx + KTQuu K, M = K^T Qux
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = i; j < NX; ++j) {
      Tp Sij = KTQuu[i * NU] * K[j], Sji = KTQuu[j * NU] * K[i];
      Tp Mij = K[i] * Qux[j], Mji = K[j] * Qux[i];
#pragma unroll
      for (int a = 1; a < NU; ++a) {
        Sij += KTQuu[i * NU + a] * K[a * NC + j];
        Sji += KTQuu[j * NU + a] * K[a * NC + i];
        Mij += K[a * NC + i] * Qux[a * NX + j];
        Mji += K[a * NC + j] * Qux[a * NX + i];
      }
      Sij = V[i * NX + j] + Sij;
      Sji = V[j * NX + i] + Sji;
      const Tp h = Tp(0.5) * (Sij + Sji);
      V[i * NX + j] = (h + Mij) + Mji;
      V[j * NX + i] = (h + Mji) + Mij;
    }
}

// Gap-closing rollout step (solvers/pipeline.py rollout_stage): feedback on
// the tangent-space deviation from the nominal, then
// x+ = x_next Exp(d) f(xbar)^-1 f(x_new).  (R, p, xi) hold the new state of
// stage t on entry and of stage t+1 on exit; (fqR, fqp, fxi) get the
// dynamics evaluation at the new (x_t, u_t) and u the new control.  The
// nominal stage (Rt, pt, xit, ut), its successor (Rn, pn, xin), the gains
// (kt, Kt), the defect dd and the nominal evaluation (fqRt, fqpt, fxit) come
// from the previous iterate.  The gains are of type Tp and the feedback
// k + K xs_err is computed in Tp from xs_err's Tp rounding: the f32 pipeline
// runs <T, T>, the mixed polish (B6, solvers/df_mixed.py rollout_stage_mx)
// <double, float> (the feedback's rounding is multiplied by xs_err -> 0).
template <typename T, typename Tp, int NU>
__device__ __forceinline__ void rollout_stage(
    T* R, T* p, T* xi, T* u, T* fqR, T* fqp, T* fxi, const T* Rt,
    const T* pt, const T* xit, const T* Rn, const T* pn, const T* xin,
    const T* ut, const Tp* kt, const Tp* Kt, const T* dd, const T* fqRt,
    const T* fqpt, const T* fxit, const Consts<T>& c) {
  T xs_err[12];
  {
    T Ri[9], pi[3], Re[9], pe[3];
    se3_inverse(Ri, pi, Rt, pt);
    se3_compose(Re, pe, Ri, pi, R, p);
    se3_log(xs_err, Re, pe);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    Tp s = Kt[a * 12] * Tp(xs_err[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) s += Kt[a * 12 + j] * Tp(xs_err[j]);
    if constexpr (std::is_same<T, Tp>::value) {
      u[a] = (ut[a] + kt[a]) + s;
    } else {
      u[a] = ut[a] + T(kt[a] + s);
    }
  }
  stage_dynamics_eval<T, NU>(fqR, fqp, fxi, R, p, xi, u, c);
  T edR[9], edp[3], fiR[9], fip[3], Ra[9], pa[3], Rb[9], pb[3];
  se3_exp(edR, edp, dd);
  se3_inverse(fiR, fip, fqRt, fqpt);
  se3_compose(Ra, pa, Rn, pn, edR, edp);
  se3_compose(Rb, pb, Ra, pa, fiR, fip);
  se3_compose(R, p, Rb, pb, fqR, fqp);
  so3_normalize(R);
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = ((xin[i] + fxi[i]) - fxit[i]) + dd[6 + i];
}

// d = [Log((R, p)^-1 fq); fxi - xi]: the defect of a stage whose dynamics
// evaluation is fq, fxi against the next state (R, p, xi).
template <typename T>
__device__ __forceinline__ void defect(T* d, const T* R, const T* p,
                                       const T* xi, const T* fqR,
                                       const T* fqp, const T* fxi) {
  T Rni[9], pni[3], Rd[9], pd[3];
  se3_inverse(Rni, pni, R, p);
  se3_compose(Rd, pd, Rni, pni, fqR, fqp);
  se3_log(d, Rd, pd);
#pragma unroll
  for (int i = 0; i < 6; ++i) d[6 + i] = fxi[i] - xi[i];
}

}  // namespace traopt
