// Per-stage math of the f32 MS-iLQR pipeline for one problem held by one
// thread: dynamics evaluation, dynamics Jacobian, GN cost quadratization,
// the defect-aware Riccati step and the gap-closing rollout step.  The plain
// versions are ops/linearize.py (stage_dynamics_eval, stage_jacobian,
// stage_cost_quad) and solvers/pipeline.py (riccati_stage, rollout_stage);
// both follow the JAX package's lane kernels formula by formula.
//
// Arrays are batch-last: entry e of stage t of an (N, ne, B) array sits at
// (t * ne + e) * B + b, so a warp's 32 neighbouring problems read 32
// neighbouring addresses.  Per-stage references (RbiR, Rbip, Adb, xib) and the
// model constants (J, Jinv, weights, Pu, fu2, Luu) are shared by the whole
// batch and read as uniform loads of small row-major arrays.
#pragma once

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
// [+ m g R^T down] + Pu u)  (models/dynamics.py free body / rigid body)
template <typename T, int NU>
__device__ __forceinline__ void stage_dynamics_eval(
    T* fqR, T* fqp, T* fxi, const T* R, const T* p, const T* xi, const T* u,
    const Consts<T>& c) {
  T tau[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) tau[i] = xi[i] * c.dt;
  T Re[9], pe[3];
  se3_exp(Re, pe, tau);
  se3_compose(fqR, fqp, R, p, Re, pe);
  so3_normalize(fqR);
  T Jxi[6], c1[3], c2[3], c3[3], Puu[6], wrench[6], Jw[6];
  mat_vec<6, 6>(Jxi, c.J, xi);
  cross3(c1, xi, Jxi);
  cross3(c2, xi + 3, Jxi + 3);
  cross3(c3, xi, Jxi + 3);
  mat_vec<6, NU>(Puu, c.Pu, u);
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
template <typename T, typename OutV, typename OutM>
__device__ __forceinline__ T stage_cost_quad(
    const OutV& lx, const OutM& lxx, const T* R, const T* p, const T* xi,
    const T* RbiR, const T* Rbip, const T* Adb, const T* xib, const T* W1,
    const T* W2) {
  T Reb[9], peb[3], e[6], ev[6];
  se3_compose(Reb, peb, R, p, RbiR, Rbip);
  se3_log(e, Reb, peb);
#pragma unroll
  for (int i = 0; i < 6; ++i) ev[i] = xi[i] - xib[i];
  T Jri[36], Jex[36], JT2W1[36];
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
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      T s = T(2) * Jex[i] * W1[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += T(2) * Jex[k * 6 + i] * W1[k * 6 + j];
      JT2W1[i * 6 + j] = s;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      T s = JT2W1[i * 6] * Jex[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += JT2W1[i * 6 + k] * Jex[k * 6 + j];
      lxx[i * 12 + j] = s;
      lxx[i * 12 + 6 + j] = T(0);
      lxx[(6 + i) * 12 + j] = T(0);
      lxx[(6 + i) * 12 + 6 + j] = T(2) * W2[i * 6 + j];
    }
  T s1 = e[0] * W1e[0], s2 = ev[0] * W2ev[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) {
    s1 += e[i] * W1e[i];
    s2 += ev[i] * W2ev[i];
  }
  return s1 + s2;
}

// Defect-aware Riccati step (solvers/pipeline.py riccati_stage) with the
// block structure Fu = [0; fu2], Lux = 0, Fx = [[A, Bb], [C, D]], C = 0
// unless glow.  (Vx, V) hold V_x, V_xx of stage t+1 on entry and of stage t
// on exit; V is reused in place for V F and then Q_xx.  The nu x nu
// Cholesky stores its diagonal as 1 / sqrt(pivot).
template <typename T, int NU>
__device__ __forceinline__ void riccati_stage(
    T* Vx, T* V, const Lane<const T>& Fxl, const Lane<const T>& ddl,
    const Lane<const T>& lxl, const Lane<const T>& lul,
    const Lane<const T>& lxxl, const Lane<const T>* luual, const T* fu2,
    const T* Luu, bool glow, const Lane<T>& k_out, const Lane<T>& K_out,
    const Lane<T>& g_out) {
  T F[144];
  load<144>(F, Fxl);
  T Vmod[12];
  {
    T dd[12];
    load<12>(dd, ddl);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T s = V[i * 12] * dd[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) s += V[i * 12 + j] * dd[j];
      Vmod[i] = Vx[i] + s;
    }
  }
  // Quu = Luu + fu2^T (V[6:, 6:] fu2) [+ diag(luual)]
  T Quu[NU * NU];
  {
    T tmp[6 * NU];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = V[(6 + i) * 12 + 6] * fu2[a];
#pragma unroll
        for (int k = 1; k < 6; ++k) s += V[(6 + i) * 12 + 6 + k] * fu2[k * NU + a];
        tmp[i * NU + a] = s;
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int b2 = 0; b2 < NU; ++b2) {
        T s = fu2[a] * tmp[b2];
#pragma unroll
        for (int k = 1; k < 6; ++k) s += fu2[k * NU + a] * tmp[k * NU + b2];
        Quu[a * NU + b2] = Luu[a * NU + b2] + s;
      }
    if (luual) {
#pragma unroll
      for (int a = 0; a < NU; ++a) Quu[a * NU + a] += (*luual)[a];
    }
  }
  // V <- V F  (row by row; F = [[A, Bb], [C, D]])
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T row[12];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      T s = V[i * 12] * F[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += V[i * 12 + k] * F[k * 12 + j];
      if (glow) {
#pragma unroll
        for (int k = 0; k < 6; ++k) s += V[i * 12 + 6 + k] * F[(6 + k) * 12 + j];
      }
      row[j] = s;
      T r = V[i * 12] * F[6 + j];
#pragma unroll
      for (int k = 1; k < 6; ++k) r += V[i * 12 + k] * F[k * 12 + 6 + j];
#pragma unroll
      for (int k = 0; k < 6; ++k) r += V[i * 12 + 6 + k] * F[(6 + k) * 12 + 6 + j];
      row[6 + j] = r;
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) V[i * 12 + j] = row[j];
  }
  // Qx = lx + F^T Vmod, Qu = lu + fu2^T Vmod[6:]
  T Qx[12], Qu[NU];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = F[i] * Vmod[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) s += F[k * 12 + i] * Vmod[k];
    if (glow) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s += F[(6 + k) * 12 + i] * Vmod[6 + k];
    }
    T r = F[6 + i] * Vmod[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) r += F[k * 12 + 6 + i] * Vmod[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) r += F[(6 + k) * 12 + 6 + i] * Vmod[6 + k];
    Qx[i] = lxl[i] + s;
    Qx[6 + i] = lxl[6 + i] + r;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = fu2[a] * Vmod[6];
#pragma unroll
    for (int k = 1; k < 6; ++k) s += fu2[k * NU + a] * Vmod[6 + k];
    Qu[a] = lul[a] + s;
  }
  // Qux = fu2^T (V F)[6:, :]   (Lux = 0)
  T Qux[NU * 12];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T s = fu2[a] * V[6 * 12 + j];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += fu2[k * NU + a] * V[(6 + k) * 12 + j];
      Qux[a * 12 + j] = s;
    }
  // V <- Qxx = lxx + F^T (V F)  (column by column)
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    T col[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T s = F[i] * V[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += F[k * 12 + i] * V[k * 12 + j];
      if (glow) {
#pragma unroll
        for (int k = 0; k < 6; ++k) s += F[(6 + k) * 12 + i] * V[(6 + k) * 12 + j];
      }
      col[i] = s;
      T r = F[6 + i] * V[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) r += F[k * 12 + 6 + i] * V[k * 12 + j];
#pragma unroll
      for (int k = 0; k < 6; ++k) r += F[(6 + k) * 12 + 6 + i] * V[(6 + k) * 12 + j];
      col[6 + i] = r;
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) V[i * 12 + j] = lxxl[i * 12 + j] + col[i];
  }
  // Cholesky Quu = L L^T, diagonal stored as 1 / sqrt(pivot)
  T L[NU * NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T sv = Quu[j * NU + j];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) sv = sv - L[j * NU + kk] * L[j * NU + kk];
    const T inv = T(1) / xsqrt(sv);
    L[j * NU + j] = inv;
#pragma unroll
    for (int i2 = j + 1; i2 < NU; ++i2) {
      T s2 = Quu[i2 * NU + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i2 * NU + kk] * L[j * NU + kk];
      L[i2 * NU + j] = s2 * inv;
    }
  }
  // K = -Quu^-1 Qux (column 12 is k = -Quu^-1 Qu)
  T K[NU * 13];
#pragma unroll
  for (int c = 0; c < 13; ++c) {
    T Y[NU];
#pragma unroll
    for (int i2 = 0; i2 < NU; ++i2) {
      T sv = c < 12 ? Qux[i2 * 12 + c] : Qu[i2];
#pragma unroll
      for (int kk = 0; kk < i2; ++kk) sv = sv - L[i2 * NU + kk] * Y[kk];
      Y[i2] = sv * L[i2 * NU + i2];
    }
#pragma unroll
    for (int i2 = NU - 1; i2 >= 0; --i2) {
      T sv = Y[i2];
#pragma unroll
      for (int kk = i2 + 1; kk < NU; ++kk) sv = sv - L[kk * NU + i2] * K[kk * 13 + c];
      K[i2 * 13 + c] = sv * L[i2 * NU + i2];
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < 13; ++c) K[a * 13 + c] = -K[a * 13 + c];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int j = 0; j < 12; ++j) K_out[a * 12 + j] = K[a * 13 + j];
    k_out[a] = K[a * 13 + 12];
    g_out[a] = Qu[a];
  }
  // KTQuu = K^T Quu (12 x NU)
  T KTQuu[12 * NU];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = K[i] * Quu[a];
#pragma unroll
      for (int b2 = 1; b2 < NU; ++b2) s += K[b2 * 13 + i] * Quu[b2 * NU + a];
      KTQuu[i * NU + a] = s;
    }
  // Vx = Qx + KTQuu k + K^T Qu + Qux^T k
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T s1 = KTQuu[i * NU] * K[12], s2 = K[i] * Qu[0], s3 = Qux[i] * K[12];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s1 += KTQuu[i * NU + a] * K[a * 13 + 12];
      s2 += K[a * 13 + i] * Qu[a];
      s3 += Qux[a * 12 + i] * K[a * 13 + 12];
    }
    Vx[i] = ((Qx[i] + s1) + s2) + s3;
  }
  // V_xx = (S + S^T) / 2 + M + M^T, S = Qxx + KTQuu K, M = K^T Qux
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = i; j < 12; ++j) {
      T Sij = KTQuu[i * NU] * K[j], Sji = KTQuu[j * NU] * K[i];
      T Mij = K[i] * Qux[j], Mji = K[j] * Qux[i];
#pragma unroll
      for (int a = 1; a < NU; ++a) {
        Sij += KTQuu[i * NU + a] * K[a * 13 + j];
        Sji += KTQuu[j * NU + a] * K[a * 13 + i];
        Mij += K[a * 13 + i] * Qux[a * 12 + j];
        Mji += K[a * 13 + j] * Qux[a * 12 + i];
      }
      Sij = V[i * 12 + j] + Sij;
      Sji = V[j * 12 + i] + Sji;
      const T h = T(0.5) * (Sij + Sji);
      V[i * 12 + j] = (h + Mij) + Mji;
      V[j * 12 + i] = (h + Mji) + Mij;
    }
}

// Gap-closing rollout step (solvers/pipeline.py rollout_stage): feedback on
// the tangent-space deviation from the nominal, then
// x+ = x_next Exp(d) f(xbar)^-1 f(x_new).  (R, p, xi) hold the new state of
// stage t on entry and of stage t+1 on exit; (fqR, fqp, fxi) get the
// dynamics evaluation at the new (x_t, u_t) and u the new control.  The
// nominal stage (Rt, pt, xit, ut), its successor (Rn, pn, xin), the gains
// (kt, Kt), the defect dd and the nominal evaluation (fqRt, fqpt, fxit) come
// from the previous iterate.
template <typename T, int NU>
__device__ __forceinline__ void rollout_stage(
    T* R, T* p, T* xi, T* u, T* fqR, T* fqp, T* fxi, const T* Rt,
    const T* pt, const T* xit, const T* Rn, const T* pn, const T* xin,
    const T* ut, const T* kt, const T* Kt, const T* dd, const T* fqRt,
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
    T s = Kt[a * 12] * xs_err[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) s += Kt[a * 12 + j] * xs_err[j];
    u[a] = (ut[a] + kt[a]) + s;
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
