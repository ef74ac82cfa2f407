// Closed-form SO(3)/SE(3) Lie operations, twist order [omega, v], double
// precision.  Native (C++) twin of ops/so3.py and ops/se3.py — the same role
// the manif C++ library plays for the reference
// (traoptlibrary/traopt_dynamics.py:11, traopt_cost.py:11), but first-party
// and matching this framework's one-and-only [omega, v] convention.
//
// Group elements are row-major 3x3 rotation blocks + translation; all
// functions are allocation-free on fixed-size arrays so the serial runtime
// (ilqr.cpp) stays cache-resident.
#pragma once
#include <cmath>
#include <cstring>

namespace traopt {

inline void mat_mul(double* C, const double* A, const double* B, int n, int m,
                    int p) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < p; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += A[i * m + k] * B[k * p + j];
      C[i * p + j] = s;
    }
}

inline void mat_vec(double* w, const double* A, const double* v, int n,
                    int m) {
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int k = 0; k < m; ++k) s += A[i * m + k] * v[k];
    w[i] = s;
  }
}

inline void mat_T(double* AT, const double* A, int n, int m) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) AT[j * n + i] = A[i * m + j];
}

inline void so3_hat(double* W, const double* w) {
  W[0] = 0;     W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0;     W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0;
}

inline void cross3(double* c, const double* a, const double* b) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3 with Taylor guards (ops/so3.py:48)
inline void sinc_coeffs(double th_sq, double* a, double* b, double* c) {
  if (th_sq < 1e-8) {
    *a = 1.0 - th_sq / 6.0;
    *b = 0.5 - th_sq / 24.0;
    *c = 1.0 / 6.0 - th_sq / 120.0;
  } else {
    double th = std::sqrt(th_sq);
    *a = std::sin(th) / th;
    *b = (1.0 - std::cos(th)) / th_sq;
    *c = (th - std::sin(th)) / (th_sq * th);
  }
}

inline void so3_exp(double* R, const double* w) {
  double th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double a, b, c, W[9], W2[9];
  sinc_coeffs(th_sq, &a, &b, &c);
  so3_hat(W, w);
  mat_mul(W2, W, W, 3, 3, 3);
  for (int i = 0; i < 9; ++i) R[i] = a * W[i] + b * W2[i];
  R[0] += 1.0; R[4] += 1.0; R[8] += 1.0;
}

// Branchless-equivalent Shepperd extraction (ops/so3.py:69): pick the
// best-conditioned pivot, canonical sign qw >= 0.
inline void quat_from_matrix(double* q, const double* R) {
  double tr = R[0] + R[4] + R[8];
  double piv[4] = {1.0 + tr, 1.0 + R[0] - R[4] - R[8],
                   1.0 - R[0] + R[4] - R[8], 1.0 - R[0] - R[4] + R[8]};
  int idx = 0;
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[idx]) idx = i;
  double s = std::sqrt(piv[idx] > 1e-30 ? piv[idx] : 1e-30);
  switch (idx) {
    case 0:
      q[0] = s * s; q[1] = R[7] - R[5]; q[2] = R[2] - R[6]; q[3] = R[3] - R[1];
      break;
    case 1:
      q[0] = R[7] - R[5]; q[1] = s * s; q[2] = R[1] + R[3]; q[3] = R[2] + R[6];
      break;
    case 2:
      q[0] = R[2] - R[6]; q[1] = R[1] + R[3]; q[2] = s * s; q[3] = R[5] + R[7];
      break;
    default:
      q[0] = R[3] - R[1]; q[1] = R[2] + R[6]; q[2] = R[5] + R[7]; q[3] = s * s;
  }
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  double sgn = q[0] < 0.0 ? -1.0 : 1.0;
  for (int i = 0; i < 4; ++i) q[i] *= sgn / n;
}

inline void matrix_from_quat(double* R, const double* q) {
  double qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  R[0] = 1 - 2 * (qy * qy + qz * qz); R[1] = 2 * (qx * qy - qw * qz); R[2] = 2 * (qx * qz + qw * qy);
  R[3] = 2 * (qx * qy + qw * qz); R[4] = 1 - 2 * (qx * qx + qz * qz); R[5] = 2 * (qy * qz - qw * qx);
  R[6] = 2 * (qx * qz - qw * qy); R[7] = 2 * (qy * qz + qw * qx); R[8] = 1 - 2 * (qx * qx + qy * qy);
}

inline void so3_normalize(double* R) {
  double q[4];
  quat_from_matrix(q, R);
  matrix_from_quat(R, q);
}

// log via quaternion with identity-smooth series (ops/so3.py:109)
inline void so3_log(double* w, const double* R) {
  double q[4];
  quat_from_matrix(q, R);
  double nv_sq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  double scale;
  if (nv_sq < 1e-14) {
    scale = 2.0 / q[0] - 2.0 * nv_sq / (3.0 * q[0] * q[0] * q[0]);
  } else {
    double nv = std::sqrt(nv_sq);
    scale = 2.0 * std::atan2(nv, q[0]) / nv;
  }
  w[0] = scale * q[1]; w[1] = scale * q[2]; w[2] = scale * q[3];
}

inline void so3_left_jacobian(double* J, const double* w) {
  double th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double a, b, c, W[9], W2[9];
  sinc_coeffs(th_sq, &a, &b, &c);
  so3_hat(W, w);
  mat_mul(W2, W, W, 3, 3, 3);
  for (int i = 0; i < 9; ++i) J[i] = b * W[i] + c * W2[i];
  J[0] += 1.0; J[4] += 1.0; J[8] += 1.0;
}

inline void so3_left_jacobian_inv(double* J, const double* w) {
  double th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double k, W[9], W2[9];
  if (th_sq < 1e-8) {
    k = 1.0 / 12.0 + th_sq / 720.0;
  } else {
    double th = std::sqrt(th_sq);
    double half = th / 2.0;
    k = 1.0 / th_sq - std::cos(half) / (2.0 * th * std::sin(half));
  }
  so3_hat(W, w);
  mat_mul(W2, W, W, 3, 3, 3);
  for (int i = 0; i < 9; ++i) J[i] = -0.5 * W[i] + k * W2[i];
  J[0] += 1.0; J[4] += 1.0; J[8] += 1.0;
}

// ---- SE(3): pose as struct { R[9]; p[3]; } --------------------------------

struct SE3 {
  double R[9];
  double p[3];
};

inline void se3_identity(SE3* T) {
  std::memset(T, 0, sizeof(SE3));
  T->R[0] = T->R[4] = T->R[8] = 1.0;
}

inline void se3_compose(SE3* C, const SE3& A, const SE3& B) {
  double R[9], p[3];
  mat_mul(R, A.R, B.R, 3, 3, 3);
  mat_vec(p, A.R, B.p, 3, 3);
  for (int i = 0; i < 3; ++i) p[i] += A.p[i];
  std::memcpy(C->R, R, sizeof(R));
  std::memcpy(C->p, p, sizeof(p));
}

inline void se3_inverse(SE3* I, const SE3& T) {
  double Rt[9], p[3];
  mat_T(Rt, T.R, 3, 3);
  mat_vec(p, Rt, T.p, 3, 3);
  std::memcpy(I->R, Rt, sizeof(Rt));
  for (int i = 0; i < 3; ++i) I->p[i] = -p[i];
}

inline void se3_exp(SE3* T, const double* xi) {  // xi = [w, v]
  so3_exp(T->R, xi);
  double Jl[9];
  so3_left_jacobian(Jl, xi);
  mat_vec(T->p, Jl, xi + 3, 3, 3);
}

inline void se3_log(double* xi, const SE3& T) {
  so3_log(xi, T.R);
  double Jli[9];
  so3_left_jacobian_inv(Jli, xi);
  mat_vec(xi + 3, Jli, T.p, 3, 3);
}

inline void se3_normalize(SE3* T) { so3_normalize(T->R); }

// Group adjoint [[R, 0], [hat(p) R, R]] in [w, v] order (ops/se3.py:107)
inline void se3_Ad(double* A, const SE3& T) {
  double P[9], PR[9];
  so3_hat(P, T.p);
  mat_mul(PR, P, T.R, 3, 3, 3);
  std::memset(A, 0, 36 * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i * 6 + j] = T.R[i * 3 + j];
      A[(i + 3) * 6 + j] = PR[i * 3 + j];
      A[(i + 3) * 6 + (j + 3)] = T.R[i * 3 + j];
    }
}

// coad(xi) = ad(xi)^T, ad = [[W, 0], [V, W]] (ops/se3.py:38)
inline void se3_coad(double* C, const double* xi) {
  double W[9], V[9];
  so3_hat(W, xi);
  so3_hat(V, xi + 3);
  std::memset(C, 0, 36 * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      C[i * 6 + j] = W[j * 3 + i];       // W^T
      C[i * 6 + (j + 3)] = V[j * 3 + i]; // V^T
      C[(i + 3) * 6 + (j + 3)] = W[j * 3 + i];
    }
}

// Barfoot Q(w, v) (ops/se3.py:117, eq. 7.86)
inline void se3_Q_matrix(double* Q, const double* w, const double* v) {
  double th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double c1, c2, c3;
  if (th_sq < 1e-8) {
    c1 = 1.0 / 6.0 - th_sq / 120.0;
    c2 = 1.0 / 24.0 - th_sq / 720.0;
    c3 = 1.0 / 120.0 - th_sq / 2520.0;
  } else {
    double th = std::sqrt(th_sq), s = std::sin(th), c = std::cos(th);
    c1 = (th - s) / (th_sq * th);
    c2 = (th_sq + 2.0 * c - 2.0) / (2.0 * th_sq * th_sq);
    c3 = (2.0 * th - 3.0 * s + th * c) / (2.0 * th_sq * th_sq * th);
  }
  double W[9], V[9], WV[9], VW[9], WVW[9], WWV[9], VWW[9], WVWW[9], WWVW[9];
  so3_hat(W, w);
  so3_hat(V, v);
  mat_mul(WV, W, V, 3, 3, 3);
  mat_mul(VW, V, W, 3, 3, 3);
  mat_mul(WVW, WV, W, 3, 3, 3);
  mat_mul(WWV, W, WV, 3, 3, 3);
  mat_mul(VWW, VW, W, 3, 3, 3);
  mat_mul(WVWW, WVW, W, 3, 3, 3);
  mat_mul(WWVW, W, WVW, 3, 3, 3);
  for (int i = 0; i < 9; ++i)
    Q[i] = 0.5 * V[i] + c1 * (WV[i] + VW[i] + WVW[i]) +
           c2 * (WWV[i] + VWW[i] - 3.0 * WVW[i]) + c3 * (WVWW[i] + WWVW[i]);
}

// SE(3) left Jacobian [[Jl, 0], [Q, Jl]] and inverse (ops/se3.py:160-192)
inline void se3_left_jacobian(double* J, const double* xi) {
  double Jw[9], Q[9];
  so3_left_jacobian(Jw, xi);
  se3_Q_matrix(Q, xi, xi + 3);
  std::memset(J, 0, 36 * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      J[i * 6 + j] = Jw[i * 3 + j];
      J[(i + 3) * 6 + j] = Q[i * 3 + j];
      J[(i + 3) * 6 + (j + 3)] = Jw[i * 3 + j];
    }
}

inline void se3_right_jacobian(double* J, const double* xi) {
  double nxi[6];
  for (int i = 0; i < 6; ++i) nxi[i] = -xi[i];
  se3_left_jacobian(J, nxi);
}

inline void se3_left_jacobian_inv(double* J, const double* xi) {
  double Jwi[9], Q[9], T1[9], JQJ[9];
  so3_left_jacobian_inv(Jwi, xi);
  se3_Q_matrix(Q, xi, xi + 3);
  mat_mul(T1, Jwi, Q, 3, 3, 3);
  mat_mul(JQJ, T1, Jwi, 3, 3, 3);
  std::memset(J, 0, 36 * sizeof(double));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      J[i * 6 + j] = Jwi[i * 3 + j];
      J[(i + 3) * 6 + j] = -JQJ[i * 3 + j];
      J[(i + 3) * 6 + (j + 3)] = Jwi[i * 3 + j];
    }
}

inline void se3_right_jacobian_inv(double* J, const double* xi) {
  double nxi[6];
  for (int i = 0; i < 6; ++i) nxi[i] = -xi[i];
  se3_left_jacobian_inv(J, nxi);
}

// Cholesky solve A X = B for SPD A (n x n), B (n x m), in place on X.
inline bool chol_solve(double* X, const double* A, const double* B, int n,
                       int m) {
  double L[36];  // n <= 6
  for (int j = 0; j < n; ++j) {
    double s = A[j * n + j];
    for (int k = 0; k < j; ++k) s -= L[j * n + k] * L[j * n + k];
    if (s <= 0.0) return false;
    L[j * n + j] = std::sqrt(s);
    for (int i = j + 1; i < n; ++i) {
      double t = A[i * n + j];
      for (int k = 0; k < j; ++k) t -= L[i * n + k] * L[j * n + k];
      L[i * n + j] = t / L[j * n + j];
    }
  }
  for (int c = 0; c < m; ++c) {
    double y[6];
    for (int i = 0; i < n; ++i) {
      double s = B[i * m + c];
      for (int k = 0; k < i; ++k) s -= L[i * n + k] * y[k];
      y[i] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      double s = y[i];
      for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * X[k * m + c];
      X[i * m + c] = s / L[i * n + i];
    }
  }
  return true;
}

}  // namespace traopt
