// Closed-form SO(3)/SE(3) Lie operations for one problem held by one thread,
// twist order [omega, v], templated on the scalar type (float / double).
//
// Adapted from the JAX package's C++17 core (native/src/lie.hpp) and made to
// follow the lane primitives of ops/lane_lie.py formula by formula: the same
// Taylor guards (theta^2 < 1e-8, compared in the scalar type), the same
// Shepperd pivot order (x, then y, then z on ties with >=, else w) and the
// same sum order in the small products, so kernel and plain version agree to
// rounding.  Matrices are row-major fixed-size arrays; every loop has
// compile-time bounds and is unrolled, so the arrays live in registers where
// the register budget allows.
#pragma once

#include <cmath>

#ifdef __CUDACC__
#define TRAOPT_HD __host__ __device__ __forceinline__
#else
#define TRAOPT_HD inline
#endif

namespace traopt {

TRAOPT_HD float xsqrt(float x) { return sqrtf(x); }
TRAOPT_HD double xsqrt(double x) { return sqrt(x); }
TRAOPT_HD float xsin(float x) { return sinf(x); }
TRAOPT_HD float xcos(float x) { return cosf(x); }
#ifdef TRAOPT_F64_TRIG
// sin and cos in double without the CUDA library's slow path for huge
// arguments, whose local array gives every kernel that calls them a stack
// frame (pipeline.cu's fp64 kernels take these): x less the nearest
// multiple q of pi/2 (a three-part Cody-Waite reduction with fused
// multiply-adds), Taylor polynomials on [-pi/4, pi/4] (truncated below
// 1e-19), and the quadrant q mod 4.  Within 1 ulp of the host libm's sin
// and cos over |x| <= 1e4 (tests/test_torch_host_rehearsal.py); the
// kernels' angles are rotation angles, far below where the reduction
// loses digits (|x| ~ 2^30).
TRAOPT_HD void xsincos(double x, double& s, double& c) {
  const double q = rint(x * 0.6366197723675814);
  double r = fma(-q, 1.5707963267948966, x);
  r = fma(-q, 6.123233995736766e-17, r);
  r = fma(-q, -1.4973849048591698e-33, r);
  const double r2 = r * r;
  // sin r = r - r^3 (1/3! - r^2/5! + ... + r^16/19!)
  double ps = 8.22063524662433e-18;
  ps = fma(ps, r2, -2.8114572543455206e-15);
  ps = fma(ps, r2, 7.647163731819816e-13);
  ps = fma(ps, r2, -1.6059043836821613e-10);
  ps = fma(ps, r2, 2.505210838544172e-08);
  ps = fma(ps, r2, -2.7557319223985893e-06);
  ps = fma(ps, r2, 0.0001984126984126984);
  ps = fma(ps, r2, -0.008333333333333333);
  ps = fma(ps, r2, 0.16666666666666666);
  const double sr = fma(-(r * r2), ps, r);
  // cos r = 1 + r^2 (-1/2! + r^2/4! - ... + r^18/20!)
  double pc = 4.110317623312165e-19;
  pc = fma(pc, r2, -1.5619206968586225e-16);
  pc = fma(pc, r2, 4.779477332387385e-14);
  pc = fma(pc, r2, -1.1470745597729725e-11);
  pc = fma(pc, r2, 2.08767569878681e-09);
  pc = fma(pc, r2, -2.755731922398589e-07);
  pc = fma(pc, r2, 2.48015873015873e-05);
  pc = fma(pc, r2, -0.001388888888888889);
  pc = fma(pc, r2, 0.041666666666666664);
  pc = fma(pc, r2, -0.5);
  const double cr = fma(pc, r2, 1.0);
  const int n = static_cast<int>(static_cast<long long>(q) & 3);
  s = n == 0 ? sr : n == 1 ? cr : n == 2 ? -sr : -cr;
  c = n == 0 ? cr : n == 1 ? -sr : n == 2 ? -cr : sr;
}
TRAOPT_HD double xsin(double x) {
  double s, c;
  xsincos(x, s, c);
  return s;
}
TRAOPT_HD double xcos(double x) {
  double s, c;
  xsincos(x, s, c);
  return c;
}
#else
TRAOPT_HD double xsin(double x) { return sin(x); }
TRAOPT_HD double xcos(double x) { return cos(x); }
#endif
TRAOPT_HD float xatan2(float y, float x) { return atan2f(y, x); }
TRAOPT_HD double xatan2(double y, double x) { return atan2(y, x); }

// sin x in float (cos x: shift 1, as sin(x + pi/2)) without the CUDA
// library's slow path for huge arguments (a Payne-Hanek reduction, whose
// local array gives every kernel that calls sinf or cosf a 32-byte stack
// frame): x less the nearest multiple q of pi/2 (a three-part Cody-Waite
// reduction with fused multiply-adds), then one minimax polynomial on
// [-pi/4, pi/4], sin's or cos's by the quadrant q + shift, as sinf's and
// cosf's own fast path.  Within 2 ulp of sin and cos over |x| <= 1e4
// (tests/test_torch_host_rehearsal.py); the kernels' angles are rotation
// angles, far below where the reduction loses digits.
TRAOPT_HD float xsin_shift(float x, int shift) {
  const float q = rintf(x * 0.636619772f);
  float r = fmaf(-q, 1.57079601e+00f, x);
  r = fmaf(-q, 3.13916473e-07f, r);
  r = fmaf(-q, 5.39030253e-15f, r);
  const int n = static_cast<int>(q) + shift;
  const bool odd = n & 1;
  const float r2 = r * r;
  float p = odd ? 2.44677067e-5f : 2.86567956e-6f;
  p = fmaf(p, r2, odd ? -1.38877297e-3f : -1.98559923e-4f);
  p = fmaf(p, r2, odd ? 4.16666567e-2f : 8.33338592e-3f);
  p = fmaf(p, r2, odd ? -5.0e-1f : -1.66666672e-1f);
  const float v = odd ? fmaf(p, r2, 1.0f) : fmaf(r * r2, p, r);
  return n & 2 ? -v : v;
}

// The trigonometry of the Lie functions below that take sin or cos (their
// first template argument): the scalar's xsin and xcos (LibTrig, the
// default), or, in float, xsin_shift above (FramelessTrig: the large-nu
// rollout of B3 and B4 keeps no stack frame); in double both take xsin and
// xcos.
struct LibTrig {
  template <typename T>
  TRAOPT_HD static T sin(T x) { return xsin(x); }
  template <typename T>
  TRAOPT_HD static T cos(T x) { return xcos(x); }
};

struct FramelessTrig {
  TRAOPT_HD static float sin(float x) { return xsin_shift(x, 0); }
  TRAOPT_HD static float cos(float x) { return xsin_shift(x, 1); }
  TRAOPT_HD static double sin(double x) { return xsin(x); }
  TRAOPT_HD static double cos(double x) { return xcos(x); }
};

template <typename T>
TRAOPT_HD bool small_angle(T th_sq) { return th_sq < T(1e-8); }

// The coefficients whose closed forms cancel (ops/lane_lie.py docstring) are
// power series in x = th^2 below x = 1: Horner over 11 doubles, the same
// values as ops/lane_lie.py, rounded to T.
template <typename T>
TRAOPT_HD bool series_range(T th_sq) { return th_sq < T(1); }

template <typename T>
TRAOPT_HD T poly11(T x, const double (&c)[11]) {
  T s = T(c[10]);
#pragma unroll
  for (int k = 9; k >= 0; --k) s = s * x + T(c[k]);
  return s;
}

// (th - sin th) / th^3
template <typename Trig = LibTrig, typename T>
TRAOPT_HD T coeff_c1(T th_sq) {
  if (series_range(th_sq)) {
    const double c[11] = {
        0.16666666666666666, -0.008333333333333333, 0.0001984126984126984,
        -2.7557319223985893e-06, 2.505210838544172e-08, -1.6059043836821613e-10,
        7.647163731819816e-13, -2.8114572543455206e-15, 8.22063524662433e-18,
        -1.9572941063391263e-20, 3.868170170630684e-23};
    return poly11(th_sq, c);
  }
  const T th = xsqrt(th_sq);
  return (th - Trig::sin(th)) / (th_sq * th);
}

// (th^2 + 2 cos th - 2) / (2 th^4)
template <typename Trig = LibTrig, typename T>
TRAOPT_HD T coeff_c2(T th_sq) {
  if (series_range(th_sq)) {
    const double c[11] = {
        0.041666666666666664, -0.001388888888888889, 2.48015873015873e-05,
        -2.755731922398589e-07, 2.08767569878681e-09, -1.1470745597729725e-11,
        4.779477332387385e-14, -1.5619206968586225e-16, 4.110317623312165e-19,
        -8.896791392450574e-22, 1.6117375710961184e-24};
    return poly11(th_sq, c);
  }
  const T th = xsqrt(th_sq);
  return (th_sq + T(2) * Trig::cos(th) - T(2)) / (T(2) * th_sq * th_sq);
}

// (2 th - 3 sin th + th cos th) / (2 th^5)
template <typename Trig = LibTrig, typename T>
TRAOPT_HD T coeff_c3(T th_sq) {
  if (series_range(th_sq)) {
    const double c[11] = {
        0.008333333333333333, -0.0003968253968253968, 8.267195767195768e-06,
        -1.0020843354176688e-07, 8.029521918410807e-10, -4.58829823909189e-12,
        1.9680200780418645e-14, -6.576508197299464e-17, 1.7615646957052136e-19,
        -3.868170170630684e-22, 7.091645312822921e-25};
    return poly11(th_sq, c);
  }
  const T th = xsqrt(th_sq);
  return (T(2) * th - T(3) * Trig::sin(th) + th * Trig::cos(th)) / (T(2) * th_sq * th_sq * th);
}

// 1/th^2 - cos(th/2) / (2 th sin(th/2))
template <typename Trig = LibTrig, typename T>
TRAOPT_HD T coeff_jinv(T th_sq) {
  if (series_range(th_sq)) {
    const double c[11] = {
        0.08333333333333333, 0.001388888888888889, 3.306878306878307e-05,
        8.267195767195768e-07, 2.08767569878681e-08, 5.284190138687493e-10,
        1.3382536530684679e-11, 3.3896802963225827e-13, 8.586062056277845e-15,
        2.174868698558062e-16, 5.5090028283602295e-18};
    return poly11(th_sq, c);
  }
  const T th = xsqrt(th_sq);
  return T(1) / th_sq - Trig::cos(th / T(2)) / (T(2) * th * Trig::sin(th / T(2)));
}

// C (n x p) = A (n x m) B (m x p)
template <int n, int m, int p, typename T>
TRAOPT_HD void mat_mul(T* C, const T* A, const T* B) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < p; ++j) {
      T s = A[i * m] * B[j];
#pragma unroll
      for (int k = 1; k < m; ++k) s += A[i * m + k] * B[k * p + j];
      C[i * p + j] = s;
    }
}

// w (n) = A (n x m) v (m)
template <int n, int m, typename T>
TRAOPT_HD void mat_vec(T* w, const T* A, const T* v) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T s = A[i * m] * v[0];
#pragma unroll
    for (int k = 1; k < m; ++k) s += A[i * m + k] * v[k];
    w[i] = s;
  }
}

template <typename T>
TRAOPT_HD void so3_hat(T* W, const T* w) {
  W[0] = T(0);  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = T(0);  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = T(0);
}

template <typename T>
TRAOPT_HD void cross3(T* c, const T* a, const T* b) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
TRAOPT_HD T theta_sq(const T* w) { return w[0] * w[0] + w[1] * w[1] + w[2] * w[2]; }

// out = I + a W + b W^2
template <typename T>
TRAOPT_HD void eye_plus(T* out, const T* w, T a, T b) {
  T W[9], W2[9];
  so3_hat(W, w);
  mat_mul<3, 3, 3>(W2, W, W);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = a * W[i] + b * W2[i];
  out[0] += T(1); out[4] += T(1); out[8] += T(1);
}

template <typename Trig = LibTrig, typename T>
TRAOPT_HD void so3_exp(T* R, const T* w) {
  T th_sq = theta_sq(w), a, b;
  if (small_angle(th_sq)) {
    a = T(1) - th_sq / T(6);
    b = T(0.5) - th_sq / T(24);
  } else {
    T th = xsqrt(th_sq);
    a = Trig::sin(th) / th;
    b = (T(1) - Trig::cos(th)) / th_sq;
  }
  eye_plus(R, w, a, b);
}

template <typename Trig = LibTrig, typename T>
TRAOPT_HD void so3_left_jacobian(T* J, const T* w) {
  const T th_sq = theta_sq(w);
  T b;
  if (small_angle(th_sq)) {
    b = T(0.5) - th_sq / T(24);
  } else {
    b = (T(1) - Trig::cos(xsqrt(th_sq))) / th_sq;
  }
  eye_plus(J, w, b, coeff_c1<Trig>(th_sq));
}

template <typename Trig = LibTrig, typename T>
TRAOPT_HD void so3_left_jacobian_inv(T* J, const T* w) {
  eye_plus(J, w, T(-0.5), coeff_jinv<Trig>(theta_sq(w)));
}

// sqrt(max(x, 1e-30))^2: the pivot's own candidate entry, rounded as the
// plain version rounds it
template <typename T>
TRAOPT_HD T pivot_sq(T x) {
  const T s = xsqrt(x > T(1e-30) ? x : T(1e-30));
  return s * s;
}

// Branchless Shepperd extraction (ops/lane_lie.quat_from_matrix): q = (w, x, y, z)
template <typename T>
TRAOPT_HD void quat_from_matrix(T* q, const T* R) {
  const T m00 = R[0], m01 = R[1], m02 = R[2];
  const T m10 = R[3], m11 = R[4], m12 = R[5];
  const T m20 = R[6], m21 = R[7], m22 = R[8];
  const T tr = m00 + m11 + m22;
  const T pw = T(1) + tr;
  const T px = T(1) + m00 - m11 - m22;
  const T py = T(1) - m00 + m11 - m22;
  const T pz = T(1) - m00 - m11 + m22;
  const bool use_x = (px >= pw) && (px >= py) && (px >= pz);
  const bool use_y = !use_x && (py >= pw) && (py >= px) && (py >= pz);
  const bool use_z = !use_x && !use_y && (pz >= pw) && (pz >= px) && (pz >= py);
  if (use_x) {
    q[0] = m21 - m12; q[1] = pivot_sq(px); q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (use_y) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = pivot_sq(py); q[3] = m12 + m21;
  } else if (use_z) {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = pivot_sq(pz);
  } else {
    q[0] = pivot_sq(pw); q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  }
  const T norm = xsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T sign = q[0] < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = sign * q[i] / norm;
}

template <typename T>
TRAOPT_HD void matrix_from_quat(T* R, const T* q) {
  const T qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  R[0] = T(1) - T(2) * (qy * qy + qz * qz);
  R[1] = T(2) * (qx * qy - qw * qz);
  R[2] = T(2) * (qx * qz + qw * qy);
  R[3] = T(2) * (qx * qy + qw * qz);
  R[4] = T(1) - T(2) * (qx * qx + qz * qz);
  R[5] = T(2) * (qy * qz - qw * qx);
  R[6] = T(2) * (qx * qz - qw * qy);
  R[7] = T(2) * (qy * qz + qw * qx);
  R[8] = T(1) - T(2) * (qx * qx + qy * qy);
}

template <typename T>
TRAOPT_HD void so3_normalize(T* R) {
  T q[4];
  quat_from_matrix(q, R);
  matrix_from_quat(R, q);
}

// log through the quaternion, with the identity-smooth series (native atan2)
template <typename T>
TRAOPT_HD void so3_log(T* w, const T* R) {
  T q[4];
  quat_from_matrix(q, R);
  const T nv_sq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  T s;
  if (nv_sq < T(1e-14)) {
    s = T(2) / q[0] - T(2) * nv_sq / (T(3) * (q[0] * q[0] * q[0]));
  } else {
    const T nv = xsqrt(nv_sq);
    s = T(2) * xatan2(nv, q[0]) / nv;
  }
  w[0] = s * q[1]; w[1] = s * q[2]; w[2] = s * q[3];
}

// ---- SE(3): pose = (R[9], p[3]) ------------------------------------------

template <typename Trig = LibTrig, typename T>
TRAOPT_HD void se3_exp(T* R, T* p, const T* xi) {
  so3_exp<Trig>(R, xi);
  T Jl[9];
  so3_left_jacobian<Trig>(Jl, xi);
  mat_vec<3, 3>(p, Jl, xi + 3);
}

template <typename Trig = LibTrig, typename T>
TRAOPT_HD void se3_log(T* xi, const T* R, const T* p) {
  so3_log(xi, R);
  T Jli[9];
  so3_left_jacobian_inv<Trig>(Jli, xi);
  mat_vec<3, 3>(xi + 3, Jli, p);
}

// (Rc, pc) = (R1, p1)(R2, p2); the outputs may not alias the inputs
template <typename T>
TRAOPT_HD void se3_compose(T* Rc, T* pc, const T* R1, const T* p1,
                           const T* R2, const T* p2) {
  mat_mul<3, 3, 3>(Rc, R1, R2);
  mat_vec<3, 3>(pc, R1, p2);
#pragma unroll
  for (int i = 0; i < 3; ++i) pc[i] += p1[i];
}

template <typename T>
TRAOPT_HD void se3_inverse(T* Ri, T* pi, const T* R, const T* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ri[i * 3 + j] = R[j * 3 + i];
  mat_vec<3, 3>(pi, Ri, p);
#pragma unroll
  for (int i = 0; i < 3; ++i) pi[i] = -pi[i];
}

// Barfoot Q(w, v), "State Estimation for Robotics" eq. (7.86)
template <typename Trig = LibTrig, typename T>
TRAOPT_HD void q_matrix(T* Q, const T* w, const T* v) {
  const T th_sq = theta_sq(w);
  const T c1 = coeff_c1<Trig>(th_sq), c2 = coeff_c2<Trig>(th_sq), c3 = coeff_c3<Trig>(th_sq);
  T W[9], V[9], WV[9], VW[9], WVW[9], A[9], Bm[9];
  so3_hat(W, w);
  so3_hat(V, v);
  mat_mul<3, 3, 3>(WV, W, V);
  mat_mul<3, 3, 3>(VW, V, W);
  mat_mul<3, 3, 3>(WVW, WV, W);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] = T(0.5) * V[i] + c1 * (WV[i] + VW[i] + WVW[i]);
  mat_mul<3, 3, 3>(A, W, WV);
  mat_mul<3, 3, 3>(Bm, VW, W);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] += c2 * (A[i] + Bm[i] - T(3) * WVW[i]);
  mat_mul<3, 3, 3>(A, WVW, W);
  mat_mul<3, 3, 3>(Bm, W, WVW);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] += c3 * (A[i] + Bm[i]);
}

// 6x6 block matrices: set block (bi, bj) of a row-major 6x6 from a 3x3
template <typename T>
TRAOPT_HD void set_block(T* M, int bi, int bj, const T* A, T scale = T(1)) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[(bi * 3 + i) * 6 + bj * 3 + j] = scale * A[i * 3 + j];
}

template <typename T>
TRAOPT_HD void zero_block(T* M, int bi, int bj) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[(bi * 3 + i) * 6 + bj * 3 + j] = T(0);
}

// Jr(xi) = Jl(-xi) = [[Jw, 0], [Q, Jw]] at (-w, -v), every entry times scale
template <typename T>
TRAOPT_HD void se3_right_jacobian(T* J, const T* xi, T scale) {
  T w[3] = {-xi[0], -xi[1], -xi[2]}, v[3] = {-xi[3], -xi[4], -xi[5]};
  T Jw[9], Q[9];
  so3_left_jacobian(Jw, w);
  q_matrix(Q, w, v);
  set_block(J, 0, 0, Jw, scale);
  zero_block(J, 0, 1);
  set_block(J, 1, 0, Q, scale);
  set_block(J, 1, 1, Jw, scale);
}

// Jr^-1(xi) = Jl^-1(-xi) = [[Jwi, 0], [-(Jwi Q) Jwi, Jwi]]
template <typename Trig = LibTrig, typename T>
TRAOPT_HD void se3_right_jacobian_inv(T* J, const T* xi) {
  T w[3] = {-xi[0], -xi[1], -xi[2]}, v[3] = {-xi[3], -xi[4], -xi[5]};
  T Jwi[9], Q[9], JQ[9], JQJ[9];
  so3_left_jacobian_inv<Trig>(Jwi, w);
  q_matrix<Trig>(Q, w, v);
  mat_mul<3, 3, 3>(JQ, Jwi, Q);
  mat_mul<3, 3, 3>(JQJ, JQ, Jwi);
  set_block(J, 0, 0, Jwi);
  zero_block(J, 0, 1);
  set_block(J, 1, 0, JQJ, T(-1));
  set_block(J, 1, 1, Jwi);
}

// Group adjoint [[R, 0], [hat(p) R, R]]
template <typename T>
TRAOPT_HD void se3_Ad(T* A, const T* R, const T* p) {
  T P[9], PR[9];
  so3_hat(P, p);
  mat_mul<3, 3, 3>(PR, P, R);
  set_block(A, 0, 0, R);
  zero_block(A, 0, 1);
  set_block(A, 1, 0, PR);
  set_block(A, 1, 1, R);
}

}  // namespace traopt
