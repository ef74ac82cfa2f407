// Kernels B13 (generic dense Riccati backward) and B14 (SE(3) free-body
// gap-closing rollout) of the generic fast tier, solvers/batched.py
// FastBatchSolver.  The plain versions are ops/riccati.py (backward_plain)
// and ops/rollout.py (rollout_plain), which follow the JAX kernels formula by
// formula.
//
// Both are sequential recursions over the N stages of one problem: one thread
// per problem (grid ceil(B / 128) x 128), the stage loop inside the thread,
// the carry in thread-local arrays, every per-stage array batch-last so a
// warp's 32 problems read 32 neighbouring addresses.  The TPU kernels carried
// the recursion across a sequential grid axis with the carry in VMEM scratch.
#include "common.cuh"
#include "stage.cuh"

namespace traopt {

// ---- B13 ------------------------------------------------------------------
// Replaces ops/pallas_riccati.py::_riccati_kernel (pallas_backward).  A dense
// step on per-stage Fx (NX x NX), Fu (NX x NU), Lux and Luu, mu = 0, an
// unrolled NU x NU Cholesky (diagonal stored as the square root, substitutions
// divide, as the JAX kernel does).
// What bounds it on an H100: at NX = 12 the carry (V_x 12, V_xx 144) and the
// stage's Q_ux, K, K^T Q_uu (72 each) exceed the 255-register limit, so they
// live in local memory.  Fx is not held: its entries are read from global
// memory (L1) where they are used, V_xx F and F^T (V_xx F) one row / column
// at a time into the V_xx buffer (V_xx -> V_xx F -> Q_xx -> V_xx in place).
template <typename T>
struct FastRiccatiArgs {
  const T *Fx, *Fu, *d, *Lx, *Lu, *Lxx, *Lux, *Luu;  // Lx, Lxx: N+1 stages
  T *k, *K, *Vx1, *Vxx1;
  int N, B;
};

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads) fast_riccati_kernel(FastRiccatiArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  constexpr int NC = NX + 1;  // Q_ux's NX columns and Q_u
  T Vx[NX], V[NX * NX];
  load<NX>(Vx, lane<NX>(a.Lx, N, B, b));
  load<NX * NX>(V, lane<NX * NX>(a.Lxx, N, B, b));
  for (int t = N - 1; t >= 0; --t) {
    const Lane<const T> F = lane<NX * NX>(a.Fx, t, B, b);
    store<NX>(lane<NX>(a.Vx1, t, B, b), Vx);
    store<NX * NX>(lane<NX * NX>(a.Vxx1, t, B, b), V);
    T Fu[NX * NU];
    load<NX * NU>(Fu, lane<NX * NU>(a.Fu, t, B, b));
    // Vmod = V_x + V_xx d
    T Vmod[NX];
    {
      T dd[NX];
      load<NX>(dd, lane<NX>(a.d, t, B, b));
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = V[i * NX] * dd[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s += V[i * NX + j] * dd[j];
        Vmod[i] = Vx[i] + s;
      }
    }
    // Q_uu = L_uu + Fu^T (V_xx Fu)
    T Quu[NU * NU];
    {
      T VFu[NX * NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          T s = V[i * NX] * Fu[c];
#pragma unroll
          for (int k = 1; k < NX; ++k) s += V[i * NX + k] * Fu[k * NU + c];
          VFu[i * NU + c] = s;
        }
      const Lane<const T> luu = lane<NU * NU>(a.Luu, t, B, b);
#pragma unroll
      for (int r = 0; r < NU; ++r)
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          T s = Fu[r] * VFu[c];
#pragma unroll
          for (int k = 1; k < NX; ++k) s += Fu[k * NU + r] * VFu[k * NU + c];
          Quu[r * NU + c] = luu[r * NU + c] + s;
        }
    }
    // Q_x = L_x + F^T Vmod, Q_u = L_u + Fu^T Vmod
    T Qx[NX], Qu[NU];
    {
      const Lane<const T> lx = lane<NX>(a.Lx, t, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = F[i] * Vmod[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s += F[k * NX + i] * Vmod[k];
        Qx[i] = lx[i] + s;
      }
      const Lane<const T> lu = lane<NU>(a.Lu, t, B, b);
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        T s = Fu[r] * Vmod[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s += Fu[k * NU + r] * Vmod[k];
        Qu[r] = lu[r] + s;
      }
    }
    // V <- V_xx F, row by row
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T row[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = V[i * NX] * F[j];
#pragma unroll
        for (int k = 1; k < NX; ++k) s += V[i * NX + k] * F[k * NX + j];
        row[j] = s;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) V[i * NX + j] = row[j];
    }
    // Q_ux = L_ux + Fu^T (V_xx F)
    T Qux[NU * NX];
    {
      const Lane<const T> lux = lane<NU * NX>(a.Lux, t, B, b);
#pragma unroll
      for (int r = 0; r < NU; ++r)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = Fu[r] * V[j];
#pragma unroll
          for (int k = 1; k < NX; ++k) s += Fu[k * NU + r] * V[k * NX + j];
          Qux[r * NX + j] = lux[r * NX + j] + s;
        }
    }
    // V <- Q_xx = L_xx + F^T (V_xx F), column by column
    {
      const Lane<const T> lxx = lane<NX * NX>(a.Lxx, t, B, b);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T col[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T s = F[i] * V[j];
#pragma unroll
          for (int k = 1; k < NX; ++k) s += F[k * NX + i] * V[k * NX + j];
          col[i] = s;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) V[i * NX + j] = lxx[i * NX + j] + col[i];
      }
    }
    // Cholesky Q_uu = L L^T
    T L[NU * NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T s = Quu[j * NU + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s = s - L[j * NU + kk] * L[j * NU + kk];
      L[j * NU + j] = xsqrt(s);
      const T inv = T(1) / L[j * NU + j];
#pragma unroll
      for (int i = j + 1; i < NU; ++i) {
        T s2 = Quu[i * NU + j];
#pragma unroll
        for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i * NU + kk] * L[j * NU + kk];
        L[i * NU + j] = s2 * inv;
      }
    }
    // [K | k] = -Q_uu^-1 [Q_ux | Q_u]
    T Kc[NU * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T Y[NU], X[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = c < NX ? Qux[i * NX + c] : Qu[i];
#pragma unroll
        for (int kk = 0; kk < i; ++kk) s = s - L[i * NU + kk] * Y[kk];
        Y[i] = s / L[i * NU + i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        T s = Y[i];
#pragma unroll
        for (int kk = i + 1; kk < NU; ++kk) s = s - L[kk * NU + i] * X[kk];
        X[i] = s / L[i * NU + i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) Kc[i * NC + c] = -X[i];
    }
    {
      const Lane<T> Ko = lane<NU * NX>(a.K, t, B, b), ko = lane<NU>(a.k, t, B, b);
#pragma unroll
      for (int r = 0; r < NU; ++r) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Ko[r * NX + j] = Kc[r * NC + j];
        ko[r] = Kc[r * NC + NX];
      }
    }
    // KTQuu = K^T Q_uu (NX x NU)
    T KTQuu[NX * NU];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T s = Kc[i] * Quu[c];
#pragma unroll
        for (int r = 1; r < NU; ++r) s += Kc[r * NC + i] * Quu[r * NU + c];
        KTQuu[i * NU + c] = s;
      }
    // V_x = Q_x + K^T Q_uu k + K^T Q_u + Q_ux^T k
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s1 = KTQuu[i * NU] * Kc[NX], s2 = Kc[i] * Qu[0], s3 = Qux[i] * Kc[NX];
#pragma unroll
      for (int r = 1; r < NU; ++r) {
        s1 += KTQuu[i * NU + r] * Kc[r * NC + NX];
        s2 += Kc[r * NC + i] * Qu[r];
        s3 += Qux[r * NX + i] * Kc[r * NC + NX];
      }
      Vx[i] = ((Qx[i] + s1) + s2) + s3;
    }
    // V_xx = sym(Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K), in place
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = i; j < NX; ++j) {
        T aij = KTQuu[i * NU] * Kc[j], aji = KTQuu[j * NU] * Kc[i];
        T bij = Kc[i] * Qux[j], bji = Kc[j] * Qux[i];
        T cij = Qux[i] * Kc[j], cji = Qux[j] * Kc[i];
#pragma unroll
        for (int r = 1; r < NU; ++r) {
          aij += KTQuu[i * NU + r] * Kc[r * NC + j];
          aji += KTQuu[j * NU + r] * Kc[r * NC + i];
          bij += Kc[r * NC + i] * Qux[r * NX + j];
          bji += Kc[r * NC + j] * Qux[r * NX + i];
          cij += Qux[r * NX + i] * Kc[r * NC + j];
          cji += Qux[r * NX + j] * Kc[r * NC + i];
        }
        const T xij = ((V[i * NX + j] + aij) + bij) + cij;
        const T xji = ((V[j * NX + i] + aji) + bji) + cji;
        const T h = T(0.5) * (xij + xji);
        V[i * NX + j] = h;
        V[j * NX + i] = h;
      }
  }
}

// ---- B14 ------------------------------------------------------------------
// Replaces ops/pallas_rollout.py::_rollout_kernel (pallas_rollout): B4's
// gap-closing step for the free body, with Exp(d_q) and f(x_i)^-1 read
// precomputed as the TPU kernel takes them.  Shares stage.cuh's deviation
// (se3 inverse, compose, log), free-body dynamics evaluation (with the
// identity input projection) and quaternion renormalization with B4.
// What bounds it on an H100: it reads 138 values (of d only the twist rows)
// and writes 24 per stage and problem, serial over stages, with B / 128 blocks; the carry (R, p, xi)
// stays in registers.
template <typename T>
struct FastRolloutArgs {
  const T *qR, *qp, *xi;           // nominal trajectory, N+1 stages
  const T *u, *k, *K, *d, *fxi;    // (N, ..., B)
  const T *edR, *edp, *fiR, *fip;  // Exp(d_q) and f(x_i)^-1, (N, ..., B)
  const T *J, *Jinv;               // (6, 6)
  T dt;
  T *oR, *op, *oxi, *ou;           // stages 1..N, controls (N, 6, B)
  int N, B;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fast_rollout_kernel(FastRolloutArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  T eye[36];  // the free body's wrench takes u directly
#pragma unroll
  for (int i = 0; i < 36; ++i) eye[i] = i % 7 == 0 ? T(1) : T(0);
  const Consts<T> c{a.J, a.Jinv, nullptr, nullptr, nullptr, nullptr, eye,
                    nullptr, nullptr, T(0), a.dt, 0, 0};
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, b));
  load<3>(p, lane<3>(a.qp, 0, B, b));
  load<6>(xi, lane<6>(a.xi, 0, B, b));
  for (int t = 0; t < N; ++t) {
    T xs_err[12];
    {
      T Rt[9], pt[3], xit[6], Ri[9], pi[3], Re[9], pe[3];
      load<9>(Rt, lane<9>(a.qR, t, B, b));
      load<3>(pt, lane<3>(a.qp, t, B, b));
      load<6>(xit, lane<6>(a.xi, t, B, b));
      se3_inverse(Ri, pi, Rt, pt);
      se3_compose(Re, pe, Ri, pi, R, p);
      se3_log(xs_err, Re, pe);
#pragma unroll
      for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
    }
    T u[6];
    {
      const Lane<const T> ut = lane<6>(a.u, t, B, b), kt = lane<6>(a.k, t, B, b);
      const Lane<const T> Kt = lane<72>(a.K, t, B, b);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T s = Kt[r * 12] * xs_err[0];
#pragma unroll
        for (int j = 1; j < 12; ++j) s += Kt[r * 12 + j] * xs_err[j];
        u[r] = (ut[r] + kt[r]) + s;
      }
    }
    T fqR[9], fqp[3], fxn[6];
    stage_dynamics_eval<T, 6>(fqR, fqp, fxn, R, p, xi, u, c);
    {
      T Rn[9], pn[3], Ed[9], ed[3], Fi[9], fi[3], Ra[9], pa[3], Rb[9], pb[3];
      load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
      load<3>(pn, lane<3>(a.qp, t + 1, B, b));
      load<9>(Ed, lane<9>(a.edR, t, B, b));
      load<3>(ed, lane<3>(a.edp, t, B, b));
      load<9>(Fi, lane<9>(a.fiR, t, B, b));
      load<3>(fi, lane<3>(a.fip, t, B, b));
      se3_compose(Ra, pa, Rn, pn, Ed, ed);
      se3_compose(Rb, pb, Ra, pa, Fi, fi);
      se3_compose(R, p, Rb, pb, fqR, fqp);
      so3_normalize(R);
    }
    {
      const Lane<const T> xin = lane<6>(a.xi, t + 1, B, b);
      const Lane<const T> fxt = lane<6>(a.fxi, t, B, b), dd = lane<12>(a.d, t, B, b);
#pragma unroll
      for (int i = 0; i < 6; ++i) xi[i] = ((xin[i] + fxn[i]) - fxt[i]) + dd[6 + i];
    }
    store<9>(lane<9>(a.oR, t, B, b), R);
    store<3>(lane<3>(a.op, t, B, b), p);
    store<6>(lane<6>(a.oxi, t, B, b), xi);
    store<6>(lane<6>(a.ou, t, B, b), u);
  }
}

}  // namespace traopt

using traopt::Scalar;

extern "C" int TRAOPT_FN(fast_riccati)(
    const void* Fx, const void* Fu, const void* d, const void* Lx,
    const void* Lu, const void* Lxx, const void* Lux, const void* Luu, void* k,
    void* K, void* Vx1, void* Vxx1, int N, int nx, int nu, int B, int device,
    void* stream) {
  using T = Scalar;
  traopt::FastRiccatiArgs<T> a;
  a.Fx = (const T*)Fx; a.Fu = (const T*)Fu; a.d = (const T*)d;
  a.Lx = (const T*)Lx; a.Lu = (const T*)Lu; a.Lxx = (const T*)Lxx;
  a.Lux = (const T*)Lux; a.Luu = (const T*)Luu;
  a.k = (T*)k; a.K = (T*)K; a.Vx1 = (T*)Vx1; a.Vxx1 = (T*)Vxx1;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = traopt::batch_grid(B);
  if (nx == 12 && nu == 6)
    traopt::fast_riccati_kernel<T, 12, 6><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nx == 12 && nu == 4)
    traopt::fast_riccati_kernel<T, 12, 4><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nx == 6 && nu == 3)
    traopt::fast_riccati_kernel<T, 6, 3><<<grid, traopt::kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int TRAOPT_FN(fast_rollout)(
    const void* qR, const void* qp, const void* xi, const void* u,
    const void* k, const void* K, const void* d, const void* fxi,
    const void* edR, const void* edp, const void* fiR, const void* fip,
    const void* J, const void* Jinv, double dt, void* oR, void* op, void* oxi,
    void* ou, int N, int B, int device, void* stream) {
  using T = Scalar;
  traopt::FastRolloutArgs<T> a;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi;
  a.u = (const T*)u; a.k = (const T*)k; a.K = (const T*)K; a.d = (const T*)d;
  a.fxi = (const T*)fxi; a.edR = (const T*)edR; a.edp = (const T*)edp;
  a.fiR = (const T*)fiR; a.fip = (const T*)fip;
  a.J = (const T*)J; a.Jinv = (const T*)Jinv; a.dt = (T)dt;
  a.oR = (T*)oR; a.op = (T*)op; a.oxi = (T*)oxi; a.ou = (T*)ou;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  traopt::fast_rollout_kernel<T><<<traopt::batch_grid(B), traopt::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
