// Kernels B10 (linearization), B11 (Riccati backward) and B12 (rollout, then
// the linearization of the new trajectory) of the SO(3)-family MS-iLQR
// pipeline (solvers/pipeline_so3.py): the free rigid-body attitude and the
// 3-D pendulum actuated at its pivot.  The state is (R, xi) with nx = 6,
// nu = 3.
//
// The stage math below follows the plain versions in solvers/pipeline_so3.py
// (so3_stage_dynamics_eval, so3_stage_jacobian, so3_stage_cost_quad,
// so3_rollout_stage) formula by formula; the Riccati step is stage.cuh's
// riccati_stage<T, T, 3, 3>, B2's with the pose half 3.  The pendulum's Fu
// = [0; fu2] depends on the stage's R: B10 writes fu2 per stage, B11 reads it
// per stage.  Batch-last arrays as in stage.cuh; the model constants (J,
// Jinv, weights, m g rho, m rho) and the per-stage references (RbiR, xib) are
// small row-major arrays shared by the batch.
#include "ahead.cuh"
#include "common.cuh"
#include "stage.cuh"

namespace traopt {

template <typename T>
struct So3Consts {
  const T *J, *Jinv;  // (3, 3) inertia and its inverse
  const T *W1, *W2;   // (3, 3) stage weights Q1, Q2
  const T *mgr, *mr;  // (3,) m g rho and m rho (pendulum; zero otherwise)
  T dt;
  int pendulum;
};

template <typename T>
__device__ __forceinline__ void transpose3(T* At, const T* A) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) At[i * 3 + j] = A[j * 3 + i];
}

// fq = normalize(R Exp(xi dt)); fxi = xi + dt Jinv torque, torque =
// -xi x (J xi) + u (free) or + (m g rho) x (R^T down) + (m rho) x (R^T u)
// (pendulum, down = (0, 0, -1))
template <typename T>
__device__ __forceinline__ void so3_dynamics_eval(T* fqR, T* fxi, const T* R,
                                                  const T* xi, const T* u,
                                                  const So3Consts<T>& c) {
  {
    T tau[3], Re[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) tau[i] = xi[i] * c.dt;
    so3_exp(Re, tau);
    mat_mul<3, 3, 3>(fqR, R, Re);
    so3_normalize(fqR);
  }
  T Jxi[3], cr[3], torque[3];
  mat_vec<3, 3>(Jxi, c.J, xi);
  cross3(cr, xi, Jxi);
  if (c.pendulum) {
    T Rtd[3], Rtu[3], t1[3], t2[3], Rt[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) Rtd[i] = -R[6 + i];  // R^T down = -(third row)
    transpose3(Rt, R);
    mat_vec<3, 3>(Rtu, Rt, u);
    cross3(t1, c.mgr, Rtd);
    cross3(t2, c.mr, Rtu);
#pragma unroll
    for (int i = 0; i < 3; ++i) torque[i] = (-cr[i] + t1[i]) + t2[i];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) torque[i] = -cr[i] + u[i];
  }
  T Jt[3];
  mat_vec<3, 3>(Jt, c.Jinv, torque);
#pragma unroll
  for (int i = 0; i < 3; ++i) fxi[i] = xi[i] + c.dt * Jt[i];
}

// Fx = [[Exp(-tau), Jr(tau) dt], [C, I + H dt]], tau = xi dt,
// H = Jinv (hat(J xi) - hat(xi) J); C = Jinv (hat(m g rho) R^T hat(down) R
// + hat(m rho) R^T hat(u) R) dt for the pendulum, 0 for the free body.
// fu2 (3 x 3, row-major) = Jinv hat(m rho) R^T dt (pendulum) or Jinv dt.
template <typename T, typename Out>
__device__ __forceinline__ void so3_jacobian(const Out& Fx, T* fu2, const T* R,
                                             const T* xi, const T* u,
                                             const So3Consts<T>& c) {
  const T dt = c.dt;
  T ntau[3], M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) ntau[i] = -(xi[i] * dt);
  so3_exp(M, ntau);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Fx[i * 6 + j] = M[i * 3 + j];
  so3_left_jacobian(M, ntau);  // Jr(tau) = Jl(-tau)
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Fx[i * 6 + 3 + j] = M[i * 3 + j] * dt;
  {
    T Jxi[3], G[9], hx[9], hJ[9], D[9];
    mat_vec<3, 3>(Jxi, c.J, xi);
    so3_hat(G, Jxi);
    so3_hat(hx, xi);
    mat_mul<3, 3, 3>(hJ, hx, c.J);
#pragma unroll
    for (int i = 0; i < 9; ++i) G[i] = G[i] - hJ[i];
    mat_mul<3, 3, 3>(D, c.Jinv, G);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Fx[(3 + i) * 6 + 3 + j] = (i == j ? T(1) : T(0)) + D[i * 3 + j] * dt;
  }
  if (c.pendulum) {
    T Rt[9], A[9], B2[9], L1[9], L2[9], hm[9];
    transpose3(Rt, R);
    {
      // hat(down) R = rows (R[1], -R[0], 0) for down = (0, 0, -1)
      T hdR[9];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        hdR[j] = R[3 + j];
        hdR[3 + j] = -R[j];
        hdR[6 + j] = T(0);
      }
      mat_mul<3, 3, 3>(A, Rt, hdR);
      so3_hat(hm, c.mgr);
      mat_mul<3, 3, 3>(L1, hm, A);
    }
    {
      T hu[9];
      so3_hat(hu, u);
      mat_mul<3, 3, 3>(A, hu, R);
      mat_mul<3, 3, 3>(B2, Rt, A);
      so3_hat(hm, c.mr);
      mat_mul<3, 3, 3>(L2, hm, B2);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) L1[i] = L1[i] + L2[i];
    mat_mul<3, 3, 3>(A, c.Jinv, L1);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Fx[(3 + i) * 6 + j] = A[i * 3 + j] * dt;
    mat_mul<3, 3, 3>(A, hm, Rt);  // hm = hat(m rho)
    mat_mul<3, 3, 3>(B2, c.Jinv, A);
#pragma unroll
    for (int i = 0; i < 9; ++i) fu2[i] = B2[i] * dt;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Fx[(3 + i) * 6 + j] = T(0);
#pragma unroll
    for (int i = 0; i < 9; ++i) fu2[i] = c.Jinv[i] * dt;
  }
}

// GN tracking quadratization on SO(3): e = Log(R RbiR), ev = xi - xib,
// J_e_x = Jr^-1(e) RbiR^T; lx = [2 J^T W1v e; 2 W2v ev],
// lxx = blk(2 J^T W1h J, 0, 0, 2 W2h), returns l = e W1v e + ev W2v ev.
// (W1v, W2v) = (W1h, W2h) for stage costs; the terminal quirk passes (Q, P).
template <typename T, typename OutV, typename OutM>
__device__ __forceinline__ T so3_cost_quad(const OutV& lx, const OutM& lxx,
                                           const T* R, const T* xi,
                                           const T* RbiR, const T* xib,
                                           const T* W1v, const T* W2v,
                                           const T* W1h, const T* W2h) {
  T e[3], ev[3], Jex[9];
  {
    T M[9];
    mat_mul<3, 3, 3>(M, R, RbiR);
    so3_log(e, M);
    T ne[3] = {-e[0], -e[1], -e[2]}, Jri[9], Adb[9];
    so3_left_jacobian_inv(Jri, ne);
    transpose3(Adb, RbiR);
    mat_mul<3, 3, 3>(Jex, Jri, Adb);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) ev[i] = xi[i] - xib[i];
  T W1e[3], W2ev[3];
  mat_vec<3, 3>(W1e, W1v, e);
  mat_vec<3, 3>(W2ev, W2v, ev);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T s = T(2) * Jex[i] * W1e[0];
#pragma unroll
    for (int k = 1; k < 3; ++k) s += T(2) * Jex[k * 3 + i] * W1e[k];
    lx[i] = s;
    lx[3 + i] = T(2) * W2ev[i];
  }
  T JT2W1[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(2) * Jex[i] * W1h[j];
#pragma unroll
      for (int k = 1; k < 3; ++k) s += T(2) * Jex[k * 3 + i] * W1h[k * 3 + j];
      JT2W1[i * 3 + j] = s;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = JT2W1[i * 3] * Jex[j];
#pragma unroll
      for (int k = 1; k < 3; ++k) s += JT2W1[i * 3 + k] * Jex[k * 3 + j];
      lxx[i * 6 + j] = s;
      lxx[i * 6 + 3 + j] = T(0);
      lxx[(3 + i) * 6 + j] = T(0);
      lxx[(3 + i) * 6 + 3 + j] = T(2) * W2h[i * 3 + j];
    }
  return (e[0] * W1e[0] + e[1] * W1e[1] + e[2] * W1e[2]) +
         (ev[0] * W2ev[0] + ev[1] * W2ev[1] + ev[2] * W2ev[2]);
}

// d = [Log(R^T fq); fxi - xi] against the next state (R, xi)
template <typename T>
__device__ __forceinline__ void so3_defect(T* d, const T* R, const T* xi,
                                           const T* fqR, const T* fxi) {
  T Rt[9], M[9];
  transpose3(Rt, R);
  mat_mul<3, 3, 3>(M, Rt, fqR);
  so3_log(d, M);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[3 + i] = fxi[i] - xi[i];
}

// ---- B10 -----------------------------------------------------------------
// Replaces solvers/pipeline_so3.py::_linearize_kernel_so3
// (SO3PipelineSolver._linearize_lane).  Grid (ceil(B / 128), N), one thread
// per (problem, stage); stages are independent.  What bounds it on an H100:
// it writes 100 values per thread (Fx, lxx and fu2 are 81 of them) and
// reads 27, about 1 k flops, so its stores bound it, as B1's; every output
// entry is written once from registers, coalesced over b.
template <typename T>
struct LinearizeSo3Args {
  const T *qR, *xi, *u;  // (N+1, 3, 3, B), (N+1, 3, B), (N, 3, B)
  const T *RbiR, *xib;   // (N+1, 3, 3), (N+1, 3)
  So3Consts<T> c;
  T *fqR, *fxi, *d, *Fx, *fu2, *lx, *lxx, *l;  // (N, ..., B)
  int N, B;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) linearize_so3_kernel(LinearizeSo3Args<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  T R[9], xi[3], u[3];
  load<9>(R, lane<9>(a.qR, t, B, b));
  load<3>(xi, lane<3>(a.xi, t, B, b));
  load<3>(u, lane<3>(a.u, t, B, b));
  {
    T fqR[9], fxi[3], Rn[9], xin[3], d[6];
    so3_dynamics_eval(fqR, fxi, R, xi, u, a.c);
    store<9>(lane<9>(a.fqR, t, B, b), fqR);
    store<3>(lane<3>(a.fxi, t, B, b), fxi);
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(xin, lane<3>(a.xi, t + 1, B, b));
    so3_defect(d, Rn, xin, fqR, fxi);
    store<6>(lane<6>(a.d, t, B, b), d);
  }
  {
    T fu2[9];
    so3_jacobian(lane<36>(a.Fx, t, B, b), fu2, R, xi, u, a.c);
    store<9>(lane<9>(a.fu2, t, B, b), fu2);
  }
  a.l[(long long)t * B + b] = so3_cost_quad<T>(
      lane<6>(a.lx, t, B, b), lane<36>(a.lxx, t, B, b), R, xi, a.RbiR + t * 9,
      a.xib + t * 3, a.c.W1, a.c.W2, a.c.W1, a.c.W2);
}

// ---- B11 -----------------------------------------------------------------
// Replaces solvers/pipeline_so3.py::_riccati_kernel_so3
// (SO3PipelineSolver._backward_lane): the terminal quadratization with the
// quirk weights (value and gradient W1vN, W2vN; Hessian W1hN, W2hN), then
// riccati_stage<T, T, 3, 3> over the stages in reverse with glow = pendulum
// and fu2 read per stage.
// What bounds it on an H100: it reads 96 values and writes 24 per stage and
// problem (0.29 ms at B = 8192, N = 249); a stage is a chain of ~900
// multiply-adds and a 3 x 3 Cholesky on a carry (V_x 6, V_xx 36) that fits
// in the registers.  One thread per problem on blocks of one warp (ahead.cuh:
// B / 32 blocks over all SMs), the carry in registers; each thread copies
// stage t - 1's 96 inputs into its shared-memory column while it computes
// stage t, so the chain no longer waits on device memory.  At B = 8192 this
// took 0.50 ms, the same kernel reading device memory inside the chain on
// 128-thread blocks 0.79, and B2's group design at nx = 6 (8 threads per
// problem, 16 problems per block) 1.28 (PERF.md).
template <typename T>
struct RiccatiSo3Args {
  const T *Fx, *fu2, *d, *lx, *lu, *lxx;  // (N, ..., B)
  const T *qR, *xi;                       // (N+1, ..., B): terminal state
  const T *RbiR, *xib;                    // (N+1, 3, 3), (N+1, 3)
  const T *W1vN, *W2vN, *W1hN, *W2hN;     // (3, 3) terminal weights
  const T* Luu;                           // (3, 3) = 2 R
  int pendulum;
  T *k, *K, *gvec, *lN;  // (N, 3, B), (N, 3, 6, B), (N, 3, B), (B,)
  int N, B;
};

// The entries of one stage in a thread's column.
struct RiccatiSo3Column {
  static constexpr int Fx = 0, fu2 = 36, d = 45, lx = 51, lu = 57, lxx = 60, n = 96;
};

template <typename T>
__device__ __forceinline__ void riccati_so3_copy(T* col, const RiccatiSo3Args<T>& a, int t,
                                                 int b) {
  using C = RiccatiSo3Column;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<36>(col + C::Fx * P, a.Fx, t, B, b);
  copy_column<9>(col + C::fu2 * P, a.fu2, t, B, b);
  copy_column<6>(col + C::d * P, a.d, t, B, b);
  copy_column<6>(col + C::lx * P, a.lx, t, B, b);
  copy_column<3>(col + C::lu * P, a.lu, t, B, b);
  copy_column<36>(col + C::lxx * P, a.lxx, t, B, b);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kAheadThreads) riccati_so3_kernel(RiccatiSo3Args<T> a) {
  using C = RiccatiSo3Column;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x;
  if (b >= B) return;
  T* col = reinterpret_cast<T*>(smem) + threadIdx.x;  // slot s at col + s * C::n * P
  T Vx[6], V[36];
  {
    T R[9], xi[3];
    load<9>(R, lane<9>(a.qR, N, B, b));
    load<3>(xi, lane<3>(a.xi, N, B, b));
    a.lN[b] = so3_cost_quad<T>(&Vx[0], &V[0], R, xi, a.RbiR + N * 9, a.xib + N * 3,
                               a.W1vN, a.W2vN, a.W1hN, a.W2hN);
  }
  riccati_so3_copy(col, a, N - 1, b);
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    if (t > 0) riccati_so3_copy(col + (cur ^ 1) * C::n * P, a, t - 1, b);
    const T* in = col + cur * C::n * P;
    T fu2[9];
    load<9>(fu2, column(in + C::fu2 * P));
    riccati_stage<T, T, 3, 3>(
        Vx, V, column(in + C::Fx * P), column(in + C::d * P), column(in + C::lx * P),
        column(in + C::lu * P), column(in + C::lxx * P), nullptr, fu2, fu2, a.Luu,
        a.pendulum != 0, lane<3>(a.k, t, B, b), lane<18>(a.K, t, B, b),
        lane<3>(a.gvec, t, B, b));
  }
}

template <typename T>
int launch_riccati_so3(const RiccatiSo3Args<T>& a, cudaStream_t s) {
  constexpr size_t bytes = 2 * RiccatiSo3Column::n * kAheadThreads * sizeof(T);
  if (cudaError_t e = cudaFuncSetAttribute(riccati_so3_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  riccati_so3_kernel<T><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- B12 -----------------------------------------------------------------
// Replaces solvers/pipeline_so3.py::_rollout_linearize_kernel_so3
// (SO3PipelineSolver._rollout_linearize_lane): the gap-closing rollout,
// x+ = x_next Exp(d) f(xbar)^-1 f(x_new) after the feedback
// u = u_t + k_t + K_t xs_err, and the linearization of every stage of the
// new trajectory.
// What bounds it on an H100: per stage and problem the rollout reads 66
// values and writes 15 in a chain of dependent steps (Log, the feedback,
// Exp, three compositions) serial over the stages; the linearization writes
// B10's 100 values (Fx, lxx and fu2 are 81 of them), store-bound.  The TPU
// kernel linearized stage t inside the rollout's stage loop; here B12 runs in
// two phases on the caller's stream, as B3 does: the rollout
// (rollout_so3_kernel), then B10's kernel on the new trajectory, a thread
// per (problem, stage), so the linearization's stores no longer wait behind
// the rollout's chain.  Both compute what the fused loop did (the same stage
// functions on the same values).  The rollout runs one problem per thread
// on blocks of one warp (ahead.cuh: B / 32 blocks) with the carry (R, xi) in
// registers, and copies stage t + 1's inputs into shared memory while it
// computes stage t.
template <typename T>
struct RolloutSo3Args {
  const T *qR, *xi, *u;     // nominal (N+1, 3, 3, B), (N+1, 3, B), (N, 3, B)
  const T *k, *K;           // (N, 3, B), (N, 3, 6, B)
  const T *d, *fqR, *fxi;   // nominal linearization (N, ..., B)
  So3Consts<T> c;
  T *oR, *oxi, *ou;         // new trajectory (N+1, ...), controls (N, 3, B)
  int N, B;
};

// Gap-closing rollout step (solvers/pipeline_so3.py so3_rollout_stage): the
// feedback on the deviation from the nominal, then
// x+ = x_next Exp(d) f(xbar)^-1 f(x_new).  (R, xi) hold the new state of
// stage t on entry and of stage t + 1 on exit; u gets the new control.  The
// nominal stage (Rt, xit, ut), its successor (Rn, xin), the gains (kt, Kt),
// the defect dd and the nominal evaluation (fqRt, fxit) come from the
// previous iterate.
template <typename T>
__device__ __forceinline__ void so3_rollout_stage(T* R, T* xi, T* u, const T* Rt, const T* xit,
                                                  const T* Rn, const T* xin, const T* ut,
                                                  const T* kt, const T* Kt, const T* dd,
                                                  const T* fqRt, const T* fxit,
                                                  const So3Consts<T>& c) {
  {
    T xs_err[6];
    {
      T Rtt[9], M[9];
      transpose3(Rtt, Rt);
      mat_mul<3, 3, 3>(M, Rtt, R);
      so3_log(xs_err, M);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) xs_err[3 + i] = xi[i] - xit[i];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      T s = Kt[r * 6] * xs_err[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += Kt[r * 6 + j] * xs_err[j];
      u[r] = (ut[r] + kt[r]) + s;
    }
  }
  T fqR[9], fxi[3];
  so3_dynamics_eval(fqR, fxi, R, xi, u, c);
  T E[9], Ra[9], Rb[9], Ft[9];
  so3_exp(E, dd);
  mat_mul<3, 3, 3>(Ra, Rn, E);
  transpose3(Ft, fqRt);
  mat_mul<3, 3, 3>(Rb, Ra, Ft);
  mat_mul<3, 3, 3>(R, Rb, fqR);
  so3_normalize(R);
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[i] = ((xin[i] + fxi[i]) - fxit[i]) + dd[3 + i];
}

// The entries of one stage in a thread's column: the nominal x_t and
// x_{t+1}, u_t, the gains, the nominal's defect and dynamics evaluation.
struct RolloutSo3Column {
  static constexpr int Rt = 0, xit = 9, Rn = 12, xin = 21, u = 24, k = 27, K = 30, d = 48,
                       fqR = 54, fxi = 63, n = 66;
};

template <typename T>
__device__ __forceinline__ void rollout_so3_copy(T* col, const RolloutSo3Args<T>& a, int t,
                                                 int b) {
  using C = RolloutSo3Column;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<9>(col + C::Rt * P, a.qR, t, B, b);
  copy_column<3>(col + C::xit * P, a.xi, t, B, b);
  copy_column<9>(col + C::Rn * P, a.qR, t + 1, B, b);
  copy_column<3>(col + C::xin * P, a.xi, t + 1, B, b);
  copy_column<3>(col + C::u * P, a.u, t, B, b);
  copy_column<3>(col + C::k * P, a.k, t, B, b);
  copy_column<18>(col + C::K * P, a.K, t, B, b);
  copy_column<6>(col + C::d * P, a.d, t, B, b);
  copy_column<9>(col + C::fqR * P, a.fqR, t, B, b);
  copy_column<3>(col + C::fxi * P, a.fxi, t, B, b);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kAheadThreads) rollout_so3_kernel(RolloutSo3Args<T> a) {
  using C = RolloutSo3Column;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x, bc = min(b, B - 1);
  const bool live = b < B;
  T* col = reinterpret_cast<T*>(smem) + threadIdx.x;  // slot s at col + s * C::n * P
  T R[9], xi[3];
  load<9>(R, lane<9>(a.qR, 0, B, bc));
  load<3>(xi, lane<3>(a.xi, 0, B, bc));
  if (live) {
    store<9>(lane<9>(a.oR, 0, B, b), R);
    store<3>(lane<3>(a.oxi, 0, B, b), xi);
  }
  rollout_so3_copy(col, a, 0, bc);
  for (int t = 0; t < N; ++t) {
    cp_async_wait_all();
    if (t + 1 < N) rollout_so3_copy(col + ((t + 1) & 1) * C::n * P, a, t + 1, bc);
    const T* cur = col + (t & 1) * C::n * P;
    const auto in = [&](int e) { return column(cur + e * P); };
    T Rt[9], xit[3], Rn[9], xin[3], ut[3], kt[3], Kt[18], dd[6], fqRt[9], fxit[3];
    load<9>(Rt, in(C::Rt));
    load<3>(xit, in(C::xit));
    load<9>(Rn, in(C::Rn));
    load<3>(xin, in(C::xin));
    load<3>(ut, in(C::u));
    load<3>(kt, in(C::k));
    load<18>(Kt, in(C::K));
    load<6>(dd, in(C::d));
    load<9>(fqRt, in(C::fqR));
    load<3>(fxit, in(C::fxi));
    T u[3];
    so3_rollout_stage(R, xi, u, Rt, xit, Rn, xin, ut, kt, Kt, dd, fqRt, fxit, a.c);
    if (live) {
      store<9>(lane<9>(a.oR, t + 1, B, b), R);
      store<3>(lane<3>(a.oxi, t + 1, B, b), xi);
      store<3>(lane<3>(a.ou, t, B, b), u);
    }
  }
}

// The rollout; with lin (its inputs the rollout's outputs), then B10's kernel
// on the new trajectory, both on stream s.
template <typename T>
int launch_rollout_so3(const RolloutSo3Args<T>& a, const LinearizeSo3Args<T>* lin,
                       cudaStream_t s) {
  constexpr size_t bytes = 2 * RolloutSo3Column::n * kAheadThreads * sizeof(T);
  if (cudaError_t e = cudaFuncSetAttribute(rollout_so3_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  rollout_so3_kernel<T><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (lin) linearize_so3_kernel<T><<<batch_grid(a.B, a.N), kThreads, 0, s>>>(*lin);
  return (int)cudaGetLastError();
}

}  // namespace traopt

using traopt::Scalar;

namespace {

traopt::So3Consts<Scalar> so3_consts(const void* J, const void* Jinv, const void* W1,
                                     const void* W2, const void* mgr, const void* mr,
                                     double dt, int pendulum) {
  using T = Scalar;
  return traopt::So3Consts<T>{(const T*)J, (const T*)Jinv, (const T*)W1, (const T*)W2,
                              (const T*)mgr, (const T*)mr, (T)dt, pendulum};
}

}  // namespace

extern "C" int TRAOPT_FN(linearize_so3)(
    const void* qR, const void* xi, const void* u, const void* RbiR,
    const void* xib, const void* J, const void* Jinv, const void* W1,
    const void* W2, const void* mgr, const void* mr, double dt, int pendulum,
    void* fqR, void* fxi, void* d, void* Fx, void* fu2, void* lx, void* lxx,
    void* l, int N, int B, int device, void* stream) {
  using T = Scalar;
  traopt::LinearizeSo3Args<T> a;
  a.qR = (const T*)qR; a.xi = (const T*)xi; a.u = (const T*)u;
  a.RbiR = (const T*)RbiR; a.xib = (const T*)xib;
  a.c = so3_consts(J, Jinv, W1, W2, mgr, mr, dt, pendulum);
  a.fqR = (T*)fqR; a.fxi = (T*)fxi; a.d = (T*)d; a.Fx = (T*)Fx;
  a.fu2 = (T*)fu2; a.lx = (T*)lx; a.lxx = (T*)lxx; a.l = (T*)l;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  traopt::linearize_so3_kernel<T>
      <<<traopt::batch_grid(B, N), traopt::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int TRAOPT_FN(riccati_so3)(
    const void* Fx, const void* fu2, const void* d, const void* lx,
    const void* lu, const void* lxx, const void* qR, const void* xi,
    const void* RbiR, const void* xib, const void* W1vN, const void* W2vN,
    const void* W1hN, const void* W2hN, const void* Luu, int pendulum, void* k,
    void* K, void* gvec, void* lN, int N, int B, int device, void* stream) {
  using T = Scalar;
  traopt::RiccatiSo3Args<T> a;
  a.Fx = (const T*)Fx; a.fu2 = (const T*)fu2; a.d = (const T*)d;
  a.lx = (const T*)lx; a.lu = (const T*)lu; a.lxx = (const T*)lxx;
  a.qR = (const T*)qR; a.xi = (const T*)xi;
  a.RbiR = (const T*)RbiR; a.xib = (const T*)xib;
  a.W1vN = (const T*)W1vN; a.W2vN = (const T*)W2vN;
  a.W1hN = (const T*)W1hN; a.W2hN = (const T*)W2hN; a.Luu = (const T*)Luu;
  a.pendulum = pendulum;
  a.k = (T*)k; a.K = (T*)K; a.gvec = (T*)gvec; a.lN = (T*)lN;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  return traopt::launch_riccati_so3<T>(a, (cudaStream_t)stream);
}

// The rollout alone when the new-linearization pointers are null, else B12.
extern "C" int TRAOPT_FN(rollout_so3)(
    const void* qR, const void* xi, const void* u, const void* k,
    const void* K, const void* d, const void* fqR, const void* fxi,
    const void* RbiR, const void* xib, const void* J, const void* Jinv,
    const void* W1, const void* W2, const void* mgr, const void* mr, double dt,
    int pendulum, void* oR, void* oxi, void* ou, void* nfqR, void* nfxi,
    void* nd, void* nFx, void* nfu2, void* nlx, void* nlxx, void* nl, int N,
    int B, int device, void* stream) {
  using T = Scalar;
  traopt::RolloutSo3Args<T> a;
  a.qR = (const T*)qR; a.xi = (const T*)xi; a.u = (const T*)u;
  a.k = (const T*)k; a.K = (const T*)K; a.d = (const T*)d;
  a.fqR = (const T*)fqR; a.fxi = (const T*)fxi;
  a.c = so3_consts(J, Jinv, W1, W2, mgr, mr, dt, pendulum);
  a.oR = (T*)oR; a.oxi = (T*)oxi; a.ou = (T*)ou;
  a.N = N; a.B = B;
  traopt::LinearizeSo3Args<T> l;
  l.qR = a.oR; l.xi = a.oxi; l.u = a.ou;
  l.RbiR = (const T*)RbiR; l.xib = (const T*)xib;
  l.c = a.c;
  l.fqR = (T*)nfqR; l.fxi = (T*)nfxi; l.d = (T*)nd; l.Fx = (T*)nFx;
  l.fu2 = (T*)nfu2; l.lx = (T*)nlx; l.lxx = (T*)nlxx; l.l = (T*)nl;
  l.N = N; l.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  return traopt::launch_rollout_so3<T>(a, nFx ? &l : nullptr, (cudaStream_t)stream);
}
