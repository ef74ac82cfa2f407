// The instances of B1, B2, B5 and B6 at any input dimension nu = 1 ...
// kMaxNu (pipeline_nu.cu: B1 and B2 in f32 and fp64; polish_nu.cu: B5 and
// B6; B3's and B4's rollout is nu_large.cuh's at every nu).  The tuned
// instances (pipeline.cu, linearize.cu, polish.cu) take nu = 6 or 4 as a
// template argument; these take nu at run time, each kernel in instances
// by a compile-time maximum MU (by_mu: 6 for nu <= 6, else 12; B2's
// by_mu_b2: 4 for nu <= 4, 6 for nu <= 6, else 12).  Each is its tuned
// twin's design: the same stage functions (stage.cuh, riccati_group.cuh,
// riccati_f64.cuh) at NU = MU, the same threads, groups and copy-ahead;
// only the loads and stores of the batch-last (N, nu, ...) arrays and the
// copies of their stages take nu at run time.  At MU = 12 B2 takes the
// steps' lean variants (kLean: Q_uu, and in fp64 fu2 and the factor, read
// from shared memory where used; the MU = 12 step spilled otherwise).
//
// The input dimensions nu .. MU - 1 are padding, set so that every product
// they enter is exactly zero: Pu and fu2 zero past column nu (copied padded
// into shared memory), Luu the identity past row nu, and u, k, K, l_u and
// the AL diagonal zero past row nu (zeroed in the registers or shared-memory
// rows that hold them, which the stage copies never write).  Q_uu is then
// block diagonal, diag(Q_uu(nu), I), its Cholesky factor diag(L, I), K and k
// vanish past row nu, and each entry of rows 0 .. nu - 1 is the nu-dimensional
// step's sum plus exact zeros: the kernels agree with their plain versions
// at nu as the tuned instances do at theirs.  The price is MU's arithmetic
// at every nu up to MU; the loops stay compile-time and branch-free (the
// step's loops stopped at the runtime nu ran slower: PERF.md, §6).
//
// What changes with MU = 12 beyond the arrays' sizes: the fp64 Riccati
// step's K^T and K^T Q_uu (24 NUP values a problem) and its factor no
// longer fit in the problem's spent l_xx row of the stage buffer (146
// values), so they take a region of their own after the groups' scratch
// (Layout64Nu).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ahead.cuh"
#include "common.cuh"
#include "group.cuh"
#include "linearize.cuh"
#include "pipeline.cuh"
#include "polish.cuh"
#include "riccati_f64.cuh"
#include "riccati_group.cuh"
#include "stage.cuh"

namespace traopt {

// The largest nu of these instances (nu_large.cuh takes nu past it).
constexpr int kMaxNu = 12;

// The instance of a runtime nu: MU = 6 for nu <= 6, else 12.
template <typename F>
int by_mu(int nu, F&& f) {
  if (nu < 1 || nu > kMaxNu) return (int)cudaErrorInvalidValue;
  return nu <= 6 ? f(std::integral_constant<int, 6>{}) : f(std::integral_constant<int, 12>{});
}

// B2's instance of a runtime nu: MU = 4 for nu <= 4, 6 for nu <= 6, else 12.
template <typename F>
int by_mu_b2(int nu, F&& f) {
  if (nu < 1 || nu > kMaxNu) return (int)cudaErrorInvalidValue;
  if (nu <= 4) return f(std::integral_constant<int, 4>{});
  return nu <= 6 ? f(std::integral_constant<int, 6>{}) : f(std::integral_constant<int, 12>{});
}

// A kernel's arguments and the runtime nu.
template <typename A>
struct NuArgs {
  A a;
  int nu;
};

// ---- loads, stores and copies with a runtime nu ----------------------------

// Entries 0 .. nu - 1 of stage t of a batch-last (N, nu, B) array for problem
// b into dst[0 .. MU), zero past nu.
template <int MU, typename T, typename S>
__device__ __forceinline__ void load_nu(T* dst, const S* src, int t, int nu, int B, int b) {
  const S* s = src + (long long)t * nu * B + b;
#pragma unroll
  for (int a = 0; a < MU; ++a) dst[a] = a < nu ? T(s[(long long)a * B]) : T(0);
}

// Rows 0 .. nu - 1 of stage t of a batch-last (N, nu, 12, B) gain array for
// problem b into K[0 .. 12 MU), zero past row nu.
template <int MU, typename T>
__device__ __forceinline__ void load_gains_nu(T* K, const T* src, int t, int nu, int B, int b) {
  const T* s = src + (long long)t * 12 * nu * B + b;
#pragma unroll
  for (int e = 0; e < 12 * MU; ++e) K[e] = e < 12 * nu ? s[(long long)e * B] : T(0);
}

// src[0 .. nu) into stage t of a batch-last (N, nu, B) array for problem b.
template <int MU, typename T>
__device__ __forceinline__ void store_nu(T* dst, const T* src, int t, int nu, int B, int b) {
  T* d = dst + (long long)t * nu * B + b;
#pragma unroll
  for (int a = 0; a < MU; ++a)
    if (a < nu) d[(long long)a * B] = src[a];
}

// Pu (6 x nu, row-major) as 6 x MU at dst (shared memory), zero past column
// nu; the block's threads share the copy and meet at a barrier.
template <int MU, typename T>
__device__ __forceinline__ void pad_pu(T* dst, const T* Pu, int nu) {
  for (int q = threadIdx.x; q < 6 * MU; q += blockDim.x) {
    const int i = q / MU, a = q % MU;
    dst[q] = a < nu ? Pu[i * nu + a] : T(0);
  }
  __syncthreads();
}

// The runtime-count copy_stage: entries 0 .. ne - 1 of stage t of the
// batch-last array src (N, ne, B) for the block's problems into dst, problem
// p's entry e at dst[p * pt + e].
template <typename T>
__device__ __forceinline__ void copy_stage_n(T* dst, const T* src, int ne, int pt, int t,
                                             int b0, int B, int tid) {
  for (int q = tid; q < ne * kProblems; q += kGroupThreads) {
    const int e = q / kProblems, p = q % kProblems;
    cp_async<sizeof(T)>(dst + p * pt + e, src + ((long long)t * ne + e) * B + min(b0 + p, B - 1));
  }
}

// The runtime-count copy_column: entries 0 .. ne - 1 of stage t of the
// batch-last array src (N, ne, B) for problem b into the column dst.
template <typename T>
__device__ __forceinline__ void copy_column_n(T* dst, const T* src, int ne, int t, int B, int b) {
  const T* s = src + (long long)t * ne * B + b;
  for (int e = 0; e < ne; ++e) cp_async<sizeof(T)>(dst + e * kAheadThreads, s + (long long)e * B);
}

// Zero entries nu .. MU - 1 of problem p's row of width pt at row, for the
// block's problems and both stage buffers (stride `stage` bytes apart).
template <int MU, typename T>
__device__ __forceinline__ void zero_rows_past_nu(unsigned char* row, size_t stage, int pt,
                                                  int nu, int tid) {
  for (int q = tid; q < 2 * kProblems * MU; q += kGroupThreads) {
    const int s = q / (kProblems * MU), p = (q / MU) % kProblems, e = q % MU;
    if (e >= nu) reinterpret_cast<T*>(row + s * stage)[p * pt + e] = T(0);
  }
}

// ---- B1 -------------------------------------------------------------------
// linearize_kernel at a runtime nu: u and Pu padded to MU (Pu in the block's
// shared memory, 6 MU values).
template <typename T, int MU>
__global__ void __launch_bounds__(kThreads) linearize_nu_kernel(NuArgs<LinearizeArgs<T>> x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LinearizeArgs<T>& a = x.a;
  T* const Pu = reinterpret_cast<T*>(smem);
  pad_pu<MU>(Pu, a.c.Pu, x.nu);
  Consts<T> c = a.c;
  c.Pu = Pu;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  T R[9], p[3], xi[6], u[MU];
  load<9>(R, lane<9>(a.qR, t, B, b));
  load<3>(p, lane<3>(a.qp, t, B, b));
  load<6>(xi, lane<6>(a.xi, t, B, b));
  load_nu<MU>(u, a.u, t, x.nu, B, b);

  T fqR[9], fqp[3], fxi[6];
  stage_dynamics_eval<T, MU>(fqR, fqp, fxi, R, p, xi, u, c);
  store<9>(lane<9>(a.fqR, t, B, b), fqR);
  store<3>(lane<3>(a.fqp, t, B, b), fqp);
  store<6>(lane<6>(a.fxi, t, B, b), fxi);
  {
    T Rn[9], pn[3], xin[6], d[12];
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    defect(d, Rn, pn, xin, fqR, fqp, fxi);
    store<12>(lane<12>(a.d, t, B, b), d);
  }
  stage_jacobian(lane<144>(a.Fx, t, B, b), R, xi, c);
  a.l[(long long)t * B + b] = stage_cost_quad<T>(
      lane<12>(a.lx, t, B, b), lane<144>(a.lxx, t, B, b), R, p, xi,
      a.refs.RbiR + t * 9, a.refs.Rbip + t * 3, a.refs.Adb + t * 36,
      a.refs.xib + t * 6, a.c.W1, a.c.W2);
}

template <typename T, int MU>
int launch_linearize_nu(const LinearizeArgs<T>& a, int nu, cudaStream_t s) {
  linearize_nu_kernel<T, MU><<<batch_grid(a.B, a.N), kThreads, 6 * MU * sizeof(T), s>>>(
      NuArgs<LinearizeArgs<T>>{a, nu});
  return (int)cudaGetLastError();
}

// ---- B2 (f32) and B5: the group Riccati kernels ----------------------------

// riccati_consts at a runtime nu: fu2 (6 x nu) in both types zero past column
// nu, Luu (nu x nu) the identity past row and column nu.
template <typename Tp, typename Tr, int MU>
__device__ __forceinline__ void riccati_consts_nu(unsigned char* smem, const Tp* fu2,
                                                  const Tr* fu2r, const Tp* Luu, int nu,
                                                  int tid) {
  using L = RiccatiLayout<Tp, Tr, MU>;
  for (int q = tid; q < 6 * MU; q += kGroupThreads) {
    const int i = q / MU, a = q % MU;
    reinterpret_cast<Tp*>(smem + L::ofu2)[i * L::NUP + a] = a < nu ? fu2[i * nu + a] : Tp(0);
    reinterpret_cast<Tr*>(smem + L::ofu2r)[i * L::NUR + a] = a < nu ? fu2r[i * nu + a] : Tr(0);
  }
  for (int q = tid; q < MU * MU; q += kGroupThreads) {
    const int i = q / MU, j = q % MU;
    reinterpret_cast<Tp*>(smem + L::oLuu)[i * L::NUP + j] =
        i < nu && j < nu ? Luu[i * nu + j] : Tp(i == j ? 1 : 0);
  }
}

// riccati_copy at a runtime nu.
template <typename Tp, typename Tr, int MU>
__device__ __forceinline__ void riccati_copy_nu(unsigned char* buf, const Tr* Fx, const Tr* d,
                                                const Tr* lx, const Tr* lu, const Tp* lxx,
                                                const Tp* luual, int nu, int t, int b0, int B,
                                                int tid) {
  using L = RiccatiLayout<Tp, Tr, MU>;
  copy_stage<144, false>(reinterpret_cast<Tr*>(buf + L::oF), Fx, t, b0, B, tid);
  copy_stage<12, false>(reinterpret_cast<Tr*>(buf + L::od), d, t, b0, B, tid);
  copy_stage<12, false>(reinterpret_cast<Tr*>(buf + L::olx), lx, t, b0, B, tid);
  copy_stage_n(reinterpret_cast<Tr*>(buf + L::olu), lu, nu, L::pu, t, b0, B, tid);
  copy_stage<144, true>(reinterpret_cast<Tp*>(buf + L::oxx), lxx, t, b0, B, tid);
  if (luual) copy_stage_n(reinterpret_cast<Tp*>(buf + L::oal), luual, nu, L::pal, t, b0, B, tid);
}

// riccati_store at a runtime nu: rows 0 .. nu - 1 of K, k and gvec.
template <typename Tp, typename Tr, int MU>
__device__ __forceinline__ void riccati_store_nu(Tp* K, Tp* k, Tr* gvec, const unsigned char* buf,
                                                 int nu, int t, int b0, int B, int tid) {
  using L = RiccatiLayout<Tp, Tr, MU>;
  store_stage_rows(K, reinterpret_cast<const Tp*>(buf + L::oK), 12 * nu, t, b0, B, tid);
  store_stage_rows(k, reinterpret_cast<const Tp*>(buf + L::ok), nu, t, b0, B, tid);
  store_stage_rows(gvec, reinterpret_cast<const Tr*>(buf + L::og), nu, t, b0, B, tid);
}

// riccati_group_sweep at a runtime nu: the rows of l_u and of the AL
// diagonal past nu are zeroed once in both stage buffers (the copies write
// entries 0 .. nu - 1 only); kLean: riccati_group_step's.
template <typename Tp, typename Tr, int MU, bool kLean = false>
__device__ __forceinline__ void riccati_group_sweep_nu(
    unsigned char* smem, int N, int B, int nu, Tp (&V)[12], Tr& Vx, const Tr* Fx, const Tr* d,
    const Tr* lx, const Tr* lu, const Tp* lxx, const Tp* luual, bool glow, Tp* K, Tp* k,
    Tr* gvec) {
  using L = RiccatiLayout<Tp, Tr, MU>;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int b0 = blockIdx.x * kProblems;
  unsigned char* stage = smem + L::ostage;
  unsigned char* outb = smem + L::oout;
  auto& gs = *reinterpret_cast<GroupScratch<Tp, Tr, MU>*>(smem + L::ogroup + g * L::gstride);
  zero_rows_past_nu<MU, Tr>(stage + L::olu, L::stage, L::pu, nu, tid);
  zero_rows_past_nu<MU, Tp>(stage + L::oal, L::stage, L::pal, nu, tid);
  riccati_copy_nu<Tp, Tr, MU>(stage, Fx, d, lx, lu, lxx, luual, nu, N - 1, b0, B, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      riccati_copy_nu<Tp, Tr, MU>(stage + (cur ^ 1) * L::stage, Fx, d, lx, lu, lxx, luual, nu,
                                  t - 1, b0, B, tid);
      cp_async_commit();
    }
    if (t < N - 1)
      riccati_store_nu<Tp, Tr, MU>(K, k, gvec, outb + ((t + 1) & 1) * L::out, nu, t + 1, b0, B,
                                   tid);
    riccati_group_step<Tp, Tr, MU, kLean>(
        r, V, Vx, stage_in<Tp, Tr, MU>(stage + cur * L::stage, g, luual != nullptr),
        reinterpret_cast<const Tp*>(smem + L::ofu2), reinterpret_cast<const Tr*>(smem + L::ofu2r),
        reinterpret_cast<const Tp*>(smem + L::oLuu), glow, gs,
        stage_out<Tp, Tr, MU>(outb + (t & 1) * L::out, g));
  }
  __syncthreads();
  riccati_store_nu<Tp, Tr, MU>(K, k, gvec, outb, nu, 0, b0, B, tid);
}

// B2 in f32 at a runtime nu (pipeline.cu riccati_kernel).
template <typename T, int MU>
__global__ void __launch_bounds__(kGroupThreads) riccati_nu_kernel(NuArgs<RiccatiArgs<T>> x) {
  using L = RiccatiLayout<T, T, MU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiArgs<T>& a = x.a;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * kProblems + g;
  riccati_consts_nu<T, T, MU>(smem, a.c.fu2, a.c.fu2, a.c.Luu, x.nu, tid);
  auto& gs = *reinterpret_cast<GroupScratch<T, T, MU>*>(smem + L::ogroup + g * L::gstride);
  if (r == 0) {
    // the terminal quadratization into the group's scratch (problems past B
    // take problem B - 1's)
    const int bc = min(b, B - 1);
    T R[9], p[3], xi[6];
    load<9>(R, lane<9>(a.qR, N, B, bc));
    load<3>(p, lane<3>(a.qp, N, B, bc));
    load<6>(xi, lane<6>(a.xi, N, B, bc));
    const T l = stage_cost_quad<T, FramelessTrig>(
        &gs.Vm[0], &gs.VS[0], R, p, xi, a.refs.RbiR + N * 9, a.refs.Rbip + N * 3,
        a.refs.Adb + N * 36, a.refs.xib + N * 6, a.c.W1N, a.c.W2N);
    if (b < B) a.lN[b] = l;
  }
  __syncwarp();
  T V[12], Vx = T(0);
#pragma unroll
  for (int j = 0; j < 12; ++j) V[j] = T(0);
  if (r < 12) {
    lds<T, 12>(V, gs.VS + r * 12);
    Vx = gs.Vm[r];
  }
  riccati_group_sweep_nu<T, T, MU, (MU > 6)>(smem, N, B, x.nu, V, Vx, a.Fx, a.d, a.lx, a.lu,
                                             a.lxx, a.luual, a.glow != 0, a.K, a.k, a.gvec);
}

// B5 at a runtime nu (polish.cu riccati_mx_kernel).
template <int MU>
__global__ void __launch_bounds__(kGroupThreads) riccati_mx_nu_kernel(NuArgs<RiccatiMxArgs> x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiMxArgs& a = x.a;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B;
  const int bc = min(int(blockIdx.x) * kProblems + g, B - 1);  // past B: problem B - 1's
  riccati_consts_nu<float, double, MU>(smem, a.fu2_32, a.fu2, a.Luu, x.nu, tid);
  float V[12];
  double Vx = 0.0;
#pragma unroll
  for (int j = 0; j < 12; ++j) V[j] = 0.f;
  if (r < 12) {
    Vx = a.VxN[(long long)r * B + bc];
#pragma unroll
    for (int j = 0; j < 12; ++j) V[j] = a.VxxN[((long long)r * 12 + j) * B + bc];
  }
  riccati_group_sweep_nu<float, double, MU>(smem, a.N, B, x.nu, V, Vx, a.Fx, a.d, a.lx, a.lu,
                                            a.lxx, a.luual, a.glow != 0, a.K, a.k, a.gvec);
}

// ---- B2 in fp64 -------------------------------------------------------------

// Layout64 at MU, with K^T and K^T Q_uu in a region of their own after the
// groups' scratch where they outgrow the l_xx row (MU = 12), and there
// after them the factor of Q_uu (MU x NUP, riccati_f64_step's Ls: the lean
// step's, MU = 12).
template <int MU>
struct Layout64Nu : Layout64<MU> {
  using Base = Layout64<MU>;
  static constexpr bool kAside = 24 * Base::NUP > Base::pF;
  static constexpr size_t oaside = Base::bytes,
                          astride = group_stride((24 + MU) * Base::NUP * sizeof(double)),
                          bytes = Base::bytes + (kAside ? Base::P * astride : 0);
};

// riccati_f64_copy at a runtime nu.
template <int MU>
__device__ __forceinline__ void riccati_f64_copy_nu(unsigned char* buf, const double* Fx,
                                                    const double* d, const double* lx,
                                                    const double* lu, const double* lxx,
                                                    const double* luual, int nu, int t, int b0,
                                                    int B, int tid) {
  using L = Layout64<MU>;
  const auto at = [&](size_t o) { return reinterpret_cast<double*>(buf + o); };
  copy_stage<144, false, L::pF>(at(L::oF), Fx, t, b0, B, tid);
  copy_stage<12, false, L::pd>(at(L::od), d, t, b0, B, tid);
  copy_stage<12, false, L::pd>(at(L::olx), lx, t, b0, B, tid);
  copy_stage_n(at(L::olu), lu, nu, L::pu, t, b0, B, tid);
  copy_stage<144, true, L::pF>(at(L::oxx), lxx, t, b0, B, tid);
  if (luual) copy_stage_n(at(L::oal), luual, nu, L::pu, t, b0, B, tid);
}

// riccati_f64_sweep at a runtime nu.
template <int MU>
__device__ __forceinline__ void riccati_f64_sweep_nu(unsigned char* smem, int N, int B, int nu,
                                                     double& Vx, const double* Fx,
                                                     const double* d, const double* lx,
                                                     const double* lu, const double* lxx,
                                                     const double* luual, bool glow, double* K,
                                                     double* k, double* gvec) {
  using L = Layout64Nu<MU>;
  const int tid = threadIdx.x, g = tid / kGroup, l = tid % kGroup;
  const int b0 = blockIdx.x * kProblems;
  zero_rows_past_nu<MU, double>(smem + L::ostage + L::olu, L::stage, L::pu, nu, tid);
  zero_rows_past_nu<MU, double>(smem + L::ostage + L::oal, L::stage, L::pu, nu, tid);
  riccati_f64_copy_nu<MU>(smem + L::ostage, Fx, d, lx, lu, lxx, luual, nu, N - 1, b0, B, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    // every address derived anew each stage (opaque_zero)
    const int z = opaque_zero(), cur = (N - 1 - t) & 1;
    unsigned char* sm = smem + z;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      riccati_f64_copy_nu<MU>(sm + L::ostage + (cur ^ 1) * L::stage, Fx, d, lx, lu, lxx, luual,
                              nu, t - 1 + z, b0, B, tid + z);
      cp_async_commit();
    }
    if (t < N - 1)
      riccati_store_nu<double, double, MU>(K, k, gvec, sm + L::oout + ((t + 1) & 1) * L::out,
                                           nu, t + 1 + z, b0, B, tid + z);
    unsigned char* buf = sm + L::ostage + cur * L::stage;
    const auto row = [&](size_t o, int pt) { return reinterpret_cast<double*>(buf + o) + g * pt; };
    double* F = row(L::oF, L::pF);
    double* dr = row(L::od, L::pd);
    double* lxxT = row(L::oxx, L::pF);
    double* KT = L::kAside ? reinterpret_cast<double*>(sm + L::oaside + g * L::astride) : lxxT;
    const StageIn<double, double> in{F, dr, row(L::olx, L::pd), row(L::olu, L::pu), lxxT,
                                     luual ? row(L::oal, L::pu) : nullptr};
    riccati_f64_step<MU, L::kAside>(
        l, Vx, in, F, KT, dr, reinterpret_cast<const double*>(sm + L::ofu2),
        reinterpret_cast<const double*>(sm + L::oLuu), glow,
        *reinterpret_cast<Scratch64<MU>*>(sm + L::ogroup + g * L::gstride),
        stage_out<double, double, MU>(sm + L::oout + (t & 1) * L::out, g), KT + 24 * L::NUP);
  }
  __syncthreads();
  riccati_store_nu<double, double, MU>(K, k, gvec, smem + L::oout, nu, 0, b0, B, tid);
}

// B2 in fp64 at a runtime nu, phase 2 (pipeline.cu riccati_f64_kernel): the
// terminal carry from the (48, B) hand-off array that terminal_kernel<double>
// filled (phase 1), then the stage loop.
struct RiccatiF64NuArgs {
  RiccatiArgs<double> a;
  int nu;
  const double* hand;
};

template <int MU>
__global__ void __launch_bounds__(kGroupThreads) riccati_f64_nu_kernel(RiccatiF64NuArgs x) {
  using L = Layout64Nu<MU>;
  constexpr int NUP = L::NUP;
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiArgs<double>& a = x.a;
  const int nu = x.nu;
  const int tid = threadIdx.x, g = tid / kGroup, l = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * kProblems + g;
  for (int q = tid; q < 6 * MU; q += kGroupThreads) {
    const int i = q / MU, c = q % MU;
    reinterpret_cast<double*>(smem + L::ofu2)[i * NUP + c] = c < nu ? a.c.fu2[i * nu + c] : 0.0;
  }
  for (int q = tid; q < MU * MU; q += kGroupThreads) {
    const int i = q / MU, j = q % MU;
    reinterpret_cast<double*>(smem + L::oLuu)[i * NUP + j] =
        i < nu && j < nu ? a.c.Luu[i * nu + j] : (i == j ? 1.0 : 0.0);
  }
  auto& gs = *reinterpret_cast<Scratch64<MU>*>(smem + L::ogroup + g * L::gstride);
  if (l < 12) {
    // problems past B take problem B - 1's terminal stage
    const Lane<const double> k0 = lane<48>(x.hand, 0, B, min(b, B - 1));
    gs.Vm[l] = k0[l];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      gs.VS[l * 12 + j] = l < 6 ? k0[12 + l * 6 + j] : 0.0;
      gs.VS[l * 12 + 6 + j] = l < 6 ? 0.0 : 2.0 * a.c.W2N[(l - 6) * 6 + j];
    }
  }
  __syncwarp();
  double Vx = gs.Vm[l < 12 ? l : 11];
  riccati_f64_sweep_nu<MU>(smem, N, B, nu, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx, a.luual,
                           a.glow != 0, a.K, a.k, a.gvec);
}

// B2 at a runtime nu on stream s; in fp64 its two phases, the terminal
// quadratization into `hand` (48, B) and the stage loop.
template <typename T, int MU>
int launch_riccati_nu(const RiccatiArgs<T>& a, int nu, T* hand, cudaStream_t s) {
  if constexpr (std::is_same<T, double>::value) {
    if (!hand) return (int)cudaErrorInvalidValue;
    constexpr size_t bytes = Layout64Nu<MU>::bytes;
    if (int e = set_smem(riccati_f64_nu_kernel<MU>, bytes, true)) return e;
    RiccatiArgs<double> t = a;
    t.K = hand;
    terminal_kernel<double><<<batch_grid(a.B), kThreads, 0, s>>>(t);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    riccati_f64_nu_kernel<MU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(
        RiccatiF64NuArgs{a, nu, hand});
  } else {
    constexpr size_t bytes = RiccatiLayout<T, T, MU>::bytes;
    if (int e = set_smem(riccati_nu_kernel<T, MU>, bytes, false)) return e;
    riccati_nu_kernel<T, MU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(
        NuArgs<RiccatiArgs<T>>{a, nu});
  }
  return (int)cudaGetLastError();
}

// B5 at a runtime nu on stream s.
template <int MU>
int launch_riccati_mx_nu(const RiccatiMxArgs& a, int nu, cudaStream_t s) {
  constexpr size_t bytes = RiccatiLayout<float, double, MU>::bytes;
  if (int e = set_smem(riccati_mx_nu_kernel<MU>, bytes, false)) return e;
  riccati_mx_nu_kernel<MU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(
      NuArgs<RiccatiMxArgs>{a, nu});
  return (int)cudaGetLastError();
}

// ---- B6 ---------------------------------------------------------------------
// polish.cu rollout_mx_kernel at a runtime nu: u, k and K zero past nu, Pu
// padded in the block's shared memory.
template <int MU>
__global__ void __launch_bounds__(kThreads) rollout_mx_nu_kernel(NuArgs<RolloutMxArgs> x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RolloutMxArgs& a = x.a;
  const int nu = x.nu;
  double* const Pu = reinterpret_cast<double*>(smem);
  pad_pu<MU>(Pu, a.c.Pu, nu);
  Consts<double> c = a.c;
  c.Pu = Pu;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  double R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, b));
  load<3>(p, lane<3>(a.qp, 0, B, b));
  load<6>(xi, lane<6>(a.xi, 0, B, b));
  store<9>(lane<9>(a.oR, 0, B, b), R);
  store<3>(lane<3>(a.op, 0, B, b), p);
  store<6>(lane<6>(a.oxi, 0, B, b), xi);
  for (int t = 0; t < N; ++t) {
    double Rt[9], pt[3], xit[6], Rn[9], pn[3], xin[6], ut[MU];
    double dd[12], fqRt[9], fqpt[3], fxit[6];
    float kt[MU], Kt[MU * 12];
    load<9>(Rt, lane<9>(a.qR, t, B, b));
    load<3>(pt, lane<3>(a.qp, t, B, b));
    load<6>(xit, lane<6>(a.xi, t, B, b));
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    load_nu<MU>(ut, a.u, t, nu, B, b);
    load_nu<MU>(kt, a.k, t, nu, B, b);
    load_gains_nu<MU>(Kt, a.K, t, nu, B, b);
    load<12>(dd, lane<12>(a.d, t, B, b));
    load<9>(fqRt, lane<9>(a.fqR, t, B, b));
    load<3>(fqpt, lane<3>(a.fqp, t, B, b));
    load<6>(fxit, lane<6>(a.fxi, t, B, b));
    double u[MU], fqR[9], fqp[3], fxi[6];
    rollout_stage<double, float, MU>(R, p, xi, u, fqR, fqp, fxi, Rt, pt, xit, Rn, pn, xin, ut,
                                     kt, Kt, dd, fqRt, fqpt, fxit, c);
    store<9>(lane<9>(a.oR, t + 1, B, b), R);
    store<3>(lane<3>(a.op, t + 1, B, b), p);
    store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
    store_nu<MU>(a.ou, u, t, nu, B, b);
    store<9>(lane<9>(a.efqR, t, B, b), fqR);
    store<3>(lane<3>(a.efqp, t, B, b), fqp);
    store<6>(lane<6>(a.efxi, t, B, b), fxi);
  }
}

template <int MU>
int launch_rollout_mx_nu(const RolloutMxArgs& a, int nu, cudaStream_t s) {
  rollout_mx_nu_kernel<MU><<<batch_grid(a.B), kThreads, 6 * MU * sizeof(double), s>>>(
      NuArgs<RolloutMxArgs>{a, nu});
  return (int)cudaGetLastError();
}

}  // namespace traopt
