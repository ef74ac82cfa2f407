// Kernels B2 (Riccati backward), B3 (rollout, then the linearization of the
// new trajectory) and B4 (rollout) of the MS-iLQR pipeline.
//
// All three are sequential recursions over the N stages of one problem.  The
// TPU kernels carried the recursion across a sequential grid axis with the
// carry in VMEM scratch; on the GPU blocks run in no order, so the stage loop
// moves inside the block.  B3 and B4 run one problem per thread on blocks of
// one warp with the carry in registers (ahead.cuh), B3 then B1's kernel on
// the new trajectory; B2 runs one problem per group of 16 threads
// (riccati_group.cuh).  The fp64 instances (the refiner's fp64 phase,
// solvers/df_pipeline.py DFPipelineSolver.refine) have designs of their own,
// riccati_f64_kernel (riccati_f64.cuh) and rollout_f64_kernel: the f32
// designs, compiled in double, spilled and left two blocks an SM.  Both
// take lie.cuh's sin and cos in double (TRAOPT_F64_TRIG), which keep no
// stack frame.
#define TRAOPT_F64_TRIG
#include <type_traits>

#include "ahead.cuh"
#include "common.cuh"
#include "linearize.cuh"
#include "riccati_f64.cuh"
#include "riccati_group.cuh"
#include "stage.cuh"

namespace traopt {

// ---- B2 ------------------------------------------------------------------
// Replaces solvers/pipeline.py::_riccati_kernel_const (PallasPipelineSolver
// ._backward_lane).  Defect-aware Riccati backward with const Fu = [0; fu2]
// and Luu = 2R, Lux = 0, the terminal quadratization computed in-kernel,
// an unrolled nu x nu Cholesky and the optional AL diagonal on Quu.
// What bounds it on an H100: its bytes (Fx and l_xx, 288 values per problem
// and stage, read once) would take 0.79 ms at B = 8192 in f32 (3.15 ms at
// B = 16384 in fp64); its ~10 k operations per problem and stage, if each
// thread ran a whole problem, keep ~500 values live (V_xx, V_xx F, Q_xx,
// Q_ux, K), which spill to local memory that does not fit in L2.  The
// design: a group of 16 threads per problem and 8 problems per block
// (B / 8 blocks, 1,024 at B = 8192), lane r keeps row r of V_xx in
// registers and the group exchanges V_xx F, S and M through its slice of
// shared memory; the block copies stage t - 1's inputs into shared memory
// (cp.async) while it computes stage t, and stages its outputs there to
// store them coalesced over its problems.  In f32 (and in B5) the step is
// riccati_group_step.  In fp64 it is riccati_f64_step (riccati_f64.cuh):
// the f32 step compiled in double was bound by its shared-memory loads
// (every lane reads all of F twice a stage, at twice f32's bytes) and
// spilled; riccati_f64_step gives each lane a 3 x 3 block of every 12 x 12
// product (half the loads), and the terminal quadratization runs first in
// terminal_kernel, a thread a problem, so that the stage loop's kernel
// carries no transcendental functions.
template <typename T>
struct RiccatiArgs {
  const T *Fx, *d, *lx, *lu, *lxx, *luual;  // (N, ..., B); luual may be null
  const T *qR, *qp, *xi;                    // (N+1, ..., B): terminal state
  Refs<T> refs;
  Consts<T> c;
  int glow;
  T *k, *K, *gvec, *lN;  // (N, nu, B), (N, nu, 12, B), (N, nu, B), (B,)
  int N, B;
};

template <typename T, int NU>
__global__ void __launch_bounds__(kGroupThreads) riccati_kernel(RiccatiArgs<T> a) {
  using L = RiccatiLayout<T, T, NU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * kProblems + g;
  riccati_consts<T, T, NU>(smem, a.c.fu2, a.c.fu2, a.c.Luu, tid);
  auto& gs = *reinterpret_cast<GroupScratch<T, T, NU>*>(smem + L::ogroup + g * L::gstride);
  if (r == 0) {
    // the terminal quadratization into the group's scratch (problems past B
    // take problem B - 1's)
    const int bc = min(b, B - 1);
    T R[9], p[3], xi[6];
    load<9>(R, lane<9>(a.qR, N, B, bc));
    load<3>(p, lane<3>(a.qp, N, B, bc));
    load<6>(xi, lane<6>(a.xi, N, B, bc));
    const T l = stage_cost_quad<T>(&gs.Vm[0], &gs.VS[0], R, p, xi, a.refs.RbiR + N * 9,
                                   a.refs.Rbip + N * 3, a.refs.Adb + N * 36,
                                   a.refs.xib + N * 6, a.c.W1N, a.c.W2N);
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
  riccati_group_sweep<T, T, NU>(smem, N, B, V, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx, a.luual,
                                a.glow != 0, a.K, a.k, a.gvec);
}

// B2 in fp64, phase 1: the terminal quadratization (stage_cost_quad at
// stage N), a thread a problem, into K's stage-0 entries of the problem:
// l_x in entries 0..11, the top-left 6 x 6 block of l_xx in 12..47 (its other
// blocks are 0 and 2 W2N).  Phase 2 reads them first and writes K's stage 0
// last.
// (A template, so that only the fp64 library, which launches it, compiles
// it.)
template <typename T>
struct TerminalLxx {
  Lane<T> k;
  mutable T sink;  // the blocks phase 2 rebuilds
  __device__ __forceinline__ T& operator[](int e) const {
    return e / 12 < 6 && e % 12 < 6 ? k[12 + (e / 12) * 6 + e % 12] : sink;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) terminal_kernel(RiccatiArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, N, B, b));
  load<3>(p, lane<3>(a.qp, N, B, b));
  load<6>(xi, lane<6>(a.xi, N, B, b));
  const Lane<T> k0 = lane<48>(a.K, 0, B, b);
  a.lN[b] = stage_cost_quad<T>(k0, TerminalLxx<T>{k0, T(0)}, R, p, xi, a.refs.RbiR + N * 9,
                               a.refs.Rbip + N * 3, a.refs.Adb + N * 36, a.refs.xib + N * 6,
                               a.c.W1N, a.c.W2N);
}

// B2 in fp64, phase 2 (riccati_f64.cuh): the carry of stage N from phase 1
// (V_xx = l_xx into the group's VS, V_x = l_x), then the stage loop.
template <int NU>
__global__ void __launch_bounds__(kGroupThreads) riccati_f64_kernel(RiccatiArgs<double> a) {
  using L = Layout64<NU>;
  constexpr int NUP = L::NUP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, l = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * kProblems + g;
  for (int q = tid; q < 6 * NU; q += kGroupThreads)
    reinterpret_cast<double*>(smem + L::ofu2)[(q / NU) * NUP + q % NU] = a.c.fu2[q];
  for (int q = tid; q < NU * NU; q += kGroupThreads)
    reinterpret_cast<double*>(smem + L::oLuu)[(q / NU) * NUP + q % NU] = a.c.Luu[q];
  auto& gs = *reinterpret_cast<Scratch64<NU>*>(smem + L::ogroup + g * L::gstride);
  if (l < 12) {
    // problems past B take problem B - 1's terminal stage
    const Lane<const double> k0 = lane<48>(static_cast<const double*>(a.K), 0, B, min(b, B - 1));
    gs.Vm[l] = k0[l];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      gs.VS[l * 12 + j] = l < 6 ? k0[12 + l * 6 + j] : 0.0;
      gs.VS[l * 12 + 6 + j] = l < 6 ? 0.0 : 2.0 * a.c.W2N[(l - 6) * 6 + j];
    }
  }
  __syncwarp();
  double Vx = gs.Vm[l < 12 ? l : 11];
  riccati_f64_sweep<NU>(smem, N, B, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx, a.luual, a.glow != 0,
                        a.K, a.k, a.gvec);
}

// Let a kernel take `bytes` of dynamic shared memory, with the SM's
// carve-out all shared memory (B2 and the rollout in fp64 fit three and four
// blocks an SM only so).
template <typename K>
int set_smem(K kernel, size_t bytes, bool carveout) {
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  if (carveout)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     100);
  return 0;
}

template <typename T, int NU>
int launch_riccati(const RiccatiArgs<T>& a, cudaStream_t s) {
  if constexpr (std::is_same<T, double>::value) {
    constexpr size_t bytes = Layout64<NU>::bytes;
    if (int e = set_smem(riccati_f64_kernel<NU>, bytes, true)) return e;
    terminal_kernel<double><<<batch_grid(a.B), kThreads, 0, s>>>(a);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    riccati_f64_kernel<NU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(a);
  } else {
    constexpr size_t bytes = RiccatiLayout<T, T, NU>::bytes;
    if (int e = set_smem(riccati_kernel<T, NU>, bytes, false)) return e;
    riccati_kernel<T, NU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// ---- B3 and B4 -------------------------------------------------------------
// B4 replaces solvers/pipeline.py::_rollout_kernel_lane (._rollout_lane),
// B3 replaces solvers/pipeline.py::_rollout_linearize_kernel
// (._rollout_linearize_lane): the same gap-closing rollout, and in B3 the
// linearization of every stage of the new trajectory.
// What bounds them on an H100: B4 reads ~150 values and writes ~24 per stage
// and problem, in a chain of dependent steps (Log, the feedback, Exp, three
// compositions) serial over the stages; B3 adds B1's outputs (Fx, lxx: 288
// values per stage), store-bound.  The TPU kernel computed the linearization
// of stage t inside the rollout's stage loop; here B3 runs in two phases on
// the caller's stream: the rollout (B4's kernel), then B1's kernel on the new
// trajectory, a thread per (problem, stage), so the linearization's stores no
// longer wait behind the rollout's chain.  Both compute what the fused loop
// did (the same stage functions on the same values).  The rollout runs one
// problem per thread on blocks of one warp (ahead.cuh: B / 32 blocks) with
// the carry (R, p, xi) in registers, and copies stage t + 1's inputs into
// shared memory while it computes stage t: in f32 rollout_kernel, in fp64
// rollout_f64_kernel (below).
template <typename T>
struct RolloutArgs {
  const T *qR, *qp, *xi, *u;      // nominal trajectory (N+1, ...) and (N, nu, B)
  const T *k, *K;                 // gains (N, nu, B), (N, nu, 12, B)
  const T *d, *fqR, *fqp, *fxi;   // nominal linearization (N, ..., B)
  Consts<T> c;
  T *oR, *op, *oxi, *ou;          // new trajectory (N+1, ...), controls (N, nu, B)
  int N, B;
};

// The entries of one stage in a thread's column: the nominal x_t and
// x_{t+1}, u_t, the gains, the nominal's defect and dynamics evaluation.
template <int NU>
struct RolloutColumn {
  static constexpr int Rt = 0, pt = 9, xit = 12, Rn = 18, pn = 27, xin = 30, u = 36,
                       k = u + NU, K = k + NU, d = K + 12 * NU, fqR = d + 12, fqp = fqR + 9,
                       fxi = fqp + 3, n = fxi + 6;
};

template <typename T, int NU>
constexpr size_t rollout_bytes() {
  return 2 * RolloutColumn<NU>::n * kAheadThreads * sizeof(T);
}

template <typename T, int NU>
__device__ __forceinline__ void rollout_copy(T* col, const RolloutArgs<T>& a, int t, int b) {
  using C = RolloutColumn<NU>;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<9>(col + C::Rt * P, a.qR, t, B, b);
  copy_column<3>(col + C::pt * P, a.qp, t, B, b);
  copy_column<6>(col + C::xit * P, a.xi, t, B, b);
  copy_column<9>(col + C::Rn * P, a.qR, t + 1, B, b);
  copy_column<3>(col + C::pn * P, a.qp, t + 1, B, b);
  copy_column<6>(col + C::xin * P, a.xi, t + 1, B, b);
  copy_column<NU>(col + C::u * P, a.u, t, B, b);
  copy_column<NU>(col + C::k * P, a.k, t, B, b);
  copy_column<12 * NU>(col + C::K * P, a.K, t, B, b);
  copy_column<12>(col + C::d * P, a.d, t, B, b);
  copy_column<9>(col + C::fqR * P, a.fqR, t, B, b);
  copy_column<3>(col + C::fqp * P, a.fqp, t, B, b);
  copy_column<6>(col + C::fxi * P, a.fxi, t, B, b);
  cp_async_commit();
}

template <typename T, int NU>
__global__ void __launch_bounds__(kAheadThreads) rollout_kernel(RolloutArgs<T> a) {
  using C = RolloutColumn<NU>;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x, bc = min(b, B - 1);
  const bool live = b < B;
  T* col = reinterpret_cast<T*>(smem) + threadIdx.x;  // slot s at col + s * C::n * P
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, bc));
  load<3>(p, lane<3>(a.qp, 0, B, bc));
  load<6>(xi, lane<6>(a.xi, 0, B, bc));
  if (live) {
    store<9>(lane<9>(a.oR, 0, B, b), R);
    store<3>(lane<3>(a.op, 0, B, b), p);
    store<6>(lane<6>(a.oxi, 0, B, b), xi);
  }
  rollout_copy<T, NU>(col, a, 0, bc);
  for (int t = 0; t < N; ++t) {
    cp_async_wait_all();
    if (t + 1 < N) rollout_copy<T, NU>(col + ((t + 1) & 1) * C::n * P, a, t + 1, bc);
    const T* cur = col + (t & 1) * C::n * P;
    const auto in = [&](int e) { return column(cur + e * P); };
    T Rt[9], pt[3], xit[6], Rn[9], pn[3], xin[6], ut[NU], kt[NU], Kt[NU * 12];
    T dd[12], fqRt[9], fqpt[3], fxit[6];
    load<9>(Rt, in(C::Rt));
    load<3>(pt, in(C::pt));
    load<6>(xit, in(C::xit));
    load<9>(Rn, in(C::Rn));
    load<3>(pn, in(C::pn));
    load<6>(xin, in(C::xin));
    load<NU>(ut, in(C::u));
    load<NU>(kt, in(C::k));
    load<NU * 12>(Kt, in(C::K));
    load<12>(dd, in(C::d));
    load<9>(fqRt, in(C::fqR));
    load<3>(fqpt, in(C::fqp));
    load<6>(fxit, in(C::fxi));
    T u[NU], fqR[9], fqp[3], fxi[6];
    rollout_stage<T, T, NU>(R, p, xi, u, fqR, fqp, fxi, Rt, pt, xit, Rn, pn,
                            xin, ut, kt, Kt, dd, fqRt, fqpt, fxit, a.c);
    if (live) {
      store<9>(lane<9>(a.oR, t + 1, B, b), R);
      store<3>(lane<3>(a.op, t + 1, B, b), p);
      store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
      store<NU>(lane<NU>(a.ou, t, B, b), u);
    }
  }
}

// The rollout in fp64.  rollout_kernel compiled in double loaded a stage's
// ~150 column entries into registers (300 of them) and spilled, and its two
// 150-entry slots, 76.8 KB a block at nu = 6, left two blocks (two warps) an
// SM: B = 16384's 512 blocks ran in two waves over 132 SMs.  This design
// keeps a thread's column to 210 entries (53.8 KB a block at nu = 6, 45.6 KB
// at nu = 4: four and five blocks an SM, B = 16384 in one wave) by copying each
// entry once: the nominal states x_t in a ring of three slots (stage t
// reads x_t and x_{t+1}, the copy brings x_{t+2}), K_t, the largest entry
// (12 nu values), in one slot that takes K_{t+1} as soon as the feedback
// has read K_t, and the rest of a stage in two slots.  It reads the column
// where an entry is used, not into register arrays, and computes the
// carry-independent compositions, x_t^-1 and G_t = (x_{t+1} Exp(d_q))
// f(xbar_t)^-1, first, off the carry's chain (B14's order): the same
// functions in the same order as rollout_stage.  Its addresses are derived
// anew each stage (opaque_zero), not held in registers across the loop.
template <int NU>
struct RolloutF64Column {
  // a stage slot: u_t, k_t, the defect d_t, the nominal's evaluation
  static constexpr int u = 0, k = NU, d = 2 * NU, fqR = d + 12, fqp = fqR + 9, fxi = fqp + 3,
                       ns = fxi + 6;
  // an x slot: the nominal state
  static constexpr int R = 0, p = 9, xi = 12, nx = 18;
  // the column: K, two stage slots, three x slots
  static constexpr int K = 0, S = 12 * NU, X = S + 2 * ns, n = X + 3 * nx;
};

template <int NU>
constexpr size_t rollout_f64_bytes() {
  return RolloutF64Column<NU>::n * kAheadThreads * sizeof(double);
}

template <int NU>
__device__ __forceinline__ void rollout_f64_copy_stage(double* slot, const RolloutArgs<double>& a,
                                                       int t, int b) {
  using C = RolloutF64Column<NU>;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<NU>(slot + C::u * P, a.u, t, B, b);
  copy_column<NU>(slot + C::k * P, a.k, t, B, b);
  copy_column<12>(slot + C::d * P, a.d, t, B, b);
  copy_column<9>(slot + C::fqR * P, a.fqR, t, B, b);
  copy_column<3>(slot + C::fqp * P, a.fqp, t, B, b);
  copy_column<6>(slot + C::fxi * P, a.fxi, t, B, b);
}

template <int NU>
__device__ __forceinline__ void rollout_f64_copy_x(double* slot, const RolloutArgs<double>& a,
                                                   int t, int b) {
  using C = RolloutF64Column<NU>;
  constexpr int P = kAheadThreads;
  copy_column<9>(slot + C::R * P, a.qR, t, a.B, b);
  copy_column<3>(slot + C::p * P, a.qp, t, a.B, b);
  copy_column<6>(slot + C::xi * P, a.xi, t, a.B, b);
}

template <int NU>
__global__ void __launch_bounds__(kAheadThreads) rollout_f64_kernel(RolloutArgs<double> a) {
  using T = double;
  using C = RolloutF64Column<NU>;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x, bc = min(b, B - 1);
  const bool live = b < B;
  T* const col0 = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* col = col0;
  const auto slot = [&](int t) { return col + (C::S + (t & 1) * C::ns) * P; };
  const auto xslot = [&](int t) { return col + (C::X + (t % 3) * C::nx) * P; };
  const auto in = [&](const T* base, int e) { return column(base + e * P); };
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, bc));
  load<3>(p, lane<3>(a.qp, 0, B, bc));
  load<6>(xi, lane<6>(a.xi, 0, B, bc));
  if (live) {
    store<9>(lane<9>(a.oR, 0, B, b), R);
    store<3>(lane<3>(a.op, 0, B, b), p);
    store<6>(lane<6>(a.oxi, 0, B, b), xi);
  }
  rollout_f64_copy_x<NU>(xslot(0), a, 0, bc);
  rollout_f64_copy_x<NU>(xslot(1), a, 1, bc);
  rollout_f64_copy_stage<NU>(slot(0), a, 0, bc);
  copy_column<12 * NU>(col + C::K * P, a.K, 0, B, bc);
  cp_async_commit();
  for (int t = 0; t < N; ++t) {
    // every address derived anew each stage (opaque_zero)
    const int z = opaque_zero(), bz = bc + z;
    col = col0 + z;
    T* const Kc = col + C::K * P;
    cp_async_wait_all();
    if (t + 1 < N) rollout_f64_copy_stage<NU>(slot(t + 1), a, t + 1, bz);
    if (t + 2 <= N) rollout_f64_copy_x<NU>(xslot(t + 2), a, t + 2, bz);
    cp_async_commit();
    const T* st = slot(t);
    const T* xt = xslot(t);
    const T* xn = xslot(t + 1);
    // off the carry's chain: x_t^-1 and G_t = (x_{t+1} Exp(d_q)) f(xbar_t)^-1
    T Ri[9], pi[3], GR[9], Gp[3];
    {
      T Rt[9], pt[3], Rn[9], pn[3], dq[6], Ed[9], ed[3], Fq[9], fq[3], Fi[9], fi[3];
      T Ra[9], pa[3];
      load<9>(Rt, in(xt, C::R));
      load<3>(pt, in(xt, C::p));
      load<9>(Rn, in(xn, C::R));
      load<3>(pn, in(xn, C::p));
      load<6>(dq, in(st, C::d));
      load<9>(Fq, in(st, C::fqR));
      load<3>(fq, in(st, C::fqp));
      se3_inverse(Ri, pi, Rt, pt);
      se3_exp(Ed, ed, dq);
      se3_inverse(Fi, fi, Fq, fq);
      se3_compose(Ra, pa, Rn, pn, Ed, ed);
      se3_compose(GR, Gp, Ra, pa, Fi, fi);
    }
    // the chain: the deviation, the feedback, the dynamics, G_t f(x, u)
    T xs_err[12];
    {
      T Re[9], pe[3];
      se3_compose(Re, pe, Ri, pi, R, p);
      se3_log(xs_err, Re, pe);
      const Lane<const T> xit = in(xt, C::xi);
#pragma unroll
      for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
    }
    T u[NU];
    {
      const Lane<const T> ut = in(st, C::u), kt = in(st, C::k),
                         Kt = column(static_cast<const T*>(Kc));
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        T s = Kt[r * 12] * xs_err[0];
#pragma unroll
        for (int j = 1; j < 12; ++j) s += Kt[r * 12 + j] * xs_err[j];
        u[r] = (ut[r] + kt[r]) + s;
      }
    }
    if (t + 1 < N) {
      copy_column<12 * NU>(Kc, a.K, t + 1, B, bz);  // K_t has been read
      cp_async_commit();
    }
    T fqR[9], fqp[3], fxi[6];
    stage_dynamics_eval<T, NU>(fqR, fqp, fxi, R, p, xi, u, a.c);
    se3_compose(R, p, GR, Gp, fqR, fqp);
    so3_normalize(R);
    {
      const Lane<const T> xin = in(xn, C::xi), fxt = in(st, C::fxi), dd = in(st, C::d);
#pragma unroll
      for (int i = 0; i < 6; ++i) xi[i] = ((xin[i] + fxi[i]) - fxt[i]) + dd[6 + i];
    }
    if (live) {
      store<9>(lane<9>(a.oR, t + 1, B, b), R);
      store<3>(lane<3>(a.op, t + 1, B, b), p);
      store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
      store<NU>(lane<NU>(a.ou, t, B, b), u);
    }
  }
}

// B4: the rollout.  B3 (lin not null): the rollout, then B1's kernel on the
// new trajectory (lin's inputs are the rollout's outputs), both on stream s.
template <typename T, int NU>
int launch_rollout(const RolloutArgs<T>& a, const LinearizeArgs<T>* lin, cudaStream_t s) {
  if constexpr (std::is_same<T, double>::value) {
    constexpr size_t bytes = rollout_f64_bytes<NU>();
    if (int e = set_smem(rollout_f64_kernel<NU>, bytes, true)) return e;
    rollout_f64_kernel<NU><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  } else {
    constexpr size_t bytes = rollout_bytes<T, NU>();
    if (int e = set_smem(rollout_kernel<T, NU>, bytes, false)) return e;
    rollout_kernel<T, NU><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  }
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (lin) linearize_kernel<T, NU><<<batch_grid(a.B, a.N), kThreads, 0, s>>>(*lin);
  return (int)cudaGetLastError();
}

// The blocks of B2's (kernel 0) or the rollout's (kernel 1) kernel at nu
// that an SM holds at once, as launch_riccati and launch_rollout launch
// them; -1 on an error.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t bytes, bool carveout) {
  int n = -1;
  if (set_smem(kernel, bytes, carveout) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes))
    return -1;
  return n;
}

template <typename T, int NU>
int occupancy(int kernel) {
  if constexpr (std::is_same<T, double>::value) {
    if (kernel == 0)
      return blocks_per_sm(riccati_f64_kernel<NU>, kGroupThreads, Layout64<NU>::bytes, true);
    return blocks_per_sm(rollout_f64_kernel<NU>, kAheadThreads, rollout_f64_bytes<NU>(), true);
  } else {
    if (kernel == 0)
      return blocks_per_sm(riccati_kernel<T, NU>, kGroupThreads, RiccatiLayout<T, T, NU>::bytes,
                           false);
    return blocks_per_sm(rollout_kernel<T, NU>, kAheadThreads, rollout_bytes<T, NU>(), false);
  }
}

}  // namespace traopt

using traopt::Scalar;

extern "C" int TRAOPT_FN(occupancy)(int kernel, int nu, int device) {
  if (cudaSetDevice(device)) return -1;
  if (nu == 6) return traopt::occupancy<Scalar, 6>(kernel);
  if (nu == 4) return traopt::occupancy<Scalar, 4>(kernel);
  return -1;
}

extern "C" int TRAOPT_FN(riccati)(
    const void* Fx, const void* d, const void* lx, const void* lu,
    const void* lxx, const void* luual, const void* qR, const void* qp,
    const void* xi, const void* RbiR, const void* Rbip, const void* Adb,
    const void* xib, const void* W1N, const void* W2N, const void* fu2,
    const void* Luu, int glow, void* k, void* K, void* gvec, void* lN, int N,
    int nu, int B, int device, void* stream) {
  using T = Scalar;
  traopt::RiccatiArgs<T> a;
  a.Fx = (const T*)Fx; a.d = (const T*)d; a.lx = (const T*)lx;
  a.lu = (const T*)lu; a.lxx = (const T*)lxx; a.luual = (const T*)luual;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi;
  a.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  a.c = traopt::Consts<T>{nullptr, nullptr, nullptr, nullptr, (const T*)W1N,
                          (const T*)W2N, nullptr, (const T*)fu2, (const T*)Luu,
                          T(0), T(0), 0, 0};
  a.glow = glow;
  a.k = (T*)k; a.K = (T*)K; a.gvec = (T*)gvec; a.lN = (T*)lN;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nu == 6) return traopt::launch_riccati<T, 6>(a, s);
  if (nu == 4) return traopt::launch_riccati<T, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

// B4 when the new-linearization pointers are null, else B3.
extern "C" int TRAOPT_FN(rollout)(
    const void* qR, const void* qp, const void* xi, const void* u,
    const void* k, const void* K, const void* d, const void* fqR,
    const void* fqp, const void* fxi, const void* RbiR, const void* Rbip,
    const void* Adb, const void* xib, const void* J, const void* Jinv,
    const void* W1, const void* W2, const void* Pu, double mg, double dt,
    int gravity, int exact_grav, void* oR, void* op, void* oxi, void* ou,
    void* nfqR, void* nfqp, void* nfxi, void* nd, void* nFx, void* nlx,
    void* nlxx, void* nl, int N, int nu, int B, int device, void* stream) {
  using T = Scalar;
  traopt::RolloutArgs<T> a;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi; a.u = (const T*)u;
  a.k = (const T*)k; a.K = (const T*)K; a.d = (const T*)d;
  a.fqR = (const T*)fqR; a.fqp = (const T*)fqp; a.fxi = (const T*)fxi;
  a.c = traopt::Consts<T>{(const T*)J, (const T*)Jinv, (const T*)W1, (const T*)W2,
                          nullptr, nullptr, (const T*)Pu, nullptr, nullptr,
                          (T)mg, (T)dt, gravity, exact_grav};
  a.oR = (T*)oR; a.op = (T*)op; a.oxi = (T*)oxi; a.ou = (T*)ou;
  a.N = N; a.B = B;
  traopt::LinearizeArgs<T> l;
  l.qR = a.oR; l.qp = a.op; l.xi = a.oxi; l.u = a.ou;
  l.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  l.c = a.c;
  l.fqR = (T*)nfqR; l.fqp = (T*)nfqp; l.fxi = (T*)nfxi; l.d = (T*)nd;
  l.Fx = (T*)nFx; l.lx = (T*)nlx; l.lxx = (T*)nlxx; l.l = (T*)nl;
  l.N = N; l.B = B;
  const traopt::LinearizeArgs<T>* lin = nFx ? &l : nullptr;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nu == 6) return traopt::launch_rollout<T, 6>(a, lin, s);
  if (nu == 4) return traopt::launch_rollout<T, 4>(a, lin, s);
  return (int)cudaErrorInvalidValue;
}
