// The instances of B1-B6 at a large input dimension nu = 13 ... kMaxNuLarge
// (pipeline_nu.cu: B1, B2, B3 and B4 in f32 and fp64; polish_nu.cu: B5 and
// B6), which the C entry points launch past nu.cuh's kMaxNu = 12 (the
// rollout of B3 and B4 at every nu).  nu is a runtime argument, and no
// register array grows with it:
//   - B2 and B5: riccati_large.cuh's step (Q_uu, its factor and the nu-long
//     arrays in the group's shared memory, sized from nu at launch; the
//     factor and the 13 solves spread over the group's 16 lanes, the 12 x 12
//     and nu-long products in register blocks), 8 problems a block in f32
//     and mixed, 4 in fp64 (its layout is twice as large); fp64 B2's
//     terminal quadratization runs first in a kernel of its own into a
//     (48, B) hand-off array (terminal_kernel<double>, as at nu <= 12);
//   - B1 forms the wrench Pu u by a loop over the inputs, Pu in the block's
//     shared memory;
//   - B3 and B4 take the fp64 rollout's design (each stage input copied
//     ahead once into the thread's shared-memory column and read where it
//     is used), u_t, k_t and K_t in a feedback slot of 14 nu values that
//     the thread refills for stage t + 1 as soon as stage t's feedback has
//     read it: the feedback and the wrench Pu u run over the inputs from
//     shared memory, and nothing on the carry's chain waits on device
//     memory; B3's second phase is B1's kernel on the new trajectory.  At
//     nu <= 12 (launch_rollout_nu) the same rollout reads G_t = (x_{t+1}
//     Exp(d_q)) f(xbar_t)^-1 from a stage-parallel pass before it
//     (g_kernel), and B3's second phase is B1's runtime-nu instance;
//   - B6 takes rollout_mx_nu_kernel's design (a thread a problem, the fp64
//     carry in registers) with a feedback loop over the inputs
//     (feedback_pu): each stage reads row a of K, u_a and k_a from device
//     memory, forms u_a, stores it and adds Pu[:, a] u_a to the wrench.
// The sums run in the order of the instances at nu <= 12 (mat_vec's for
// Pu u, the feedback's over j), so the kernels agree with their plain
// versions as those do.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "nu.cuh"
#include "riccati_large.cuh"

#ifndef TRAOPT_MAX_NU
#error "build with -DTRAOPT_MAX_NU=<nu> (_build.MAX_NU)"
#endif

namespace traopt {

// Problems a block of the large-nu Riccati kernels: 8 (f32 B2, B5; Tp =
// float), 4 (fp64 B2).
template <typename Tp>
constexpr int kLargeProblems = sizeof(Tp) == 8 ? 4 : 8;

template <typename Tp, typename Tr>
__host__ __device__ constexpr LargeLayout riccati_large_layout(int nu) {
  return large_layout<Tp, Tr, kLargeProblems<Tp>>(nu);
}

// Whether the Riccati layouts of every scalar at nu fit one block.
constexpr bool large_fits(int nu) {
  return riccati_large_layout<float, float>(nu).bytes <= kSmemPerBlock &&
         riccati_large_layout<float, double>(nu).bytes <= kSmemPerBlock &&
         riccati_large_layout<double, double>(nu).bytes <= kSmemPerBlock;
}

// The largest nu of the large-nu instances: the build's (_build.MAX_NU),
// checked here against the Riccati step (a lane holds at most kLargeSlots
// rows of an nu-long array) and its layout.
constexpr int kMaxNuLarge = TRAOPT_MAX_NU;
static_assert(kMaxNuLarge > kMaxNu && kMaxNuLarge <= kLargeSlots * kGroup &&
                  large_fits(kMaxNuLarge),
              "TRAOPT_MAX_NU must be a nu whose Riccati layouts fit one block");

// Pu (6 x nu, row-major) into shared memory at dst; the block's threads
// share the copy and meet at a barrier.
template <typename T>
__device__ __forceinline__ void copy_pu(T* dst, const T* Pu, int nu) {
  for (int q = threadIdx.x; q < 6 * nu; q += blockDim.x) dst[q] = Pu[q];
  __syncthreads();
}

// w = Pu u, u_a = u(a) for a = 0 .. nu - 1, in mat_vec's order.
template <typename T, typename U>
__device__ __forceinline__ void pu_times(T* w, const T* Pu, int nu, U&& u) {
  const T u0 = u(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = Pu[i * nu] * u0;
  for (int a = 1; a < nu; ++a) {
    const T ua = u(a);
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] += Pu[i * nu + a] * ua;
  }
}

// The feedback of a rollout stage at a large nu: u_a = u_t[a] + k_t[a] +
// K_t[a] xs for a = 0 .. nu - 1, the problem's entries of stage t (entry a
// of ut and kt at [a * B], entry (a, j) of Kt at [(a * 12 + j) * B]), each
// stored to ou[a * B] unless ou is null, and w = Pu u.  The feedback runs in
// Tp on xs's Tp rounding, as rollout_stage's.
template <typename T, typename Tp>
__device__ __forceinline__ void feedback_pu(T* w, const T* xs, const T* ut, const Tp* kt,
                                            const Tp* Kt, long long B, int nu, const T* Pu,
                                            T* ou) {
  Tp xe[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) xe[j] = Tp(xs[j]);
  pu_times(w, Pu, nu, [&](int a) {
    const Tp* Ka = Kt + a * 12 * B;
    Tp s = Ka[0] * xe[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) s += Ka[j * B] * xe[j];
    T ua;
    if constexpr (std::is_same<T, Tp>::value) {
      ua = (ut[a * B] + kt[a * B]) + s;
    } else {
      ua = ut[a * B] + T(kt[a * B] + s);
    }
    if (ou) ou[a * B] = ua;
    return ua;
  });
}

// ---- B1 -------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) linearize_large_kernel(NuArgs<LinearizeArgs<T>> x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LinearizeArgs<T>& a = x.a;
  const int nu = x.nu;
  T* const Pu = reinterpret_cast<T*>(smem);
  copy_pu(Pu, a.c.Pu, nu);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, t, B, b));
  load<3>(p, lane<3>(a.qp, t, B, b));
  load<6>(xi, lane<6>(a.xi, t, B, b));
  const T* u = a.u + (long long)t * nu * B + b;

  T fqR[9], fqp[3], fxi[6];
  stage_dynamics_eval_with(
      fqR, fqp, fxi, R, p, xi,
      [&](T* w) { pu_times(w, Pu, nu, [&](int e) { return u[(long long)e * B]; }); }, a.c);
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
  stage_jacobian(lane<144>(a.Fx, t, B, b), R, xi, a.c);
  a.l[(long long)t * B + b] = stage_cost_quad<T>(
      lane<12>(a.lx, t, B, b), lane<144>(a.lxx, t, B, b), R, p, xi,
      a.refs.RbiR + t * 9, a.refs.Rbip + t * 3, a.refs.Adb + t * 36,
      a.refs.xib + t * 6, a.c.W1, a.c.W2);
}

template <typename T>
int launch_linearize_large(const LinearizeArgs<T>& a, int nu, cudaStream_t s) {
  linearize_large_kernel<T><<<batch_grid(a.B, a.N), kThreads, 6 * nu * sizeof(T), s>>>(
      NuArgs<LinearizeArgs<T>>{a, nu});
  return (int)cudaGetLastError();
}

// ---- B2 and B5 --------------------------------------------------------------

// B2's arguments at a large nu: fp64 reads its terminal carry from the
// (48, B) hand-off array `hand` that terminal_kernel<double> filled.
template <typename T>
struct RiccatiLargeArgs {
  RiccatiArgs<T> a;
  const T* hand;
  LargeLayout L;
};

template <typename T>
__global__ void __launch_bounds__(kGroup * kLargeProblems<T>)
    riccati_large_kernel(RiccatiLargeArgs<T> x) {
  constexpr int P = kLargeProblems<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiArgs<T>& a = x.a;
  const LargeLayout& L = x.L;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * P + g, bc = min(b, B - 1);
  riccati_large_consts<T, T, P>(smem, L, a.c.fu2, a.c.fu2, a.c.Luu, tid);
  const LargeScratch<T, T> gs = large_scratch<T, T>(smem + L.ogroup + g * L.gstride, L);
  // the terminal carry into the group's scratch (problems past B take
  // problem B - 1's)
  if constexpr (std::is_same<T, double>::value) {
    if (r < 12) {
      const Lane<const double> k0 = lane<48>(x.hand, 0, B, bc);
      gs.Vm[r] = k0[r];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        gs.VS[r * 12 + j] = r < 6 ? k0[12 + r * 6 + j] : 0.0;
        gs.VS[r * 12 + 6 + j] = r < 6 ? 0.0 : 2.0 * a.c.W2N[(r - 6) * 6 + j];
      }
    }
  } else if (r == 0) {
    T R[9], p[3], xi[6];
    load<9>(R, lane<9>(a.qR, N, B, bc));
    load<3>(p, lane<3>(a.qp, N, B, bc));
    load<6>(xi, lane<6>(a.xi, N, B, bc));
    const T l = stage_cost_quad<T>(gs.Vm, gs.VS, R, p, xi, a.refs.RbiR + N * 9,
                                   a.refs.Rbip + N * 3, a.refs.Adb + N * 36,
                                   a.refs.xib + N * 6, a.c.W1N, a.c.W2N);
    if (b < B) a.lN[b] = l;
  }
  __syncwarp();
  T Vx[3];  // V_x[I] on the diagonal lanes (riccati_large_step)
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) Vx[ii] = gs.Vm[3 * (r / 4) + ii];
  riccati_large_run<T, T, P>(smem, L, N, B, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx, a.luual,
                             a.glow != 0, a.K, a.k, a.gvec);
}

// B2 at a large nu on stream s; in fp64 its two phases, the terminal
// quadratization into `hand` (48, B) and the stage loop.
template <typename T>
int launch_riccati_large(const RiccatiArgs<T>& a, int nu, T* hand, cudaStream_t s) {
  constexpr int P = kLargeProblems<T>;
  const LargeLayout L = riccati_large_layout<T, T>(nu);
  if (int e = set_smem(riccati_large_kernel<T>, L.bytes, true)) return e;
  if constexpr (std::is_same<T, double>::value) {
    if (!hand) return (int)cudaErrorInvalidValue;
    RiccatiArgs<double> t = a;
    t.K = hand;
    terminal_kernel<double><<<batch_grid(a.B), kThreads, 0, s>>>(t);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  riccati_large_kernel<T><<<dim3((a.B + P - 1) / P), kGroup * P, L.bytes, s>>>(
      RiccatiLargeArgs<T>{a, hand, L});
  return (int)cudaGetLastError();
}

struct RiccatiMxLargeArgs {
  RiccatiMxArgs a;
  LargeLayout L;
};

// A template (on the problems a block), as its launcher, so that only the
// unit that launches it (polish_nu.cu) compiles it.
template <int P>
__global__ void __launch_bounds__(kGroup * P) riccati_mx_large_kernel(RiccatiMxLargeArgs x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiMxArgs& a = x.a;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B;
  const int bc = min(int(blockIdx.x) * P + g, B - 1);  // past B: problem B - 1's
  riccati_large_consts<float, double, P>(smem, x.L, a.fu2_32, a.fu2, a.Luu, tid);
  const LargeScratch<float, double> gs =
      large_scratch<float, double>(smem + x.L.ogroup + g * x.L.gstride, x.L);
  // the terminal carry into the group's scratch
  if (r < 12) {
    gs.Vm[r] = a.VxN[(long long)r * B + bc];
#pragma unroll
    for (int j = 0; j < 12; ++j) gs.VS[r * 12 + j] = a.VxxN[((long long)r * 12 + j) * B + bc];
  }
  __syncwarp();
  double Vx[3];  // V_x[I] on the diagonal lanes (riccati_large_step)
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) Vx[ii] = gs.Vm[3 * (r / 4) + ii];
  riccati_large_run<float, double, P>(smem, x.L, a.N, B, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx,
                                      a.luual, a.glow != 0, a.K, a.k, a.gvec);
}

// B5 at a large nu on stream s.
template <int P = kLargeProblems<float>>
int launch_riccati_mx_large(const RiccatiMxArgs& a, int nu, cudaStream_t s) {
  const LargeLayout L = riccati_large_layout<float, double>(nu);
  if (int e = set_smem(riccati_mx_large_kernel<P>, L.bytes, true)) return e;
  riccati_mx_large_kernel<P><<<dim3((a.B + P - 1) / P), kGroup * P, L.bytes, s>>>(
      RiccatiMxLargeArgs{a, L});
  return (int)cudaGetLastError();
}

// ---- B3 and B4: the rollout ------------------------------------------------
// A thread's column: two stage slots (the defect d_t, the nominal's
// evaluation), three x slots (the nominal state) and, with kSlot, one
// feedback slot (u_t, k_t and K_t: 14 nu values), which the thread refills
// with stage t + 1's as soon as stage t's feedback has read it; then Pu
// (6 x nu) after the block's columns.
struct LargeRolloutColumn {
  static constexpr int d = 0, fqR = 12, fqp = 21, fxi = 24, ns = 30;
  static constexpr int R = 0, p = 9, xi = 12, nx = 18;
  static constexpr int S = 0, X = 2 * ns, F = X + 3 * nx;
  __host__ __device__ static constexpr int n(int nu, bool slot) {
    return F + (slot ? 14 * nu : 0);
  }
};

template <typename T, bool kSlot>
constexpr size_t rollout_large_bytes(int nu) {
  return LargeRolloutColumn::n(nu, kSlot) * kAheadThreads * sizeof(T) +
         align16(6 * nu * sizeof(T));
}

// The rollout's blocks an SM that its launch bounds ask for: in f32, 12
// caps a thread's registers at 170, under which ptxas holds a stage without
// a spill (uncapped, f32 took 254 and spilled: its trigonometry without the
// library's slow path left the stage one long block of code); fp64 is left
// uncapped, as before the redesign (capped at 170 it spilled), and its
// shared memory holds it to fewer blocks an SM than its registers would.
template <typename T>
constexpr int kRolloutLargeBlocks = std::is_same<T, float>::value ? 12 : 1;

// G_t = (x_{t+1} Exp(d_q)) f(xbar_t)^-1 of one stage and problem, from the
// lanes of x_{t+1} (Rn, pn), d_t (its first six entries, d_q) and f(xbar_t)
// (Fq, fq): the rollout's composition off its carry's chain, in the
// rollout's loop past nu = 12 and in g_kernel's pass up to it.
template <typename T, typename Src>
__device__ __forceinline__ void stage_g(T* GR, T* Gp, const Src& Rn_, const Src& pn_,
                                        const Src& d_, const Src& Fq_, const Src& fq_) {
  T Rn[9], pn[3], dq[6], Ed[9], ed[3], Fq[9], fq[3], Fi[9], fi[3], Ra[9], pa[3];
  load<9>(Rn, Rn_);
  load<3>(pn, pn_);
  load<6>(dq, d_);
  load<9>(Fq, Fq_);
  load<3>(fq, fq_);
  se3_exp<FramelessTrig>(Ed, ed, dq);
  se3_inverse(Fi, fi, Fq, fq);
  se3_compose(Ra, pa, Rn, pn, Ed, ed);
  se3_compose(GR, Gp, Ra, pa, Fi, fi);
}

// The fp64 rollout's design (pipeline.cu rollout_f64_kernel) at a runtime
// nu: each stage input copied ahead once into the thread's column; the
// feedback u_a = (u_t[a] + k_t[a]) + K_t[a] xs_err and the wrench Pu u run
// over the inputs in feedback_pu's order, reading u_t, k_t and K_t from the feedback slot (kSlot: nothing on
// the carry's chain waits on device memory) or, where the slot's shared
// memory would leave too few problems resident (launch_rollout_large), from
// device memory.
// kG (the rollout at nu <= kMaxNu): G_t comes from the output array, where
// g_kernel left it (in oR, op at stage t + 1, which the rollout overwrites
// with x_{t+1} once it has read G_t), in the stage slot's place of f(xbar_t).
template <typename T, bool kSlot, bool kG = false>
__global__ void __launch_bounds__(kAheadThreads, kRolloutLargeBlocks<T>)
    rollout_large_kernel(NuArgs<RolloutArgs<T>> x) {
  using C = LargeRolloutColumn;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const RolloutArgs<T>& a = x.a;
  const int nu = x.nu;
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x, bc = min(b, B - 1);
  const bool live = b < B;
  T* const col0 = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* const Pu = reinterpret_cast<T*>(smem + C::n(nu, kSlot) * P * sizeof(T));
  copy_pu(Pu, a.c.Pu, nu);
  T* col = col0;
  const auto slot = [&](int t) { return col + (C::S + (t & 1) * C::ns) * P; };
  const auto xslot = [&](int t) { return col + (C::X + (t % 3) * C::nx) * P; };
  const auto in = [&](const T* base, int e) { return column(base + e * P); };
  const auto copy_stage = [&](T* sl, int t, int bb) {
    copy_column<12>(sl + C::d * P, a.d, t, B, bb);
    if constexpr (kG) {
      copy_column<9>(sl + C::fqR * P, a.oR, t + 1, B, bb);
      copy_column<3>(sl + C::fqp * P, a.op, t + 1, B, bb);
    } else {
      copy_column<9>(sl + C::fqR * P, a.fqR, t, B, bb);
      copy_column<3>(sl + C::fqp * P, a.fqp, t, B, bb);
    }
    copy_column<6>(sl + C::fxi * P, a.fxi, t, B, bb);
  };
  const auto copy_x = [&](T* sl, int t, int bb) {
    copy_column<9>(sl + C::R * P, a.qR, t, B, bb);
    copy_column<3>(sl + C::p * P, a.qp, t, B, bb);
    copy_column<6>(sl + C::xi * P, a.xi, t, B, bb);
  };
  const auto copy_feedback = [&](int t, int bb) {
    T* const f = col + C::F * P;
    copy_column_n(f, a.u, nu, t, B, bb);
    copy_column_n(f + nu * P, a.k, nu, t, B, bb);
    copy_column_n(f + 2 * nu * P, a.K, 12 * nu, t, B, bb);
  };
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, bc));
  load<3>(p, lane<3>(a.qp, 0, B, bc));
  load<6>(xi, lane<6>(a.xi, 0, B, bc));
  if (live) {
    store<9>(lane<9>(a.oR, 0, B, b), R);
    store<3>(lane<3>(a.op, 0, B, b), p);
    store<6>(lane<6>(a.oxi, 0, B, b), xi);
  }
  copy_x(xslot(0), 0, bc);
  copy_x(xslot(1), 1, bc);
  copy_stage(slot(0), 0, bc);
  if constexpr (kSlot) copy_feedback(0, bc);
  cp_async_commit();
  for (int t = 0; t < N; ++t) {
    // every address derived anew each stage (opaque_zero)
    const int z = opaque_zero(), bz = bc + z;
    col = col0 + z;
    cp_async_wait_all();
    if (t + 1 < N) copy_stage(slot(t + 1), t + 1, bz);
    if (t + 2 <= N) copy_x(xslot(t + 2), t + 2, bz);
    cp_async_commit();
    const T* st = slot(t);
    const T* xt = xslot(t);
    const T* xn = xslot(t + 1);
    // the chain: the deviation (x_t^-1 off it), the feedback, the
    // dynamics, G_t f(x, u) with G_t = (x_{t+1} Exp(d_q)) f(xbar_t)^-1 off
    // it, formed after the feedback (holding G_t across it cost registers)
    T xs_err[12];
    {
      T Rt[9], pt[3], Ri[9], pi[3], Re[9], pe[3];
      load<9>(Rt, in(xt, C::R));
      load<3>(pt, in(xt, C::p));
      se3_inverse(Ri, pi, Rt, pt);
      se3_compose(Re, pe, Ri, pi, R, p);
      se3_log<FramelessTrig>(xs_err, Re, pe);
      const Lane<const T> xit = in(xt, C::xi);
#pragma unroll
      for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
    }
    // the feedback: entry e of u_t, k_t at fu[e fs], fk[e fs]; entry (e, j)
    // of K_t at fK[(12 e + j) fs]
    T Puu[6];
    {
      const long long o = (long long)t * nu * B, fs = kSlot ? P : B;
      const T *fu, *fk, *fK;
      if constexpr (kSlot) {
        fu = col + C::F * P;
        fk = fu + nu * P;
        fK = fu + 2 * nu * P;
      } else {
        fu = a.u + o + bz;
        fk = a.k + o + bz;
        fK = a.K + 12 * o + bz;
      }
      T* const ou = a.ou + o + b;
      pu_times(Puu, Pu, nu, [&](int e) {
        const T* Ke = fK + 12 * e * fs;
        T s = Ke[0] * xs_err[0];
#pragma unroll
        for (int j = 1; j < 12; ++j) s += Ke[j * fs] * xs_err[j];
        const T ue = (fu[e * fs] + fk[e * fs]) + s;
        if (live) ou[e * B] = ue;
        return ue;
      });
    }
    if constexpr (kSlot) {
      if (t + 1 < N) {
        copy_feedback(t + 1, bz);  // stage t's has been read
        cp_async_commit();
      }
    }
    T fqR[9], fqp[3], fxi[6];
    stage_dynamics_eval_with<FramelessTrig>(
        fqR, fqp, fxi, R, p, xi,
        [&](T* w) {
#pragma unroll
          for (int i = 0; i < 6; ++i) w[i] = Puu[i];
        },
        a.c);
    if constexpr (kG) {
      T GR[9], Gp[3];
      load<9>(GR, in(st, C::fqR));
      load<3>(Gp, in(st, C::fqp));
      se3_compose(R, p, GR, Gp, fqR, fqp);
    } else {
      T GR[9], Gp[3];
      stage_g(GR, Gp, in(xn, C::R), in(xn, C::p), in(st, C::d), in(st, C::fqR),
              in(st, C::fqp));
      se3_compose(R, p, GR, Gp, fqR, fqp);
    }
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
    }
  }
}

// Whether the rollout at nu takes the feedback slot for a batch of B
// (*slot): while the whole batch is resident at once.  Past that (f32 at
// nu >= 24 and fp64 at nu >= 16, B = 16384, on an H100) the slot's shared
// memory leaves too few problems resident, and the feedback from device
// memory, with every problem resident, was the faster (PERF.md).
// Returns the CUDA error of the device query, if any.
template <typename T>
int rollout_large_slot(int nu, int B, bool* slot) {
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  const size_t bytes = rollout_large_bytes<T, true>(nu);
  int n = 0;
  if (int e = set_smem(rollout_large_kernel<T, true>, bytes, true)) return e;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rollout_large_kernel<T, true>, kAheadThreads, bytes))
    return (int)e;
  *slot = n > 0 && (long long)n * sms * kAheadThreads >= B;
  return 0;
}

// B4 at a large nu; B3 (lin not null): the rollout, then B1's kernel at the
// same nu on the new trajectory, both on stream s.  *slot: whether the
// rollout took its feedback-slot instance; kG: rollout_large_kernel's.
template <typename T, bool kG = false>
int launch_rollout_large(const RolloutArgs<T>& a, const LinearizeArgs<T>* lin, int nu,
                         cudaStream_t s, bool* slot) {
  const NuArgs<RolloutArgs<T>> x{a, nu};
  if (int e = rollout_large_slot<T>(nu, a.B, slot)) return e;
  if (*slot) {
    const size_t bytes = rollout_large_bytes<T, true>(nu);
    if (int e = set_smem(rollout_large_kernel<T, true, kG>, bytes, true)) return e;
    rollout_large_kernel<T, true, kG><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(x);
  } else {
    const size_t bytes = rollout_large_bytes<T, false>(nu);
    if (int e = set_smem(rollout_large_kernel<T, false, kG>, bytes, true)) return e;
    rollout_large_kernel<T, false, kG><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(x);
  }
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (lin) return launch_linearize_large<T>(*lin, nu, s);
  return (int)cudaGetLastError();
}

// G_t = (x_{t+1} Exp(d_q,t)) f(xbar_t)^-1 of every stage t and problem (a
// thread each, the rollout's functions in its order) into oR, op at stage
// t + 1.
template <typename T>
__global__ void __launch_bounds__(kThreads) g_kernel(RolloutArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x, t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  T GR[9], Gp[3];
  stage_g(GR, Gp, lane<9>(a.qR, t + 1, B, b), lane<3>(a.qp, t + 1, B, b),
          lane<12>(a.d, t, B, b), lane<9>(a.fqR, t, B, b), lane<3>(a.fqp, t, B, b));
  store<9>(lane<9>(a.oR, t + 1, B, b), GR);
  store<3>(lane<3>(a.op, t + 1, B, b), Gp);
}

// The one-warp blocks an SM up to which the rollout at nu <= kMaxNu takes
// G_t from g_kernel's pass (rollout_nu_g): 3 in f32, 2 in fp64, where the
// pass's gain crossed zero on an H100 (scripts/nu_instances.py --g-pass, nu
// = 3 and 12: f32 gained at B = 12288 and lost at 16384 at nu = 12; fp64
// gained at 8192 at nu = 3, lost there at nu = 12 and lost at 12288).
template <typename T>
constexpr int kRolloutNuGWarps = std::is_same<T, float>::value ? 3 : 2;

// Whether the rollout at nu <= kMaxNu takes G_t from g_kernel's pass for a
// batch of B (*g): while B fills at most kRolloutNuGWarps<T> of its one-warp
// blocks an SM.  There a stage's chain holds the warp, and the pass takes
// G_t's compositions off it; with more warps an SM they hide in the chain's
// stalls, and the pass's traffic (42 values a stage and problem) costs more
// than it saves (PERF.md, §6).
template <typename T>
int rollout_nu_g(int B, bool* g) {
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  *g = B <= (long long)kRolloutNuGWarps<T> * kAheadThreads * sms;
  return 0;
}

// B4 at nu <= kMaxNu: the large-nu rollout, reading G_t from g_kernel's pass
// before it where rollout_nu_g says so (pass < 0), or as pass says (0: without,
// 1: with it); B3 (lin not null): then B1's runtime-nu instance on the new
// trajectory, all on stream s.  *g: whether the pass ran; *slot: as
// launch_rollout_large's.
template <typename T>
int launch_rollout_nu(const RolloutArgs<T>& a, const LinearizeArgs<T>* lin, int nu, int pass,
                      cudaStream_t s, bool* g, bool* slot) {
  *g = pass > 0;
  if (pass < 0)
    if (int e = rollout_nu_g<T>(a.B, g)) return e;
  if (*g) {
    g_kernel<T><<<batch_grid(a.B, a.N), kThreads, 0, s>>>(a);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (int e = *g ? launch_rollout_large<T, true>(a, nullptr, nu, s, slot)
                 : launch_rollout_large<T>(a, nullptr, nu, s, slot))
    return e;
  if (lin) return by_mu(nu, [&](auto mu) {
    return launch_linearize_nu<T, decltype(mu)::value>(*lin, nu, s);
  });
  return 0;
}

// ---- B6 ---------------------------------------------------------------------
// rollout_mx_nu_kernel at a large nu: rollout_stage with feedback_pu's loop.
__global__ void __launch_bounds__(kThreads) rollout_mx_large_kernel(NuArgs<RolloutMxArgs> x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RolloutMxArgs& a = x.a;
  const int nu = x.nu;
  double* const Pu = reinterpret_cast<double*>(smem);
  copy_pu(Pu, a.c.Pu, nu);
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
    double Rt[9], pt[3], xit[6], Rn[9], pn[3], xin[6];
    double dd[12], fqRt[9], fqpt[3], fxit[6];
    load<9>(Rt, lane<9>(a.qR, t, B, b));
    load<3>(pt, lane<3>(a.qp, t, B, b));
    load<6>(xit, lane<6>(a.xi, t, B, b));
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    load<12>(dd, lane<12>(a.d, t, B, b));
    load<9>(fqRt, lane<9>(a.fqR, t, B, b));
    load<3>(fqpt, lane<3>(a.fqp, t, B, b));
    load<6>(fxit, lane<6>(a.fxi, t, B, b));
    double xs_err[12];
    {
      double Ri[9], pi[3], Re[9], pe[3];
      se3_inverse(Ri, pi, Rt, pt);
      se3_compose(Re, pe, Ri, pi, R, p);
      se3_log(xs_err, Re, pe);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
    double Puu[6];
    {
      const long long o = (long long)t * nu * B;
      feedback_pu<double, float>(Puu, xs_err, a.u + o + b, a.k + o + b, a.K + 12 * o + b, B, nu,
                                 Pu, a.ou + o + b);
    }
    double fqR[9], fqp[3], fxi[6];
    stage_dynamics_eval_with(
        fqR, fqp, fxi, R, p, xi,
        [&](double* w) {
#pragma unroll
          for (int i = 0; i < 6; ++i) w[i] = Puu[i];
        },
        a.c);
    {
      double edR[9], edp[3], fiR[9], fip[3], Ra[9], pa[3], Rb[9], pb[3];
      se3_exp(edR, edp, dd);
      se3_inverse(fiR, fip, fqRt, fqpt);
      se3_compose(Ra, pa, Rn, pn, edR, edp);
      se3_compose(Rb, pb, Ra, pa, fiR, fip);
      se3_compose(R, p, Rb, pb, fqR, fqp);
      so3_normalize(R);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = ((xin[i] + fxi[i]) - fxit[i]) + dd[6 + i];
    store<9>(lane<9>(a.oR, t + 1, B, b), R);
    store<3>(lane<3>(a.op, t + 1, B, b), p);
    store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
    store<9>(lane<9>(a.efqR, t, B, b), fqR);
    store<3>(lane<3>(a.efqp, t, B, b), fqp);
    store<6>(lane<6>(a.efxi, t, B, b), fxi);
  }
}

inline int launch_rollout_mx_large(const RolloutMxArgs& a, int nu, cudaStream_t s) {
  rollout_mx_large_kernel<<<batch_grid(a.B), kThreads, 6 * nu * sizeof(double), s>>>(
      NuArgs<RolloutMxArgs>{a, nu});
  return (int)cudaGetLastError();
}

}  // namespace traopt
