// Kernels B13 (generic dense Riccati backward) and B14 (SE(3) free-body
// gap-closing rollout) of the generic fast tier, solvers/batched.py
// FastBatchSolver.  The plain versions are ops/riccati.py (backward_plain)
// and ops/rollout.py (rollout_plain), which follow the JAX kernels formula by
// formula.
//
// Both are sequential recursions over the N stages of one problem, the stage
// loop inside the block (the TPU kernels carried the recursion across a
// sequential grid axis with the carry in VMEM scratch), every per-stage array
// batch-last: B13 at nx = 12 runs one problem per group of 16 threads
// (group.cuh); B13 at (6, 3) and B14 one problem per thread on blocks of one
// warp with the carry in registers and each stage's inputs copied a stage
// ahead into shared memory (ahead.cuh); B13 at any other shape up to
// (12, 12) one problem per thread, reading global memory.
#include "ahead.cuh"
#include "common.cuh"
#include "group.cuh"
#include "stage.cuh"

namespace traopt {

// ---- B13 ------------------------------------------------------------------
// Replaces ops/pallas_riccati.py::_riccati_kernel (pallas_backward).  A dense
// step on per-stage Fx (NX x NX), Fu (NX x NU), Lux and Luu, mu = 0, an
// unrolled NU x NU Cholesky (diagonal stored as the square root, substitutions
// divide, as the JAX kernel does), from the terminal Lx[N], Lxx[N]; the
// carry before each stage's update is an output (Vx1, Vxx1).
// What bounds it on an H100: its bytes (Fx, Lxx and the rest, ~500 values per
// problem and stage, read once; the carry, ~160 values, written once) take
// 1.4 ms at (12, 6), B = 8192, N = 200.  One thread per problem would keep
// ~500 values live (V_xx, V_xx F, Q_xx, Q_ux, K), which spill to local memory
// that does not fit in L2.  The design is B2's (riccati_group.cuh): a group
// of kGroup = 16 threads per problem and kProblems = 8 problems per block
// (group.cuh); lane r < NX keeps row r of V_xx and V_x[r] in registers and,
// per stage, column r of Q_xx, Q_ux and K (lane NX: Q_u and k); the group
// exchanges V_xx F, V_xx Fu, Q_uu, K, K^T Q_uu, Q_ux and the new V_xx's
// unsymmetrised X through its slice of shared memory between __syncwarp()s;
// the block copies stage t - 1's inputs into shared memory (cp.async) while it
// computes stage t, and stages its outputs to store them coalesced.  Every
// entry keeps the one-thread step's sum order (the k-loop outermost where an
// entry sums over k), so the result agrees with backward_plain to rounding.
template <typename T>
struct FastRiccatiArgs {
  const T *Fx, *Fu, *d, *Lx, *Lu, *Lxx, *Lux, *Luu;  // Lx, Lxx: N+1 stages
  T *k, *K, *Vx1, *Vxx1;
  int N, B;
  int nx, nu;  // read by the any-shape kernel only
};

// One group's scratch.
template <typename T, int NX, int NU>
struct FastScratch {
  static constexpr int NUP = vpad<T>(NU);
  alignas(16) T Vm[vpad<T>(NX)];   // V_x + V_xx d
  alignas(16) T Qu[NUP];           // Q_u
  alignas(16) T VS[NX * NX];       // (V_xx F)^T in A-B, X (row-major) in D-E
  alignas(16) T VFu[NX * NUP];     // V_xx Fu
  alignas(16) T KT[(NX + 1) * NUP];  // row c < NX: column c of K; row NX: k
  alignas(16) T KQ[NX * NUP];      // K^T Q_uu
  alignas(16) T QuxT[NX * NUP];    // Q_ux^T
  alignas(16) T Quu[NU * NUP];
};

// Shared memory of a block: two stage buffers (the stage being computed and
// the one being copied), two output buffers (the stage being written and the
// one being stored), and the groups' scratch.  Byte offsets, each 16-byte
// aligned (a row of pitch<T>(ne) elements is a whole number of 16 bytes).
template <typename T, int NX, int NU>
struct FastLayout {
  static constexpr int P = kProblems;
  // one stage buffer: a row of pitch<T>(ne) per problem for each input
  static constexpr int pF = pitch<T>(NX * NX), pFu = pitch<T>(NX * NU), pd = pitch<T>(NX),
                       pu = pitch<T>(NU), pux = pitch<T>(NU * NX), puu = pitch<T>(NU * NU);
  static constexpr size_t oF = 0, oFu = oF + P * pF * sizeof(T),
                          od = oFu + P * pFu * sizeof(T), olx = od + P * pd * sizeof(T),
                          olu = olx + P * pd * sizeof(T), olxx = olu + P * pu * sizeof(T),
                          olux = olxx + P * pF * sizeof(T), oluu = olux + P * pux * sizeof(T),
                          stage = oluu + P * puu * sizeof(T);
  // one output buffer: K, k, Vx1, Vxx1, entry e of problem p at e * kOutStride + p
  static constexpr int eK = 0, ek = NU * NX, eVx = ek + NU, eVxx = eVx + NX,
                       nout = eVxx + NX * NX;
  static constexpr size_t out = align16(nout * kOutStride * sizeof(T));
  // the block
  static constexpr size_t ostage = 0, oout = 2 * stage, ogroup = oout + 2 * out,
                          gstride = group_stride(sizeof(FastScratch<T, NX, NU>)),
                          bytes = ogroup + P * gstride;
};

// One problem's view of a stage buffer and of an output buffer.
template <typename T>
struct FastIn {
  const T *F, *Fu, *d, *lx, *lu, *lxx, *lux, *luu;
};

template <typename T>
struct FastOut {
  T *K, *k, *Vx, *Vxx;  // entry e at [e * kOutStride]
};

template <typename T, int NX, int NU>
__device__ __forceinline__ FastIn<T> fast_in(const unsigned char* buf, int p) {
  using L = FastLayout<T, NX, NU>;
  const auto at = [&](size_t off, int pt) { return reinterpret_cast<const T*>(buf + off) + p * pt; };
  return {at(L::oF, L::pF),    at(L::oFu, L::pFu),  at(L::od, L::pd),    at(L::olx, L::pd),
          at(L::olu, L::pu),   at(L::olxx, L::pF),  at(L::olux, L::pux), at(L::oluu, L::puu)};
}

template <typename T, int NX, int NU>
__device__ __forceinline__ FastOut<T> fast_out(unsigned char* buf, int p) {
  using L = FastLayout<T, NX, NU>;
  T* o = reinterpret_cast<T*>(buf) + p;
  return {o + L::eK * kOutStride, o + L::ek * kOutStride, o + L::eVx * kOutStride,
          o + L::eVxx * kOutStride};
}

// The block's copy of stage t's inputs into a stage buffer.
template <typename T, int NX, int NU>
__device__ __forceinline__ void fast_copy(unsigned char* buf, const FastRiccatiArgs<T>& a, int t,
                                          int b0, int tid) {
  using L = FastLayout<T, NX, NU>;
  const auto at = [&](size_t off) { return reinterpret_cast<T*>(buf + off); };
  copy_stage<NX * NX, false>(at(L::oF), a.Fx, t, b0, a.B, tid);
  copy_stage<NX * NU, false>(at(L::oFu), a.Fu, t, b0, a.B, tid);
  copy_stage<NX, false>(at(L::od), a.d, t, b0, a.B, tid);
  copy_stage<NX, false>(at(L::olx), a.Lx, t, b0, a.B, tid);
  copy_stage<NU, false>(at(L::olu), a.Lu, t, b0, a.B, tid);
  copy_stage<NX * NX, false>(at(L::olxx), a.Lxx, t, b0, a.B, tid);
  copy_stage<NU * NX, false>(at(L::olux), a.Lux, t, b0, a.B, tid);
  copy_stage<NU * NU, false>(at(L::oluu), a.Luu, t, b0, a.B, tid);
}

// The block's store of stage t's outputs from an output buffer.
template <typename T, int NX, int NU>
__device__ __forceinline__ void fast_store(const FastRiccatiArgs<T>& a, const unsigned char* buf,
                                           int t, int b0, int tid) {
  using L = FastLayout<T, NX, NU>;
  const T* o = reinterpret_cast<const T*>(buf);
  store_stage<NU * NX>(a.K, o + L::eK * kOutStride, t, b0, a.B, tid);
  store_stage<NU>(a.k, o + L::ek * kOutStride, t, b0, a.B, tid);
  store_stage<NX>(a.Vx1, o + L::eVx * kOutStride, t, b0, a.B, tid);
  store_stage<NX * NX>(a.Vxx1, o + L::eVxx * kOutStride, t, b0, a.B, tid);
}

// One dense Riccati step for lane r of a group: (V, Vx) hold row r of V_xx
// and V_x[r] of stage t + 1 on entry and of stage t on exit (lanes r < NX);
// out gets the carry on entry (Vx1, Vxx1) and K, k.  The phases:
//   A  row r of V_xx F (stored transposed) and of V_xx Fu, V_x + V_xx d;
//   B  column r of Q_xx = L_xx + F^T (V_xx F) and of Q_ux = L_ux + Fu^T (V_xx F),
//      Q_x[r]; lane a < NU row a of Q_uu = L_uu + Fu^T (V_xx Fu), lane NX Q_u;
//   C  every lane the Cholesky factor of Q_uu, then lane c <= NX one
//      right-hand side of -Q_uu^-1 [Q_ux | Q_u]: column c of K, or k; row r of
//      K^T Q_uu;
//   D  V_x[r], and column r of X = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K;
//   E  row r of V_xx = (X + X^T) / 2.
// Every lane of the warp calls it (it synchronises the warp).
template <typename T, int NX, int NU>
__device__ __forceinline__ void fast_group_step(int r, T (&V)[NX], T& Vx, const FastIn<T>& in,
                                                FastScratch<T, NX, NU>& g,
                                                const FastOut<T>& out) {
  constexpr int NUP = FastScratch<T, NX, NU>::NUP;
  const bool own = r < NX;

  // ---- A ----
  if (own) {
    out.Vx[r * kOutStride] = Vx;
#pragma unroll
    for (int j = 0; j < NX; ++j) out.Vxx[(r * NX + j) * kOutStride] = V[j];
    {
      T dd[NX];
      lds<T, NX>(dd, in.d);
      T s = V[0] * dd[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) s += V[j] * dd[j];
      g.Vm[r] = Vx + s;
    }
    T vf[NX], vfu[NU];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T f[NX], fu[NU];
      lds<T, NX>(f, in.F + k * NX);
      lds<T, NU>(fu, in.Fu + k * NU);
#pragma unroll
      for (int j = 0; j < NX; ++j) vf[j] = k == 0 ? V[0] * f[j] : vf[j] + V[k] * f[j];
#pragma unroll
      for (int c = 0; c < NU; ++c) vfu[c] = k == 0 ? V[0] * fu[c] : vfu[c] + V[k] * fu[c];
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) g.VS[j * NX + r] = vf[j];
#pragma unroll
    for (int c = 0; c < NU; ++c) g.VFu[r * NUP + c] = vfu[c];
  }
  __syncwarp();

  // ---- B ----
  T qxx[NX], qux[NU], qx = T(0), qu[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) qu[a] = T(0);
  if (own) {
    T vfc[NX];
    lds<T, NX>(vfc, g.VS + r * NX);  // column r of V_xx F
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T f[NX];
      lds<T, NX>(f, in.F + k * NX);
#pragma unroll
      for (int i = 0; i < NX; ++i) qxx[i] = k == 0 ? f[i] * vfc[0] : qxx[i] + f[i] * vfc[k];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) qxx[i] = in.lxx[i * NX + r] + qxx[i];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = in.Fu[a] * vfc[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s += in.Fu[k * NU + a] * vfc[k];
      qux[a] = in.lux[a * NX + r] + s;
    }
    {
      T vm[NX];
      lds<T, NX>(vm, g.Vm);
      T s = in.F[r] * vm[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s += in.F[k * NX + r] * vm[k];
      qx = in.lx[r] + s;
    }
  } else if (r == NX) {
    T vm[NX];
    lds<T, NX>(vm, g.Vm);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = in.Fu[a] * vm[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s += in.Fu[k * NU + a] * vm[k];
      qu[a] = in.lu[a] + s;
      g.Qu[a] = qu[a];
    }
  }
  if (r < NU) {
    T q[NU];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T vfu[NUP];
      lds<T, NUP>(vfu, g.VFu + k * NUP);
      const T fk = in.Fu[k * NU + r];
#pragma unroll
      for (int c = 0; c < NU; ++c) q[c] = k == 0 ? fk * vfu[c] : q[c] + fk * vfu[c];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) g.Quu[r * NUP + c] = in.luu[r * NU + c] + q[c];
  }
  __syncwarp();

  // ---- C ----
  T Q[NU * NU], L[NU * NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T row[NUP];
    lds<T, NUP>(row, g.Quu + a * NUP);
#pragma unroll
    for (int c = 0; c < NU; ++c) Q[a * NU + c] = row[c];
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T s = Q[j * NU + j];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) s = s - L[j * NU + kk] * L[j * NU + kk];
    L[j * NU + j] = xsqrt(s);
    const T inv = T(1) / L[j * NU + j];
#pragma unroll
    for (int i = j + 1; i < NU; ++i) {
      T s2 = Q[i * NU + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i * NU + kk] * L[j * NU + kk];
      L[i * NU + j] = s2 * inv;
    }
  }
  T kc[NU];  // column r of K (r < NX) or k (r = NX)
  {
    T Y[NU], X[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T s = own ? qux[i] : qu[i];
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
    for (int a = 0; a < NU; ++a) kc[a] = -X[a];
  }
  T kq[NU];
  if (own) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      g.KT[r * NUP + a] = kc[a];
      g.QuxT[r * NUP + a] = qux[a];
      out.K[(a * NX + r) * kOutStride] = kc[a];
      T s = kc[0] * Q[a];
#pragma unroll
      for (int c = 1; c < NU; ++c) s += kc[c] * Q[c * NU + a];
      kq[a] = s;
      g.KQ[r * NUP + a] = s;
    }
  } else if (r == NX) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      g.KT[NX * NUP + a] = kc[a];
      out.k[a * kOutStride] = kc[a];
    }
  }
  __syncwarp();

  // ---- D ----
  T xcol[NX];
  if (own) {
    T kk[NUP], quv[NUP];
    lds<T, NUP>(kk, g.KT + NX * NUP);
    lds<T, NUP>(quv, g.Qu);
    T s1 = kq[0] * kk[0], s2 = kc[0] * quv[0], s3 = qux[0] * kk[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s1 += kq[a] * kk[a];
      s2 += kc[a] * quv[a];
      s3 += qux[a] * kk[a];
    }
    Vx = ((qx + s1) + s2) + s3;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T kqi[NUP], kti[NUP], qti[NUP];
      lds<T, NUP>(kqi, g.KQ + i * NUP);
      lds<T, NUP>(kti, g.KT + i * NUP);
      lds<T, NUP>(qti, g.QuxT + i * NUP);
      T av = kqi[0] * kc[0], bv = kti[0] * qux[0], cv = qti[0] * kc[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) {
        av += kqi[a] * kc[a];
        bv += kti[a] * qux[a];
        cv += qti[a] * kc[a];
      }
      xcol[i] = ((qxx[i] + av) + bv) + cv;
      g.VS[i * NX + r] = xcol[i];
    }
  }
  __syncwarp();

  // ---- E ----
  if (own) {
    T xrow[NX];
    lds<T, NX>(xrow, g.VS + r * NX);
#pragma unroll
    for (int j = 0; j < NX; ++j) V[j] = T(0.5) * (xrow[j] + xcol[j]);
  }
}

// The stage loop, from the carry of stage N (Lx[N], Lxx[N]) down to stage 0:
// while the group computes stage t, the block copies stage t - 1's inputs
// into the other stage buffer and stores stage t + 1's outputs from the other
// output buffer; one block barrier per stage makes each stage's copies
// visible.  Problems past B (the ragged last block) run problem B - 1's
// recursion and store nothing.
template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kGroupThreads) fast_riccati_kernel(FastRiccatiArgs<T> a) {
  using L = FastLayout<T, NX, NU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B, N = a.N, b0 = blockIdx.x * kProblems, bc = min(b0 + g, B - 1);
  auto& gs = *reinterpret_cast<FastScratch<T, NX, NU>*>(smem + L::ogroup + g * L::gstride);
  unsigned char* stage = smem + L::ostage;
  unsigned char* outb = smem + L::oout;
  T V[NX], Vx = T(0);
#pragma unroll
  for (int j = 0; j < NX; ++j) V[j] = T(0);
  if (r < NX) {
    const Lane<const T> lxx = lane<NX * NX>(a.Lxx, N, B, bc);
#pragma unroll
    for (int j = 0; j < NX; ++j) V[j] = lxx[r * NX + j];
    Vx = lane<NX>(a.Lx, N, B, bc)[r];
  }
  fast_copy<T, NX, NU>(stage, a, N - 1, b0, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      fast_copy<T, NX, NU>(stage + (cur ^ 1) * L::stage, a, t - 1, b0, tid);
      cp_async_commit();
    }
    if (t < N - 1) fast_store<T, NX, NU>(a, outb + ((t + 1) & 1) * L::out, t + 1, b0, tid);
    fast_group_step<T, NX, NU>(r, V, Vx, fast_in<T, NX, NU>(stage + cur * L::stage, g), gs,
                               fast_out<T, NX, NU>(outb + (t & 1) * L::out, g));
  }
  __syncthreads();
  fast_store<T, NX, NU>(a, outb, 0, b0, tid);
}

template <typename T, int NX, int NU>
int launch_fast_riccati(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  constexpr size_t bytes = FastLayout<T, NX, NU>::bytes;
  if (cudaError_t e = cudaFuncSetAttribute(fast_riccati_kernel<T, NX, NU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  fast_riccati_kernel<T, NX, NU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// B13 at nx = 6, (6, 3): B11's design (so3.cu).  One thread per problem on
// blocks of one warp (ahead.cuh: B / 32 blocks over all SMs, 256 at B =
// 8192), the carry (V_x, V_xx) and the stage's products in registers; each
// thread copies stage t - 1's 132 inputs into its own shared-memory column
// with cp.async while it computes stage t, so the chain no longer waits on
// device memory, and reads back only what it copied (no barrier): 1.20 ms
// at B = 8192, N = 249, against 1.45 for the same step reading device
// memory inside the chain on 128-thread blocks and 1.79 for the group
// design, whose fixed cost per stage (five warp barriers, a block barrier,
// the staged copies for 7 busy lanes of 16) outweighed its warps at this
// size (PERF.md).  The same step, sum order and Cholesky as the group
// kernel's.

// The entries of one stage in a thread's column.
template <int NX, int NU>
struct FastColumn {
  static constexpr int Fx = 0, Fu = NX * NX, d = Fu + NX * NU, lx = d + NX, lu = lx + NX,
                       lxx = lu + NU, lux = lxx + NX * NX, luu = lux + NU * NX,
                       n = luu + NU * NU;
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void fast_column_copy(T* col, const FastRiccatiArgs<T>& a, int t,
                                                 int b) {
  using C = FastColumn<NX, NU>;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<NX * NX>(col + C::Fx * P, a.Fx, t, B, b);
  copy_column<NX * NU>(col + C::Fu * P, a.Fu, t, B, b);
  copy_column<NX>(col + C::d * P, a.d, t, B, b);
  copy_column<NX>(col + C::lx * P, a.Lx, t, B, b);
  copy_column<NU>(col + C::lu * P, a.Lu, t, B, b);
  copy_column<NX * NX>(col + C::lxx * P, a.Lxx, t, B, b);
  copy_column<NU * NX>(col + C::lux * P, a.Lux, t, B, b);
  copy_column<NU * NU>(col + C::luu * P, a.Luu, t, B, b);
  cp_async_commit();
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kAheadThreads) fast_riccati_thread_kernel(FastRiccatiArgs<T> a) {
  using C = FastColumn<NX, NU>;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x;
  if (b >= B) return;
  T* col = reinterpret_cast<T*>(smem) + threadIdx.x;  // slot s at col + s * C::n * P
  constexpr int NC = NX + 1;  // Q_ux's NX columns and Q_u
  T Vx[NX], V[NX * NX];
  load<NX>(Vx, lane<NX>(a.Lx, N, B, b));
  load<NX * NX>(V, lane<NX * NX>(a.Lxx, N, B, b));
  fast_column_copy<T, NX, NU>(col, a, N - 1, b);
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    if (t > 0) fast_column_copy<T, NX, NU>(col + (cur ^ 1) * C::n * P, a, t - 1, b);
    const T* in = col + cur * C::n * P;
    const Lane<const T> F = column(in + C::Fx * P);
    store<NX>(lane<NX>(a.Vx1, t, B, b), Vx);
    store<NX * NX>(lane<NX * NX>(a.Vxx1, t, B, b), V);
    T Fu[NX * NU];
    load<NX * NU>(Fu, column(in + C::Fu * P));
    // Vmod = V_x + V_xx d
    T Vmod[NX];
    {
      T dd[NX];
      load<NX>(dd, column(in + C::d * P));
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
      const Lane<const T> luu = column(in + C::luu * P);
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
      const Lane<const T> lx = column(in + C::lx * P);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = F[i] * Vmod[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s += F[k * NX + i] * Vmod[k];
        Qx[i] = lx[i] + s;
      }
      const Lane<const T> lu = column(in + C::lu * P);
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
      const Lane<const T> lux = column(in + C::lux * P);
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
      const Lane<const T> lxx = column(in + C::lxx * P);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T qcol[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T s = F[i] * V[j];
#pragma unroll
          for (int k = 1; k < NX; ++k) s += F[k * NX + i] * V[k * NX + j];
          qcol[i] = s;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) V[i * NX + j] = lxx[i * NX + j] + qcol[i];
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

template <typename T, int NX, int NU>
int launch_fast_riccati_thread(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  constexpr size_t bytes = 2 * FastColumn<NX, NU>::n * kAheadThreads * sizeof(T);
  if (cudaError_t e = cudaFuncSetAttribute(fast_riccati_thread_kernel<T, NX, NU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  fast_riccati_thread_kernel<T, NX, NU><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// B13 at any other (nx, nu) with nx, nu <= kAnyMax (the JAX kernel takes
// the shapes from its arguments): one thread per problem on blocks of
// kThreads, the shape a runtime argument, the stage's inputs read from
// global memory as the step needs them (batch-last, so a warp's read of an
// entry is 32 neighbouring problems) and the carry and the step's products
// in arrays sized for kAnyMax, which live in local memory.  The same step,
// sum order and Cholesky as the thread kernel above; no copy-ahead and no
// group design: it serves shapes no model family of the package has.
constexpr int kAnyMax = 12;

template <typename T>
__global__ void __launch_bounds__(kThreads) fast_riccati_any_kernel(FastRiccatiArgs<T> a) {
  constexpr int M = kAnyMax;
  const int B = a.B, N = a.N, nx = a.nx, nu = a.nu, b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu, nc = nx + 1;
  const auto at = [&](const T* base, int ne, int t) {
    return Lane<const T>{base + ((long long)t * ne) * B + b, B};
  };
  const auto out = [&](T* base, int ne, int t) {
    return Lane<T>{base + ((long long)t * ne) * B + b, B};
  };
  T Vx[M], V[M * M];
  {
    const Lane<const T> lx = at(a.Lx, nx, N), lxx = at(a.Lxx, nxx, N);
    for (int i = 0; i < nx; ++i) Vx[i] = lx[i];
    for (int e = 0; e < nxx; ++e) V[e] = lxx[e];
  }
  for (int t = N - 1; t >= 0; --t) {
    const Lane<const T> F = at(a.Fx, nxx, t), Fu = at(a.Fu, nxu, t);
    {
      const Lane<T> vo = out(a.Vx1, nx, t), vvo = out(a.Vxx1, nxx, t);
      for (int i = 0; i < nx; ++i) vo[i] = Vx[i];
      for (int e = 0; e < nxx; ++e) vvo[e] = V[e];
    }
    // Vmod = V_x + V_xx d
    T Vmod[M];
    {
      const Lane<const T> dd = at(a.d, nx, t);
      for (int i = 0; i < nx; ++i) {
        T s = V[i * nx] * dd[0];
        for (int j = 1; j < nx; ++j) s += V[i * nx + j] * dd[j];
        Vmod[i] = Vx[i] + s;
      }
    }
    // Q_uu = L_uu + Fu^T (V_xx Fu)
    T Quu[M * M];
    {
      T VFu[M * M];
      for (int i = 0; i < nx; ++i)
        for (int c = 0; c < nu; ++c) {
          T s = V[i * nx] * Fu[c];
          for (int k = 1; k < nx; ++k) s += V[i * nx + k] * Fu[k * nu + c];
          VFu[i * nu + c] = s;
        }
      const Lane<const T> luu = at(a.Luu, nuu, t);
      for (int r = 0; r < nu; ++r)
        for (int c = 0; c < nu; ++c) {
          T s = Fu[r] * VFu[c];
          for (int k = 1; k < nx; ++k) s += Fu[k * nu + r] * VFu[k * nu + c];
          Quu[r * nu + c] = luu[r * nu + c] + s;
        }
    }
    // Q_x = L_x + F^T Vmod, Q_u = L_u + Fu^T Vmod
    T Qx[M], Qu[M];
    {
      const Lane<const T> lx = at(a.Lx, nx, t), lu = at(a.Lu, nu, t);
      for (int i = 0; i < nx; ++i) {
        T s = F[i] * Vmod[0];
        for (int k = 1; k < nx; ++k) s += F[k * nx + i] * Vmod[k];
        Qx[i] = lx[i] + s;
      }
      for (int r = 0; r < nu; ++r) {
        T s = Fu[r] * Vmod[0];
        for (int k = 1; k < nx; ++k) s += Fu[k * nu + r] * Vmod[k];
        Qu[r] = lu[r] + s;
      }
    }
    // V <- V_xx F, row by row
    for (int i = 0; i < nx; ++i) {
      T row[M];
      for (int j = 0; j < nx; ++j) {
        T s = V[i * nx] * F[j];
        for (int k = 1; k < nx; ++k) s += V[i * nx + k] * F[k * nx + j];
        row[j] = s;
      }
      for (int j = 0; j < nx; ++j) V[i * nx + j] = row[j];
    }
    // Q_ux = L_ux + Fu^T (V_xx F)
    T Qux[M * M];
    {
      const Lane<const T> lux = at(a.Lux, nxu, t);
      for (int r = 0; r < nu; ++r)
        for (int j = 0; j < nx; ++j) {
          T s = Fu[r] * V[j];
          for (int k = 1; k < nx; ++k) s += Fu[k * nu + r] * V[k * nx + j];
          Qux[r * nx + j] = lux[r * nx + j] + s;
        }
    }
    // V <- Q_xx = L_xx + F^T (V_xx F), column by column
    {
      const Lane<const T> lxx = at(a.Lxx, nxx, t);
      for (int j = 0; j < nx; ++j) {
        T qcol[M];
        for (int i = 0; i < nx; ++i) {
          T s = F[i] * V[j];
          for (int k = 1; k < nx; ++k) s += F[k * nx + i] * V[k * nx + j];
          qcol[i] = s;
        }
        for (int i = 0; i < nx; ++i) V[i * nx + j] = lxx[i * nx + j] + qcol[i];
      }
    }
    // Cholesky Q_uu = L L^T
    T L[M * M];
    for (int j = 0; j < nu; ++j) {
      T s = Quu[j * nu + j];
      for (int kk = 0; kk < j; ++kk) s = s - L[j * nu + kk] * L[j * nu + kk];
      L[j * nu + j] = xsqrt(s);
      const T inv = T(1) / L[j * nu + j];
      for (int i = j + 1; i < nu; ++i) {
        T s2 = Quu[i * nu + j];
        for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i * nu + kk] * L[j * nu + kk];
        L[i * nu + j] = s2 * inv;
      }
    }
    // [K | k] = -Q_uu^-1 [Q_ux | Q_u]
    T Kc[M * (M + 1)];
    for (int c = 0; c < nc; ++c) {
      T Y[M], X[M];
      for (int i = 0; i < nu; ++i) {
        T s = c < nx ? Qux[i * nx + c] : Qu[i];
        for (int kk = 0; kk < i; ++kk) s = s - L[i * nu + kk] * Y[kk];
        Y[i] = s / L[i * nu + i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        T s = Y[i];
        for (int kk = i + 1; kk < nu; ++kk) s = s - L[kk * nu + i] * X[kk];
        X[i] = s / L[i * nu + i];
      }
      for (int i = 0; i < nu; ++i) Kc[i * nc + c] = -X[i];
    }
    {
      const Lane<T> Ko = out(a.K, nxu, t), ko = out(a.k, nu, t);
      for (int r = 0; r < nu; ++r) {
        for (int j = 0; j < nx; ++j) Ko[r * nx + j] = Kc[r * nc + j];
        ko[r] = Kc[r * nc + nx];
      }
    }
    // KTQuu = K^T Q_uu (nx x nu)
    T KTQuu[M * M];
    for (int i = 0; i < nx; ++i)
      for (int c = 0; c < nu; ++c) {
        T s = Kc[i] * Quu[c];
        for (int r = 1; r < nu; ++r) s += Kc[r * nc + i] * Quu[r * nu + c];
        KTQuu[i * nu + c] = s;
      }
    // V_x = Q_x + K^T Q_uu k + K^T Q_u + Q_ux^T k
    for (int i = 0; i < nx; ++i) {
      T s1 = KTQuu[i * nu] * Kc[nx], s2 = Kc[i] * Qu[0], s3 = Qux[i] * Kc[nx];
      for (int r = 1; r < nu; ++r) {
        s1 += KTQuu[i * nu + r] * Kc[r * nc + nx];
        s2 += Kc[r * nc + i] * Qu[r];
        s3 += Qux[r * nx + i] * Kc[r * nc + nx];
      }
      Vx[i] = ((Qx[i] + s1) + s2) + s3;
    }
    // V_xx = sym(Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K), in place
    for (int i = 0; i < nx; ++i)
      for (int j = i; j < nx; ++j) {
        T aij = KTQuu[i * nu] * Kc[j], aji = KTQuu[j * nu] * Kc[i];
        T bij = Kc[i] * Qux[j], bji = Kc[j] * Qux[i];
        T cij = Qux[i] * Kc[j], cji = Qux[j] * Kc[i];
        for (int r = 1; r < nu; ++r) {
          aij += KTQuu[i * nu + r] * Kc[r * nc + j];
          aji += KTQuu[j * nu + r] * Kc[r * nc + i];
          bij += Kc[r * nc + i] * Qux[r * nx + j];
          bji += Kc[r * nc + j] * Qux[r * nx + i];
          cij += Qux[r * nx + i] * Kc[r * nc + j];
          cji += Qux[r * nx + j] * Kc[r * nc + i];
        }
        const T xij = ((V[i * nx + j] + aij) + bij) + cij;
        const T xji = ((V[j * nx + i] + aji) + bji) + cji;
        const T h = T(0.5) * (xij + xji);
        V[i * nx + j] = h;
        V[j * nx + i] = h;
      }
  }
}

template <typename T>
int launch_fast_riccati_any(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  if (a.nx < 1 || a.nu < 1 || a.nx > kAnyMax || a.nu > kAnyMax) return (int)cudaErrorInvalidValue;
  fast_riccati_any_kernel<T><<<batch_grid(a.B), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- B14 ------------------------------------------------------------------
// Replaces ops/pallas_rollout.py::_rollout_kernel (pallas_rollout): B4's
// gap-closing step for the free body, with Exp(d_q) and f(x_i)^-1 read
// precomputed as the TPU kernel takes them.  Shares stage.cuh's deviation
// (se3 inverse, compose, log), free-body dynamics evaluation (with the
// identity input projection) and quaternion renormalization with B4.
// What bounds it on an H100: it reads 138 values (of d only the twist rows)
// and writes 24 per stage and problem (0.32 ms at B = 8192, N = 200), in a
// chain of dependent steps serial over the stages.  B4's design (ahead.cuh):
// one thread per problem on blocks of one warp (B / 32 blocks over all
// SMs), the carry (R, p, xi) in registers; each thread copies stage t + 1's
// inputs into its own shared-memory column with cp.async while it computes
// stage t, and reads back only what it copied (no barrier).  Once a stage's
// column has landed, the carry-independent part, G_t = (q_{t+1} Exp(d_q))
// f(x_t)^-1 and the nominal inverse q_t^-1, is computed off the chain, so
// the chain is Log(q_t^-1 q), the feedback, the dynamics, G_t f and the
// renormalization: the same functions in the same order as rollout_plain.
// 0.80 ms at B = 8192, N = 200, against 1.68 for the same step reading
// device memory inside the chain on 128-thread blocks (PERF.md).
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

// The entries of one stage in a thread's column: the nominal x_t and
// x_{t+1} (both in the column, so that no nominal is carried in registers
// through the chain: B4's choice), u_t, the gains, the twist rows of the
// defect, the nominal's twist evaluation, Exp(d_q) and f(x_t)^-1.
struct FastRolloutColumn {
  static constexpr int Rt = 0, pt = 9, xit = 12, Rn = 18, pn = 27, xin = 30, u = 36, k = 42,
                       K = 48, dxi = 120, fxi = 126, edR = 132, edp = 141, fiR = 144,
                       fip = 153, n = 156;
};

template <typename T>
__device__ __forceinline__ void fast_rollout_copy(T* col, const FastRolloutArgs<T>& a, int t,
                                                  int b) {
  using C = FastRolloutColumn;
  constexpr int P = kAheadThreads;
  const int B = a.B;
  copy_column<9>(col + C::Rt * P, a.qR, t, B, b);
  copy_column<3>(col + C::pt * P, a.qp, t, B, b);
  copy_column<6>(col + C::xit * P, a.xi, t, B, b);
  copy_column<9>(col + C::Rn * P, a.qR, t + 1, B, b);
  copy_column<3>(col + C::pn * P, a.qp, t + 1, B, b);
  copy_column<6>(col + C::xin * P, a.xi, t + 1, B, b);
  copy_column<6>(col + C::u * P, a.u, t, B, b);
  copy_column<6>(col + C::k * P, a.k, t, B, b);
  copy_column<72>(col + C::K * P, a.K, t, B, b);
  copy_column<6, 12>(col + C::dxi * P, a.d + 6LL * B, t, B, b);  // rows 6..11 of d
  copy_column<6>(col + C::fxi * P, a.fxi, t, B, b);
  copy_column<9>(col + C::edR * P, a.edR, t, B, b);
  copy_column<3>(col + C::edp * P, a.edp, t, B, b);
  copy_column<9>(col + C::fiR * P, a.fiR, t, B, b);
  copy_column<3>(col + C::fip * P, a.fip, t, B, b);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kAheadThreads) fast_rollout_kernel(FastRolloutArgs<T> a) {
  using C = FastRolloutColumn;
  constexpr int P = kAheadThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, b = blockIdx.x * P + threadIdx.x;
  if (b >= B) return;
  T* col = reinterpret_cast<T*>(smem) + threadIdx.x;  // slot s at col + s * C::n * P
  T eye[36];  // the free body's wrench takes u directly
#pragma unroll
  for (int i = 0; i < 36; ++i) eye[i] = i % 7 == 0 ? T(1) : T(0);
  const Consts<T> c{a.J, a.Jinv, nullptr, nullptr, nullptr, nullptr, eye,
                    nullptr, nullptr, T(0), a.dt, 0, 0};
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, b));
  load<3>(p, lane<3>(a.qp, 0, B, b));
  load<6>(xi, lane<6>(a.xi, 0, B, b));
  fast_rollout_copy(col, a, 0, b);
  for (int t = 0; t < N; ++t) {
    cp_async_wait_all();
    if (t + 1 < N) fast_rollout_copy(col + ((t + 1) & 1) * C::n * P, a, t + 1, b);
    const T* cur = col + (t & 1) * C::n * P;
    const auto in = [&](int e) { return column(cur + e * P); };
    // off the chain: q_t^-1 and G_t = (q_{t+1} Exp(d_q)) f(x_t)^-1
    T Ri[9], pi[3], GR[9], Gp[3];
    {
      T Rt[9], pt[3], Rn[9], pn[3], Ed[9], ed[3], Fi[9], fi[3], Ra[9], pa[3];
      load<9>(Rt, in(C::Rt));
      load<3>(pt, in(C::pt));
      load<9>(Rn, in(C::Rn));
      load<3>(pn, in(C::pn));
      load<9>(Ed, in(C::edR));
      load<3>(ed, in(C::edp));
      load<9>(Fi, in(C::fiR));
      load<3>(fi, in(C::fip));
      se3_inverse(Ri, pi, Rt, pt);
      se3_compose(Ra, pa, Rn, pn, Ed, ed);
      se3_compose(GR, Gp, Ra, pa, Fi, fi);
    }
    T xs_err[12];
    {
      T xit[6], Re[9], pe[3];
      load<6>(xit, in(C::xit));
      se3_compose(Re, pe, Ri, pi, R, p);
      se3_log(xs_err, Re, pe);
#pragma unroll
      for (int i = 0; i < 6; ++i) xs_err[6 + i] = xi[i] - xit[i];
    }
    T u[6];
    {
      const Lane<const T> ut = in(C::u), kt = in(C::k), Kt = in(C::K);
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
    se3_compose(R, p, GR, Gp, fqR, fqp);
    so3_normalize(R);
    {
      const Lane<const T> xin = in(C::xin), fxt = in(C::fxi), dxi = in(C::dxi);
#pragma unroll
      for (int i = 0; i < 6; ++i) xi[i] = ((xin[i] + fxn[i]) - fxt[i]) + dxi[i];
    }
    store<9>(lane<9>(a.oR, t, B, b), R);
    store<3>(lane<3>(a.op, t, B, b), p);
    store<6>(lane<6>(a.oxi, t, B, b), xi);
    store<6>(lane<6>(a.ou, t, B, b), u);
  }
}

template <typename T>
int launch_fast_rollout(const FastRolloutArgs<T>& a, cudaStream_t s) {
  constexpr size_t bytes = 2 * FastRolloutColumn::n * kAheadThreads * sizeof(T);
  if (cudaError_t e = cudaFuncSetAttribute(fast_rollout_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  fast_rollout_kernel<T><<<ahead_grid(a.B), kAheadThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
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
  a.N = N; a.B = B; a.nx = nx; a.nu = nu;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nx == 12 && nu == 6) return traopt::launch_fast_riccati<T, 12, 6>(a, s);
  if (nx == 12 && nu == 4) return traopt::launch_fast_riccati<T, 12, 4>(a, s);
  if (nx == 6 && nu == 3) return traopt::launch_fast_riccati_thread<T, 6, 3>(a, s);
  return (int)cudaErrorInvalidValue;
}

// B13's runtime-shape instance at any (nx, nu) with nx, nu <= 12, tuned
// shape or not (ops/riccati.py calls it for the shapes fast_riccati has no
// instance for).
extern "C" int TRAOPT_FN(fast_riccati_any)(
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
  a.N = N; a.B = B; a.nx = nx; a.nu = nu;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  return traopt::launch_fast_riccati_any<T>(a, (cudaStream_t)stream);
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
  return traopt::launch_fast_rollout<T>(a, s);
}
