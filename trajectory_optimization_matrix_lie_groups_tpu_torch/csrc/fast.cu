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
// (group.cuh), and so does B13 at any other shape up to (12, 12), the shape
// a runtime argument, and past nu = 12 (fast_large.cuh: Q_uu, its factor
// and the solves in the group's shared memory); B13 at (6, 3) and B14 one
// problem per thread on blocks
// of one warp with the carry in registers and each stage's inputs copied a
// stage ahead into shared memory (ahead.cuh).
#include "ahead.cuh"
#include "common.cuh"
#include "fast_large.cuh"
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
// Its arguments, FastRiccatiArgs, are in fast_large.cuh.

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

// B13 at any other (nx, nu) with nx, nu <= kAnyMax.  Replaces
// ops/pallas_riccati.py::_riccati_kernel (pallas_backward), which takes the
// shape from its arguments.  What bounds it on an H100: its bytes, as at the
// tuned shapes (591 values per problem and stage at (12, 3): 1.16 ms at
// B = 8192, N = 200).  The design is the tuned group kernel's with the
// shape a runtime argument: a group of kGroup = 16 threads per problem,
// kProblems = 8 problems per block (B / 8 blocks: 128 at B = 1024); lane
// r < nx keeps row r of V_xx and V_x[r] in registers, lane nx forms Q_u
// and k, lanes a < nu row a of Q_uu (with nu > nx, lanes past nx); the
// group exchanges its products through its scratch; the block copies stage
// t - 1's inputs into shared memory with cp.async while it computes stage t
// and stages its outputs to store them coalesced, one block barrier a
// stage.  The shared memory is laid out at launch from the runtime shape
// (FastAnyLayout: runtime row pitches, nx or nu rows a region), so a small
// shape takes little of it and more blocks fit on an SM.  Three instances,
// each with its per-lane arrays sized for maxima (MX, MU): (6, 6) for
// nx, nu <= 6, (12, 6) for nu <= 6, (12, 12) past it.  A loop over a
// matrix's rows runs to nx or nu at run time, reading the rows from shared
// memory; a loop over a row's entries is unrolled to the maximum under a
// guard (j < nx, c < nu) into register accumulators indexed by constants.
// Two things keep the registers down: every register array is written
// whole before any guarded update (a value defined only under a guard stays
// live back to its previous definition), and every address of the stage
// loop is derived anew each stage (opaque_zero), not held one per region
// and row across the loop.  The NU x NU Cholesky is the
// group's: lane a computes row a of L, one column a warp barrier, the rows
// exchanged through the scratch (every lane holding all of L, as the tuned
// kernel does, would take nu^2 registers); then lane c <= nx solves one
// right-hand side in row c of K^T.  Lane r's column of Q_xx waits for phase
// D in its problem's L_xx column (only lane r reads it), X's column in the
// scratch.  Every entry keeps the one-thread step's sum order and Cholesky
// (the k-loop outermost where an entry sums over k), so the result agrees
// with backward_plain to rounding.
constexpr int kAnyMax = 12;

// The block's shared memory for a runtime (nx, nu), in elements of T, each
// region a whole number of 16-byte vectors.
struct FastAnyLayout {
  int nx, nu, px, pu;  // the shape; the row pitches of nx- and nu-wide rows
  RowCopy in[8];       // F, Fu, d, lx, lu, lxx, lux, luu in a stage buffer
  int stage;           // one stage buffer
  int ek, eVx, eVxx, out;  // an output buffer: entries of k, Vx1, Vxx1 (K at 0); its size
  // a group's scratch: V_x + V_xx d, Q_u, (V_xx F)^T then X^T (rows of px),
  // V_xx Fu, K^T (row nx: k), K^T Q_uu, Q_ux^T, Q_uu, L (rows of pu); its stride
  int Vm, Qu, VS, VFu, KT, KQ, QuxT, Quu, L, group;
  int oout, ogroup;    // the block: two stage buffers at 0, two output buffers, the scratch
  size_t bytes;
};

template <typename T>
FastAnyLayout fast_any_layout(int nx, int nu) {
  FastAnyLayout l{};
  l.nx = nx;
  l.nu = nu;
  const int px = l.px = vpad<T>(nx), pu = l.pu = vpad<T>(nu);
  int off = 0;
  const auto place = [&](int k, int rows, int cols, int rp) {
    const int pt = spread_pitch<T>(rows * rp);
    l.in[k] = row_copy(off, pt, rows, cols, rp);
    off += kProblems * pt;
  };
  place(0, nx, nx, px);
  place(1, nx, nu, pu);
  place(2, 1, nx, nx);
  place(3, 1, nx, nx);
  place(4, 1, nu, nu);
  place(5, nx, nx, px);
  place(6, nu, nx, px);
  place(7, nu, nu, pu);
  l.stage = off;
  l.ek = nu * nx;
  l.eVx = l.ek + nu;
  l.eVxx = l.eVx + nx;
  l.out = vpad<T>((l.eVxx + nx * nx) * kOutStride);
  l.Vm = 0;
  l.Qu = px;
  l.VS = l.Qu + pu;
  l.VFu = l.VS + nx * px;
  l.KT = l.VFu + nx * pu;
  l.KQ = l.KT + (nx + 1) * pu;
  l.QuxT = l.KQ + nx * pu;
  l.Quu = l.QuxT + nx * pu;
  l.L = l.Quu + nu * pu;
  l.group = (int)(group_stride((l.L + nu * pu) * sizeof(T)) / sizeof(T));
  l.oout = 2 * l.stage;
  l.ogroup = l.oout + 2 * l.out;
  l.bytes = (size_t)(l.ogroup + kProblems * l.group) * sizeof(T);
  return l;
}

template <typename T>
struct FastAnyArgs {
  FastRiccatiArgs<T> a;
  FastAnyLayout l;
};

// One problem's view of a stage buffer; lxx is also where lane r keeps
// column r of Q_xx from phase B to phase D.
template <typename T>
struct FastAnyIn {
  const T *F, *Fu, *d, *lx, *lu;
  T* lxx;
  const T *lux, *luu;
};

// Entries 0 .. n - 1 (n <= M) of a 16-byte-aligned row of shared memory, in
// 16-byte loads; a partial last vector also fills the entries from n to the
// vector's end with the row's padding, which no sum reads, and the entries
// past it are 0.  Every entry is written, so that no register holds a value
// defined only under a guard (the compiler would keep such a register live
// back to wherever it was last defined).
template <typename T, int M>
__device__ __forceinline__ void ldsn(T (&dst)[M], const T* src, int n) {
  constexpr int v = 16 / sizeof(T);
  static_assert(M % v == 0, "a whole number of vectors");
#pragma unroll
  for (int i = 0; i < M / v; ++i) {
    if constexpr (sizeof(T) == 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i * v < n) x = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = x.x;
      dst[4 * i + 1] = x.y;
      dst[4 * i + 2] = x.z;
      dst[4 * i + 3] = x.w;
    } else {
      double2 x = make_double2(0.0, 0.0);
      if (i * v < n) x = reinterpret_cast<const double2*>(src)[i];
      dst[2 * i] = x.x;
      dst[2 * i + 1] = x.y;
    }
  }
}

// fast_group_step with (nx, nu) = (l.nx, l.nu) at run time: the same phases
// A-E (C: the group's Cholesky, then the solves), the same sums in the same
// order.  A loop over a matrix's rows runs to nx or nu at run time and keeps
// to shared memory (the row of V_xx it multiplies from the staging buffer,
// the solves' unknowns in K^T's row), so that no register array is indexed
// by it; a loop over a row's entries is unrolled to the maximum (MX or MU)
// under a guard and accumulates in registers.  Every lane of the warp calls
// it.
template <typename T, int MX, int MU>
__device__ __forceinline__ void fast_any_step(int r, T (&V)[vpad<T>(MX)], T& Vx,
                                              const FastAnyLayout& l, const FastAnyIn<T>& in,
                                              T* gs, const FastOut<T>& out) {
  constexpr int PX = vpad<T>(MX), PU = vpad<T>(MU);  // the arrays' sizes
  const int nx = l.nx, nu = l.nu, px = l.px, pu = l.pu;
  const bool own = r < nx;
  T *Vm = gs + l.Vm, *Qu = gs + l.Qu, *VS = gs + l.VS, *VFu = gs + l.VFu, *KT = gs + l.KT,
    *KQ = gs + l.KQ, *QuxT = gs + l.QuxT, *Quu = gs + l.Quu, *Ls = gs + l.L;

  // ---- A ----
  if (own) {
    T* Vo = out.Vxx + r * nx * kOutStride;  // row r of V_xx, staged
    out.Vx[r * kOutStride] = Vx;
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) Vo[j * kOutStride] = V[j];
    {
      T dd[PX];
      ldsn(dd, in.d, nx);
      T s = V[0] * dd[0];
#pragma unroll
      for (int j = 1; j < MX; ++j)
        if (j < nx) s += V[j] * dd[j];
      Vm[r] = Vx + s;
    }
    T vf[PX] = {}, vfu[PU] = {};
    {
      T f[PX], fu[PU];
      ldsn(f, in.F, nx);
      ldsn(fu, in.Fu, nu);
#pragma unroll
      for (int j = 0; j < MX; ++j)
        if (j < nx) vf[j] = V[0] * f[j];
#pragma unroll
      for (int c = 0; c < MU; ++c)
        if (c < nu) vfu[c] = V[0] * fu[c];
    }
#pragma unroll 1
    for (int k = 1; k < nx; ++k) {
      T f[PX], fu[PU];
      ldsn(f, in.F + k * px, nx);
      ldsn(fu, in.Fu + k * pu, nu);
      const T vk = Vo[k * kOutStride];
#pragma unroll
      for (int j = 0; j < MX; ++j)
        if (j < nx) vf[j] = vf[j] + vk * f[j];
#pragma unroll
      for (int c = 0; c < MU; ++c)
        if (c < nu) vfu[c] = vfu[c] + vk * fu[c];
    }
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) VS[j * px + r] = vf[j];
#pragma unroll
    for (int c = 0; c < MU; ++c)
      if (c < nu) VFu[r * pu + c] = vfu[c];
  }
  __syncwarp();

  // ---- B ----
  T qx = T(0);
  if (own) {  // column r of Q_xx (into L_xx's), of Q_ux (row r of QuxT), Q_x[r]
    const T* vfc = VS + r * px;  // column r of V_xx F
    T qxx[PX] = {}, qs[PU] = {};
    {
      T f[PX], fu[PU];
      ldsn(f, in.F, nx);
      ldsn(fu, in.Fu, nu);
      const T v0 = vfc[0];
#pragma unroll
      for (int i = 0; i < MX; ++i)
        if (i < nx) qxx[i] = f[i] * v0;
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) qs[a] = fu[a] * v0;
    }
#pragma unroll 1
    for (int k = 1; k < nx; ++k) {
      T f[PX], fu[PU];
      ldsn(f, in.F + k * px, nx);
      ldsn(fu, in.Fu + k * pu, nu);
      const T vk = vfc[k];
#pragma unroll
      for (int i = 0; i < MX; ++i)
        if (i < nx) qxx[i] = qxx[i] + f[i] * vk;
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) qs[a] = qs[a] + fu[a] * vk;
    }
#pragma unroll
    for (int i = 0; i < MX; ++i)
      if (i < nx) in.lxx[i * px + r] = in.lxx[i * px + r] + qxx[i];
#pragma unroll
    for (int a = 0; a < MU; ++a)
      if (a < nu) QuxT[r * pu + a] = in.lux[a * px + r] + qs[a];
    T s = in.F[r] * Vm[0];
#pragma unroll 1
    for (int k = 1; k < nx; ++k) s += in.F[k * px + r] * Vm[k];
    qx = in.lx[r] + s;
  } else if (r == nx) {  // Q_u
    T qs[PU] = {};
    {
      T fu[PU];
      ldsn(fu, in.Fu, nu);
      const T v0 = Vm[0];
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) qs[a] = fu[a] * v0;
    }
#pragma unroll 1
    for (int k = 1; k < nx; ++k) {
      T fu[PU];
      ldsn(fu, in.Fu + k * pu, nu);
      const T vk = Vm[k];
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) qs[a] = qs[a] + fu[a] * vk;
    }
#pragma unroll
    for (int a = 0; a < MU; ++a)
      if (a < nu) Qu[a] = in.lu[a] + qs[a];
  }
  if (r < nu) {  // row r of Q_uu
    T q[PU] = {};
    {
      T vfu[PU];
      ldsn(vfu, VFu, nu);
      const T f0 = in.Fu[r];
#pragma unroll
      for (int c = 0; c < MU; ++c)
        if (c < nu) q[c] = f0 * vfu[c];
    }
#pragma unroll 1
    for (int k = 1; k < nx; ++k) {
      T vfu[PU];
      ldsn(vfu, VFu + k * pu, nu);
      const T fk = in.Fu[k * pu + r];
#pragma unroll
      for (int c = 0; c < MU; ++c)
        if (c < nu) q[c] = q[c] + fk * vfu[c];
    }
    T lr[PU];
    ldsn(lr, in.luu + r * pu, nu);
#pragma unroll
    for (int c = 0; c < MU; ++c)
      if (c < nu) Quu[r * pu + c] = lr[c] + q[c];
  }
  __syncwarp();

  // ---- C ----
  // the Cholesky factor of Q_uu, column by column: lanes a >= j each form
  // L[j][j] from row j (its entries before j are in Ls), lanes a > j then
  // L[a][j] from their own row; lane a stores L[a][j]
#pragma unroll 1
  for (int j = 0; j < nu; ++j) {
    if (r >= j && r < nu) {
      T s = Quu[j * pu + j];
      for (int kk = 0; kk < j; ++kk) {
        const T ljk = Ls[j * pu + kk];
        s = s - ljk * ljk;
      }
      T lrj = xsqrt(s);
      if (r > j) {
        const T inv = T(1) / lrj;
        T s2 = Quu[r * pu + j];
        for (int kk = 0; kk < j; ++kk) s2 = s2 - Ls[r * pu + kk] * Ls[j * pu + kk];
        lrj = s2 * inv;
      }
      Ls[r * pu + j] = lrj;
    }
    __syncwarp();
  }
  // lane r <= nx: -Q_uu^-1 of column r of Q_ux (r < nx) or of Q_u (r = nx),
  // L y = q then L^T x = y in place, in row r of K^T: column r of K, or k
  T kc[PU] = {}, kq[PU] = {};  // row r of K^T and of K^T Q_uu (r < nx)
  if (r <= nx) {
    T* y = KT + r * pu;
    const T* q = own ? QuxT + r * pu : Qu;
#pragma unroll 1
    for (int i = 0; i < nu; ++i) {
      T s = q[i];
      for (int kk = 0; kk < i; ++kk) s = s - Ls[i * pu + kk] * y[kk];
      y[i] = s / Ls[i * pu + i];
    }
#pragma unroll 1
    for (int i = nu - 1; i >= 0; --i) {
      T s = y[i];
      for (int kk = i + 1; kk < nu; ++kk) s = s - Ls[kk * pu + i] * y[kk];
      y[i] = s / Ls[i * pu + i];
    }
    ldsn(kc, y, nu);
#pragma unroll
    for (int a = 0; a < MU; ++a)
      if (a < nu) {
        kc[a] = -kc[a];
        y[a] = kc[a];
      }
  }
  if (own) {
    {
      T qr[PU];
      ldsn(qr, Quu, nu);
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) kq[a] = kc[0] * qr[a];
    }
#pragma unroll 1
    for (int c = 1; c < nu; ++c) {
      T qr[PU];
      ldsn(qr, Quu + c * pu, nu);
      const T kcc = KT[r * pu + c];
#pragma unroll
      for (int a = 0; a < MU; ++a)
        if (a < nu) kq[a] = kq[a] + kcc * qr[a];
    }
#pragma unroll
    for (int a = 0; a < MU; ++a)
      if (a < nu) {
        KQ[r * pu + a] = kq[a];
        out.K[(a * nx + r) * kOutStride] = kc[a];
      }
  } else if (r == nx) {
#pragma unroll
    for (int a = 0; a < MU; ++a)
      if (a < nu) out.k[a * kOutStride] = kc[a];
  }
  __syncwarp();

  // ---- D ----
  // V_x[r], and column r of X = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K into
  // the scratch (VS, transposed)
  if (own) {
    T kk[PU], quv[PU], qc[PU];
    ldsn(kk, KT + nx * pu, nu);
    ldsn(quv, Qu, nu);
    ldsn(qc, QuxT + r * pu, nu);
    T s1 = kq[0] * kk[0], s2 = kc[0] * quv[0], s3 = qc[0] * kk[0];
#pragma unroll
    for (int a = 1; a < MU; ++a)
      if (a < nu) {
        s1 += kq[a] * kk[a];
        s2 += kc[a] * quv[a];
        s3 += qc[a] * kk[a];
      }
    Vx = ((qx + s1) + s2) + s3;
#pragma unroll 1
    for (int i = 0; i < nx; ++i) {
      T kqi[PU], kti[PU], qti[PU];
      ldsn(kqi, KQ + i * pu, nu);
      ldsn(kti, KT + i * pu, nu);
      ldsn(qti, QuxT + i * pu, nu);
      T av = kqi[0] * kc[0], bv = kti[0] * qc[0], cv = qti[0] * kc[0];
#pragma unroll
      for (int a = 1; a < MU; ++a)
        if (a < nu) {
          av += kqi[a] * kc[a];
          bv += kti[a] * qc[a];
          cv += qti[a] * kc[a];
        }
      VS[i * px + r] = ((in.lxx[i * px + r] + av) + bv) + cv;
    }
  }
  __syncwarp();

  // ---- E ----
  // row r of V_xx = (X + X^T) / 2
  if (own) {
    T xrow[PX];
    ldsn(xrow, VS + r * px, nx);
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) V[j] = T(0.5) * (xrow[j] + VS[j * px + r]);
  }
}

// The block's copy of stage t's inputs into a stage buffer, and its store of
// stage t's outputs from an output buffer.
template <typename T>
__device__ __forceinline__ void fast_any_copy(T* buf, const FastAnyArgs<T>& x, int t, int b0,
                                              int tid) {
  const FastRiccatiArgs<T>& a = x.a;
  const T* src[8] = {a.Fx, a.Fu, a.d, a.Lx, a.Lu, a.Lxx, a.Lux, a.Luu};
#pragma unroll
  for (int k = 0; k < 8; ++k) copy_stage_rows(buf, x.l.in[k], src[k], t, b0, a.B, tid);
}

template <typename T>
__device__ __forceinline__ void fast_any_store(const FastAnyArgs<T>& x, const T* buf, int t,
                                               int b0, int tid) {
  const FastRiccatiArgs<T>& a = x.a;
  const FastAnyLayout& l = x.l;
  store_stage_rows(a.K, buf, l.nu * l.nx, t, b0, a.B, tid);
  store_stage_rows(a.k, buf + l.ek * kOutStride, l.nu, t, b0, a.B, tid);
  store_stage_rows(a.Vx1, buf + l.eVx * kOutStride, l.nx, t, b0, a.B, tid);
  store_stage_rows(a.Vxx1, buf + l.eVxx * kOutStride, l.nx * l.nx, t, b0, a.B, tid);
}

// The stage loop: fast_riccati_kernel's, on the runtime layout.
template <typename T, int MX, int MU>
__global__ void __launch_bounds__(kGroupThreads) fast_riccati_any_kernel(FastAnyArgs<T> x) {
  const FastAnyLayout& l = x.l;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = x.a.B, N = x.a.N, nx = l.nx, b0 = blockIdx.x * kProblems;
  T V[vpad<T>(MX)], Vx = T(0);
#pragma unroll
  for (int j = 0; j < vpad<T>(MX); ++j) V[j] = T(0);
  if (r < nx) {
    const int bc = min(b0 + g, B - 1);
    const T* lxx = x.a.Lxx + ((long long)N * nx * nx + r * nx) * B + bc;
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) V[j] = lxx[(long long)j * B];
    Vx = x.a.Lx[((long long)N * nx + r) * B + bc];
  }
  fast_any_copy(reinterpret_cast<T*>(smem), x, N - 1, b0, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    const int z = opaque_zero(), cur = (N - 1 - t) & 1;
    T* sm = reinterpret_cast<T*>(smem) + z;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      fast_any_copy(sm + (cur ^ 1) * l.stage, x, t - 1 + z, b0, tid + z);
      cp_async_commit();
    }
    if (t < N - 1)
      fast_any_store(x, sm + l.oout + ((t + 1) & 1) * l.out, t + 1 + z, b0, tid + z);
    T* buf = sm + cur * l.stage;
    const auto at = [&](int k) { return buf + l.in[k].off + g * l.in[k].pt; };
    T* o = sm + l.oout + (t & 1) * l.out + g;
    fast_any_step<T, MX, MU>(
        r, V, Vx, l, FastAnyIn<T>{at(0), at(1), at(2), at(3), at(4), at(5), at(6), at(7)},
        sm + l.ogroup + g * l.group,
        FastOut<T>{o, o + l.ek * kOutStride, o + l.eVx * kOutStride, o + l.eVxx * kOutStride});
  }
  __syncthreads();
  fast_any_store(x, reinterpret_cast<T*>(smem) + l.oout, 0, b0, tid);
}

template <typename T, int MX, int MU>
int launch_fast_riccati_any_instance(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  const FastAnyArgs<T> x{a, fast_any_layout<T>(a.nx, a.nu)};
  const int bytes = (int)x.l.bytes;
  if (cudaError_t e = cudaFuncSetAttribute(fast_riccati_any_kernel<T, MX, MU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return (int)e;
  fast_riccati_any_kernel<T, MX, MU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(x);
  return (int)cudaGetLastError();
}

// B13 at any (nx, nu) the tuned instances do not take: the runtime-shape
// instance up to (12, 12), the large-nu one past nu = 12.
template <typename T>
int launch_fast_riccati_any(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  if (a.nx < 1 || a.nu < 1 || a.nx > kAnyMax || a.nu > kFastMaxNu) return (int)cudaErrorInvalidValue;
  if (a.nu > kAnyMax) return launch_fast_riccati_large<T>(a, s);
  if (a.nu > 6) return launch_fast_riccati_any_instance<T, kAnyMax, kAnyMax>(a, s);
  if (a.nx > 6) return launch_fast_riccati_any_instance<T, kAnyMax, 6>(a, s);
  return launch_fast_riccati_any_instance<T, 6, 6>(a, s);
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

// B13's arguments and their names.
#define FAST_RICCATI_PARAMS                                                        \
  const void *Fx, const void *Fu, const void *d, const void *Lx, const void *Lu,   \
      const void *Lxx, const void *Lux, const void *Luu, void *k, void *K, void *Vx1, \
      void *Vxx1, int N, int nx, int nu, int B, int device, void *stream
#define FAST_RICCATI_NAMES Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, k, K, Vx1, Vxx1, N, nx, nu, B, device, stream

// B13 at any (nx, nu) with nx <= 12 and nu <= kFastMaxNu: the runtime-shape
// instance up to nu = 12 (tuned shape or not), the large-nu one past it; or
// with kLarge the large-nu instance at any nu (scripts time it against the
// runtime-shape one).  ops/riccati.py calls it for the shapes fast_riccati
// has no instance for.
template <bool kLarge>
static int fast_riccati_entry(FAST_RICCATI_PARAMS) {
  using T = Scalar;
  traopt::FastRiccatiArgs<T> a;
  a.Fx = (const T*)Fx; a.Fu = (const T*)Fu; a.d = (const T*)d;
  a.Lx = (const T*)Lx; a.Lu = (const T*)Lu; a.Lxx = (const T*)Lxx;
  a.Lux = (const T*)Lux; a.Luu = (const T*)Luu;
  a.k = (T*)k; a.K = (T*)K; a.Vx1 = (T*)Vx1; a.Vxx1 = (T*)Vxx1;
  a.N = N; a.B = B; a.nx = nx; a.nu = nu;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  if (kLarge) return traopt::launch_fast_riccati_large<T>(a, (cudaStream_t)stream);
  return traopt::launch_fast_riccati_any<T>(a, (cudaStream_t)stream);
}

extern "C" int TRAOPT_FN(fast_riccati_any)(FAST_RICCATI_PARAMS) {
  return fast_riccati_entry<false>(FAST_RICCATI_NAMES);
}
extern "C" int TRAOPT_FN(fast_riccati_large)(FAST_RICCATI_PARAMS) {
  return fast_riccati_entry<true>(FAST_RICCATI_NAMES);
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
