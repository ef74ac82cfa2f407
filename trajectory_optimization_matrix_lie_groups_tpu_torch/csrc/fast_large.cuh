// B13's large-nu instance (fast.cu launches it at nx <= 12 and nu = 13 ...
// kFastMaxNu): the dense Riccati step of ops/riccati.py riccati_step for one
// problem held by a group of kGroup = 16 threads, and the kernel
// fast_riccati_large_kernel that loops it over the stages.
//
// Why a design of its own.  fast_any_step (fast.cu) gives lane a < nu row a
// of Q_uu and keeps per-lane arrays sized for the instance's maximum nu
// (12): past it the lanes no longer cover the rows, and the arrays outgrow
// the register file.  Here nu is a runtime argument and no register array
// grows with it:
//   - lane r < nx owns row r of V_xx and V_x[r] in registers, as in
//     fast_riccati_any_kernel;
//   - V_xx Fu, Q_ux^T, Q_uu, its factor, K^T (row c < nx: column c of K,
//     row nx: k) and K^T Q_uu live in the group's shared memory, every
//     nu-wide row at the odd pitch w = nu | 1, so that the lanes of a group
//     reading one column of 16 rows hit 16 banks;
//   - phase A: lane r writes row r of V_xx F and of V_xx Fu (a loop over nu);
//   - phase B: lane r column r of Q_xx (registers) and of Q_ux, lane nx Q_u,
//     and lane r rows r, r + 16, ... of Q_uu, each a sum over nx;
//   - phase C: a cooperative Cholesky, column by column between
//     __syncwarp()s (every lane the pivot, lane r the rows j + 1 + r,
//     j + 17 + r, ...), the diagonal stored as 1 / sqrt(pivot) as
//     pipeline.chol_factor_lane stores it; then lane c <= nx one of the nx + 1
//     triangular solves in its row of K^T, multiplying by the stored
//     reciprocal where utils/linalg.chol_solve divides by the square root
//     (the two agree to rounding), and lane r < nx row r of K^T Q_uu;
//   - phases D and E: the new V_x and V_xx, their sums over nu loops.
// Every entry is riccati_step's sum in fast_any_step's order (the k-loop
// outermost where an entry sums over k), so the kernel agrees with
// backward_plain to rounding.  Lane r's column of Q_xx waits for phase D in
// its problem's L_xx column of the stage buffer (only lane r reads it),
// so that no register array lives across the factorization, whose square
// roots and divisions call their slow paths.
//
// The block copies stage t - 1's inputs (Luu too) into shared memory with
// cp.async while it computes stage t and stages its outputs to store them
// coalesced over its problems, as fast_riccati_any_kernel does.  The shared
// memory (FastLargeLayout) is laid out at launch from (nx, nu), and so is
// the number of problems a block, P = 8, 4 or 2 (fast_large_problems: the
// one that puts the most problems on an SM), so P is a runtime argument
// too.  What bounds it on an H100: its bytes, as at the smaller shapes
// (1,332 values per problem and stage at (12, 16): 2.6 ms at B = 8192,
// N = 200, f32); a problem's stages form a chain of dependent steps, and
// the shared memory a problem takes keeps 8 to 13 problems on an SM.
#pragma once

#include "group.cuh"
#include "lie.cuh"

#ifndef TRAOPT_MAX_NU
#error "build with -DTRAOPT_MAX_NU=<nu> (_build.MAX_NU)"
#endif

namespace traopt {

// B13's arguments (every instance's, fast.cu): the inputs and outputs,
// batch-last as ops/riccati.py lays them out.
template <typename T>
struct FastRiccatiArgs {
  const T *Fx, *Fu, *d, *Lx, *Lu, *Lxx, *Lux, *Luu;  // Lx, Lxx: N+1 stages
  T *k, *K, *Vx1, *Vxx1;
  int N, B;
  int nx, nu;  // read by the any-shape and large-nu kernels only
};

// An H100 SM's shared memory, and what CUDA reserves of it for each
// resident block (_build.SMEM_PER_SM, SMEM_BLOCK_RESERVED).
constexpr size_t kSmemPerSM = 233472, kSmemPerBlockReserved = 1024;
constexpr int kFastLargeMaxProblems = 8;
// The largest shape it takes: nx = 12 (lane r < nx holds row r of V_xx),
// and B1-B6's nu (_build.MAX_NU), so that both tiers take the same problems.
constexpr int kFastMaxNx = 12, kFastMaxNu = TRAOPT_MAX_NU;

// The block's shared memory for (nx, nu) and P problems a block, in
// elements of T, each region a whole number of 16-byte vectors.
struct FastLargeLayout {
  int nx, nu, px, w, P;  // the shape; nx- and nu-wide rows' pitches; problems a block
  RowCopy in[8];         // F, Fu, d, lx, lu, lxx, lux, luu in a stage buffer
  int stage;             // one stage buffer
  int ek, eVx, eVxx, out;  // an output buffer: entries of k, Vx1, Vxx1 (K at 0); its size
  // a group's scratch: V_x + V_xx d, Q_u, (V_xx F)^T then X^T (rows of px),
  // V_xx Fu, K^T (row nx: k), K^T Q_uu, Q_ux^T, Q_uu, L (rows of w); its stride
  int Vm, Qu, VS, VFu, KT, KQ, QuxT, Quu, L, group;
  int oout, ogroup;      // the block: two stage buffers at 0, two output buffers, the scratch
  size_t bytes;
};

template <typename T>
constexpr FastLargeLayout fast_large_layout(int nx, int nu, int P) {
  FastLargeLayout l{};
  l.nx = nx;
  l.nu = nu;
  l.P = P;
  const int px = l.px = vpad<T>(nx), w = l.w = nu | 1;
  int off = 0;
  const int rows[8][3] = {{nx, nx, px}, {nx, nu, w}, {1, nx, nx}, {1, nx, nx},
                          {1, nu, nu},  {nx, nx, px}, {nu, nx, px}, {nu, nu, w}};
  for (int k = 0; k < 8; ++k) {
    const int pt = spread_pitch<T>(rows[k][0] * rows[k][2]);
    l.in[k] = row_copy(off, pt, rows[k][0], rows[k][1], rows[k][2]);
    off += P * pt;
  }
  l.stage = off;
  l.ek = nu * nx;
  l.eVx = l.ek + nu;
  l.eVxx = l.eVx + nx;
  l.out = vpad<T>((l.eVxx + nx * nx) * (P + 1));
  l.Vm = 0;
  l.Qu = px;
  l.VS = l.Qu + vpad<T>(nu);
  l.VFu = l.VS + nx * px;
  l.KT = l.VFu + vpad<T>(nx * w);
  l.KQ = l.KT + vpad<T>((nx + 1) * w);
  l.QuxT = l.KQ + vpad<T>(nx * w);
  l.Quu = l.QuxT + vpad<T>(nx * w);
  l.L = l.Quu + vpad<T>(nu * w);
  l.group = (int)(group_stride((l.L + vpad<T>(nu * w)) * sizeof(T)) / sizeof(T));
  l.oout = 2 * l.stage;
  l.ogroup = l.oout + 2 * l.out;
  l.bytes = (size_t)(l.ogroup + P * l.group) * sizeof(T);
  return l;
}

// The problems a block at (nx, nu): of 8, 4 and 2, the one whose blocks fit
// the most problems on an SM at once (the larger on a tie); 0 if no block
// fits.
template <typename T>
constexpr int fast_large_problems(int nx, int nu) {
  int best = 0, pick = 0;
  for (int P = kFastLargeMaxProblems; P >= 2; P /= 2) {
    const size_t b = fast_large_layout<T>(nx, nu, P).bytes;
    const int n = P * (int)(kSmemPerSM / (b + kSmemPerBlockReserved));
    if (b <= kSmemPerBlock && n > best) {
      best = n;
      pick = P;
    }
  }
  return pick;
}

static_assert(fast_large_problems<float>(12, kFastMaxNu) > 0 &&
                  fast_large_problems<double>(12, kFastMaxNu) > 0,
              "B13's large-nu layout must fit one block at (12, TRAOPT_MAX_NU) in both scalars");

template <typename T>
struct FastLargeArgs {
  FastRiccatiArgs<T> a;
  FastLargeLayout l;
};

// One problem's view of a stage buffer, and of an output buffer (entry e at
// [e * os]).
template <typename T>
struct FastLargeIn {
  const T *F, *Fu, *d, *lx, *lu;
  T* lxx;  // column r: Q_xx's from phase B to phase D
  const T *lux, *luu;
};

template <typename T>
struct FastLargeOut {
  T *K, *k, *Vx, *Vxx;
  int os;
};

// One Riccati step for lane r of a group: (V, Vx) hold row r of V_xx and
// V_x[r] of stage t + 1 on entry and of stage t on exit (lanes r < nx).
// Every lane of the warp calls it (it synchronises the warp).
template <typename T>
__device__ __forceinline__ void fast_large_step(int r, T (&V)[12], T& Vx, const FastLargeLayout& l,
                                                const FastLargeIn<T>& in, T* gs,
                                                const FastLargeOut<T>& out) {
  constexpr int MX = 12;
  const int nx = l.nx, nu = l.nu, px = l.px, w = l.w, os = out.os;
  const bool own = r < nx;
  T *Vm = gs + l.Vm, *Qu = gs + l.Qu, *VS = gs + l.VS, *VFu = gs + l.VFu, *KT = gs + l.KT,
    *KQ = gs + l.KQ, *QuxT = gs + l.QuxT, *Quu = gs + l.Quu, *Ls = gs + l.L;

  // ---- A ----
  // the carry staged as the outputs Vx1, Vxx1; V_x + V_xx d; row r of V_xx F
  // (into column r of VS) and of V_xx Fu
  if (own) {
    out.Vx[r * os] = Vx;
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) out.Vxx[(r * nx + j) * os] = V[j];
    T s = V[0] * in.d[0];
#pragma unroll
    for (int j = 1; j < MX; ++j)
      if (j < nx) s += V[j] * in.d[j];
    Vm[r] = Vx + s;
    T vf[MX];
#pragma unroll
    for (int j = 0; j < MX; ++j) vf[j] = j < nx ? V[0] * in.F[j] : T(0);
#pragma unroll
    for (int k = 1; k < MX; ++k)
      if (k < nx) {
#pragma unroll
        for (int j = 0; j < MX; ++j)
          if (j < nx) vf[j] = vf[j] + V[k] * in.F[k * px + j];
      }
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < nx) VS[j * px + r] = vf[j];
    for (int c = 0; c < nu; ++c) {
      T sc = V[0] * in.Fu[c];
#pragma unroll
      for (int k = 1; k < MX; ++k)
        if (k < nx) sc = sc + V[k] * in.Fu[k * w + c];
      VFu[r * w + c] = sc;
    }
  }
  __syncwarp();

  // ---- B ----
  // lane r < nx: column r of Q_xx (into L_xx's), of Q_ux (row r of QuxT)
  // and Q_x[r]; lane nx: Q_u; lane r: rows r, r + 16, ... of Q_uu
  T qx = T(0);
  if (own) {
    T qxx[MX];
    T vc[MX];  // column r of V_xx F
#pragma unroll
    for (int k = 0; k < MX; ++k) vc[k] = k < nx ? VS[r * px + k] : T(0);
#pragma unroll
    for (int i = 0; i < MX; ++i) qxx[i] = i < nx ? in.F[i] * vc[0] : T(0);
#pragma unroll
    for (int k = 1; k < MX; ++k)
      if (k < nx) {
#pragma unroll
        for (int i = 0; i < MX; ++i)
          if (i < nx) qxx[i] = qxx[i] + in.F[k * px + i] * vc[k];
      }
#pragma unroll
    for (int i = 0; i < MX; ++i)
      if (i < nx) in.lxx[i * px + r] = in.lxx[i * px + r] + qxx[i];
    for (int a = 0; a < nu; ++a) {
      T sa = in.Fu[a] * vc[0];
#pragma unroll
      for (int k = 1; k < MX; ++k)
        if (k < nx) sa = sa + in.Fu[k * w + a] * vc[k];
      QuxT[r * w + a] = in.lux[a * px + r] + sa;
    }
    T s = in.F[r] * Vm[0];
#pragma unroll
    for (int k = 1; k < MX; ++k)
      if (k < nx) s += in.F[k * px + r] * Vm[k];
    qx = in.lx[r] + s;
  } else if (r == nx) {
    T vm[MX];
#pragma unroll
    for (int k = 0; k < MX; ++k) vm[k] = k < nx ? Vm[k] : T(0);
    for (int a = 0; a < nu; ++a) {
      T sa = in.Fu[a] * vm[0];
#pragma unroll
      for (int k = 1; k < MX; ++k)
        if (k < nx) sa = sa + in.Fu[k * w + a] * vm[k];
      Qu[a] = in.lu[a] + sa;
    }
  }
  for (int a = r; a < nu; a += kGroup) {
    T fa[MX];  // column a of Fu
#pragma unroll
    for (int k = 0; k < MX; ++k) fa[k] = k < nx ? in.Fu[k * w + a] : T(0);
    for (int c = 0; c < nu; ++c) {
      T sc = fa[0] * VFu[c];
#pragma unroll
      for (int k = 1; k < MX; ++k)
        if (k < nx) sc = sc + fa[k] * VFu[k * w + c];
      Quu[a * w + c] = in.luu[a * w + c] + sc;
    }
  }
  __syncwarp();

  // ---- C ----
  // the factor, column j at a time: every lane the pivot, lane r rows
  // j + 1 + r, j + 17 + r, ...
  for (int j = 0; j < nu; ++j) {
    const T* Lj = Ls + j * w;
    T sv = Quu[j * w + j];
    for (int kk = 0; kk < j; ++kk) sv = sv - Lj[kk] * Lj[kk];
    const T inv = T(1) / xsqrt(sv);
    for (int i = j + 1 + r; i < nu; i += kGroup) {
      T s2 = Quu[i * w + j];
      for (int kk = 0; kk < j; ++kk) s2 = s2 - Ls[i * w + kk] * Lj[kk];
      Ls[i * w + j] = s2 * inv;
    }
    if (r == 0) Ls[j * w + j] = inv;
    __syncwarp();
  }
  // lane c <= nx: -Q_uu^-1 times column c of Q_ux (c < nx) or Q_u (c = nx),
  // L y = q then L^T x = y in place in row c of K^T
  if (r <= nx) {
    T* y = KT + r * w;
    const T* q = own ? QuxT + r * w : Qu;
    for (int i = 0; i < nu; ++i) {
      T sv = q[i];
      const T* Li = Ls + i * w;
      for (int kk = 0; kk < i; ++kk) sv = sv - Li[kk] * y[kk];
      y[i] = sv * Li[i];
    }
    for (int i = nu - 1; i >= 0; --i) {
      T sv = y[i];
      for (int kk = i + 1; kk < nu; ++kk) sv = sv - Ls[kk * w + i] * y[kk];
      y[i] = sv * Ls[i * w + i];
    }
    for (int a = 0; a < nu; ++a) y[a] = -y[a];
  }
  if (own) {
    const T* kc = KT + r * w;  // column r of K
    for (int a = 0; a < nu; ++a) {
      out.K[(a * nx + r) * os] = kc[a];
      T sa = kc[0] * Quu[a];
      for (int c = 1; c < nu; ++c) sa = sa + kc[c] * Quu[c * w + a];
      KQ[r * w + a] = sa;  // row r of K^T Q_uu
    }
  } else if (r == nx) {
    for (int a = 0; a < nu; ++a) out.k[a * os] = KT[nx * w + a];
  }
  __syncwarp();

  // ---- D ----
  // V_x[r], and column r of X = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K
  // into VS.  The carry (V_x, and V_xx in E) is written whole, on every
  // lane: a value written only under a guard would keep the old one live
  // from phase A through the factorization.
  T vx = T(0);
  if (own) {
    const T *kk = KT + nx * w, *kc = KT + r * w, *kq = KQ + r * w, *qc = QuxT + r * w;
    T s1 = kq[0] * kk[0], s2 = kc[0] * Qu[0], s3 = qc[0] * kk[0];
    for (int a = 1; a < nu; ++a) {
      s1 = s1 + kq[a] * kk[a];
      s2 = s2 + kc[a] * Qu[a];
      s3 = s3 + qc[a] * kk[a];
    }
    vx = ((qx + s1) + s2) + s3;
#pragma unroll
    for (int i = 0; i < MX; ++i)
      if (i < nx) {
        const T *kqi = KQ + i * w, *kti = KT + i * w, *qti = QuxT + i * w;
        T av = kqi[0] * kc[0], bv = kti[0] * qc[0], cv = qti[0] * kc[0];
        for (int a = 1; a < nu; ++a) {
          av = av + kqi[a] * kc[a];
          bv = bv + kti[a] * qc[a];
          cv = cv + qti[a] * kc[a];
        }
        VS[i * px + r] = ((in.lxx[i * px + r] + av) + bv) + cv;
      }
  }
  Vx = vx;
  __syncwarp();

  // ---- E ----
  // row r of V_xx = (X + X^T) / 2
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    T v = T(0);
    if (own && j < nx) v = T(0.5) * (VS[r * px + j] + VS[j * px + r]);
    V[j] = v;
  }
}

// The block's copy of stage t's inputs into a stage buffer, and its store of
// stage t's outputs from an output buffer.
template <typename T>
__device__ __forceinline__ void fast_large_copy(T* buf, const FastLargeArgs<T>& x, int t, int b0,
                                                int tid) {
  const FastRiccatiArgs<T>& a = x.a;
  const T* src[8] = {a.Fx, a.Fu, a.d, a.Lx, a.Lu, a.Lxx, a.Lux, a.Luu};
#pragma unroll
  for (int k = 0; k < 8; ++k) copy_stage_rows(buf, x.l.in[k], src[k], t, b0, a.B, tid, x.l.P);
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void fast_large_store(const FastLargeArgs<T>& x, const T* buf, int t,
                                                 int b0, int tid) {
  const FastRiccatiArgs<T>& a = x.a;
  const FastLargeLayout& l = x.l;
  const int P = l.P, S = P + 1;
  store_stage_rows(a.K, buf, l.nu * l.nx, t, b0, a.B, tid, P);
  store_stage_rows(a.k, buf + l.ek * S, l.nu, t, b0, a.B, tid, P);
  store_stage_rows(a.Vx1, buf + l.eVx * S, l.nx, t, b0, a.B, tid, P);
  store_stage_rows(a.Vxx1, buf + l.eVxx * S, l.nx * l.nx, t, b0, a.B, tid, P);
}

// The stage loop: fast_riccati_any_kernel's, on the large layout, blocks of
// kGroup * l.P threads.
template <typename T>
__global__ void __launch_bounds__(kGroup* kFastLargeMaxProblems)
    fast_riccati_large_kernel(FastLargeArgs<T> x) {
  const FastLargeLayout& l = x.l;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = x.a.B, N = x.a.N, nx = l.nx, P = l.P, b0 = blockIdx.x * P;
  T V[12], Vx = T(0);
#pragma unroll
  for (int j = 0; j < 12; ++j) V[j] = T(0);
  if (r < nx) {
    const int bc = min(b0 + g, B - 1);
    const T* lxx = x.a.Lxx + ((long long)N * nx * nx + r * nx) * B + bc;
#pragma unroll
    for (int j = 0; j < 12; ++j)
      if (j < nx) V[j] = lxx[(long long)j * B];
    Vx = x.a.Lx[((long long)N * nx + r) * B + bc];
  }
  T* sm = reinterpret_cast<T*>(smem);
  fast_large_copy(sm, x, N - 1, b0, tid);
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) fast_large_copy(sm + (cur ^ 1) * l.stage, x, t - 1, b0, tid);
    if (t < N - 1) fast_large_store(x, sm + l.oout + ((t + 1) & 1) * l.out, t + 1, b0, tid);
    T* buf = sm + cur * l.stage;
    const auto at = [&](int k) { return buf + l.in[k].off + g * l.in[k].pt; };
    T* o = sm + l.oout + (t & 1) * l.out + g;
    fast_large_step<T>(r, V, Vx, l,
                       FastLargeIn<T>{at(0), at(1), at(2), at(3), at(4), at(5), at(6), at(7)},
                       sm + l.ogroup + g * l.group,
                       FastLargeOut<T>{o, o + l.ek * (P + 1), o + l.eVx * (P + 1),
                                       o + l.eVxx * (P + 1), P + 1});
  }
  __syncthreads();
  fast_large_store(x, sm + l.oout, 0, b0, tid);
}

// B13's large-nu instance on the arguments a, at any nx <= kFastMaxNx and
// nu <= kFastMaxNu (fast.cu launches it past nu = 12), on stream s; the
// problems a block chosen here.
template <typename T>
int launch_fast_riccati_large(const FastRiccatiArgs<T>& a, cudaStream_t s) {
  if (a.nx < 1 || a.nu < 1 || a.nx > kFastMaxNx || a.nu > kFastMaxNu)
    return (int)cudaErrorInvalidValue;
  const int P = fast_large_problems<T>(a.nx, a.nu);
  if (P == 0) return (int)cudaErrorInvalidValue;
  const FastLargeArgs<T> x{a, fast_large_layout<T>(a.nx, a.nu, P)};
  const int bytes = (int)x.l.bytes;
  if (cudaError_t e = cudaFuncSetAttribute(fast_riccati_large_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return (int)e;
  if (cudaError_t e = cudaFuncSetAttribute(fast_riccati_large_kernel<T>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout, 100))
    return (int)e;
  fast_riccati_large_kernel<T><<<dim3((a.B + P - 1) / P), kGroup * P, bytes, s>>>(x);
  return (int)cudaGetLastError();
}

}  // namespace traopt
