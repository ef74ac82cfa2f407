// The fp64 instance of B2 (pipeline.cu riccati_f64_kernel): the defect-aware
// Riccati step of riccati_group.cuh for one problem held by a group of
// kGroup = 16 threads (group.cuh), redesigned for double, and the
// shared-memory layout of the kernel that loops it over the stages.
//
// Why fp64 needs its own design.  riccati_group_step has lane r < 12 hold row
// r of V_xx and read all of F twice (V_xx F, then F^T (V_xx F)) and all of
// K^T and K^T Q_uu once per stage from shared memory.  A shared-memory load
// costs the warp by the bytes each lane receives, however many lanes share
// an address, so in double those ~700 values a lane take twice the cycles
// they take in f32, and the f32 design compiled in double ran at 2x its f32
// time (12.6 ms at B = 16384, 25% of its bound), spilled (255 registers),
// and more resident blocks did not help (chip runs, PERF.md).  This step:
//   - splits every 12 x 12 product (V_xx F, Q_xx = l_xx + F^T (V_xx F),
//     S = Q_xx + K^T Q_uu K, M = K^T Q_ux and the new V_xx) into 3 x 3
//     blocks, one a lane (lane l: rows 3 (l / 4).., columns 3 (l % 4)..), so
//     that a lane reads 3 rows and 3 columns of the operands (72 values), not
//     a row and the whole of the other (~150); all 16 lanes work;
//   - keeps fu2 in registers over phases A and B, Q_uu's factor in
//     registers in C (Q_uu itself read where used: 168 registers at nu = 6,
//     three blocks an SM);
//   - stores V_xx in the group's scratch between stages, and puts K^T,
//     K^T Q_uu, k and M in the problem's rows of the stage buffer being
//     computed, which phase C has read last (shared memory of 73 KB a
//     block at nu = 6, 64 KB at nu = 4: three blocks an SM);
//   - leaves the terminal quadratization to a kernel of its own
//     (pipeline.cu terminal_kernel<double>), so that this one carries no
//     transcendental functions and their registers.
// Every entry is riccati_stage's sum in riccati_group_step's order (the
// k-loop outermost where an entry sums over k, the Cholesky's diagonal as
// 1 / sqrt(pivot)), so the kernel agrees with the plain version to rounding.
// kLean (B2's runtime-nu instances in fp64): fu2 is read from the block's
// constants where it is used, the factor of Q_uu goes to the group's Ls
// once computed and the solves read it there, and the blocks of S and M
// take their rows of K^T Q_uu, K^T and Q_ux^T a term at a time, instead of
// holding them in registers (at NU = 12 they spilled).
#pragma once

#include "group.cuh"
#include "riccati_group.cuh"
#include "stage.cuh"

namespace traopt {

// A problem's row in an fp64 stage buffer: ne rounded up to whole 16-byte
// vectors, 2 doubles more where that is a multiple of 16 doubles, so that
// the two groups of a warp read their rows in different banks.
__host__ __device__ constexpr int pitch64(int ne) {
  const int p = (ne + 1) / 2 * 2;
  return p % 16 == 0 ? p + 2 : p;
}

// One group's scratch.
template <int NU>
struct Scratch64 {
  static constexpr int NUP = vpad<double>(NU);
  alignas(16) double Vm[12];        // V_x + V_xx d
  alignas(16) double Qu[NUP];       // Q_u
  alignas(16) double VS[144];       // V_xx in A, V_xx F in B-C, S in D-E (row-major)
  alignas(16) double Tm[6 * NUP];   // V_xx[6:, 6:] fu2
  alignas(16) double Quu[NU * NUP];
  alignas(16) double QxT[12 * NUP];  // Q_ux^T: row c is column c of Q_ux
};

// Shared memory of a block: the constants, two stage buffers, two output
// buffers (riccati_group.cuh's, so riccati_store and stage_out serve), and
// the groups' scratch.  Byte offsets, each 16-byte aligned.  Once phase C
// has read them, a problem's rows of the stage buffer being computed hold
// M (the F row), K^T then K^T Q_uu (the l_xx row) and k (the d row).
template <int NU>
struct Layout64 {
  using Out = RiccatiLayout<double, double, NU>;
  static constexpr int P = kProblems, NUP = vpad<double>(NU);
  static constexpr int pF = pitch64(144), pd = pitch64(12), pu = pitch64(NU);
  static constexpr size_t D = sizeof(double);
  static constexpr size_t oF = 0, od = oF + P * pF * D, olx = od + P * pd * D,
                          olu = olx + P * pd * D, oxx = olu + P * pu * D,
                          oal = oxx + P * pF * D, stage = oal + P * pu * D;
  static constexpr size_t out = Out::out;
  static constexpr size_t ofu2 = 0, oLuu = align16(6 * NUP * D),
                          ostage = oLuu + align16(NU * NUP * D), oout = ostage + 2 * stage,
                          ogroup = oout + 2 * out, gstride = group_stride(sizeof(Scratch64<NU>)),
                          bytes = ogroup + P * gstride;
  static_assert(NUP <= pd, "k fits in its row");
};

// The block's copy of stage t's inputs into a stage buffer.
template <int NU>
__device__ __forceinline__ void riccati_f64_copy(unsigned char* buf, const double* Fx,
                                                 const double* d, const double* lx,
                                                 const double* lu, const double* lxx,
                                                 const double* luual, int t, int b0, int B,
                                                 int tid) {
  using L = Layout64<NU>;
  const auto at = [&](size_t o) { return reinterpret_cast<double*>(buf + o); };
  copy_stage<144, false, L::pF>(at(L::oF), Fx, t, b0, B, tid);
  copy_stage<12, false, L::pd>(at(L::od), d, t, b0, B, tid);
  copy_stage<12, false, L::pd>(at(L::olx), lx, t, b0, B, tid);
  copy_stage<NU, false, L::pu>(at(L::olu), lu, t, b0, B, tid);
  copy_stage<144, true, L::pF>(at(L::oxx), lxx, t, b0, B, tid);
  if (luual) copy_stage<NU, false, L::pu>(at(L::oal), luual, t, b0, B, tid);
}

// One Riccati step for lane l of a group: V_xx of stage t + 1 in VS and
// V_x[l] in Vx on entry, of stage t on exit (lanes l < 12).  Mx, KT and kv
// are the problem's F, l_xx and d rows of the stage buffer in; fu2s and Luu
// the block's constants; out gets K, k and gvec = Q_u.  Lane l's block is
// rows I = bi.. bi + 2 and columns J = bj.. bj + 2 (bi = 3 (l / 4), bj =
// 3 (l % 4)).  The phases, between __syncwarp()s:
//   A  V_x + V_xx d, for l >= 6 row l - 6 of V_xx[6:, 6:] fu2 (lane l < 12
//      from row l of V_xx), and the block (I, J) of V_xx F, stored once every
//      lane has read V_xx;
//   B  column l of Q_ux = fu2^T (V_xx F)[6:] and Q_x[l]; lane 12 Q_u; lane
//      a < nu row a of Q_uu;
//   C  the Cholesky factor of Q_uu, then lane c <= 12 one right-hand side of
//      -Q_uu^-1 [Q_ux | Q_u] (column c of K, or k) and row c of K^T Q_uu, and
//      the block (I, J) of Q_xx = l_xx + F^T (V_xx F); K^T, K^T Q_uu and
//      Q_ux^T stored once every lane has read l_xx;
//   D  V_x[l], the blocks (I, J) of S = Q_xx + K^T Q_uu K and of
//      M = K^T Q_ux;
//   E  the block (I, J) of V_xx = (S + S^T) / 2 + M + M^T, stored once
//      every lane has read S and M.
// Every lane of the warp calls it (it synchronises the warp).
template <int NU, bool kLean = false>
__device__ __forceinline__ void riccati_f64_step(int l, double& Vx,
                                                 const StageIn<double, double>& in, double* Mx,
                                                 double* KT, double* kv, const double* fu2s,
                                                 const double* Luu, bool glow, Scratch64<NU>& g,
                                                 const StageOut<double, double>& out,
                                                 double* Ls = nullptr) {
  using T = double;
  constexpr int NX = 12, H = 6, NUP = Scratch64<NU>::NUP;
  const bool own = l < NX;
  const int r = own ? l : NX - 1;  // lanes 12..15 take lane 11's row and store none
  const int bi = 3 * (l / 4), bj = 3 * (l % 4);
  T* KQ = KT + NX * NUP;
  const T* F = in.F;

  T fu2[kLean ? 1 : H * NU];  // fu2 (6 x nu), for phases A and B
  if constexpr (!kLean) {
#pragma unroll
    for (int k = 0; k < H; ++k) {
      T row[NUP];
      lds<T, NUP>(row, fu2s + k * NUP);
#pragma unroll
      for (int a = 0; a < NU; ++a) fu2[k * NU + a] = row[a];
    }
  }
  const auto f2 = [&](int k, int a) -> T { return kLean ? fu2s[k * NUP + a] : fu2[k * NU + a]; };

  // ---- A ----
  {
    T v[NX], dd[NX];
    lds<T, NX>(v, g.VS + r * NX);  // row r of V_xx
    lds<T, NX>(dd, in.d);
    T s = v[0] * dd[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s += v[j] * dd[j];
    if (own) g.Vm[l] = Vx + s;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T t = v[H] * f2(0, a);
#pragma unroll
      for (int k = 1; k < H; ++k) t += v[H + k] * f2(k, a);
      if (own && l >= H) g.Tm[(l - H) * NUP + a] = t;
    }
  }
  {
    // the block (I, J) of V_xx F; a column of F's C block (rows k >= 6,
    // columns j < 6) enters only with glow
    const bool left = bj < H;
    T vf[9];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (k >= H && left && !glow) continue;
      T f[3], v[3];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) f[jj] = F[k * NX + bj + jj];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) v[ii] = g.VS[(bi + ii) * NX + k];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj)
          vf[ii * 3 + jj] = k == 0 ? v[ii] * f[jj] : vf[ii * 3 + jj] + v[ii] * f[jj];
    }
    __syncwarp();  // every lane has read V_xx: VS takes V_xx F
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) g.VS[(bi + ii) * NX + bj + jj] = vf[ii * 3 + jj];
  }
  __syncwarp();

  // ---- B ----
  T qux[NU], qx;  // column r of Q_ux, Q_x[r]
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = f2(0, a) * g.VS[H * NX + r];
#pragma unroll
    for (int k = 1; k < H; ++k) s += f2(k, a) * g.VS[(H + k) * NX + r];
    qux[a] = s;
  }
  {
    T vm[NX];
    lds<T, NX>(vm, g.Vm);
    T s = F[r] * vm[0];
#pragma unroll
    for (int k = 1; k < H; ++k) s += F[k * NX + r] * vm[k];
    if (glow || r >= H) {
#pragma unroll
      for (int k = H; k < NX; ++k) s += F[k * NX + r] * vm[k];
    }
    qx = in.lx[r] + s;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T q = f2(0, a) * vm[H];
#pragma unroll
      for (int k = 1; k < H; ++k) q += f2(k, a) * vm[H + k];
      q = in.lu[a] + q;
      if (l == NX) g.Qu[a] = q;
    }
  }
  {
    const int ra = l < NU ? l : NU - 1;
    T q[NU];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      T tm[NUP];
      lds<T, NUP>(tm, g.Tm + k * NUP);
      const T fk = fu2s[k * NUP + ra];
#pragma unroll
      for (int b2 = 0; b2 < NU; ++b2) q[b2] = k == 0 ? fk * tm[b2] : q[b2] + fk * tm[b2];
    }
    T row[NUP];
    lds<T, NUP>(row, Luu + ra * NUP);
#pragma unroll
    for (int b2 = 0; b2 < NU; ++b2) {
      T v = row[b2] + q[b2];
      if (in.luual && b2 == ra) v += in.luual[ra];
      if (l < NU) g.Quu[ra * NUP + b2] = v;
    }
  }
  __syncwarp();

  // ---- C ----
  T kc[NU], kq[NU];  // column l of K (k on lane 12), row l of K^T Q_uu
  {
    T L[NU * NU];  // the lower triangle of the factor
    const T* Q = g.Quu;  // read where used
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T sv = Q[j * NUP + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) sv = sv - L[j * NU + kk] * L[j * NU + kk];
      const T inv = T(1) / xsqrt(sv);
      L[j * NU + j] = inv;
#pragma unroll
      for (int i2 = j + 1; i2 < NU; ++i2) {
        T s2 = Q[i2 * NUP + j];
#pragma unroll
        for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i2 * NU + kk] * L[j * NU + kk];
        L[i2 * NU + j] = s2 * inv;
      }
    }
    if constexpr (kLean) {
      if (l == 0) {
#pragma unroll
        for (int j = 0; j < NU; ++j)
#pragma unroll
          for (int i2 = j; i2 < NU; ++i2) Ls[i2 * NUP + j] = L[i2 * NU + j];
      }
      __syncwarp();
    }
    const auto lf = [&](int i, int j) -> T { return kLean ? Ls[i * NUP + j] : L[i * NU + j]; };
    T Y[NU], X[NU];
#pragma unroll
    for (int i2 = 0; i2 < NU; ++i2) {
      T sv = l == NX ? g.Qu[i2] : qux[i2];
#pragma unroll
      for (int kk = 0; kk < i2; ++kk) sv = sv - lf(i2, kk) * Y[kk];
      Y[i2] = sv * lf(i2, i2);
    }
#pragma unroll
    for (int i2 = NU - 1; i2 >= 0; --i2) {
      T sv = Y[i2];
#pragma unroll
      for (int kk = i2 + 1; kk < NU; ++kk) sv = sv - lf(kk, i2) * X[kk];
      X[i2] = sv * lf(i2, i2);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) kc[a] = -X[a];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = kc[0] * Q[a];
#pragma unroll
      for (int b2 = 1; b2 < NU; ++b2) s += kc[b2] * Q[b2 * NUP + a];
      kq[a] = s;
    }
  }
  T qxx[9];  // the block (I, J) of Q_xx
  {
    // a row of F's C block (rows k >= 6, entries i < 6) enters only with glow
    const bool top = bi < H;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (k >= H && top && !glow) continue;
      T f[3], w[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) f[ii] = F[k * NX + bi + ii];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) w[jj] = g.VS[k * NX + bj + jj];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj)
          qxx[ii * 3 + jj] = k == 0 ? f[ii] * w[jj] : qxx[ii * 3 + jj] + f[ii] * w[jj];
    }
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        qxx[ii * 3 + jj] = in.lxxT[(bj + jj) * NX + bi + ii] + qxx[ii * 3 + jj];
  }
  __syncwarp();  // every lane has read l_xx: its row takes K^T and K^T Q_uu
  if (own) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      KT[l * NUP + a] = kc[a];
      KQ[l * NUP + a] = kq[a];
      g.QxT[l * NUP + a] = qux[a];
      out.K[(a * NX + l) * kOutStride] = kc[a];
    }
  }
  if (l == NX) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      kv[a] = kc[a];
      out.k[a * kOutStride] = kc[a];
      out.g[a * kOutStride] = g.Qu[a];
    }
  }
  __syncwarp();

  // ---- D ----
  {
    T kk[NUP], quv[NUP];
    lds<T, NUP>(kk, kv);
    lds<T, NUP>(quv, g.Qu);
    T s1 = kq[0] * kk[0], s2 = kc[0] * quv[0], s3 = qux[0] * kk[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s1 += kq[a] * kk[a];
      s2 += kc[a] * quv[a];
      s3 += qux[a] * kk[a];
    }
    Vx = ((qx + s1) + s2) + s3;
  }
  T sb[9], mb[9];  // the blocks (I, J) of S and of M
  if constexpr (kLean) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T kqi[3], kti[3], ktj[3], qxj[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        kqi[ii] = KQ[(bi + ii) * NUP + a];
        kti[ii] = KT[(bi + ii) * NUP + a];
        ktj[ii] = KT[(bj + ii) * NUP + a];
        qxj[ii] = g.QxT[(bj + ii) * NUP + a];
      }
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          sb[ii * 3 + jj] = a == 0 ? kqi[ii] * ktj[jj] : sb[ii * 3 + jj] + kqi[ii] * ktj[jj];
          mb[ii * 3 + jj] = a == 0 ? kti[ii] * qxj[jj] : mb[ii * 3 + jj] + kti[ii] * qxj[jj];
        }
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) sb[e] = qxx[e] + sb[e];
  } else {
    T kqi[3][NUP], kti[3][NUP], ktj[3][NUP], qxj[3][NUP];
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
      lds<T, NUP>(kqi[ii], KQ + (bi + ii) * NUP);
      lds<T, NUP>(kti[ii], KT + (bi + ii) * NUP);
      lds<T, NUP>(ktj[ii], KT + (bj + ii) * NUP);
      lds<T, NUP>(qxj[ii], g.QxT + (bj + ii) * NUP);
    }
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        T sv = kqi[ii][0] * ktj[jj][0], mv = kti[ii][0] * qxj[jj][0];
#pragma unroll
        for (int a = 1; a < NU; ++a) {
          sv += kqi[ii][a] * ktj[jj][a];
          mv += kti[ii][a] * qxj[jj][a];
        }
        sb[ii * 3 + jj] = qxx[ii * 3 + jj] + sv;
        mb[ii * 3 + jj] = mv;
      }
  }
#pragma unroll
  for (int ii = 0; ii < 3; ++ii)
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      g.VS[(bi + ii) * NX + bj + jj] = sb[ii * 3 + jj];
      Mx[(bi + ii) * NX + bj + jj] = mb[ii * 3 + jj];
    }
  __syncwarp();

  // ---- E ----
  {
    T vb[9];
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int t = (bj + jj) * NX + bi + ii;  // (j, i)
        const T h = T(0.5) * (sb[ii * 3 + jj] + g.VS[t]);
        vb[ii * 3 + jj] = (h + mb[ii * 3 + jj]) + Mx[t];
      }
    __syncwarp();  // every lane has read S and M: VS takes V_xx
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) g.VS[(bi + ii) * NX + bj + jj] = vb[ii * 3 + jj];
  }
}

// The stage loop, from the carry of stage N (V_xx in the group's VS, V_x[r]
// in Vx) down to stage 0: while
// the group computes stage t, the block copies stage t - 1's inputs into the
// other stage buffer and stores stage t + 1's outputs from the other output
// buffer.  The constants must be in place; one block barrier per stage makes
// them, each stage's copies, and the reuse of a stage buffer's rows that
// phases C-E wrote, safe.
template <int NU>
__device__ __forceinline__ void riccati_f64_sweep(unsigned char* smem, int N, int B, double& Vx,
                                                  const double* Fx, const double* d,
                                                  const double* lx, const double* lu,
                                                  const double* lxx, const double* luual,
                                                  bool glow, double* K, double* k, double* gvec) {
  using L = Layout64<NU>;
  static_assert(24 * L::NUP <= L::pF, "K^T and K^T Q_uu fit in the l_xx row");
  const int tid = threadIdx.x, g = tid / kGroup, l = tid % kGroup;
  const int b0 = blockIdx.x * kProblems;
  riccati_f64_copy<NU>(smem + L::ostage, Fx, d, lx, lu, lxx, luual, N - 1, b0, B, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    // every address derived anew each stage (opaque_zero)
    const int z = opaque_zero(), cur = (N - 1 - t) & 1;
    unsigned char* sm = smem + z;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      riccati_f64_copy<NU>(sm + L::ostage + (cur ^ 1) * L::stage, Fx, d, lx, lu, lxx, luual,
                           t - 1 + z, b0, B, tid + z);
      cp_async_commit();
    }
    if (t < N - 1)
      riccati_store<double, double, NU>(K, k, gvec, sm + L::oout + ((t + 1) & 1) * L::out,
                                        t + 1 + z, b0, B, tid + z);
    unsigned char* buf = sm + L::ostage + cur * L::stage;
    const auto row = [&](size_t o, int pt) { return reinterpret_cast<double*>(buf + o) + g * pt; };
    double* F = row(L::oF, L::pF);
    double* dr = row(L::od, L::pd);
    double* lxxT = row(L::oxx, L::pF);
    const StageIn<double, double> in{F, dr, row(L::olx, L::pd), row(L::olu, L::pu), lxxT,
                                     luual ? row(L::oal, L::pu) : nullptr};
    riccati_f64_step<NU>(l, Vx, in, F, lxxT, dr, reinterpret_cast<const double*>(sm + L::ofu2),
                         reinterpret_cast<const double*>(sm + L::oLuu), glow,
                         *reinterpret_cast<Scratch64<NU>*>(sm + L::ogroup + g * L::gstride),
                         stage_out<double, double, NU>(sm + L::oout + (t & 1) * L::out, g));
  }
  __syncthreads();
  riccati_store<double, double, NU>(K, k, gvec, smem + L::oout, 0, b0, B, tid);
}

}  // namespace traopt
