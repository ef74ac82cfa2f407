// B13's large-nu instance (fast.cu launches it at nx <= 12 and nu = 13 ...
// kFastMaxNu): the dense Riccati step of ops/riccati.py riccati_step for one
// problem held by a group of kGroup = 16 threads, and the kernel
// fast_riccati_large_kernel that loops it over the stages.
//
// It is riccati_large.cuh's step (B2 at a large nu) carried onto the dense
// step, nu and nx runtime arguments and no register array growing with nu:
//   - every nx-sized array is padded to 12 with zeros (the stage buffers
//     are zeroed once, and the copies write only the entries below nx), so
//     the 12 x 12 products run as at nx = 12 and the padding stays exactly
//     zero: V_xx F, Q_xx = l_xx + F^T (V_xx F), S = Q_xx + K^T Q_uu K,
//     M = K^T Q_ux and the new V_xx in 3 x 3 blocks, one a lane (lane l:
//     rows I = 3 (l / 4).., columns J = 3 (l % 4)..), V_xx in the group's
//     scratch between stages, V_x[I] on the lanes of the diagonal blocks;
//     V_xx Fu in the same blocks, its columns c = l % 4 + 4 m;
//   - the nu-long arrays are nu-major (rows of Q_ux, of (V_xx Fu)^T, of
//     [K | k] and of K^T Q_uu: 12 or 13 values), lane l owning rows a = l,
//     l + 16, l + 32 of Q_uu, of its factor and of the 13 right-hand sides
//     [Q_ux | Q_u] (Q_u in column 12, whatever nx);
//   - the factor right-looking in panels of four columns fused with the
//     forward solve, then the back substitution a row a step: B2's
//     large_factor_solve itself; K^T Q_uu by rows.
// What differs from B2's step: Fu is dense (nx x nu) and l_ux, l_uu are
// read per stage; the outputs are K, k and the carry V_x, V_xx of each
// stage.  Every entry is riccati_step's sum in its order (the back
// substitution's from row nu - 1 down, and the new V_xx as sym(Q_xx +
// K^T Q_uu K) + M + M^T), so the kernel agrees with backward_plain to
// rounding.
//
// The block copies stage t - 1's inputs into shared memory with cp.async
// while it computes stage t and stages its outputs to store them coalesced
// over its problems, as fast_riccati_any_kernel does.  The shared memory
// (FastLargeLayout) is laid out at launch from (nx, nu), and so is the
// number of problems a block, P = 8, 4 or 2 (fast_large_problems: the one
// that puts the most problems on an SM), so P is a runtime argument too.
#pragma once

#include "group.cuh"
#include "lie.cuh"
#include "riccati_large.cuh"

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
// elements of T, each region a whole number of 16-byte vectors.  A stage
// buffer holds each input at 12 for nx: F and l_xx 12 x 12 (rows of 12),
// Fu 12 x nu (rows of w = nu | 1), d and l_x 12, l_ux nu x 12; the entries
// past nx stay zero.
struct FastLargeLayout {
  int nx, nu, w, P;      // the shape; the pitch of nu-wide rows; problems a block
  RowCopy in[8];         // F, Fu, d, lx, lu, lxx, lux, luu in a stage buffer
  int stage;             // one stage buffer
  int ek, eVx, eVxx, out;  // an output buffer: entries of k, Vx1, Vxx1 (K at 0); its size
  // a group's scratch (V_m, 12, at 0): Q_u, V_xx (12 x 12), K^T Q_uu's rows
  // (in phases A-B (V_xx Fu)^T's), Q_ux's rows (12 a row), [K | k]'s rows
  // (vpad(13) a row), Q_uu (rows of w), its lower triangle; its stride
  int Qu, VS, KQ, Qx, KX, Quu, A, group;
  int oout, ogroup;      // the block: two stage buffers at 0, two output buffers, the scratch
  size_t bytes;
};

template <typename T>
constexpr FastLargeLayout fast_large_layout(int nx, int nu, int P) {
  FastLargeLayout l{};
  l.nx = nx;
  l.nu = nu;
  l.P = P;
  const int w = l.w = nu | 1;
  int off = 0;
  // rows copied, their entries, the rows' pitch, the region's entries
  const int rows[8][4] = {{nx, nx, 12, 144},    {nx, nu, w, 12 * w}, {1, nx, nx, 12},
                          {1, nx, nx, 12},      {1, nu, nu, nu},     {nx, nx, 12, 144},
                          {nu, nx, 12, 12 * nu}, {nu, nu, w, nu * w}};
  for (int k = 0; k < 8; ++k) {
    const int pt = spread_pitch<T>(rows[k][3]);
    l.in[k] = row_copy(off, pt, rows[k][0], rows[k][1], rows[k][2]);
    off += P * pt;
  }
  l.stage = off;
  l.ek = nu * nx;
  l.eVx = l.ek + nu;
  l.eVxx = l.eVx + nx;
  l.out = vpad<T>((l.eVxx + nx * nx) * (P + 1));
  l.Qu = 12;
  l.VS = l.Qu + vpad<T>(nu);
  l.KQ = l.VS + 144;
  l.Qx = l.KQ + 12 * nu;
  l.KX = l.Qx + 12 * nu;
  l.Quu = l.KX + nu * vpad<T>(13);
  l.A = l.Quu + vpad<T>(nu * w);
  l.group = (int)(group_stride((l.A + vpad<T>(nu * (nu + 1) / 2)) * sizeof(T)) / sizeof(T));
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
  const T *F, *Fu, *d, *lx, *lu, *lxx, *lux, *luu;
};

template <typename T>
struct FastLargeOut {
  T *K, *k, *Vx, *Vxx;
  int os;
};

// One Riccati step for lane l of a group holding NS rows of the nu-long
// arrays: V_xx of stage t + 1 in the group's scratch and, on the lanes of
// the diagonal blocks, V_x[I] in Vx on entry, of stage t on exit.  Mx: the
// problem's F region of the stage buffer being computed, which holds M once
// phase D has read F.  The phases, between __syncwarp()s:
//   A  the carry out as Vx1 and Vxx1; V_x + V_xx d on the diagonal lanes;
//      the blocks (I, c) of V_xx Fu into rows c of (V_xx Fu)^T; the block
//      (I, J) of V_xx F, stored once every lane has read V_xx;
//   B  lane l its rows a of Q_ux and Q_u (the right-hand sides) and of
//      Q_uu (and its lower triangle into A);
//   C  large_factor_solve; lane l its rows of K and k out, and its rows a
//      of (K^T Q_uu)^T;
//   D  the block (I, J) of Q_xx and Q_x[I]; V_x[I] (diagonal lanes), the
//      blocks (I, J) of S and M, stored once every lane has read F, V_xx F
//      and l_xx;
//   E  the block (I, J) of the new V_xx, stored once every lane has read S
//      and M.
// Every lane of the warp calls it (it synchronises the warp).
template <typename T, int NS>
__device__ __forceinline__ void fast_large_step(int l, const FastLargeLayout& L, T (&Vx)[3],
                                                const FastLargeIn<T>& in, T* Mx, T* gs,
                                                const FastLargeOut<T>& out) {
  constexpr int NX = 12, NC = NX + 1, S = NS, PK = vpad<T>(NC);
  constexpr bool kZs = sizeof(T) == 8;
  const int nx = L.nx, nu = L.nu, w = L.w, os = out.os;
  const int bi = 3 * (l / 4), bj = 3 * (l % 4);
  T *Vm = gs, *Qu = gs + L.Qu, *VS = gs + L.VS, *KQ = gs + L.KQ, *Qx = gs + L.Qx,
    *KX = gs + L.KX, *Quu = gs + L.Quu, *A = gs + L.A;
  // lane l's row of slot s (slots 0 .. NS - 2 hold a row on every lane),
  // whether it is one, the row it computes there (past nu: the last), and
  // where row i of the triangle A starts
  const auto row = [&](int s) { return l + kGroup * s; };
  const auto live = [&](int s) { return s < S - 1 || l + kGroup * s < nu; };
  const auto crow = [&](int s) { return min(l + kGroup * s, nu - 1); };
  const auto tri = [](int i) { return (i * (i + 1)) >> 1; };

  // ---- A ----
  {
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        if (bi + ii < nx && bj + jj < nx)
          out.Vxx[((bi + ii) * nx + bj + jj) * os] = VS[(bi + ii) * NX + bj + jj];
    T v[3][NX];  // rows I of V_xx
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) lds<T, NX>(v[ii], VS + (bi + ii) * NX);
    {
      T dd[NX];
      lds<T, NX>(dd, in.d);
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        T s = v[ii][0] * dd[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s += v[ii][j] * dd[j];
        if (bi == bj) {
          if (bi + ii < nx) out.Vx[(bi + ii) * os] = Vx[ii];
          Vm[bi + ii] = Vx[ii] + s;
        }
      }
    }
    // the blocks (I, c) of V_xx Fu, c = l % 4 + 4 m, into rows c of
    // (V_xx Fu)^T
    for (int c = l % 4; c < nu; c += 4) {
      T f[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) f[k] = in.Fu[k * w + c];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        T s = v[ii][0] * f[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s += v[ii][k] * f[k];
        KQ[c * NX + bi + ii] = s;
      }
    }
    // the block (I, J) of V_xx F
    T vf[9];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T f[3];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) f[jj] = in.F[k * NX + bj + jj];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj)
          vf[ii * 3 + jj] = k == 0 ? v[ii][0] * f[jj] : vf[ii * 3 + jj] + v[ii][k] * f[jj];
    }
    __syncwarp();  // every lane has read V_xx: VS takes V_xx F
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) VS[(bi + ii) * NX + bj + jj] = vf[ii * 3 + jj];
  }
  __syncwarp();

  // ---- B ----
  // lane l's rows of [Q_ux | Q_u], solved in place in C: in registers, or
  // in fp64 in its rows of K
  T Z[kZs ? 1 : S][NC];
#pragma unroll
  for (int s = 0; s < (kZs ? 1 : S); ++s)
#pragma unroll
    for (int c = 0; c < NC; ++c) Z[s][c] = T(0);
  {
    T vm[NX];
    lds<T, NX>(vm, Vm);
    T fa[S][NX];  // column a of Fu for each of lane l's rows a
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int k = 0; k < NX; ++k) fa[s][k] = in.Fu[k * w + crow(s)];
    // Q_u[a] = l_u[a] + Fu^T (V_x + V_xx d)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = crow(s);
      T q = fa[s][0] * vm[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) q += fa[s][k] * vm[k];
      q = in.lu[a] + q;
      if constexpr (kZs) {
        if (live(s)) {
          KX[row(s) * PK + NX] = q;
#pragma unroll
          for (int c = NC; c < PK; ++c) KX[row(s) * PK + c] = T(0);
        }
      } else {
        Z[s][NX] = q;
      }
      if (live(s)) Qu[a] = q;
    }
    // row a of Q_ux = l_ux + Fu^T (V_xx F)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T vc[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) vc[k] = VS[k * NX + c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        T t = fa[s][0] * vc[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) t += fa[s][k] * vc[k];
        t = in.lux[crow(s) * NX + c] + t;
        if (live(s)) {
          Qx[row(s) * NX + c] = t;
          if constexpr (kZs) KX[row(s) * PK + c] = t;
        }
        if constexpr (!kZs) Z[s][c] = t;
      }
    }
    // rows a of Q_uu = l_uu + Fu^T (V_xx Fu), and their lower triangle into
    // A (row 0's pivot then as its reciprocal), E columns a batch (fp64: one,
    // for its registers), the loads ahead of the stores (the second of the
    // last batch past nu reads column nu - 1 and stores nothing)
    constexpr int E = kZs ? 1 : 2;
    for (int b0 = 0; b0 < nu; b0 += E) {
      T tm[E][NX], lu[S][E];
#pragma unroll
      for (int e = 0; e < E; ++e) lds<T, NX>(tm[e], KQ + min(b0 + e, nu - 1) * NX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int e = 0; e < E; ++e) lu[s][e] = in.luu[crow(s) * w + min(b0 + e, nu - 1)];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int a = crow(s);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int b2 = b0 + e;
          T t = fa[s][0] * tm[e][0];
#pragma unroll
          for (int k = 1; k < NX; ++k) t += fa[s][k] * tm[e][k];
          const T v = lu[s][e] + t;
          if (live(s) && b2 < nu) {
            Quu[a * w + b2] = v;
            if (b2 <= a) A[tri(a) + b2] = v;
          }
        }
      }
    }
    if (l == 0) A[0] = T(1) / xsqrt(A[0]);
  }
  __syncwarp();

  // ---- C ----
  large_factor_solve<T, S>(l, nu, A, KX, Z);
  // lane l's rows of K and k out
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int a = row(s);
    if (live(s)) {
      T z[PK];
      if constexpr (kZs) {
        lds<T, PK>(z, KX + a * PK);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) z[c] = Z[s][c];
      }
#pragma unroll
      for (int c = 0; c < NX; ++c)
        if (c < nx) out.K[(a * nx + c) * os] = z[c];
      out.k[a * os] = z[NX];
    }
  }
  // rows a of (K^T Q_uu)^T: (K^T Q_uu)[c, a] = sum_b K[b, c] Q_uu[b, a]
  {
    T kq[S][NX];
    const auto term = [&](int b2, auto first) {
      T kb[PK];
      lds<T, PK>(kb, KX + b2 * PK);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const T q = Quu[b2 * w + crow(s)];
#pragma unroll
        for (int c = 0; c < NX; ++c) {
          if constexpr (decltype(first)::value) {
            kq[s][c] = kb[c] * q;
          } else {
            kq[s][c] += kb[c] * q;
          }
        }
      }
    };
    term(0, std::true_type{});
#pragma unroll 2
    for (int b2 = 1; b2 < nu; ++b2) term(b2, std::false_type{});
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (live(s)) sts<T, NX>(KQ + row(s) * NX, kq[s]);
  }
  __syncwarp();

  // ---- D ----
  // the block (I, J) of Q_xx and Q_x[I], from F, V_xx F (VS), l_xx and
  // V_x + V_xx d, which D overwrites only after its barrier
  T qxx[9], qx[3];
  {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T f[3], vw[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) f[ii] = in.F[k * NX + bi + ii];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) vw[jj] = VS[k * NX + bj + jj];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj)
          qxx[ii * 3 + jj] = k == 0 ? f[ii] * vw[jj] : qxx[ii * 3 + jj] + f[ii] * vw[jj];
    }
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        qxx[ii * 3 + jj] = in.lxx[(bi + ii) * NX + bj + jj] + qxx[ii * 3 + jj];
    T vm[NX];
    lds<T, NX>(vm, Vm);
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
      const int r = bi + ii;
      T s = in.F[r] * vm[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s += in.F[k * NX + r] * vm[k];
      qx[ii] = in.lx[r] + s;
    }
  }
  T sb[9], mb[9];  // the blocks (I, J) of S and of M
  {
    // and on the diagonal lanes the three V_x corrections of rows I:
    // K^T Q_uu k, K^T Q_u, Q_ux^T k
    T c1[3], c2[3], c3[3];
    const auto term = [&](int a, auto first) {
      const T *kr = KX + a * PK, *qr = KQ + a * NX, *xr = Qx + a * NX;
      T kqi[3], ki[3], kj[3], qj[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        kqi[ii] = qr[bi + ii];
        ki[ii] = kr[bi + ii];
        kj[ii] = kr[bj + ii];
        qj[ii] = xr[bj + ii];
      }
      const T ka = kr[NX], qa = Qu[a];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        if constexpr (decltype(first)::value) {
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            sb[ii * 3 + jj] = kqi[ii] * kj[jj];
            mb[ii * 3 + jj] = ki[ii] * qj[jj];
          }
          c1[ii] = kqi[ii] * ka;
          c2[ii] = ki[ii] * qa;
          c3[ii] = qj[ii] * ka;
        } else {
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            sb[ii * 3 + jj] += kqi[ii] * kj[jj];
            mb[ii * 3 + jj] += ki[ii] * qj[jj];
          }
          c1[ii] += kqi[ii] * ka;
          c2[ii] += ki[ii] * qa;
          c3[ii] += qj[ii] * ka;
        }
      }
    };
    term(0, std::true_type{});
#pragma unroll 2
    for (int a = 1; a < nu; ++a) term(a, std::false_type{});
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) Vx[ii] = ((qx[ii] + c1[ii]) + c2[ii]) + c3[ii];
  }
  __syncwarp();  // every lane has read F, V_xx F and l_xx: they take S and M
#pragma unroll
  for (int ii = 0; ii < 3; ++ii)
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      sb[ii * 3 + jj] = qxx[ii * 3 + jj] + sb[ii * 3 + jj];
      VS[(bi + ii) * NX + bj + jj] = sb[ii * 3 + jj];
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
        const T h = T(0.5) * (sb[ii * 3 + jj] + VS[t]);
        vb[ii * 3 + jj] = (h + mb[ii * 3 + jj]) + Mx[t];
      }
    __syncwarp();  // every lane has read S and M: VS takes V_xx
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) VS[(bi + ii) * NX + bj + jj] = vb[ii * 3 + jj];
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

// The stage loop, from the carry of stage N (V_xx in the group's scratch,
// V_x[I] in Vx on the diagonal lanes) down to stage 0: while the group
// computes stage t, the block copies stage t - 1's inputs into the other
// stage buffer and stores stage t + 1's outputs from the other output
// buffer; one block barrier a stage makes them, and the reuse of a stage
// buffer's F region for M, safe.
template <typename T, int NS>
__device__ __forceinline__ void fast_large_sweep(const FastLargeArgs<T>& x, T* sm, T (&Vx)[3]) {
  const FastLargeLayout& l = x.l;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int N = x.a.N, P = l.P, b0 = blockIdx.x * P;
  T* const gs = sm + l.ogroup + g * l.group;
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
    fast_large_step<T, NS>(r, l, Vx,
                           FastLargeIn<T>{at(0), at(1), at(2), at(3), at(4), at(5), at(6), at(7)},
                           at(0), gs,
                           FastLargeOut<T>{o, o + l.ek * (P + 1), o + l.eVx * (P + 1),
                                           o + l.eVxx * (P + 1), P + 1});
  }
  __syncthreads();
  fast_large_store(x, sm + l.oout, 0, b0, tid);
}

// The kernel: the stage buffers and the groups' V_xx zeroed (the entries
// past nx stay zero), the terminal carry, then fast_large_sweep with the
// slots (rows of an nu-long array a lane holds) that nu takes: ceil(nu /
// 16), 1 ... kLargeSlots.  Blocks of kGroup * l.P threads.
template <typename T>
__global__ void __launch_bounds__(kGroup* kFastLargeMaxProblems)
    fast_riccati_large_kernel(FastLargeArgs<T> x) {
  static_assert(kLargeSlots == 3, "one sweep a slot count");
  const FastLargeLayout& l = x.l;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = x.a.B, N = x.a.N, nx = l.nx, bc = min(int(blockIdx.x) * l.P + g, B - 1);
  T* const VS = sm + l.ogroup + g * l.group + l.VS;
  for (int q = tid; q < 2 * l.stage; q += blockDim.x) sm[q] = T(0);
#pragma unroll
  for (int i = 0; i < 144 / kGroup; ++i) VS[r + kGroup * i] = T(0);
  __syncthreads();
  // the terminal carry (problems past B take problem B - 1's)
  if (r < nx) {
    const T* lxx = x.a.Lxx + ((long long)N * nx * nx + r * nx) * B + bc;
    for (int j = 0; j < nx; ++j) VS[r * 12 + j] = lxx[(long long)j * B];
  }
  T Vx[3];  // V_x[I] on the diagonal lanes (fast_large_step)
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) {
    const int i = 3 * (r / 4) + ii;
    Vx[ii] = i < nx ? x.a.Lx[((long long)N * nx + i) * B + bc] : T(0);
  }
  __syncwarp();
  const int ns = (l.nu + kGroup - 1) / kGroup;
  if (ns <= 1) {
    fast_large_sweep<T, 1>(x, sm, Vx);
  } else if (ns == 2) {
    fast_large_sweep<T, 2>(x, sm, Vx);
  } else {
    fast_large_sweep<T, 3>(x, sm, Vx);
  }
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
