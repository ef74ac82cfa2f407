// The defect-aware Riccati step of B2 and B5 at a large input dimension nu
// (13 ... kMaxNuLarge, nu.cuh's instances take nu <= 12), for one problem
// held by a group of kGroup = 16 threads, and the shared-memory layout of the
// kernels that loop it over the stages (nu_large.cuh).
//
// nu is a runtime argument and no register array grows with it.  A step is
// bound by the latency of its dependent chains and by the bytes each lane
// loads from shared memory (a load costs the warp by the bytes each lane
// receives, broadcast or not), so every phase spreads its work over all 16
// lanes as independent sums, and each value a lane loads serves several of
// them:
//   - the 12 x 12 products (V_xx F, Q_xx = l_xx + F^T (V_xx F), S = Q_xx +
//     K^T Q_uu K, M = K^T Q_ux and the new V_xx) in 3 x 3 blocks, one a lane
//     (lane l: rows I = 3 (l / 4).., columns J = 3 (l % 4)..), as
//     riccati_f64.cuh's step; V_xx stays in the group's scratch between
//     stages, and the lanes of the diagonal blocks (l = 0, 5, 10, 15) hold
//     V_x[I];
//   - the nu-long sums run over rows of nu-major arrays (row a of Q_ux, of
//     K = [K | k] and of K^T Q_uu: 12 or 13 values), which a lane reads in
//     16-byte vectors: lane l owns the rows a = l, l + 16, l + 32 (the rows
//     of Q_uu, of the factor and of the solves), and the blocks of S and M
//     read 3 + 3 values of two such rows for 9 sums each;
//   - phase C factors Q_uu right-looking in panels of four columns, a
//     column a step: row j's owner stores the reciprocal of its finished
//     pivot on the diagonal, every lane scales column j of its rows and of
//     the panel's rows itself (no barrier between the scaling and its use)
//     and updates its rows' entries in the panel's later columns; at a
//     panel's end every lane takes the panel's four terms off its rows right
//     of it, four independent FMAs an entry.  The forward solve of the 13
//     right-hand sides [Q_ux | Q_u] runs in the same steps: row j's owner
//     scales its row (in registers; fp64: in its row of K) by the
//     reciprocal and writes it as y_j, and after the step's __syncwarp()
//     every lane takes L_mj y_j off its rows.  The back substitution then
//     goes the same way from row nu - 1 down.  2 nu barrier steps of
//     independent work in place of 13 chains of ~nu^2 dependent FMAs.
//   - the step is instantiated for the rows a lane holds (NS = ceil(nu /
//     16): 1, 2 or 3), so that no lane computes for a slot nu leaves empty.
// Every entry is riccati_stage's formula, its terms in riccati_stage's
// order but for the back substitution's (from row nu - 1 down), so the
// kernels agree with the plain versions to rounding.  The group's shared
// memory, sized from nu at launch (LargeLayout), bounds nu.
#pragma once

#include <type_traits>

#include "group.cuh"
#include "lie.cuh"
#include "riccati_group.cuh"

namespace traopt {

// The rows of an nu-long array a lane holds at most: rows l, l + 16, l + 32.
constexpr int kLargeSlots = 3;

// The block's shared memory at nu, byte offsets, each 16-byte aligned: the
// constants (fu2 in both types, Luu), two stage buffers (the problems'
// rows: Fx, d, lx, lu in Tr; l_xx transposed and the AL diagonal in Tp),
// two output buffers (K, k in Tp, gvec in Tr; entry e of problem p at
// e * (P + 1) + p) and the groups' scratch (offsets within a group's).
// Computed on the host at launch and passed with the kernel's arguments.
struct LargeLayout {
  int nu, w;      // w = nu | 1: the pitch of Q_uu's rows and of the constants'
  int pk, pt;     // the pitch of K's rows (13 values), of (V_xx fu2)^T's (6)
  int pF, pd, pu, pxx, pal;                      // the stage buffer's row pitches
  size_t od, olx, olu, oxx, oal, stage;          // the stage buffer (Fx at 0)
  size_t ok, og, out;                            // an output buffer (K at 0)
  size_t sQu, sVS, sKQ, sQx, sKX, sQuu, sA, sFp, gstride;  // a group's (V_m at 0)
  size_t ofu2r, oLuu, ostage, oout, ogroup, bytes;  // the block (fu2 at 0)
};

template <typename Tp, typename Tr, int P>
__host__ __device__ constexpr LargeLayout large_layout(int nu) {
  LargeLayout L{};
  const int w = nu | 1;
  L.nu = nu;
  L.w = w;
  L.pk = vpad<Tp>(13);
  L.pt = vpad<Tp>(6);
  L.pF = pitch<Tr>(144);
  L.pd = pitch<Tr>(12);
  L.pu = pitch<Tr>(nu);
  L.pxx = pitch<Tp>(144);
  L.pal = pitch<Tp>(nu);
  const size_t p = sizeof(Tp), r = sizeof(Tr);
  L.od = P * L.pF * r;
  L.olx = L.od + P * L.pd * r;
  L.olu = L.olx + P * L.pd * r;
  L.oxx = L.olu + P * L.pu * r;
  L.oal = L.oxx + P * L.pxx * p;
  L.stage = L.oal + P * L.pal * p;
  const size_t S = P + 1;
  L.ok = align16(12 * nu * S * p);
  L.og = L.ok + align16(nu * S * p);
  L.out = L.og + align16(nu * S * r);
  L.sQu = align16(12 * r);
  L.sVS = L.sQu + align16(nu * r);
  L.sKQ = L.sVS + 144 * p;
  L.sQx = L.sKQ + align16(12 * nu * p);
  L.sKX = L.sQx + align16(12 * nu * p);
  L.sQuu = L.sKX + nu * L.pk * p;
  L.sA = L.sQuu + align16(nu * w * p);
  L.sFp = L.sA + align16(nu * (nu + 1) / 2 * p);
  L.gstride = group_stride(L.sFp + (std::is_same<Tp, Tr>::value ? 0 : 144 * p));
  L.ofu2r = align16(6 * w * p);
  L.oLuu = L.ofu2r + align16(6 * w * r);
  L.ostage = L.oLuu + align16(nu * w * p);
  L.oout = L.ostage + 2 * L.stage;
  L.ogroup = L.oout + 2 * L.out;
  L.bytes = L.ogroup + P * L.gstride;
  return L;
}

// One group's scratch.  Rows of nu-major arrays: Q_ux (row a: Q_ux[a, :]),
// K (row a: K[a, :] then k[a], pitch pk), K^T Q_uu (row a: column a of it;
// in phases A-B the same place holds (V_xx[6:, 6:] fu2)^T at pitch pt);
// Q_uu at pitch w; A the lower triangle of Q_uu, row i at i (i + 1) / 2,
// which the factorization turns into the factor's, the diagonal into the
// pivots' reciprocals.
template <typename Tp, typename Tr>
struct LargeScratch {
  Tr *Vm, *Qu;  // V_x + V_xx d (the terminal l_x); Q_u
  Tp *VS;       // V_xx (the carry; the terminal l_xx), V_xx F in B-D, S in D-E
  Tp *KQ, *Qx, *KX, *Quu, *A, *Fp;  // Fp: F in Tp (mixed)
};

template <typename Tp, typename Tr>
__device__ __forceinline__ LargeScratch<Tp, Tr> large_scratch(unsigned char* g,
                                                              const LargeLayout& L) {
  const auto p = [&](size_t o) { return reinterpret_cast<Tp*>(g + o); };
  return {reinterpret_cast<Tr*>(g), reinterpret_cast<Tr*>(g + L.sQu), p(L.sVS), p(L.sKQ),
          p(L.sQx), p(L.sKX), p(L.sQuu), p(L.sA), p(L.sFp)};
}

// One problem's place in an output buffer: entry e at [e * stride].
template <typename Tp, typename Tr>
struct LargeOut {
  Tp *K, *k;
  Tr* g;
  int stride;
};

// The block's copy of entries 0 .. ne - 1 of stage t of the batch-last array
// src (N, ne, B) for its P problems: problem p's entry e at dst[p * pt + e],
// or with TRANSPOSE (ne = 144) entry (i, j) of the 12 x 12 matrix at
// j * 12 + i.  Problems past B read problem B - 1.
template <int P, bool TRANSPOSE = false, typename T>
__device__ __forceinline__ void large_copy(T* dst, const T* src, int ne, int pt, int t, int b0,
                                           int B, int tid) {
  for (int q = tid; q < ne * P; q += kGroup * P) {
    const int e = q / P, p = q % P;
    const int s = TRANSPOSE ? (e % 12) * 12 + e / 12 : e;
    cp_async<sizeof(T)>(dst + p * pt + s, src + ((long long)t * ne + e) * B + min(b0 + p, B - 1));
  }
}

// The block's store of entries 0 .. ne - 1 of stage t of the batch-last array
// dst (N, ne, B) from the staged buf; problems past B store nothing.
template <int P, typename T>
__device__ __forceinline__ void large_store(T* dst, const T* buf, int ne, int t, int b0, int B,
                                            int tid) {
  for (int q = tid; q < ne * P; q += kGroup * P) {
    const int e = q / P, p = q % P;
    if (b0 + p < B) dst[((long long)t * ne + e) * B + b0 + p] = buf[e * (P + 1) + p];
  }
}

// n values to 16-byte-aligned shared memory, in 16-byte stores where n
// allows (lds's counterpart).
template <typename T, int n>
__device__ __forceinline__ void sts(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 && n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
  } else if constexpr (sizeof(T) == 8 && n % 2 == 0) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i)
      reinterpret_cast<double2*>(dst)[i] = make_double2(src[2 * i], src[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

// One Riccati step for lane l of a group holding NS rows of the nu-long
// arrays: V_xx of stage t + 1 in the group's VS and, on the lanes of the
// diagonal blocks, V_x[I] in Vx on entry, of stage t on exit.  Mx: the
// problem's F row of the stage buffer being computed, which holds M once
// phase D has read F.  fu2, fu2r and Luu are the block's constants at
// pitch w; out gets K, k and gvec = Q_u.  The phases, between
// __syncwarp()s:
//   A  the block (I, J) of V_xx F, stored once every lane has read V_xx;
//      V_x + V_xx d on the diagonal lanes; lane l its rows a of (V_xx[6:,
//      6:] fu2)^T;
//   B  lane l its rows a of Q_ux and Q_u (the right-hand sides) and of
//      Q_uu (and its lower triangle into A);
//   C  the factorization with the forward solve, a column a step; the back
//      substitution, a row a step (K = -x); lane l its rows of K and k out,
//      and its rows a of (K^T Q_uu)^T;
//   D  the block (I, J) of Q_xx = l_xx + F^T (V_xx F) and Q_x[I]; V_x[I]
//      (diagonal lanes), the blocks (I, J) of S and M, stored once every
//      lane has read F, V_xx F and l_xx;
//   E  the block (I, J) of the new V_xx, stored once every lane has read S
//      and M.
// Every lane of the warp calls it (it synchronises the warp).
template <typename Tp, typename Tr, int NS>
__device__ __forceinline__ void riccati_large_step(int l, const LargeLayout& L,
                                                   Tr (&Vx)[3], const StageIn<Tp, Tr>& in,
                                                   Tp* Mx, const Tp* fu2, const Tr* fu2r,
                                                   const Tp* Luu, bool glow,
                                                   const LargeScratch<Tp, Tr>& g,
                                                   const LargeOut<Tp, Tr>& out) {
  constexpr bool kMixed = !std::is_same<Tp, Tr>::value;
  constexpr int NX = 12, H = 6, NC = NX + 1, S = NS;
  constexpr int PK = vpad<Tp>(NC), PT = vpad<Tp>(H);  // L.pk, L.pt
  const int nu = L.nu, w = L.w;
  const int bi = 3 * (l / 4), bj = 3 * (l % 4);
  // lane l's row of slot s (slots 0 .. NS - 2 hold a row on every lane),
  // whether it is one, the row it computes there (past nu: the last), and
  // where row i of the triangle A starts
  const auto row = [&](int s) { return l + kGroup * s; };
  const auto live = [&](int s) { return s < S - 1 || l + kGroup * s < nu; };
  const auto crow = [&](int s) { return min(l + kGroup * s, nu - 1); };
  const auto tri = [](int i) { return (i * (i + 1)) >> 1; };
  const Tp* Fp;
  if constexpr (kMixed) {
#pragma unroll
    for (int i = 0; i < 144 / kGroup; ++i) g.Fp[l + kGroup * i] = Tp(in.F[l + kGroup * i]);
    __syncwarp();
    Fp = g.Fp;
  } else {
    Fp = in.F;
  }

  // ---- A ----
  {
    {
      // rows a of (V_xx[6:, 6:] fu2)^T
      Tp vt[H][H];
#pragma unroll
      for (int i = 0; i < H; ++i)
#pragma unroll
        for (int k = 0; k < H; ++k) vt[i][k] = g.VS[(H + i) * NX + H + k];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int a = crow(s);
        Tp f[H], tm[PT];
#pragma unroll
        for (int k = 0; k < H; ++k) f[k] = fu2[k * w + a];
#pragma unroll
        for (int i = 0; i < PT; ++i) tm[i] = Tp(0);
#pragma unroll
        for (int i = 0; i < H; ++i) {
          Tp t = vt[i][0] * f[0];
#pragma unroll
          for (int k = 1; k < H; ++k) t += vt[i][k] * f[k];
          tm[i] = t;
        }
        if (live(s)) sts<Tp, PT>(g.KQ + a * PT, tm);
      }
    }
    Tp v[3][NX];  // rows I of V_xx
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) lds<Tp, NX>(v[ii], g.VS + (bi + ii) * NX);
    {
      Tr dd[NX];
      lds<Tr, NX>(dd, in.d);
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        Tp s = v[ii][0] * Tp(dd[0]);
#pragma unroll
        for (int j = 1; j < NX; ++j) s += v[ii][j] * Tp(dd[j]);
        if (bi == bj) g.Vm[bi + ii] = Vx[ii] + Tr(s);
      }
    }
    // the block (I, J) of V_xx F; a column of F's C block (rows k >= 6,
    // columns j < 6) enters only with glow
    const bool left = bj < H;
    Tp vf[9];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (k >= H && left && !glow) continue;
      Tp f[3];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) f[jj] = Fp[k * NX + bj + jj];
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
      for (int jj = 0; jj < 3; ++jj) g.VS[(bi + ii) * NX + bj + jj] = vf[ii * 3 + jj];
  }
  __syncwarp();

  // ---- B ----
  // lane l's rows of [Q_ux | Q_u], solved in place in C: in registers, or
  // in fp64 (where its 13 doubles a row do not fit beside the rest) in its
  // rows of K
  constexpr bool kZs = sizeof(Tp) == 8;
  Tp Z[kZs ? 1 : S][NC];
#pragma unroll
  for (int s = 0; s < (kZs ? 1 : S); ++s)
#pragma unroll
    for (int c = 0; c < NC; ++c) Z[s][c] = Tp(0);
  const auto getz = [&](int s, Tp(&z)[PK]) {
    if constexpr (kZs) {
      lds<Tp, PK>(z, g.KX + row(s) * PK);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = Z[s][c];
    }
  };
  const auto putz = [&](int s, const Tp(&z)[PK]) {
    if constexpr (kZs) {
      sts<Tp, PK>(g.KX + row(s) * PK, z);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) Z[s][c] = z[c];
    }
  };
  {
    Tr vm[NX];
    lds<Tr, NX>(vm, g.Vm);
    Tp fa[S][H];  // column a of fu2 for each of lane l's rows a
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int k = 0; k < H; ++k) fa[s][k] = fu2[k * w + crow(s)];
    // Q_u[a] and row a of Q_ux = fu2^T (V_xx F)[6:]
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = crow(s);
      Tr q = fu2r[a] * vm[H];
#pragma unroll
      for (int k = 1; k < H; ++k) q += fu2r[k * w + a] * vm[H + k];
      q = in.lu[a] + q;
      if constexpr (kZs) {
        if (live(s)) {
          g.KX[row(s) * PK + NX] = Tp(q);
#pragma unroll
          for (int c = NC; c < PK; ++c) g.KX[row(s) * PK + c] = Tp(0);
        }
      } else {
        Z[s][NX] = Tp(q);
      }
      if (live(s)) {
        g.Qu[a] = q;
        out.g[a * out.stride] = q;
      }
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      Tp vc[H];
#pragma unroll
      for (int k = 0; k < H; ++k) vc[k] = g.VS[(H + k) * NX + c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        Tp t = fa[s][0] * vc[0];
#pragma unroll
        for (int k = 1; k < H; ++k) t += fa[s][k] * vc[k];
        if (live(s)) {
          g.Qx[row(s) * NX + c] = t;
          if constexpr (kZs) g.KX[row(s) * PK + c] = t;
        }
        if constexpr (!kZs) Z[s][c] = t;
      }
    }
    // rows a of Q_uu = Luu + fu2^T (V_xx[6:, 6:] fu2) [+ diag(luual)], and
    // their lower triangle into A (row 0's pivot then as its reciprocal)
    // two columns a batch, the loads ahead of the stores (the second of
    // the last batch past nu reads column nu - 1 and stores nothing)
    for (int b0 = 0; b0 < nu; b0 += 2) {
      Tp tm[2][PT], lu[S][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) lds<Tp, PT>(tm[e], g.KQ + min(b0 + e, nu - 1) * PT);
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int e = 0; e < 2; ++e) lu[s][e] = Luu[crow(s) * w + min(b0 + e, nu - 1)];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int a = crow(s);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b2 = b0 + e;
          Tp t = fa[s][0] * tm[e][0];
#pragma unroll
          for (int k = 1; k < H; ++k) t += fa[s][k] * tm[e][k];
          Tp v = lu[s][e] + t;
          if (in.luual && b2 == a) v += in.luual[a];
          if (live(s) && b2 < nu) {
            g.Quu[a * w + b2] = v;
            if (b2 <= a) g.A[tri(a) + b2] = v;
          }
        }
      }
    }
    if (l == 0) g.A[0] = Tp(1) / xsqrt(g.A[0]);
  }
  __syncwarp();

  // ---- C ----
  // The factorization and the forward solve, column j a step, in panels of
  // four columns (right-looking: each entry's terms in riccati_stage's
  // order).  At step j every lane reads the pivot's reciprocal r_j (which
  // row j's owner stored on the diagonal when it finished the pivot),
  // scales column j of its rows, L_mj (kept in lq until the panel is done),
  // and takes L_mj L_cj off its rows' entries in the panel's later columns
  // c (each lane scales the L_cj it needs itself); row j's owner writes
  // y_j, and at the next step the rows m > j take L_mj y_j.  After a
  // panel's last column every lane takes the panel's four terms off its
  // rows' entries right of it, and the panel's L goes into A during the
  // next one (its raw columns are read until then).
  int tr[S];  // where lane l's rows start in A
#pragma unroll
  for (int s = 0; s < S; ++s) tr[s] = tri(row(s));
  Tp inv[S], lo[S], lq[S][4], rp[4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    inv[s] = lo[s] = Tp(0);
#pragma unroll
    for (int p = 0; p < 4; ++p) lq[s][p] = Tp(0);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) rp[p] = Tp(0);
  const auto put_panel = [&](int J) {  // lane l's L of columns J .. J + 3
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int m = row(s);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (live(s) && m > J + p) g.A[tr[s] + J + p] = lq[s][p];
    }
  };
#pragma unroll
  for (int s0 = 0; s0 < S; ++s0) {
    const int oe = min(kGroup, nu - kGroup * s0);
    for (int o4 = 0; o4 < oe; o4 += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o4 + q >= oe) break;
        const int o = o4 + q, j = kGroup * s0 + o, J = j - q;
        // the step's loads: r_j, column j of lane l's rows and of the
        // panel's rows c = j + 1 .. J + 3, y_{j-1}, the panel's entries
        const Tp rj = g.A[tri(j) + j];
        Tp aj[S], ac[3], av[S][3];
#pragma unroll
        for (int s = s0; s < S; ++s) {
          const int m = row(s), tm = tr[s];
          aj[s] = live(s) && m > j ? g.A[tm + j] : Tp(0);
#pragma unroll
          for (int e = 0; e < 3 - q; ++e)
            av[s][e] = live(s) && m > j + e ? g.A[tm + j + 1 + e] : Tp(0);
        }
#pragma unroll
        for (int e = 0; e < 3 - q; ++e) ac[e] = g.A[tri(min(j + 1 + e, nu - 1)) + j];
        if (j > 0) {
          Tp y[PK];
          lds<Tp, PK>(y, g.KX + (j - 1) * PK);
#pragma unroll
          for (int s = s0; s < S; ++s) {
            if (live(s) && row(s) >= j) {
              Tp z[PK];
              getz(s, z);
#pragma unroll
              for (int c = 0; c < NC; ++c) z[c] = z[c] - lo[s] * y[c];
              putz(s, z);
            }
          }
        }
        if (q == 0 && j > 0) put_panel(J - 4);  // before lq takes this panel's
        rp[q] = rj;
#pragma unroll
        for (int s = s0; s < S; ++s) {
          if (live(s) && row(s) > j) lo[s] = lq[s][q] = aj[s] * rj;
        }
        // the panel's later columns; row j + 1's owner (slot s0) finishes
        // its pivot
        Tp piv = Tp(1);
#pragma unroll
        for (int e = 0; e < 3 - q; ++e) {
          const int c = j + 1 + e;
          const Tp lc = ac[e] * rj;
#pragma unroll
          for (int s = s0; s < S; ++s) {
            const int m = row(s);
            const Tp v = av[s][e] - lq[s][q] * lc;
            if (live(s) && m >= c) g.A[tr[s] + c] = v;
            if (e == 0 && s == s0 && m == c) piv = v;
          }
        }
        if (q < 3 && j + 1 < nu) {  // every lane (1 where it owns no pivot), no branch
          const Tp rn = Tp(1) / xsqrt(piv);
          if (row(s0) == j + 1) g.A[tri(j + 1) + j + 1] = rn;
        }
        if (q == 3 && J + 4 < nu) {
          // the panel's four terms off lane l's rows m >= J + 4, columns
          // k = J + 4 .. m, two columns a batch; row J + 4's owner
          // finishes its pivot
          int top = J + 3;
#pragma unroll
          for (int s = s0; s < S; ++s)
            if (live(s) && row(s) >= J + 4) top = row(s);
          for (int k = J + 4; k <= top; k += 2) {
            Tp lk[2][4], ak[S][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tk = tri(min(k + e, top));
#pragma unroll
              for (int p = 0; p < 4; ++p) lk[e][p] = g.A[tk + J + p];
            }
#pragma unroll
            for (int s = s0; s < S; ++s) {
              const int m = row(s), tm = tr[s];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                ak[s][e] = live(s) && m >= k + e ? g.A[tm + k + e] : Tp(0);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              Tp lr[4];
#pragma unroll
              for (int p = 0; p < 4; ++p) lr[p] = lk[e][p] * rp[p];
#pragma unroll
              for (int s = s0; s < S; ++s) {
                const int m = row(s);
                Tp v = ak[s][e];
#pragma unroll
                for (int p = 0; p < 4; ++p) v = v - lq[s][p] * lr[p];
                if (live(s) && m >= k + e) g.A[tr[s] + k + e] = v;
                if (m == J + 4 && k + e == m) piv = v;
              }
            }
          }
          const Tp rn = Tp(1) / xsqrt(piv);
          if (top >= J + 4 && (row(s0) == J + 4 || row(s0 + 1) == J + 4))
            g.A[tri(J + 4) + J + 4] = rn;
        }
        {
          // row j's owner: y_j (every lane scales its slot's row, no branch)
          Tp y[PK];
          getz(s0, y);
#pragma unroll
          for (int c = 0; c < NC; ++c) y[c] = y[c] * rj;
#pragma unroll
          for (int c = NC; c < PK; ++c) y[c] = Tp(0);
          if (l == o) {
            if constexpr (!kZs) putz(s0, y);
            sts<Tp, PK>(g.KX + j * PK, y);
            inv[s0] = rj;
          }
        }
        __syncwarp();
      }
    }
  }
  put_panel((nu - 1) & ~3);
  __syncwarp();
  // the back substitution, row i a step: the rows m <= i take L_{i+1, m}
  // K_{i+1} (K = -x), then row i's owner x_i and K's row i
#pragma unroll
  for (int s0 = S - 1; s0 >= 0; --s0) {
    const int oe = min(kGroup, nu - kGroup * s0);
    for (int o = oe - 1; o >= 0; --o) {
      const int i = kGroup * s0 + o;
      if (i < nu - 1) {
        Tp kx[PK];
        lds<Tp, PK>(kx, g.KX + (i + 1) * PK);
        const Tp* Li = g.A + tri(i + 1);
#pragma unroll
        for (int s = 0; s <= s0; ++s) {
          const int m = row(s);
          if (m <= i) {
            const Tp lm = Li[m];
            Tp z[PK];
            getz(s, z);
#pragma unroll
            for (int c = 0; c < NC; ++c) z[c] = z[c] + lm * kx[c];
            putz(s, z);
          }
        }
      }
      {
        Tp x[PK];
        getz(s0, x);
#pragma unroll
        for (int c = 0; c < NC; ++c) x[c] = -(x[c] * inv[s0]);
#pragma unroll
        for (int c = NC; c < PK; ++c) x[c] = Tp(0);
        if (l == o) {
          if constexpr (!kZs) putz(s0, x);
          sts<Tp, PK>(g.KX + i * PK, x);
        }
      }
      __syncwarp();
    }
  }
  // lane l's rows of K and k out
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int a = row(s);
    if (live(s)) {
      Tp z[PK];
      getz(s, z);
#pragma unroll
      for (int c = 0; c < NX; ++c) out.K[(a * NX + c) * out.stride] = z[c];
      out.k[a * out.stride] = z[NX];
    }
  }
  // rows a of (K^T Q_uu)^T: (K^T Q_uu)[c, a] = sum_b K[b, c] Q_uu[b, a]
  {
    Tp kq[S][NX];
    const auto term = [&](int b2, auto first) {
      Tp kb[PK];
      lds<Tp, PK>(kb, g.KX + b2 * PK);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const Tp q = g.Quu[b2 * w + crow(s)];
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
      if (live(s)) sts<Tp, NX>(g.KQ + row(s) * NX, kq[s]);
  }
  __syncwarp();

  // ---- D ----
  // the block (I, J) of Q_xx and Q_x[I] (diagonal lanes), from F, V_xx F
  // (VS), l_xx and V_x + V_xx d, which D overwrites only after its barrier
  Tp qxx[9];
  Tr qx[3];
  {
    // a row of F's C block (rows k >= 6, entries i < 6) enters only with glow
    const bool top = bi < H;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (k >= H && top && !glow) continue;
      Tp f[3], vw[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) f[ii] = Fp[k * NX + bi + ii];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) vw[jj] = g.VS[k * NX + bj + jj];
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
        qxx[ii * 3 + jj] = in.lxxT[(bj + jj) * NX + bi + ii] + qxx[ii * 3 + jj];
  }
  {
    Tr vm[NX];
    lds<Tr, NX>(vm, g.Vm);
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
      const int r = bi + ii;
      Tr s = in.F[r] * vm[0];
#pragma unroll
      for (int k = 1; k < H; ++k) s += in.F[k * NX + r] * vm[k];
      if (glow || r >= H) {
#pragma unroll
        for (int k = H; k < NX; ++k) s += in.F[k * NX + r] * vm[k];
      }
      qx[ii] = in.lx[r] + s;
    }
  }
  Tp sb[9], mb[9];  // the blocks (I, J) of S and of M
  {
    // and on the diagonal lanes the three V_x corrections of rows I:
    // K^T Q_uu k, K^T Q_u, Q_ux^T k
    Tp c1[3], c2[3], c3[3];
    const auto term = [&](int a, auto first) {
      const Tp *kr = g.KX + a * PK, *qr = g.KQ + a * NX, *xr = g.Qx + a * NX;
      Tp kqi[3], ki[3], kj[3], qj[3];
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
        kqi[ii] = qr[bi + ii];
        ki[ii] = kr[bi + ii];
        kj[ii] = kr[bj + ii];
        qj[ii] = xr[bj + ii];
      }
      const Tp ka = kr[NX], qa = Tp(g.Qu[a]);
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
    for (int ii = 0; ii < 3; ++ii) {
      if constexpr (kMixed) {
        Vx[ii] = qx[ii] + Tr((c1[ii] + c2[ii]) + c3[ii]);
      } else {
        Vx[ii] = ((qx[ii] + c1[ii]) + c2[ii]) + c3[ii];
      }
    }
  }
  __syncwarp();  // every lane has read F, V_xx F and l_xx: they take S and M
#pragma unroll
  for (int ii = 0; ii < 3; ++ii)
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      sb[ii * 3 + jj] = qxx[ii * 3 + jj] + sb[ii * 3 + jj];
      g.VS[(bi + ii) * NX + bj + jj] = sb[ii * 3 + jj];
      Mx[(bi + ii) * NX + bj + jj] = mb[ii * 3 + jj];
    }
  __syncwarp();

  // ---- E ----
  {
    Tp vb[9];
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int t = (bj + jj) * NX + bi + ii;  // (j, i)
        const Tp h = Tp(0.5) * (sb[ii * 3 + jj] + g.VS[t]);
        vb[ii * 3 + jj] = (h + mb[ii * 3 + jj]) + Mx[t];
      }
    __syncwarp();  // every lane has read S and M: VS takes V_xx
#pragma unroll
    for (int ii = 0; ii < 3; ++ii)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) g.VS[(bi + ii) * NX + bj + jj] = vb[ii * 3 + jj];
  }
}

// The block's constants at nu: fu2 (6 x nu) in both types and Luu (nu x nu),
// rows at pitch w.
template <typename Tp, typename Tr, int P>
__device__ __forceinline__ void riccati_large_consts(unsigned char* smem, const LargeLayout& L,
                                                     const Tp* fu2, const Tr* fu2r,
                                                     const Tp* Luu, int tid) {
  const int nu = L.nu, w = L.w;
  for (int q = tid; q < 6 * nu; q += kGroup * P) {
    const int i = q / nu, a = q % nu;
    reinterpret_cast<Tp*>(smem)[i * w + a] = fu2[q];
    reinterpret_cast<Tr*>(smem + L.ofu2r)[i * w + a] = fu2r[q];
  }
  for (int q = tid; q < nu * nu; q += kGroup * P)
    reinterpret_cast<Tp*>(smem + L.oLuu)[(q / nu) * w + q % nu] = Luu[q];
}

// The stage loop of a large-nu Riccati kernel, from the carry of stage N
// (V_xx in the group's VS; V_x[I] in Vx on the diagonal lanes l = 0, 5, 10,
// 15) down to stage 0: while the group computes stage t, the block copies
// stage t - 1's inputs into the other stage buffer and stores stage t + 1's
// outputs from the other output buffer, as riccati_group_sweep does.  The
// constants must be in place (riccati_large_consts); one block barrier per
// stage makes them, each stage's copies, and the reuse of a stage buffer's
// F rows for M, safe.
template <typename Tp, typename Tr, int P, int NS>
__device__ __forceinline__ void riccati_large_sweep(unsigned char* smem, const LargeLayout& L,
                                                    int N, int B, Tr (&Vx)[3], const Tr* Fx,
                                                    const Tr* d, const Tr* lx, const Tr* lu,
                                                    const Tp* lxx, const Tp* luual, bool glow,
                                                    Tp* K, Tp* k, Tr* gvec) {
  const int tid = threadIdx.x, g = tid / kGroup, l = tid % kGroup;
  const int b0 = blockIdx.x * P, nu = L.nu;
  const auto copy = [&](unsigned char* buf, int t) {
    large_copy<P>(reinterpret_cast<Tr*>(buf), Fx, 144, L.pF, t, b0, B, tid);
    large_copy<P>(reinterpret_cast<Tr*>(buf + L.od), d, 12, L.pd, t, b0, B, tid);
    large_copy<P>(reinterpret_cast<Tr*>(buf + L.olx), lx, 12, L.pd, t, b0, B, tid);
    large_copy<P>(reinterpret_cast<Tr*>(buf + L.olu), lu, nu, L.pu, t, b0, B, tid);
    large_copy<P, true>(reinterpret_cast<Tp*>(buf + L.oxx), lxx, 144, L.pxx, t, b0, B, tid);
    if (luual) large_copy<P>(reinterpret_cast<Tp*>(buf + L.oal), luual, nu, L.pal, t, b0, B, tid);
    cp_async_commit();
  };
  const auto store = [&](const unsigned char* buf, int t) {
    large_store<P>(K, reinterpret_cast<const Tp*>(buf), 12 * nu, t, b0, B, tid);
    large_store<P>(k, reinterpret_cast<const Tp*>(buf + L.ok), nu, t, b0, B, tid);
    large_store<P>(gvec, reinterpret_cast<const Tr*>(buf + L.og), nu, t, b0, B, tid);
  };
  unsigned char* stage = smem + L.ostage;
  unsigned char* outb = smem + L.oout;
  const LargeScratch<Tp, Tr> gs = large_scratch<Tp, Tr>(smem + L.ogroup + g * L.gstride, L);
  copy(stage, N - 1);
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) copy(stage + (cur ^ 1) * L.stage, t - 1);
    if (t < N - 1) store(outb + ((t + 1) & 1) * L.out, t + 1);
    unsigned char* buf = stage + cur * L.stage;
    const auto rr = [&](size_t o, int pt) { return reinterpret_cast<const Tr*>(buf + o) + g * pt; };
    const auto rp = [&](size_t o, int pt) { return reinterpret_cast<const Tp*>(buf + o) + g * pt; };
    const StageIn<Tp, Tr> in{rr(0, L.pF), rr(L.od, L.pd), rr(L.olx, L.pd), rr(L.olu, L.pu),
                             rp(L.oxx, L.pxx), luual ? rp(L.oal, L.pal) : nullptr};
    unsigned char* ob = outb + (t & 1) * L.out;
    const LargeOut<Tp, Tr> o{reinterpret_cast<Tp*>(ob) + g, reinterpret_cast<Tp*>(ob + L.ok) + g,
                             reinterpret_cast<Tr*>(ob + L.og) + g, P + 1};
    riccati_large_step<Tp, Tr, NS>(l, L, Vx, in, reinterpret_cast<Tp*>(buf + g * L.pF * sizeof(Tr)),
                               reinterpret_cast<const Tp*>(smem),
                               reinterpret_cast<const Tr*>(smem + L.ofu2r),
                               reinterpret_cast<const Tp*>(smem + L.oLuu), glow, gs, o);
  }
  __syncthreads();
  store(outb, 0);
}

// riccati_large_sweep with the slots (rows of an nu-long array a lane
// holds) that L.nu takes: ceil(nu / 16), 1 ... kLargeSlots.
template <typename Tp, typename Tr, int P>
__device__ __forceinline__ void riccati_large_run(unsigned char* smem, const LargeLayout& L,
                                                  int N, int B, Tr (&Vx)[3], const Tr* Fx,
                                                  const Tr* d, const Tr* lx, const Tr* lu,
                                                  const Tp* lxx, const Tp* luual, bool glow,
                                                  Tp* K, Tp* k, Tr* gvec) {
  static_assert(kLargeSlots == 3, "one sweep a slot count");
  const int ns = (L.nu + kGroup - 1) / kGroup;
  if (ns <= 1) {
    riccati_large_sweep<Tp, Tr, P, 1>(smem, L, N, B, Vx, Fx, d, lx, lu, lxx, luual, glow, K, k,
                                      gvec);
  } else if (ns == 2) {
    riccati_large_sweep<Tp, Tr, P, 2>(smem, L, N, B, Vx, Fx, d, lx, lu, lxx, luual, glow, K, k,
                                      gvec);
  } else {
    riccati_large_sweep<Tp, Tr, P, 3>(smem, L, N, B, Vx, Fx, d, lx, lu, lxx, luual, glow, K, k,
                                      gvec);
  }
}

}  // namespace traopt
