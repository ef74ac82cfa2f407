// The defect-aware Riccati step of B2 and B5 at a large input dimension nu
// (13 ... kMaxNuLarge, nu.cuh's instances take nu <= 12), for one problem
// held by a group of kGroup = 16 threads, and the shared-memory layout of the
// kernels that loop it over the stages (nu_large.cuh).
//
// Why a design of its own.  riccati_group_step (riccati_group.cuh) gives lane
// a < NU row a of Q_uu, and every lane copies Q_uu and its factor into
// registers and solves with nu-sized register arrays: past nu = 12 the
// lanes no longer cover the rows, and the arrays outgrow the register file.
// Here nu is a runtime argument and no register array grows with it:
//   - Q_uu, its factor, Q_ux^T (the right-hand sides of K), K^T (row c < 12
//     column c of K, row 12 k), K^T Q_uu, Q_u and V_xx[6:, 6:] fu2 live in
//     the group's shared memory, every nu-wide row at the odd pitch w =
//     nu | 1, so that the lanes of a group reading one column of 16 rows hit
//     16 banks;
//   - phase B: lane r takes rows r, r + 16, ... of Q_uu;
//   - phase C: a cooperative Cholesky, column by column between __syncwarp()s
//     (every lane the pivot, lanes r the rows j + 1 + r, j + 17 + r, ...),
//     the diagonal stored as 1 / sqrt(pivot) as pipeline.chol_factor_lane
//     stores it; then lane c <= 12 one of the 13 triangular solves in its row
//     of K^T, reading the factor from shared memory;
//   - phases A, D and E are riccati_group_step's (lane r < 12 owns row r of
//     V_xx), their sums over nu loops.
// Every entry is riccati_stage's sum in riccati_group_step's order (the
// k-loop outermost where an entry sums over k), so the kernels agree with
// the plain versions to rounding.  The group's shared memory, sized from nu
// at launch (LargeLayout), bounds nu: kMaxNuLarge is the largest nu whose
// layout fits an H100's shared memory for one block in every scalar.
#pragma once

#include <type_traits>

#include "group.cuh"
#include "lie.cuh"
#include "riccati_group.cuh"

namespace traopt {

// The block's shared memory at nu, byte offsets, each 16-byte aligned: the
// constants (fu2 in both types, Luu), two stage buffers (the problems'
// rows: Fx, d, lx, lu in Tr; l_xx transposed and the AL diagonal in Tp),
// two output buffers (K, k in Tp, gvec in Tr; entry e of problem p at
// e * (P + 1) + p) and the groups' scratch (offsets within a group's).
// Computed on the host at launch and passed with the kernel's arguments.
struct LargeLayout {
  int nu, w;      // w = nu | 1: the pitch of every nu-wide row but the stage buffer's
  int pF, pd, pu, pxx, pal;                      // the stage buffer's row pitches
  size_t od, olx, olu, oxx, oal, stage;          // the stage buffer (Fx at 0)
  size_t ok, og, out;                            // an output buffer (K at 0)
  size_t sQu, sVS, sM, sKT, sKQ, sQx, sQuu, sL, sTm, sFp, gstride;  // a group's (V_m at 0)
  size_t ofu2r, oLuu, ostage, oout, ogroup, bytes;  // the block (fu2 at 0)
};

template <typename Tp, typename Tr, int P>
__host__ __device__ constexpr LargeLayout large_layout(int nu) {
  LargeLayout L{};
  const int w = nu | 1;
  L.nu = nu;
  L.w = w;
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
  L.sM = L.sVS + 144 * p;
  L.sKT = L.sM + 144 * p;
  L.sKQ = L.sKT + align16(13 * w * p);
  L.sQx = L.sKQ + align16(12 * w * p);
  L.sQuu = L.sQx + align16(12 * w * p);
  L.sL = L.sQuu + align16(nu * w * p);
  L.sTm = L.sL + align16(nu * w * p);
  L.sFp = L.sTm + align16(6 * w * p);
  L.gstride = group_stride(L.sFp + (std::is_same<Tp, Tr>::value ? 0 : 144 * p));
  L.ofu2r = align16(6 * w * p);
  L.oLuu = L.ofu2r + align16(6 * w * r);
  L.ostage = L.oLuu + align16(nu * w * p);
  L.oout = L.ostage + 2 * L.stage;
  L.ogroup = L.oout + 2 * L.out;
  L.bytes = L.ogroup + P * L.gstride;
  return L;
}

// One group's scratch.
template <typename Tp, typename Tr>
struct LargeScratch {
  Tr *Vm, *Qu;   // V_x + V_xx d (the terminal l_x); Q_u
  Tp *VS, *M;    // (V_xx F)^T in A-B, S in D-E (the terminal l_xx); M = K^T Q_ux
  Tp *KT, *KQ, *Qx, *Quu, *L, *Tm, *Fp;  // rows at pitch w; Fp: F in Tp (mixed)
};

template <typename Tp, typename Tr>
__device__ __forceinline__ LargeScratch<Tp, Tr> large_scratch(unsigned char* g,
                                                              const LargeLayout& L) {
  const auto p = [&](size_t o) { return reinterpret_cast<Tp*>(g + o); };
  return {reinterpret_cast<Tr*>(g), reinterpret_cast<Tr*>(g + L.sQu), p(L.sVS), p(L.sM),
          p(L.sKT), p(L.sKQ), p(L.sQx), p(L.sQuu), p(L.sL), p(L.sTm), p(L.sFp)};
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

// One Riccati step for lane r of a group: (V, Vx) hold row r of V_xx and
// V_x[r] of stage t + 1 on entry and of stage t on exit (lanes r < 12).
// fu2, fu2r and Luu are the block's constants at pitch w; out gets K, k and
// gvec = Q_u.  Every lane of the warp calls it (it synchronises the warp).
template <typename Tp, typename Tr>
__device__ __forceinline__ void riccati_large_step(int r, int nu, int w, Tp (&V)[12], Tr& Vx,
                                                   const StageIn<Tp, Tr>& in, const Tp* fu2,
                                                   const Tr* fu2r, const Tp* Luu, bool glow,
                                                   const LargeScratch<Tp, Tr>& g,
                                                   const LargeOut<Tp, Tr>& out) {
  constexpr bool kMixed = !std::is_same<Tp, Tr>::value;
  constexpr int NX = 12, H = 6;
  const bool own = r < NX;
  const Tp* Fp;
  if constexpr (kMixed) {
#pragma unroll
    for (int i = 0; i < 144 / kGroup; ++i) g.Fp[r + kGroup * i] = Tp(in.F[r + kGroup * i]);
    __syncwarp();
    Fp = g.Fp;
  } else {
    Fp = in.F;
  }

  // ---- A ----
  if (own) {
    {
      Tr dd[NX];
      lds<Tr, NX>(dd, in.d);
      Tp s = V[0] * Tp(dd[0]);
#pragma unroll
      for (int j = 1; j < NX; ++j) s += V[j] * Tp(dd[j]);
      g.Vm[r] = Vx + Tr(s);
    }
    Tp vf[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      Tp f[NX];
      const bool tail = k >= H && !glow;
      f_row(f, Fp, k, tail);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if (j < H && k >= H && !glow) continue;
        vf[j] = k == 0 ? V[0] * f[j] : vf[j] + V[k] * f[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) g.VS[j * NX + r] = vf[j];
    if (r >= H) {
      for (int a = 0; a < nu; ++a) {
        Tp s = V[H] * fu2[a];
#pragma unroll
        for (int k = 1; k < H; ++k) s += V[H + k] * fu2[k * w + a];
        g.Tm[(r - H) * w + a] = s;
      }
    }
  }
  __syncwarp();

  // ---- B ----
  Tp qxx[NX];
  Tr qx = Tr(0);
  if (own) {
    Tp vfc[NX];
    lds<Tp, NX>(vfc, g.VS + r * NX);  // column r of V_xx F
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      Tp f[NX];
      const bool tail = k >= H && !glow;
      f_row(f, Fp, k, tail);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (i < H && k >= H && !glow) continue;
        qxx[i] = k == 0 ? f[i] * vfc[0] : qxx[i] + f[i] * vfc[k];
      }
    }
    {
      Tp lxc[NX];
      lds<Tp, NX>(lxc, in.lxxT + r * NX);  // column r of l_xx
#pragma unroll
      for (int i = 0; i < NX; ++i) qxx[i] = lxc[i] + qxx[i];
    }
    for (int a = 0; a < nu; ++a) {  // column r of Q_ux
      Tp s = fu2[a] * vfc[H];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2[k * w + a] * vfc[H + k];
      g.Qx[r * w + a] = s;
    }
    {
      Tr vm[NX];
      lds<Tr, NX>(vm, g.Vm);
      Tr s = in.F[r] * vm[0];
#pragma unroll
      for (int k = 1; k < H; ++k) s += in.F[k * NX + r] * vm[k];
      if (glow || r >= H) {
#pragma unroll
        for (int k = H; k < NX; ++k) s += in.F[k * NX + r] * vm[k];
      }
      qx = in.lx[r] + s;
    }
  } else if (r == NX) {
    Tr vm[NX];
    lds<Tr, NX>(vm, g.Vm);
    for (int a = 0; a < nu; ++a) {
      Tr s = fu2r[a] * vm[H];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2r[k * w + a] * vm[H + k];
      g.Qu[a] = in.lu[a] + s;
    }
  }
  for (int a = r; a < nu; a += kGroup) {  // rows r, r + 16, ... of Q_uu
    for (int b2 = 0; b2 < nu; ++b2) {
      Tp s = fu2[a] * g.Tm[b2];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2[k * w + a] * g.Tm[k * w + b2];
      Tp v = Luu[a * w + b2] + s;
      if (in.luual && b2 == a) v += in.luual[a];
      g.Quu[a * w + b2] = v;
    }
  }
  __syncwarp();

  // ---- C ----
  // the factor, column j at a time: every lane the pivot, lane r rows
  // j + 1 + r, j + 17 + r, ...
  for (int j = 0; j < nu; ++j) {
    const Tp* Lj = g.L + j * w;
    Tp sv = g.Quu[j * w + j];
    for (int kk = 0; kk < j; ++kk) sv = sv - Lj[kk] * Lj[kk];
    const Tp inv = Tp(1) / xsqrt(sv);
    if (r == 0) g.L[j * w + j] = inv;
    for (int i2 = j + 1 + r; i2 < nu; i2 += kGroup) {
      Tp s2 = g.Quu[i2 * w + j];
      for (int kk = 0; kk < j; ++kk) s2 = s2 - g.L[i2 * w + kk] * Lj[kk];
      g.L[i2 * w + j] = s2 * inv;
    }
    __syncwarp();
  }
  // lane c <= 12: -Q_uu^-1 times column c of Q_ux (c < 12) or Q_u (c = 12),
  // in place in row c of K^T
  if (r <= NX) {
    Tp* x = g.KT + r * w;
    for (int i2 = 0; i2 < nu; ++i2) {
      Tp sv = own ? g.Qx[r * w + i2] : Tp(g.Qu[i2]);
      const Tp* Li = g.L + i2 * w;
      for (int kk = 0; kk < i2; ++kk) sv = sv - Li[kk] * x[kk];
      x[i2] = sv * Li[i2];
    }
    for (int i2 = nu - 1; i2 >= 0; --i2) {
      Tp sv = x[i2];
      for (int kk = i2 + 1; kk < nu; ++kk) sv = sv - g.L[kk * w + i2] * x[kk];
      x[i2] = sv * g.L[i2 * w + i2];
    }
    for (int a = 0; a < nu; ++a) x[a] = -x[a];
  }
  if (own) {
    const Tp* kc = g.KT + r * w;  // column r of K
    for (int a = 0; a < nu; ++a) {
      out.K[(a * NX + r) * out.stride] = kc[a];
      Tp s = kc[0] * g.Quu[a];
      for (int b2 = 1; b2 < nu; ++b2) s += kc[b2] * g.Quu[b2 * w + a];
      g.KQ[r * w + a] = s;  // row r of K^T Q_uu
    }
  } else if (r == NX) {
    for (int a = 0; a < nu; ++a) {
      out.k[a * out.stride] = g.KT[NX * w + a];
      out.g[a * out.stride] = g.Qu[a];
    }
  }
  __syncwarp();

  // ---- D ----
  Tp scol[NX], mcol[NX];
  if (own) {
    const Tp *kk = g.KT + NX * w, *kc = g.KT + r * w, *kq = g.KQ + r * w, *qux = g.Qx + r * w;
    Tp s1 = kq[0] * kk[0], s2 = kc[0] * Tp(g.Qu[0]), s3 = qux[0] * kk[0];
    for (int a = 1; a < nu; ++a) {
      s1 += kq[a] * kk[a];
      s2 += kc[a] * Tp(g.Qu[a]);
      s3 += qux[a] * kk[a];
    }
    if constexpr (kMixed) {
      Vx = qx + Tr((s1 + s2) + s3);
    } else {
      Vx = ((qx + s1) + s2) + s3;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const Tp *kqi = g.KQ + i * w, *kti = g.KT + i * w;
      Tp sv = kqi[0] * kc[0], mv = kti[0] * qux[0];
      for (int a = 1; a < nu; ++a) {
        sv += kqi[a] * kc[a];
        mv += kti[a] * qux[a];
      }
      scol[i] = qxx[i] + sv;
      mcol[i] = mv;
      g.VS[i * NX + r] = scol[i];
      g.M[i * NX + r] = mcol[i];
    }
  }
  __syncwarp();

  // ---- E ----
  if (own) {
    Tp srow[NX], mrow[NX];
    lds<Tp, NX>(srow, g.VS + r * NX);
    lds<Tp, NX>(mrow, g.M + r * NX);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const Tp h = Tp(0.5) * (srow[j] + scol[j]);
      V[j] = (h + mrow[j]) + mcol[j];
    }
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

// The stage loop of a large-nu Riccati kernel, from the carry (V, Vx) of
// stage N (lane r < 12: row r of V_xx, V_x[r]) down to stage 0: while the
// group computes stage t, the block copies stage t - 1's inputs into the
// other stage buffer and stores stage t + 1's outputs from the other output
// buffer, as riccati_group_sweep does.  The constants must be in place
// (riccati_large_consts); one block barrier per stage makes them, and each
// stage's copies, visible.
template <typename Tp, typename Tr, int P>
__device__ __forceinline__ void riccati_large_sweep(unsigned char* smem, const LargeLayout& L,
                                                    int N, int B, Tp (&V)[12], Tr& Vx,
                                                    const Tr* Fx, const Tr* d, const Tr* lx,
                                                    const Tr* lu, const Tp* lxx, const Tp* luual,
                                                    bool glow, Tp* K, Tp* k, Tr* gvec) {
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
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
    const unsigned char* buf = stage + cur * L.stage;
    const auto rr = [&](size_t o, int pt) { return reinterpret_cast<const Tr*>(buf + o) + g * pt; };
    const auto rp = [&](size_t o, int pt) { return reinterpret_cast<const Tp*>(buf + o) + g * pt; };
    const StageIn<Tp, Tr> in{rr(0, L.pF), rr(L.od, L.pd), rr(L.olx, L.pd), rr(L.olu, L.pu),
                             rp(L.oxx, L.pxx), luual ? rp(L.oal, L.pal) : nullptr};
    unsigned char* ob = outb + (t & 1) * L.out;
    const LargeOut<Tp, Tr> o{reinterpret_cast<Tp*>(ob) + g, reinterpret_cast<Tp*>(ob + L.ok) + g,
                             reinterpret_cast<Tr*>(ob + L.og) + g, P + 1};
    riccati_large_step<Tp, Tr>(r, nu, L.w, V, Vx, in, reinterpret_cast<const Tp*>(smem),
                               reinterpret_cast<const Tr*>(smem + L.ofu2r),
                               reinterpret_cast<const Tp*>(smem + L.oLuu), glow, gs, o);
  }
  __syncthreads();
  store(outb, 0);
}

}  // namespace traopt
