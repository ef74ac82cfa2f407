// The defect-aware Riccati step of B2 and B5 (`stage.cuh` riccati_stage with
// the pose half H = 6) for one problem held by a group of kGroup = 16
// threads (group.cuh), and the shared-memory layout of the kernels that loop
// it over the stages.
//
// Lane r < 12 owns row r of V_xx and V_x[r] in registers (the carry), and in
// each stage column r of Q_xx, Q_ux and K; lane 12 owns Q_u and k.  Between
// the five phases of a step, the group exchanges through its slice of shared
// memory (GroupScratch), after a __syncwarp:
//   A  row r of V_xx F (stored transposed), V_x + V_xx d, and for r >= 6 the
//      row r - 6 of V_xx[6:, 6:] fu2;
//   B  column r of Q_xx = l_xx + F^T (V_xx F), of Q_ux = fu2^T (V_xx F)[6:],
//      Q_x[r] = l_x[r] + F[:, r]^T (V_x + V_xx d); lane a < nu row a of Q_uu,
//      lane 12 Q_u;
//   C  every lane the Cholesky factor of Q_uu (diagonal as 1 / sqrt(pivot)),
//      then lane c <= 12 one right-hand side of -Q_uu^-1 [Q_ux | Q_u]: column
//      c of K, or k; row r of K^T Q_uu;
//   D  V_x[r], and column r of S = Q_xx + K^T Q_uu K and of M = K^T Q_ux;
//   E  row r of V_xx = (S + S^T) / 2 + M + M^T.
// The arithmetic is riccati_stage's: the same Tp roundings of F, d and Q_u,
// the same order of every sum, B5's three V_x corrections summed in Tp and
// added once.  Only where an entry sums over k does the loop run over k in
// the outer place (one row of F at a time, shared by every entry).
// kLean (B2's runtime-nu instances in f32): phase C reads Q_uu from the
// group's scratch where it uses it instead of holding it whole in
// registers beside the factor (which spilled at NU = 12).
#pragma once

#include <type_traits>

#include "group.cuh"
#include "lie.cuh"

namespace traopt {

// One group's scratch.  Tp is the preconditioner's type, Tr the residual's.
template <typename Tp, typename Tr, int NU>
struct GroupScratch {
  static constexpr bool kMixed = !std::is_same<Tp, Tr>::value;
  static constexpr int NUP = vpad<Tp>(NU), NUR = vpad<Tr>(NU);
  alignas(16) Tr Vm[12];        // V_x + V_xx d; l_x of the terminal stage
  alignas(16) Tr Qu[NUR];       // Q_u
  alignas(16) Tp VS[144];       // (V_xx F)^T in A-B, S (row-major) in D-E; the terminal l_xx
  alignas(16) Tp M[144];        // M = K^T Q_ux (row-major)
  alignas(16) Tp KT[13 * NUP];  // row c < 12: column c of K; row 12: k
  alignas(16) Tp KQ[12 * NUP];  // K^T Q_uu
  alignas(16) Tp Quu[NU * NUP];
  alignas(16) Tp Tm[6 * NUP];   // V_xx[6:, 6:] fu2
  alignas(16) Tp Fp[kMixed ? 144 : 4];  // the Tp rounding of F (mixed only)
};

// Shared memory of a block: the constants, two stage buffers (the stage
// being computed and the one being copied), two output buffers (the stage
// being written and the one being stored), and the groups' scratch.  Byte
// offsets, each 16-byte aligned.
template <typename Tp, typename Tr, int NU>
struct RiccatiLayout {
  static constexpr int P = kProblems;
  static constexpr int NUP = vpad<Tp>(NU), NUR = vpad<Tr>(NU);
  // one stage buffer: Fx, d, lx, lu (Tr), l_xx transposed and the AL diagonal (Tp)
  static constexpr int pF = pitch<Tr>(144), pd = pitch<Tr>(12), pu = pitch<Tr>(NU);
  static constexpr int pxx = pitch<Tp>(144), pal = pitch<Tp>(NU);
  static constexpr size_t oF = 0, od = oF + P * pF * sizeof(Tr), olx = od + P * pd * sizeof(Tr),
                          olu = olx + P * pd * sizeof(Tr), oxx = olu + P * pu * sizeof(Tr),
                          oal = oxx + P * pxx * sizeof(Tp), stage = oal + P * pal * sizeof(Tp);
  // one output buffer: K, k (Tp), gvec (Tr)
  static constexpr size_t oK = 0, ok = align16(NU * 12 * kOutStride * sizeof(Tp)),
                          og = ok + align16(NU * kOutStride * sizeof(Tp)),
                          out = og + align16(NU * kOutStride * sizeof(Tr));
  // the block
  static constexpr size_t ofu2 = 0, ofu2r = align16(6 * NUP * sizeof(Tp)),
                          oLuu = ofu2r + align16(6 * NUR * sizeof(Tr)),
                          ostage = oLuu + align16(NU * NUP * sizeof(Tp)),
                          oout = ostage + 2 * stage, ogroup = oout + 2 * out,
                          gstride = group_stride(sizeof(GroupScratch<Tp, Tr, NU>)),
                          bytes = ogroup + P * gstride;
};

// One problem's view of a stage buffer and of an output buffer.
template <typename Tp, typename Tr>
struct StageIn {
  const Tr *F, *d, *lx, *lu;
  const Tp *lxxT, *luual;  // luual null when absent
};

template <typename Tp, typename Tr>
struct StageOut {
  Tp *K, *k;  // entry e at [e * kOutStride]
  Tr* g;
};

template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ StageIn<Tp, Tr> stage_in(const unsigned char* buf, int p, bool al) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  return {reinterpret_cast<const Tr*>(buf + L::oF) + p * L::pF,
          reinterpret_cast<const Tr*>(buf + L::od) + p * L::pd,
          reinterpret_cast<const Tr*>(buf + L::olx) + p * L::pd,
          reinterpret_cast<const Tr*>(buf + L::olu) + p * L::pu,
          reinterpret_cast<const Tp*>(buf + L::oxx) + p * L::pxx,
          al ? reinterpret_cast<const Tp*>(buf + L::oal) + p * L::pal : nullptr};
}

template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ StageOut<Tp, Tr> stage_out(unsigned char* buf, int p) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  return {reinterpret_cast<Tp*>(buf + L::oK) + p, reinterpret_cast<Tp*>(buf + L::ok) + p,
          reinterpret_cast<Tr*>(buf + L::og) + p};
}

// The block's copy of stage t's inputs into a stage buffer.
template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ void riccati_copy(unsigned char* buf, const Tr* Fx, const Tr* d,
                                             const Tr* lx, const Tr* lu, const Tp* lxx,
                                             const Tp* luual, int t, int b0, int B, int tid) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  copy_stage<144, false>(reinterpret_cast<Tr*>(buf + L::oF), Fx, t, b0, B, tid);
  copy_stage<12, false>(reinterpret_cast<Tr*>(buf + L::od), d, t, b0, B, tid);
  copy_stage<12, false>(reinterpret_cast<Tr*>(buf + L::olx), lx, t, b0, B, tid);
  copy_stage<NU, false>(reinterpret_cast<Tr*>(buf + L::olu), lu, t, b0, B, tid);
  copy_stage<144, true>(reinterpret_cast<Tp*>(buf + L::oxx), lxx, t, b0, B, tid);
  if (luual) copy_stage<NU, false>(reinterpret_cast<Tp*>(buf + L::oal), luual, t, b0, B, tid);
}

// The block's store of stage t's outputs from an output buffer.
template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ void riccati_store(Tp* K, Tp* k, Tr* gvec, const unsigned char* buf,
                                              int t, int b0, int B, int tid) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  store_stage<NU * 12>(K, reinterpret_cast<const Tp*>(buf + L::oK), t, b0, B, tid);
  store_stage<NU>(k, reinterpret_cast<const Tp*>(buf + L::ok), t, b0, B, tid);
  store_stage<NU>(gvec, reinterpret_cast<const Tr*>(buf + L::og), t, b0, B, tid);
}

// The block's constants: fu2 (6 x nu) in both types and Luu (nu x nu), rows
// padded to whole vectors.
template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ void riccati_consts(unsigned char* smem, const Tp* fu2,
                                               const Tr* fu2r, const Tp* Luu, int tid) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  for (int q = tid; q < 6 * NU; q += kGroupThreads) {
    reinterpret_cast<Tp*>(smem + L::ofu2)[(q / NU) * L::NUP + q % NU] = fu2[q];
    reinterpret_cast<Tr*>(smem + L::ofu2r)[(q / NU) * L::NUR + q % NU] = fu2r[q];
  }
  for (int q = tid; q < NU * NU; q += kGroupThreads)
    reinterpret_cast<Tp*>(smem + L::oLuu)[(q / NU) * L::NUP + q % NU] = Luu[q];
}

// Row k of F in Tp into f: all 12 entries, or (tail) only those of the D
// block, f[6 .. 11] (f32 loads f[4 .. 11]).
template <typename Tp>
__device__ __forceinline__ void f_row(Tp* f, const Tp* Fp, int k, bool tail) {
  if (!tail) {
    lds<Tp, 12>(f, Fp + k * 12);
  } else if constexpr (sizeof(Tp) == 4) {
    lds<Tp, 8>(f + 4, Fp + k * 12 + 4);
  } else {
    lds<Tp, 6>(f + 6, Fp + k * 12 + 6);
  }
}

// One Riccati step for lane r of a group: (V, Vx) hold row r of V_xx and
// V_x[r] of stage t + 1 on entry and of stage t on exit (lanes r < 12).
// fu2, fu2r and Luu are the block's constants (riccati_consts); out gets K,
// k and gvec = Q_u.  Every lane of the warp calls it (it synchronises the
// warp).
template <typename Tp, typename Tr, int NU, bool kLean = false>
__device__ __forceinline__ void riccati_group_step(
    int r, Tp (&V)[12], Tr& Vx, const StageIn<Tp, Tr>& in, const Tp* fu2, const Tr* fu2r,
    const Tp* Luu, bool glow, GroupScratch<Tp, Tr, NU>& g, const StageOut<Tp, Tr>& out) {
  using S = GroupScratch<Tp, Tr, NU>;
  constexpr bool kMixed = S::kMixed;
  constexpr int NX = 12, H = 6, NUP = S::NUP, NUR = S::NUR;
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
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Tp s = V[H] * fu2[a];
#pragma unroll
        for (int k = 1; k < H; ++k) s += V[H + k] * fu2[k * NUP + a];
        g.Tm[(r - H) * NUP + a] = s;
      }
    }
  }
  __syncwarp();

  // ---- B ----
  Tp qxx[NX], qux[NU];
  Tr qx = Tr(0), qu[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) qu[a] = Tr(0);
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
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      Tp s = fu2[a] * vfc[H];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2[k * NUP + a] * vfc[H + k];
      qux[a] = s;
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
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      Tr s = fu2r[a] * vm[H];
#pragma unroll
      for (int k = 1; k < H; ++k) s += fu2r[k * NUR + a] * vm[H + k];
      qu[a] = in.lu[a] + s;
      g.Qu[a] = qu[a];
    }
  }
  if (r < NU) {
    Tp q[NU];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      Tp tm[NUP];
      lds<Tp, NUP>(tm, g.Tm + k * NUP);
      const Tp fk = fu2[k * NUP + r];
#pragma unroll
      for (int b2 = 0; b2 < NU; ++b2) q[b2] = k == 0 ? fk * tm[b2] : q[b2] + fk * tm[b2];
    }
    Tp row[NUP];
    lds<Tp, NUP>(row, Luu + r * NUP);
#pragma unroll
    for (int b2 = 0; b2 < NU; ++b2) {
      Tp v = row[b2] + q[b2];
      if (in.luual && b2 == r) v += in.luual[r];
      g.Quu[r * NUP + b2] = v;
    }
  }
  __syncwarp();

  // ---- C ----
  Tp Q[kLean ? 1 : NU * NU], L[NU * NU];
  if constexpr (!kLean) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      Tp row[NUP];
      lds<Tp, NUP>(row, g.Quu + a * NUP);
#pragma unroll
      for (int b2 = 0; b2 < NU; ++b2) Q[a * NU + b2] = row[b2];
    }
  }
  // Q_uu[i, j]
  const auto quu = [&](int i, int j) -> Tp { return kLean ? g.Quu[i * NUP + j] : Q[i * NU + j]; };
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    Tp sv = quu(j, j);
#pragma unroll
    for (int kk = 0; kk < j; ++kk) sv = sv - L[j * NU + kk] * L[j * NU + kk];
    const Tp inv = Tp(1) / xsqrt(sv);
    L[j * NU + j] = inv;
#pragma unroll
    for (int i2 = j + 1; i2 < NU; ++i2) {
      Tp s2 = quu(i2, j);
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s2 = s2 - L[i2 * NU + kk] * L[j * NU + kk];
      L[i2 * NU + j] = s2 * inv;
    }
  }
  Tp kc[NU];  // column r of K (r < 12) or k (r = 12)
  {
    Tp Y[NU], X[NU];
#pragma unroll
    for (int i2 = 0; i2 < NU; ++i2) {
      Tp sv = own ? qux[i2] : (r == NX ? Tp(qu[i2]) : Tp(0));
#pragma unroll
      for (int kk = 0; kk < i2; ++kk) sv = sv - L[i2 * NU + kk] * Y[kk];
      Y[i2] = sv * L[i2 * NU + i2];
    }
#pragma unroll
    for (int i2 = NU - 1; i2 >= 0; --i2) {
      Tp sv = Y[i2];
#pragma unroll
      for (int kk = i2 + 1; kk < NU; ++kk) sv = sv - L[kk * NU + i2] * X[kk];
      X[i2] = sv * L[i2 * NU + i2];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) kc[a] = -X[a];
  }
  Tp kq[NU];
  if (own) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      g.KT[r * NUP + a] = kc[a];
      out.K[(a * NX + r) * kOutStride] = kc[a];
      Tp s = kc[0] * quu(0, a);
#pragma unroll
      for (int b2 = 1; b2 < NU; ++b2) s += kc[b2] * quu(b2, a);
      kq[a] = s;
      g.KQ[r * NUP + a] = s;
    }
  } else if (r == NX) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      g.KT[NX * NUP + a] = kc[a];
      out.k[a * kOutStride] = kc[a];
      out.g[a * kOutStride] = qu[a];
    }
  }
  __syncwarp();

  // ---- D ----
  Tp scol[NX], mcol[NX];
  if (own) {
    Tp kk[NUP];
    lds<Tp, NUP>(kk, g.KT + NX * NUP);
    Tr quv[NUR];
    lds<Tr, NUR>(quv, g.Qu);
    Tp s1 = kq[0] * kk[0], s2 = kc[0] * Tp(quv[0]), s3 = qux[0] * kk[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s1 += kq[a] * kk[a];
      s2 += kc[a] * Tp(quv[a]);
      s3 += qux[a] * kk[a];
    }
    if constexpr (kMixed) {
      Vx = qx + Tr((s1 + s2) + s3);
    } else {
      Vx = ((qx + s1) + s2) + s3;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Tp kqi[NUP], kti[NUP];
      lds<Tp, NUP>(kqi, g.KQ + i * NUP);
      lds<Tp, NUP>(kti, g.KT + i * NUP);
      Tp sv = kqi[0] * kc[0], mv = kti[0] * qux[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) {
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

// The stage loop of a group Riccati kernel, from the carry (V, Vx) of
// stage N (lane r < 12: row r of V_xx, V_x[r]) down to stage 0: while the
// group computes stage t, the block copies stage t - 1's inputs into the
// other stage buffer and stores stage t + 1's outputs from the other output
// buffer.  The constants must be in place (riccati_consts); one block
// barrier per stage makes them, and each stage's copies, visible.
template <typename Tp, typename Tr, int NU>
__device__ __forceinline__ void riccati_group_sweep(
    unsigned char* smem, int N, int B, Tp (&V)[12], Tr& Vx, const Tr* Fx, const Tr* d,
    const Tr* lx, const Tr* lu, const Tp* lxx, const Tp* luual, bool glow, Tp* K, Tp* k,
    Tr* gvec) {
  using L = RiccatiLayout<Tp, Tr, NU>;
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int b0 = blockIdx.x * kProblems;
  unsigned char* stage = smem + L::ostage;
  unsigned char* outb = smem + L::oout;
  auto& gs = *reinterpret_cast<GroupScratch<Tp, Tr, NU>*>(smem + L::ogroup + g * L::gstride);
  riccati_copy<Tp, Tr, NU>(stage, Fx, d, lx, lu, lxx, luual, N - 1, b0, B, tid);
  cp_async_commit();
  for (int t = N - 1; t >= 0; --t) {
    const int cur = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      riccati_copy<Tp, Tr, NU>(stage + (cur ^ 1) * L::stage, Fx, d, lx, lu, lxx, luual, t - 1,
                               b0, B, tid);
      cp_async_commit();
    }
    if (t < N - 1)
      riccati_store<Tp, Tr, NU>(K, k, gvec, outb + ((t + 1) & 1) * L::out, t + 1, b0, B, tid);
    riccati_group_step<Tp, Tr, NU>(
        r, V, Vx, stage_in<Tp, Tr, NU>(stage + cur * L::stage, g, luual != nullptr),
        reinterpret_cast<const Tp*>(smem + L::ofu2), reinterpret_cast<const Tr*>(smem + L::ofu2r),
        reinterpret_cast<const Tp*>(smem + L::oLuu), glow, gs,
        stage_out<Tp, Tr, NU>(outb + (t & 1) * L::out, g));
  }
  __syncthreads();
  riccati_store<Tp, Tr, NU>(K, k, gvec, outb, 0, b0, B, tid);
}

}  // namespace traopt
