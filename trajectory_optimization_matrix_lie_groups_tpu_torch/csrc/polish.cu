// Kernels of the mixed-precision polish (solvers/df_mixed.py,
// MixedDFPipelineSolver): B5 (Riccati backward), B6 (gap-closing rollout)
// and B7-B9 fused into one stage-parallel linearization tail.
//
// The TPU polish carried its residual path in double-f32 (hi/lo f32 pairs)
// because the TPU has no f64.  Here the residual path is native fp64: the
// trajectory and control carry, the defect d, the Jacobian Fx, the gradient
// lx, the adjoint V_x chain and Q_u.  The preconditioner stays f32: V_xx,
// Q_xx, Q_ux, Q_uu, the Cholesky, the gains k and K, the GN Hessian lxx and
// the feedback product K xs_err, each from the f32 rounding of its fp64
// operands (the JAX code reads the hi part of the DF value).  The fixed point
// d = 0, Q_u = 0 is set by the fp64 residuals alone.
//
// This unit is built once (-DTRAOPT_SUFFIX=mx): its scalar types are fixed.
#include "common.cuh"
#include "polish.cuh"
#include "riccati_group.cuh"
#include "stage.cuh"

namespace traopt {

// ---- B5 ------------------------------------------------------------------
// Replaces solvers/df_mixed.py::_riccati_kernel_mx (MixedDFPipelineSolver
// ._backward_mx_k).  The reverse recursion over the N stages with the carry
// fp64 V_x (12) and f32 V_xx (144), starting from the terminal quadratization
// (VxN, VxxN), which the caller computes.  Fx, d, lx, lu are fp64; lxx and
// the optional AL diagonal luual are f32.
// What bounds it on an H100: its bytes (fp64 Fx and f32 l_xx, 1,728 bytes
// per problem and stage, read once) would take 2.3 ms at B = 16384; one
// thread per problem would keep ~500 live values, ~60 of them fp64, and
// spill.  The design is B2's (riccati_group.cuh, <float, double>): a group of
// 16 threads per problem, V_xx rows in registers, the stage inputs copied
// ahead into shared memory; each stage's fp64 Fx is rounded to f32 once, in
// shared memory, for the f32 products, and read in fp64 only by the
// adjoint Q_x = l_x + Fx^T (V_x + V_xx d).
template <int NU>
__global__ void __launch_bounds__(kGroupThreads) riccati_mx_kernel(RiccatiMxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B;
  const int bc = min(int(blockIdx.x) * kProblems + g, B - 1);  // past B: problem B - 1's
  riccati_consts<float, double, NU>(smem, a.fu2_32, a.fu2, a.Luu, tid);
  float V[12];
  double Vx = 0.0;
#pragma unroll
  for (int j = 0; j < 12; ++j) V[j] = 0.f;
  if (r < 12) {
    Vx = a.VxN[(long long)r * B + bc];
#pragma unroll
    for (int j = 0; j < 12; ++j) V[j] = a.VxxN[((long long)r * 12 + j) * B + bc];
  }
  riccati_group_sweep<float, double, NU>(smem, a.N, B, V, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx,
                                         a.luual, a.glow != 0, a.K, a.k, a.gvec);
}

template <int NU>
int launch_riccati_mx(const RiccatiMxArgs& a, cudaStream_t s) {
  constexpr size_t bytes = RiccatiLayout<float, double, NU>::bytes;
  if (cudaError_t e = cudaFuncSetAttribute(riccati_mx_kernel<NU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  riccati_mx_kernel<NU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- B6 ------------------------------------------------------------------
// Replaces solvers/df_mixed.py::_rollout_kernel_mx (._rollout_mx_k).  The
// gap-closing rollout with the fp64 carry (R, p, xi) in thread-local arrays,
// one thread per problem; per stage xs_err in fp64, the feedback
// k + K float(xs_err) in f32, u_new = u + double(feedback), the fp64 dynamics
// evaluation, Exp(d), the gap-closing compose and the renormalization (the
// full se3_log, se3_exp and so3_normalize: the TPU's small-angle and Newton
// shortcuts existed for its compiler's body-size ceiling).  Emits the new
// trajectory and the per-stage dynamics evaluations that B7-B9 reuse.
// What bounds it on an H100: registers (the fp64 B3 already spills) and
// B / 128 blocks; per stage it reads ~90 values and writes ~40, coalesced.
template <int NU>
__global__ void __launch_bounds__(kThreads) rollout_mx_kernel(RolloutMxArgs a) {
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
    double Rt[9], pt[3], xit[6], Rn[9], pn[3], xin[6], ut[NU];
    double dd[12], fqRt[9], fqpt[3], fxit[6];
    float kt[NU], Kt[NU * 12];
    load<9>(Rt, lane<9>(a.qR, t, B, b));
    load<3>(pt, lane<3>(a.qp, t, B, b));
    load<6>(xit, lane<6>(a.xi, t, B, b));
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    load<NU>(ut, lane<NU>(a.u, t, B, b));
    load<NU>(kt, lane<NU>(a.k, t, B, b));
    load<NU * 12>(Kt, lane<NU * 12>(a.K, t, B, b));
    load<12>(dd, lane<12>(a.d, t, B, b));
    load<9>(fqRt, lane<9>(a.fqR, t, B, b));
    load<3>(fqpt, lane<3>(a.fqp, t, B, b));
    load<6>(fxit, lane<6>(a.fxi, t, B, b));
    double u[NU], fqR[9], fqp[3], fxi[6];
    rollout_stage<double, float, NU>(R, p, xi, u, fqR, fqp, fxi, Rt, pt, xit,
                                     Rn, pn, xin, ut, kt, Kt, dd, fqRt, fqpt,
                                     fxit, a.c);
    store<9>(lane<9>(a.oR, t + 1, B, b), R);
    store<3>(lane<3>(a.op, t + 1, B, b), p);
    store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
    store<NU>(lane<NU>(a.ou, t, B, b), u);
    store<9>(lane<9>(a.efqR, t, B, b), fqR);
    store<3>(lane<3>(a.efqp, t, B, b), fqp);
    store<6>(lane<6>(a.efxi, t, B, b), fxi);
  }
}

// ---- B7 + B8 + B9 ------------------------------------------------------------
// Replaces solvers/df_mixed.py::_defect_kernel_mx (B7), _jacobian_kernel_mx
// (B8) and _cost_quad_kernel_mx (B9) (._linearize_tail_mx_k).  The TPU split
// them into three kernels only to keep each body under its compiler's size
// ceiling; here they are one.  For every stage t and problem b, with the
// stage state and the rollout's dynamics evaluation of that stage:
//   defect     d = [Log(q_{t+1}^-1 fq); fxi - xi_{t+1}]   fp64    (B7)
//   jacobian   Fx (skipped when Fx is null: fx_mode 'f32') fp64    (B8)
//   cost quad  lx fp64, lxx f32, l f32                             (B9)
// Grid (ceil(B / 128), N), one thread per (problem, stage), as B1.  What
// bounds it on an H100: the stores (fp64 Fx and f32 lxx: 144 x 12 bytes per
// thread; 200 x 144 x 16384 x 8 B = 3.8 GB of Fx per launch at the main
// shapes); every entry is written once, coalesced over b.
struct TailMxArgs {
  const double *qR, *qp, *xi;      // (N+1, ..., B)
  const double *fqR, *fqp, *fxi;   // (N, ..., B)
  Refs<double> refs;
  Consts<double> c;
  double *d, *Fx, *lx;             // (N, 12, B), (N, 12, 12, B) or null, (N, 12, B)
  float *lxx, *l;                  // (N, 12, 12, B), (N, 1, B)
  int N, B;
};

__global__ void __launch_bounds__(kThreads) linearize_tail_mx_kernel(TailMxArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  double R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, t, B, b));
  load<3>(p, lane<3>(a.qp, t, B, b));
  load<6>(xi, lane<6>(a.xi, t, B, b));
  {
    double Rn[9], pn[3], xin[6], fqR[9], fqp[3], fxi[6], d[12];
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    load<9>(fqR, lane<9>(a.fqR, t, B, b));
    load<3>(fqp, lane<3>(a.fqp, t, B, b));
    load<6>(fxi, lane<6>(a.fxi, t, B, b));
    defect(d, Rn, pn, xin, fqR, fqp, fxi);
    store<12>(lane<12>(a.d, t, B, b), d);
  }
  if (a.Fx) stage_jacobian(lane<144>(a.Fx, t, B, b), R, xi, a.c);
  a.l[(long long)t * B + b] = stage_cost_quad<float>(
      lane<12>(a.lx, t, B, b), lane<144>(a.lxx, t, B, b), R, p, xi,
      a.refs.RbiR + t * 9, a.refs.Rbip + t * 3, a.refs.Adb + t * 36,
      a.refs.xib + t * 6, a.c.W1, a.c.W2);
}

}  // namespace traopt

extern "C" int TRAOPT_FN(riccati)(
    const void* Fx, const void* d, const void* lx, const void* lu,
    const void* lxx, const void* luual, const void* VxN, const void* VxxN,
    const void* fu2, const void* fu2_32, const void* Luu, int glow, void* k,
    void* K, void* gvec, int N, int nu, int B, int device, void* stream) {
  traopt::RiccatiMxArgs a;
  a.Fx = (const double*)Fx; a.d = (const double*)d; a.lx = (const double*)lx;
  a.lu = (const double*)lu; a.lxx = (const float*)lxx; a.luual = (const float*)luual;
  a.VxN = (const double*)VxN; a.VxxN = (const float*)VxxN;
  a.fu2 = (const double*)fu2; a.fu2_32 = (const float*)fu2_32; a.Luu = (const float*)Luu;
  a.glow = glow;
  a.k = (float*)k; a.K = (float*)K; a.gvec = (double*)gvec;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nu == 6) return traopt::launch_riccati_mx<6>(a, s);
  if (nu == 4) return traopt::launch_riccati_mx<4>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int TRAOPT_FN(rollout)(
    const void* qR, const void* qp, const void* xi, const void* u,
    const void* k, const void* K, const void* d, const void* fqR,
    const void* fqp, const void* fxi, const void* J, const void* Jinv,
    const void* Pu, double mg, double dt, int gravity, void* oR, void* op,
    void* oxi, void* ou, void* efqR, void* efqp, void* efxi, int N, int nu,
    int B, int device, void* stream) {
  traopt::RolloutMxArgs a;
  a.qR = (const double*)qR; a.qp = (const double*)qp; a.xi = (const double*)xi;
  a.u = (const double*)u; a.k = (const float*)k; a.K = (const float*)K;
  a.d = (const double*)d; a.fqR = (const double*)fqR; a.fqp = (const double*)fqp;
  a.fxi = (const double*)fxi;
  a.c = traopt::Consts<double>{(const double*)J, (const double*)Jinv, nullptr,
                               nullptr, nullptr, nullptr, (const double*)Pu,
                               nullptr, nullptr, mg, dt, gravity, 0};
  a.oR = (double*)oR; a.op = (double*)op; a.oxi = (double*)oxi; a.ou = (double*)ou;
  a.efqR = (double*)efqR; a.efqp = (double*)efqp; a.efxi = (double*)efxi;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = traopt::batch_grid(B);
  if (nu == 6)
    traopt::rollout_mx_kernel<6><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nu == 4)
    traopt::rollout_mx_kernel<4><<<grid, traopt::kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Fx may be null: then the Jacobian (B8) is not computed.
extern "C" int TRAOPT_FN(linearize_tail)(
    const void* qR, const void* qp, const void* xi, const void* fqR,
    const void* fqp, const void* fxi, const void* RbiR, const void* Rbip,
    const void* Adb, const void* xib, const void* J, const void* Jinv,
    const void* W1, const void* W2, double mg, double dt, int gravity,
    int exact_grav, void* d, void* Fx, void* lx, void* lxx, void* l, int N,
    int B, int device, void* stream) {
  traopt::TailMxArgs a;
  a.qR = (const double*)qR; a.qp = (const double*)qp; a.xi = (const double*)xi;
  a.fqR = (const double*)fqR; a.fqp = (const double*)fqp; a.fxi = (const double*)fxi;
  a.refs = {(const double*)RbiR, (const double*)Rbip, (const double*)Adb,
            (const double*)xib};
  a.c = traopt::Consts<double>{(const double*)J, (const double*)Jinv,
                               (const double*)W1, (const double*)W2, nullptr,
                               nullptr, nullptr, nullptr, nullptr, mg, dt,
                               gravity, exact_grav};
  a.d = (double*)d; a.Fx = (double*)Fx; a.lx = (double*)lx;
  a.lxx = (float*)lxx; a.l = (float*)l;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  traopt::linearize_tail_mx_kernel<<<traopt::batch_grid(B, N), traopt::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
