// Kernels B2 (Riccati backward), B3 (rollout fused with the next
// linearization) and B4 (rollout) of the MS-iLQR pipeline.
//
// All three are sequential recursions over the N stages of one problem.  The
// TPU kernels carried the recursion across a sequential grid axis with the
// carry in VMEM scratch; on the GPU blocks run in no order, so the stage loop
// moves inside the block.  B3 and B4 run one problem per thread (grid
// ceil(B / 128) x 128) with the carry in registers; B2 runs one problem per
// group of 16 threads (riccati_group.cuh).
#include "common.cuh"
#include "riccati_group.cuh"
#include "stage.cuh"

namespace traopt {

// ---- B2 ------------------------------------------------------------------
// Replaces solvers/pipeline.py::_riccati_kernel_const (PallasPipelineSolver
// ._backward_lane).  Defect-aware Riccati backward with const Fu = [0; fu2]
// and Luu = 2R, Lux = 0, the terminal quadratization computed in-kernel,
// an unrolled nu x nu Cholesky and the optional AL diagonal on Quu.
// What bounds it on an H100: its bytes (Fx and l_xx, 288 values per problem
// and stage, read once) would take 0.79 ms at B = 8192; its ~10 k operations
// per problem and stage, if each thread ran a whole problem, keep ~500 values
// live (V_xx, V_xx F, Q_xx, Q_ux, K), which spill to local memory that does
// not fit in L2.  The design: a group of 16 threads per problem and 8
// problems per block (B / 8 blocks, 1,024 at B = 8192), lane r keeps row r
// of V_xx in registers and the group exchanges V_xx F, S and M through its
// slice of shared memory; the block copies stage t - 1's inputs into shared
// memory (cp.async) while it computes stage t, and stages its outputs there
// to store them coalesced over its problems.
template <typename T>
struct RiccatiArgs {
  const T *Fx, *d, *lx, *lu, *lxx, *luual;  // (N, ..., B); luual may be null
  const T *qR, *qp, *xi;                    // (N+1, ..., B): terminal state
  Refs<T> refs;
  Consts<T> c;
  int glow;
  T *k, *K, *gvec, *lN;  // (N, nu, B), (N, nu, 12, B), (N, nu, B), (B,)
  int N, B;
};

template <typename T, int NU>
__global__ void __launch_bounds__(kGroupThreads) riccati_kernel(RiccatiArgs<T> a) {
  using L = RiccatiLayout<T, T, NU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / kGroup, r = tid % kGroup;
  const int B = a.B, N = a.N, b = blockIdx.x * kProblems + g;
  riccati_consts<T, T, NU>(smem, a.c.fu2, a.c.fu2, a.c.Luu, tid);
  auto& gs = *reinterpret_cast<GroupScratch<T, T, NU>*>(smem + L::ogroup + g * L::gstride);
  if (r == 0) {
    // the terminal quadratization into the group's scratch (problems past B
    // take problem B - 1's)
    const int bc = min(b, B - 1);
    T R[9], p[3], xi[6];
    load<9>(R, lane<9>(a.qR, N, B, bc));
    load<3>(p, lane<3>(a.qp, N, B, bc));
    load<6>(xi, lane<6>(a.xi, N, B, bc));
    const T l = stage_cost_quad<T>(&gs.Vm[0], &gs.VS[0], R, p, xi, a.refs.RbiR + N * 9,
                                   a.refs.Rbip + N * 3, a.refs.Adb + N * 36,
                                   a.refs.xib + N * 6, a.c.W1N, a.c.W2N);
    if (b < B) a.lN[b] = l;
  }
  __syncwarp();
  T V[12], Vx = T(0);
#pragma unroll
  for (int j = 0; j < 12; ++j) V[j] = T(0);
  if (r < 12) {
    lds<T, 12>(V, gs.VS + r * 12);
    Vx = gs.Vm[r];
  }
  riccati_group_sweep<T, T, NU>(smem, N, B, V, Vx, a.Fx, a.d, a.lx, a.lu, a.lxx, a.luual,
                                a.glow != 0, a.K, a.k, a.gvec);
}

template <typename T, int NU>
int launch_riccati(const RiccatiArgs<T>& a, cudaStream_t s) {
  constexpr size_t bytes = RiccatiLayout<T, T, NU>::bytes;
  if (cudaError_t e = cudaFuncSetAttribute(riccati_kernel<T, NU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  riccati_kernel<T, NU><<<group_grid(a.B), kGroupThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- B3 and B4 -------------------------------------------------------------
// B4 replaces solvers/pipeline.py::_rollout_kernel_lane (._rollout_lane),
// B3 replaces solvers/pipeline.py::_rollout_linearize_kernel
// (._rollout_linearize_lane): the same gap-closing rollout, and in B3 the
// linearization of stage t of the new trajectory reusing the rollout's
// dynamics evaluation (the next iteration's B1 pass disappears).
// What bounds them on an H100: B4 reads ~90 values and writes ~22 per stage
// and problem; B3 adds the B1 outputs (Fx, lxx: 288 values per stage), so it
// is store-bound like B1 but serial over stages, with B / 128 blocks.  The
// carry (R, p, xi) stays in registers across the stage loop.
template <typename T>
struct RolloutArgs {
  const T *qR, *qp, *xi, *u;      // nominal trajectory (N+1, ...) and (N, nu, B)
  const T *k, *K;                 // gains (N, nu, B), (N, nu, 12, B)
  const T *d, *fqR, *fqp, *fxi;   // nominal linearization (N, ..., B)
  Refs<T> refs;                   // B3 only
  Consts<T> c;
  T *oR, *op, *oxi, *ou;          // new trajectory (N+1, ...), controls (N, nu, B)
  T *nfqR, *nfqp, *nfxi, *nd, *nFx, *nlx, *nlxx, *nl;  // B3: new linearization
  int N, B;
};

template <typename T, int NU, bool LIN>
__device__ __forceinline__ void rollout_sweep(const RolloutArgs<T>& a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, 0, B, b));
  load<3>(p, lane<3>(a.qp, 0, B, b));
  load<6>(xi, lane<6>(a.xi, 0, B, b));
  store<9>(lane<9>(a.oR, 0, B, b), R);
  store<3>(lane<3>(a.op, 0, B, b), p);
  store<6>(lane<6>(a.oxi, 0, B, b), xi);
  for (int t = 0; t < N; ++t) {
    if (LIN) {
      // the linearization of the new stage t needs only (R, p, xi)
      stage_jacobian(lane<144>(a.nFx, t, B, b), R, xi, a.c);
      a.nl[(long long)t * B + b] = stage_cost_quad<T>(
          lane<12>(a.nlx, t, B, b), lane<144>(a.nlxx, t, B, b), R, p, xi,
          a.refs.RbiR + t * 9, a.refs.Rbip + t * 3, a.refs.Adb + t * 36,
          a.refs.xib + t * 6, a.c.W1, a.c.W2);
    }
    T Rt[9], pt[3], xit[6], Rn[9], pn[3], xin[6], ut[NU], kt[NU], Kt[NU * 12];
    T dd[12], fqRt[9], fqpt[3], fxit[6];
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
    T u[NU], fqR[9], fqp[3], fxi[6];
    rollout_stage<T, T, NU>(R, p, xi, u, fqR, fqp, fxi, Rt, pt, xit, Rn, pn,
                            xin, ut, kt, Kt, dd, fqRt, fqpt, fxit, a.c);
    store<9>(lane<9>(a.oR, t + 1, B, b), R);
    store<3>(lane<3>(a.op, t + 1, B, b), p);
    store<6>(lane<6>(a.oxi, t + 1, B, b), xi);
    store<NU>(lane<NU>(a.ou, t, B, b), u);
    if (LIN) {
      T nd[12];
      defect(nd, R, p, xi, fqR, fqp, fxi);
      store<9>(lane<9>(a.nfqR, t, B, b), fqR);
      store<3>(lane<3>(a.nfqp, t, B, b), fqp);
      store<6>(lane<6>(a.nfxi, t, B, b), fxi);
      store<12>(lane<12>(a.nd, t, B, b), nd);
    }
  }
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs<T> a) {
  rollout_sweep<T, NU, false>(a);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads) rollout_linearize_kernel(RolloutArgs<T> a) {
  rollout_sweep<T, NU, true>(a);
}

}  // namespace traopt

using traopt::Scalar;

extern "C" int TRAOPT_FN(riccati)(
    const void* Fx, const void* d, const void* lx, const void* lu,
    const void* lxx, const void* luual, const void* qR, const void* qp,
    const void* xi, const void* RbiR, const void* Rbip, const void* Adb,
    const void* xib, const void* W1N, const void* W2N, const void* fu2,
    const void* Luu, int glow, void* k, void* K, void* gvec, void* lN, int N,
    int nu, int B, int device, void* stream) {
  using T = Scalar;
  traopt::RiccatiArgs<T> a;
  a.Fx = (const T*)Fx; a.d = (const T*)d; a.lx = (const T*)lx;
  a.lu = (const T*)lu; a.lxx = (const T*)lxx; a.luual = (const T*)luual;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi;
  a.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  a.c = traopt::Consts<T>{nullptr, nullptr, nullptr, nullptr, (const T*)W1N,
                          (const T*)W2N, nullptr, (const T*)fu2, (const T*)Luu,
                          T(0), T(0), 0, 0};
  a.glow = glow;
  a.k = (T*)k; a.K = (T*)K; a.gvec = (T*)gvec; a.lN = (T*)lN;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nu == 6) return traopt::launch_riccati<T, 6>(a, s);
  if (nu == 4) return traopt::launch_riccati<T, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

// B4 when the new-linearization pointers are null, else B3.
extern "C" int TRAOPT_FN(rollout)(
    const void* qR, const void* qp, const void* xi, const void* u,
    const void* k, const void* K, const void* d, const void* fqR,
    const void* fqp, const void* fxi, const void* RbiR, const void* Rbip,
    const void* Adb, const void* xib, const void* J, const void* Jinv,
    const void* W1, const void* W2, const void* Pu, double mg, double dt,
    int gravity, int exact_grav, void* oR, void* op, void* oxi, void* ou,
    void* nfqR, void* nfqp, void* nfxi, void* nd, void* nFx, void* nlx,
    void* nlxx, void* nl, int N, int nu, int B, int device, void* stream) {
  using T = Scalar;
  traopt::RolloutArgs<T> a;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi; a.u = (const T*)u;
  a.k = (const T*)k; a.K = (const T*)K; a.d = (const T*)d;
  a.fqR = (const T*)fqR; a.fqp = (const T*)fqp; a.fxi = (const T*)fxi;
  a.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  a.c = traopt::Consts<T>{(const T*)J, (const T*)Jinv, (const T*)W1, (const T*)W2,
                          nullptr, nullptr, (const T*)Pu, nullptr, nullptr,
                          (T)mg, (T)dt, gravity, exact_grav};
  a.oR = (T*)oR; a.op = (T*)op; a.oxi = (T*)oxi; a.ou = (T*)ou;
  a.nfqR = (T*)nfqR; a.nfqp = (T*)nfqp; a.nfxi = (T*)nfxi; a.nd = (T*)nd;
  a.nFx = (T*)nFx; a.nlx = (T*)nlx; a.nlxx = (T*)nlxx; a.nl = (T*)nl;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  const bool lin = nFx != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = traopt::batch_grid(B);
  if (nu == 6 && lin)
    traopt::rollout_linearize_kernel<T, 6><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nu == 4 && lin)
    traopt::rollout_linearize_kernel<T, 4><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nu == 6)
    traopt::rollout_kernel<T, 6><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nu == 4)
    traopt::rollout_kernel<T, 4><<<grid, traopt::kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
