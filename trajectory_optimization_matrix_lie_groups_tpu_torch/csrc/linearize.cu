// Kernel B1: fused per-stage linearization + GN quadratization.
//
// Replaces the TPU kernel ops/pallas_linearize.py::_linearize_kernel (called
// by pallas_linearize and solvers/pipeline.py PallasPipelineSolver
// ._linearize_lane).  For every stage t and problem b, with the stage state
// (R, p, xi, u) and the next state:
//   dynamics eval   fq = normalize(q Exp(xi dt)), fxi (Euler-Poincare)
//   defect          d = [Log(q_{t+1}^-1 fq); fxi - xi_{t+1}]
//   dynamics jac    Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [J_xi_q, I + H dt]]
//   cost quad       lx, lxx, l (Gauss-Newton tracking)
//
// Grid: (ceil(B / 128), N), one thread per (problem, stage); stages are
// independent.  What bounds it on an H100: it writes 2 x 144 + 40 values per
// thread (Fx and lxx dominate: N * 288 * B * 4 bytes, 1.9 GB at N=200,
// B=8192 in f32), about 3 k flops per thread, so it is store-bound; the
// design writes every output entry once, coalesced over b, straight from
// registers (no staging of the 12x12 blocks in memory).
#include "common.cuh"
#include "stage.cuh"

namespace traopt {

template <typename T>
struct LinearizeArgs {
  const T *qR, *qp, *xi, *u;          // (N+1, 3, 3, B), (N+1, 3, B), (N+1, 6, B), (N, nu, B)
  Refs<T> refs;
  Consts<T> c;
  T *fqR, *fqp, *fxi, *d, *Fx, *lx, *lxx, *l;  // (N, ..., B)
  int N, B;
};

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads) linearize_kernel(LinearizeArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= a.B) return;
  const int B = a.B;
  T R[9], p[3], xi[6], u[NU];
  load<9>(R, lane<9>(a.qR, t, B, b));
  load<3>(p, lane<3>(a.qp, t, B, b));
  load<6>(xi, lane<6>(a.xi, t, B, b));
  load<NU>(u, lane<NU>(a.u, t, B, b));

  T fqR[9], fqp[3], fxi[6];
  stage_dynamics_eval<T, NU>(fqR, fqp, fxi, R, p, xi, u, a.c);
  store<9>(lane<9>(a.fqR, t, B, b), fqR);
  store<3>(lane<3>(a.fqp, t, B, b), fqp);
  store<6>(lane<6>(a.fxi, t, B, b), fxi);
  {
    T Rn[9], pn[3], xin[6], d[12];
    load<9>(Rn, lane<9>(a.qR, t + 1, B, b));
    load<3>(pn, lane<3>(a.qp, t + 1, B, b));
    load<6>(xin, lane<6>(a.xi, t + 1, B, b));
    defect(d, Rn, pn, xin, fqR, fqp, fxi);
    store<12>(lane<12>(a.d, t, B, b), d);
  }
  stage_jacobian(lane<144>(a.Fx, t, B, b), R, xi, a.c);
  a.l[(long long)t * B + b] = stage_cost_quad(
      lane<12>(a.lx, t, B, b), lane<144>(a.lxx, t, B, b), R, p, xi,
      a.refs.RbiR + t * 9, a.refs.Rbip + t * 3, a.refs.Adb + t * 36,
      a.refs.xib + t * 6, a.c.W1, a.c.W2);
}

}  // namespace traopt

using traopt::Scalar;

extern "C" int TRAOPT_FN(linearize)(
    const void* qR, const void* qp, const void* xi, const void* u,
    const void* RbiR, const void* Rbip, const void* Adb, const void* xib,
    const void* J, const void* Jinv, const void* W1, const void* W2,
    const void* Pu, double mg, double dt, int gravity, int exact_grav,
    void* fqR, void* fqp, void* fxi, void* d, void* Fx, void* lx, void* lxx,
    void* l, int N, int nu, int B, int device, void* stream) {
  using T = Scalar;
  traopt::LinearizeArgs<T> a;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi; a.u = (const T*)u;
  a.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  a.c = traopt::Consts<T>{(const T*)J, (const T*)Jinv, (const T*)W1, (const T*)W2,
                          nullptr, nullptr, (const T*)Pu, nullptr, nullptr,
                          (T)mg, (T)dt, gravity, exact_grav};
  a.fqR = (T*)fqR; a.fqp = (T*)fqp; a.fxi = (T*)fxi; a.d = (T*)d;
  a.Fx = (T*)Fx; a.lx = (T*)lx; a.lxx = (T*)lxx; a.l = (T*)l;
  a.N = N; a.B = B;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = traopt::batch_grid(B, N);
  if (nu == 6)
    traopt::linearize_kernel<T, 6><<<grid, traopt::kThreads, 0, s>>>(a);
  else if (nu == 4)
    traopt::linearize_kernel<T, 4><<<grid, traopt::kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
