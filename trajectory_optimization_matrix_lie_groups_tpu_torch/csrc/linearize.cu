// The C entry point of kernel B1 (linearize.cuh).
#include "linearize.cuh"

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
