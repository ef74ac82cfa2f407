// The C entry points of B5 and B6 at any input dimension nu = 1 ... 12
// (nu.cuh), built once (-DTRAOPT_SUFFIX=mx) as polish.cu is; the wrappers
// send them every nu that the tuned instances (nu = 6 and 4) do not take.
// Each takes the arguments of its polish.cu twin and returns
// cudaErrorInvalidValue for nu outside 1 ... 12.
#include <type_traits>

#include "nu.cuh"

extern "C" int TRAOPT_FN(riccati_nu)(
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
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_riccati_mx_nu<decltype(mu)::value>(a, nu, s);
  });
}

extern "C" int TRAOPT_FN(rollout_nu)(
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
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_rollout_mx_nu<decltype(mu)::value>(a, nu, s);
  });
}
