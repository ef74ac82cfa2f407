// The C entry points of B5 and B6 at any input dimension nu = 1 ...
// kMaxNuLarge (nu.cuh up to 12, nu_large.cuh past it), built once
// (-DTRAOPT_SUFFIX=mx) as polish.cu is; the wrappers send them every nu
// that the tuned instances (nu = 6 and 4) do not take.  Each takes the
// arguments of its polish.cu twin and returns cudaErrorInvalidValue for nu
// outside 1 ... kMaxNuLarge.
#include <type_traits>

#include "nu_large.cuh"

// B5's arguments and their names.
#define RICCATI_PARAMS                                                                 \
  const void *Fx, const void *d, const void *lx, const void *lu, const void *lxx,      \
      const void *luual, const void *VxN, const void *VxxN, const void *fu2,            \
      const void *fu2_32, const void *Luu, int glow, void *k, void *K, void *gvec, int N, \
      int nu, int B, int device, void *stream
#define RICCATI_NAMES \
  Fx, d, lx, lu, lxx, luual, VxN, VxxN, fu2, fu2_32, Luu, glow, k, K, gvec, N, nu, B, device, stream

// B5 at nu: the large-nu instance past 12, or with kLarge at any nu up to
// kMaxNuLarge (scripts/nu_instances.py times it at 12 against nu.cuh's).
template <bool kLarge>
static int riccati_entry(RICCATI_PARAMS) {
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
  if ((kLarge || nu > traopt::kMaxNu) && nu >= 1 && nu <= traopt::kMaxNuLarge)
    return traopt::launch_riccati_mx_large(a, nu, s);
  if (kLarge) return (int)cudaErrorInvalidValue;
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_riccati_mx_nu<decltype(mu)::value>(a, nu, s);
  });
}

extern "C" int TRAOPT_FN(riccati_nu)(RICCATI_PARAMS) { return riccati_entry<false>(RICCATI_NAMES); }
extern "C" int TRAOPT_FN(riccati_large)(RICCATI_PARAMS) {
  return riccati_entry<true>(RICCATI_NAMES);
}

// B6's arguments and their names.
#define ROLLOUT_PARAMS                                                                  \
  const void *qR, const void *qp, const void *xi, const void *u, const void *k,       \
      const void *K, const void *d, const void *fqR, const void *fqp, const void *fxi, \
      const void *J, const void *Jinv, const void *Pu, double mg, double dt, int gravity, \
      void *oR, void *op, void *oxi, void *ou, void *efqR, void *efqp, void *efxi, int N, \
      int nu, int B, int device, void *stream
#define ROLLOUT_NAMES                                                                   \
  qR, qp, xi, u, k, K, d, fqR, fqp, fxi, J, Jinv, Pu, mg, dt, gravity, oR, op, oxi, ou, \
      efqR, efqp, efxi, N, nu, B, device, stream

// B6 at nu: the large-nu instance past 12, or with kLarge at any nu up to
// kMaxNuLarge.
template <bool kLarge>
static int rollout_entry(ROLLOUT_PARAMS) {
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
  if ((kLarge || nu > traopt::kMaxNu) && nu >= 1 && nu <= traopt::kMaxNuLarge)
    return traopt::launch_rollout_mx_large(a, nu, s);
  if (kLarge) return (int)cudaErrorInvalidValue;
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_rollout_mx_nu<decltype(mu)::value>(a, nu, s);
  });
}

extern "C" int TRAOPT_FN(rollout_nu)(ROLLOUT_PARAMS) { return rollout_entry<false>(ROLLOUT_NAMES); }
extern "C" int TRAOPT_FN(rollout_large)(ROLLOUT_PARAMS) {
  return rollout_entry<true>(ROLLOUT_NAMES);
}
