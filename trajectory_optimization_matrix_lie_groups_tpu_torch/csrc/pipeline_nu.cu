// The C entry points of B1-B4 at any input dimension nu = 1 ... kMaxNuLarge
// (nu.cuh up to 12, nu_large.cuh past it), built once per scalar type as
// pipeline.cu is; the wrappers send them every nu that the tuned instances
// (nu = 6 and 4) do not take.  Each entry takes the arguments of its
// pipeline.cu / linearize.cu twin (B2 also a (48, B) hand-off array for its
// fp64 terminal quadratization) and returns cudaErrorInvalidValue for nu
// outside 1 ... kMaxNuLarge.
#define TRAOPT_F64_TRIG
#include <type_traits>

#include "nu_large.cuh"

namespace traopt {

// The blocks of B2's (kernel 0) or the rollout's (kernel 1; past 12 its
// feedback-slot instance) instance at nu that an SM holds at once, as they
// are launched; -1 on an error.
template <typename T>
int occupancy_large(int kernel, int nu) {
  if (kernel == 1)
    return blocks_per_sm(rollout_large_kernel<T, true>, kAheadThreads,
                         rollout_large_bytes<T, true>(nu), true);
  return blocks_per_sm(riccati_large_kernel<T>, kGroup * kLargeProblems<T>,
                       riccati_large_layout<T, T>(nu).bytes, true);
}

template <typename T, int MU>
int occupancy_nu(int kernel) {
  if (kernel == 1)
    return blocks_per_sm(rollout_nu_kernel<T, MU>, kAheadThreads, rollout_nu_bytes<T, MU>(),
                         true);
  if constexpr (std::is_same<T, double>::value)
    return blocks_per_sm(riccati_f64_nu_kernel<MU>, kGroupThreads, Layout64Nu<MU>::bytes, true);
  else
    return blocks_per_sm(riccati_nu_kernel<T, MU>, kGroupThreads,
                         RiccatiLayout<T, T, MU>::bytes, false);
}

}  // namespace traopt

using traopt::Scalar;

extern "C" int TRAOPT_FN(occupancy_nu)(int kernel, int nu, int device) {
  if (cudaSetDevice(device) || nu < 1 || nu > traopt::kMaxNuLarge) return -1;
  if (nu > traopt::kMaxNu) return traopt::occupancy_large<Scalar>(kernel, nu);
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::occupancy_nu<Scalar, decltype(mu)::value>(kernel);
  });
}

extern "C" int TRAOPT_FN(linearize_nu)(
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
  if (nu > traopt::kMaxNu && nu <= traopt::kMaxNuLarge)
    return traopt::launch_linearize_large<T>(a, nu, s);
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_linearize_nu<T, decltype(mu)::value>(a, nu, s);
  });
}

// B2's arguments (hand: a (48, B) array, the fp64 terminal quadratization's
// hand-off, unused in f32) and their names.
#define RICCATI_PARAMS                                                            \
  const void *Fx, const void *d, const void *lx, const void *lu, const void *lxx, \
      const void *luual, const void *qR, const void *qp, const void *xi,           \
      const void *RbiR, const void *Rbip, const void *Adb, const void *xib,        \
      const void *W1N, const void *W2N, const void *fu2, const void *Luu, int glow, \
      void *k, void *K, void *gvec, void *lN, int N, int nu, int B, int device,     \
      void *stream, void *hand
#define RICCATI_NAMES                                                                  \
  Fx, d, lx, lu, lxx, luual, qR, qp, xi, RbiR, Rbip, Adb, xib, W1N, W2N, fu2, Luu, glow, \
      k, K, gvec, lN, N, nu, B, device, stream, hand

// B2 at nu: the large-nu instance past 12, or with kLarge at any nu up to
// kMaxNuLarge (scripts/nu_instances.py times it at 12 against nu.cuh's).
template <bool kLarge>
static int riccati_entry(RICCATI_PARAMS) {
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
  if ((kLarge || nu > traopt::kMaxNu) && nu >= 1 && nu <= traopt::kMaxNuLarge)
    return traopt::launch_riccati_large<T>(a, nu, (T*)hand, s);
  if (kLarge) return (int)cudaErrorInvalidValue;
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_riccati_nu<T, decltype(mu)::value>(a, nu, (T*)hand, s);
  });
}

extern "C" int TRAOPT_FN(riccati_nu)(RICCATI_PARAMS) { return riccati_entry<false>(RICCATI_NAMES); }
extern "C" int TRAOPT_FN(riccati_large)(RICCATI_PARAMS) {
  return riccati_entry<true>(RICCATI_NAMES);
}

// B3's and B4's arguments and their names.
#define ROLLOUT_PARAMS                                                                 \
  const void *qR, const void *qp, const void *xi, const void *u, const void *k,      \
      const void *K, const void *d, const void *fqR, const void *fqp, const void *fxi, \
      const void *RbiR, const void *Rbip, const void *Adb, const void *xib,           \
      const void *J, const void *Jinv, const void *W1, const void *W2, const void *Pu, \
      double mg, double dt, int gravity, int exact_grav, void *oR, void *op, void *oxi, \
      void *ou, void *nfqR, void *nfqp, void *nfxi, void *nd, void *nFx, void *nlx,    \
      void *nlxx, void *nl, int N, int nu, int B, int device, void *stream
#define ROLLOUT_NAMES                                                                 \
  qR, qp, xi, u, k, K, d, fqR, fqp, fxi, RbiR, Rbip, Adb, xib, J, Jinv, W1, W2, Pu, mg, \
      dt, gravity, exact_grav, oR, op, oxi, ou, nfqR, nfqp, nfxi, nd, nFx, nlx, nlxx,   \
      nl, N, nu, B, device, stream

// The large-nu rollout's launches since the library was loaded, by the
// instance taken: [0] the feedback read from device memory, [1] from the
// feedback slot (rollout_large_slot).
static int rollout_large_launches[2];

extern "C" int TRAOPT_FN(rollout_large_launches)(int slot) {
  return slot == 0 || slot == 1 ? rollout_large_launches[slot] : -1;
}

// B4 when the new-linearization pointers are null, else B3: the large-nu
// instances past 12, or with kLarge at any nu up to kMaxNuLarge.
template <bool kLarge>
static int rollout_entry(ROLLOUT_PARAMS) {
  using T = Scalar;
  traopt::RolloutArgs<T> a;
  a.qR = (const T*)qR; a.qp = (const T*)qp; a.xi = (const T*)xi; a.u = (const T*)u;
  a.k = (const T*)k; a.K = (const T*)K; a.d = (const T*)d;
  a.fqR = (const T*)fqR; a.fqp = (const T*)fqp; a.fxi = (const T*)fxi;
  a.c = traopt::Consts<T>{(const T*)J, (const T*)Jinv, (const T*)W1, (const T*)W2,
                          nullptr, nullptr, (const T*)Pu, nullptr, nullptr,
                          (T)mg, (T)dt, gravity, exact_grav};
  a.oR = (T*)oR; a.op = (T*)op; a.oxi = (T*)oxi; a.ou = (T*)ou;
  a.N = N; a.B = B;
  traopt::LinearizeArgs<T> l;
  l.qR = a.oR; l.qp = a.op; l.xi = a.oxi; l.u = a.ou;
  l.refs = {(const T*)RbiR, (const T*)Rbip, (const T*)Adb, (const T*)xib};
  l.c = a.c;
  l.fqR = (T*)nfqR; l.fqp = (T*)nfqp; l.fxi = (T*)nfxi; l.d = (T*)nd;
  l.Fx = (T*)nFx; l.lx = (T*)nlx; l.lxx = (T*)nlxx; l.l = (T*)nl;
  l.N = N; l.B = B;
  const traopt::LinearizeArgs<T>* lin = nFx ? &l : nullptr;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if ((kLarge || nu > traopt::kMaxNu) && nu >= 1 && nu <= traopt::kMaxNuLarge) {
    bool slot = false;
    const int e = traopt::launch_rollout_large<T>(a, lin, nu, s, &slot);
    if (!e) ++rollout_large_launches[slot];
    return e;
  }
  if (kLarge) return (int)cudaErrorInvalidValue;
  return traopt::by_mu(nu, [&](auto mu) {
    return traopt::launch_rollout_nu<T, decltype(mu)::value>(a, lin, nu, s);
  });
}

extern "C" int TRAOPT_FN(rollout_nu)(ROLLOUT_PARAMS) { return rollout_entry<false>(ROLLOUT_NAMES); }
extern "C" int TRAOPT_FN(rollout_large)(ROLLOUT_PARAMS) {
  return rollout_entry<true>(ROLLOUT_NAMES);
}
