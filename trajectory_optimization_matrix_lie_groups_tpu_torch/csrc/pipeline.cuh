// The argument blocks and the pieces shared by pipeline.cu (the tuned
// instances of B2-B4, nu = 6 and 4) and pipeline_nu.cu (their instances at
// any other nu up to 12): the kernels' arguments, B2's fp64 terminal
// quadratization (terminal_kernel), the fp64 rollout's column layout and the
// host helpers that opt a kernel into more shared memory and ask how many of
// its blocks an SM holds.  pipeline.cu and pipeline_nu.cu define
// TRAOPT_F64_TRIG before they include it.
#pragma once

#include <cuda_runtime.h>

#include "ahead.cuh"
#include "common.cuh"
#include "stage.cuh"

namespace traopt {

// B2's arguments.
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

// B2 in fp64, phase 1: the terminal quadratization (stage_cost_quad at
// stage N), a thread a problem, into the first 48 entries of the problem in
// a.K: l_x in entries 0..11, the top-left 6 x 6 block of l_xx in 12..47 (its
// other blocks are 0 and 2 W2N).  In pipeline.cu a.K is K itself, whose
// stage 0 holds 12 nu >= 48 values a problem at nu = 6 and 4: phase 2 reads
// them first and writes K's stage 0 last.  pipeline_nu.cu points a.K at a
// (48, B) hand-off array of its own (at nu < 4 stage 0 is too small).
// (A template, so that only the fp64 library, which launches it, compiles
// it.)
template <typename T>
struct TerminalLxx {
  Lane<T> k;
  mutable T sink;  // the blocks phase 2 rebuilds
  __device__ __forceinline__ T& operator[](int e) const {
    return e / 12 < 6 && e % 12 < 6 ? k[12 + (e / 12) * 6 + e % 12] : sink;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) terminal_kernel(RiccatiArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  T R[9], p[3], xi[6];
  load<9>(R, lane<9>(a.qR, N, B, b));
  load<3>(p, lane<3>(a.qp, N, B, b));
  load<6>(xi, lane<6>(a.xi, N, B, b));
  const Lane<T> k0 = lane<48>(a.K, 0, B, b);
  a.lN[b] = stage_cost_quad<T>(k0, TerminalLxx<T>{k0, T(0)}, R, p, xi, a.refs.RbiR + N * 9,
                               a.refs.Rbip + N * 3, a.refs.Adb + N * 36, a.refs.xib + N * 6,
                               a.c.W1N, a.c.W2N);
}

// B3's and B4's arguments.
template <typename T>
struct RolloutArgs {
  const T *qR, *qp, *xi, *u;      // nominal trajectory (N+1, ...) and (N, nu, B)
  const T *k, *K;                 // gains (N, nu, B), (N, nu, 12, B)
  const T *d, *fqR, *fqp, *fxi;   // nominal linearization (N, ..., B)
  Consts<T> c;
  T *oR, *op, *oxi, *ou;          // new trajectory (N+1, ...), controls (N, nu, B)
  int N, B;
};

// The column of a thread of the fp64 rollout (pipeline.cu rollout_f64_kernel)
// and of the rollout at any nu (pipeline_nu.cu): K, two stage slots, three
// x slots.
template <int NU>
struct RolloutF64Column {
  // a stage slot: u_t, k_t, the defect d_t, the nominal's evaluation
  static constexpr int u = 0, k = NU, d = 2 * NU, fqR = d + 12, fqp = fqR + 9, fxi = fqp + 3,
                       ns = fxi + 6;
  // an x slot: the nominal state
  static constexpr int R = 0, p = 9, xi = 12, nx = 18;
  // the column: K, two stage slots, three x slots
  static constexpr int K = 0, S = 12 * NU, X = S + 2 * ns, n = X + 3 * nx;
};

// Let a kernel take `bytes` of dynamic shared memory, with the SM's
// carve-out all shared memory (B2 and the rollout in fp64 fit three and four
// blocks an SM only so).
template <typename K>
int set_smem(K kernel, size_t bytes, bool carveout) {
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes))
    return (int)e;
  if (carveout)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     100);
  return 0;
}

// The blocks of a kernel that an SM holds at once, launched with `threads`
// threads and `bytes` of dynamic shared memory (set_smem); -1 on an error.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t bytes, bool carveout) {
  int n = -1;
  if (set_smem(kernel, bytes, carveout) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes))
    return -1;
  return n;
}

}  // namespace traopt
