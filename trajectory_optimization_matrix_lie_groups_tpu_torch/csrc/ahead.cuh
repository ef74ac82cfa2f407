// The machinery of the one-thread-per-problem stage loops with copy-ahead
// (B3 and B4, B11 and B12's rollout, B13 at (6, 3) and B14): kAheadThreads
// problems per block, one warp, so that a batch of B problems spreads over
// B / 32 blocks; each thread copies its own problem's inputs of the next
// stage (t + 1 in a rollout, t - 1 in a Riccati backward) into shared
// memory with cp.async while it computes stage t.  Entry e of thread p's
// stage buffer sits at e * kAheadThreads + p: a warp's copy of one entry
// reads 32 neighbouring problems (whole sectors of a batch-last array) and
// writes 32 neighbouring banks, and each thread reads back only what it
// copied itself, so the loop needs no barrier.  Threads past B (the ragged
// last block) read problem B - 1 and store nothing (the rollouts of B3, B4
// and B12) or return at once (B11, B13 at (6, 3), B14).
#pragma once

#include "group.cuh"
#include "stage.cuh"

namespace traopt {

constexpr int kAheadThreads = 32;

inline dim3 ahead_grid(int B) { return dim3((B + kAheadThreads - 1) / kAheadThreads); }

// Entry e of one thread's column of a stage buffer, at col[e * kAheadThreads].
template <typename T>
__device__ __forceinline__ Lane<T> column(T* col) {
  return Lane<T>{col, kAheadThreads};
}

// Copy entries 0 .. ne - 1 of stage t of the batch-last array src
// (., stride, B) for problem b into the column dst.
template <int ne, int stride = ne, typename T>
__device__ __forceinline__ void copy_column(T* dst, const T* src, int t, int B, int b) {
  const T* s = src + (long long)t * stride * B + b;
#pragma unroll
  for (int e = 0; e < ne; ++e) cp_async<sizeof(T)>(dst + e * kAheadThreads, s + (long long)e * B);
}

}  // namespace traopt
