// The machinery of the group kernels (B2, B5): a group of kGroup threads
// per problem and kProblems problems per block; each stage's inputs for the
// block's problems copied one stage ahead into shared memory with cp.async;
// the outputs staged in shared memory and stored coalesced over the block's
// problems.
//
// Batch-last arrays (N, ne, B) hold entry e of stage t for the block's
// problems b0 .. b0 + kProblems - 1 in one contiguous run, so a warp's copy
// of 4 entries x 8 problems reads 4 whole 32-byte sectors (f32).  The copies
// are element-wise (4 or 8 bytes), so they need no alignment beyond the
// element's, whatever B and the tensors' offsets, and each element can land
// anywhere in shared memory: one problem's entries sit in a row of
// `pitch` elements (or transposed, for a 12 x 12 matrix), so that the two
// groups of a warp read rows 20 banks apart.  Problems past B (the ragged
// last block) read problem B - 1 and store nothing.
#pragma once

#include "common.cuh"

#ifndef __CUDA_ARCH__
#include <cstring>
#endif

namespace traopt {

constexpr int kGroup = 16;                          // threads per problem: a half-warp
constexpr int kProblems = 8;                        // problems per block
constexpr int kGroupThreads = kGroup * kProblems;   // 128
constexpr int kOutStride = kProblems + 1;           // staged output: entry e of problem p at e * 9 + p

inline dim3 group_grid(int B) { return dim3((B + kProblems - 1) / kProblems); }

// The row of one problem's entries in shared memory: at least ne elements,
// a multiple of 16 bytes, and 20 banks (mod 32) from the next problem's row.
template <typename T>
__host__ __device__ constexpr int pitch(int ne) {
  constexpr int w = sizeof(T) / 4;
  int p = ne;
  while ((p * w) % 32 != 20) ++p;
  return p;
}

// n rounded up to whole 16-byte vectors of T.
template <typename T>
__host__ __device__ constexpr int vpad(int n) {
  constexpr int v = 16 / sizeof(T);
  return (n + v - 1) / v * v;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// n consecutive values from 16-byte-aligned shared memory, in 16-byte loads
// where n allows.
template <typename T, int n>
__device__ __forceinline__ void lds(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 && n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && n % 2 == 0) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(src)[i];
      dst[2 * i] = v.x;
      dst[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

// One element from device memory into shared memory, asynchronously.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
#else
  memcpy(dst, src, BYTES);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait for this thread's copies; a barrier then makes every thread's visible.
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Copy stage t of the batch-last array src (N, ne, B) for the block's
// problems into dst: problem p's entry e at dst[p * pitch<T>(ne) + e], or,
// with TRANSPOSE (ne = 144), entry (i, j) of the 12 x 12 matrix at j * 12 + i.
template <int ne, bool TRANSPOSE, typename T>
__device__ __forceinline__ void copy_stage(T* dst, const T* src, int t, int b0, int B,
                                           int tid) {
  constexpr int n = ne * kProblems, pt = pitch<T>(ne);
  static_assert(!TRANSPOSE || ne == 144, "the transposed copy is of a 12 x 12 matrix");
#pragma unroll
  for (int q0 = 0; q0 < n; q0 += kGroupThreads) {
    const int q = q0 + tid;
    if (n % kGroupThreads == 0 || q < n) {
      const int e = q / kProblems, p = q % kProblems;
      const int b = min(b0 + p, B - 1);
      const int s = TRANSPOSE ? (e % 12) * 12 + e / 12 : e;
      cp_async<sizeof(T)>(dst + p * pt + s, src + ((long long)t * ne + e) * B + b);
    }
  }
}

// Store stage t of the batch-last array dst (N, ne, B) for the block's
// problems from the staged buf (entry e of problem p at e * kOutStride + p).
template <int ne, typename T>
__device__ __forceinline__ void store_stage(T* dst, const T* buf, int t, int b0, int B,
                                            int tid) {
  constexpr int n = ne * kProblems;
#pragma unroll
  for (int q0 = 0; q0 < n; q0 += kGroupThreads) {
    const int q = q0 + tid;
    if (n % kGroupThreads == 0 || q < n) {
      const int e = q / kProblems, p = q % kProblems;
      if (b0 + p < B) dst[((long long)t * ne + e) * B + b0 + p] = buf[e * kOutStride + p];
    }
  }
}

// The byte stride of a group's scratch: its size in whole 16-byte vectors,
// then 20 banks (mod 32) from the next group's.
__host__ __device__ constexpr size_t group_stride(size_t bytes) {
  size_t s = align16(bytes);
  while (s % 128 != 80) s += 16;
  return s;
}

}  // namespace traopt
