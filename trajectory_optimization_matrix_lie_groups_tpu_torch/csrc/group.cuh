// The machinery of the group kernels (B2, B5, B13 at nx = 12 and at any
// runtime shape): a group of kGroup threads per problem and kProblems
// problems per block; each stage's inputs for the block's problems copied
// one stage ahead into shared memory with cp.async; the outputs staged in
// shared memory and stored coalesced over the block's problems.
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
// An H100's shared memory for one block (227 KB).
constexpr size_t kSmemPerBlock = 232448;

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

// One problem's share of a stage buffer's region for an input of ne
// entries: whole 16-byte vectors, an odd number of 4-bank groups, so that
// the 8 problems of a block start in 8 different groups of banks (a warp's
// copy of 4 entries of 8 problems writes 32 different banks in f32).
template <typename T>
constexpr int spread_pitch(int ne) {
  constexpr int w = sizeof(T) / 4;
  int p = ne;
  while ((p * w) % 8 != 4) ++p;
  return p;
}

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
// problems into dst: problem p's entry e at dst[p * pt + e] (pt = PT, or
// pitch<T>(ne) by default), or, with TRANSPOSE (ne = 144), entry (i, j) of
// the 12 x 12 matrix at j * 12 + i.
template <int ne, bool TRANSPOSE, int PT = -1, typename T>
__device__ __forceinline__ void copy_stage(T* dst, const T* src, int t, int b0, int B,
                                           int tid) {
  constexpr int n = ne * kProblems, pt = PT < 0 ? pitch<T>(ne) : PT;
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

// The runtime-shape counterparts of copy_stage and store_stage (B13's
// runtime-shape and large-nu instances, fast.cu and fast_large.cuh), the
// entry counts runtime arguments, and the problems a block P (kGroup * P
// threads) too where the large-nu instance chooses it at launch.
// One input's place in a stage buffer: problem p's entry (i, j) of a
// rows x cols matrix (a vector: one row) at off + p * pt + i * rp + j, rp >=
// cols padding each row to whole 16-byte vectors so that a row reads in
// vector loads.  Thread tid copies entries e = tid / P + 16 s (s = 0, 1,
// ...) of problem tid % P, so (i, j) advance by (di, dj) =
// (16 / cols, 16 % cols) a step, and i starts at (e * m) >> 16 with m =
// ceil(2^16 / cols), exact for e < 16: no division in the device code.
struct RowCopy {
  int off, pt, rp, cols, ne, di, dj, m;
};

constexpr RowCopy row_copy(int off, int pt, int rows, int cols, int rp) {
  constexpr int de = kGroupThreads / kProblems;
  return {off, pt, rp, cols, rows * cols, de / cols, de % cols, ((1 << 16) + cols - 1) / cols};
}

// Copy stage t of the batch-last array src (N, c.ne, B) for the block's P
// problems into the stage buffer buf at c's place.
template <typename T>
__device__ __forceinline__ void copy_stage_rows(T* buf, const RowCopy& c, const T* src, int t,
                                                int b0, int B, int tid, int P = kProblems) {
  constexpr int de = kGroupThreads / kProblems;
  const int p = tid % P;
  int e = tid / P, i = (e * c.m) >> 16, j = e - i * c.cols;
  T* dst = buf + c.off + p * c.pt;
  const T* s = src + (long long)t * c.ne * B + min(b0 + p, B - 1);
  for (; e < c.ne; e += de) {
    cp_async<sizeof(T)>(dst + i * c.rp + j, s + (long long)e * B);
    i += c.di;
    j += c.dj;
    if (j >= c.cols) {
      j -= c.cols;
      ++i;
    }
  }
}

// Store stage t of the batch-last array dst (N, ne, B) for the block's P
// problems from the staged buf (entry e of problem p at e * (P + 1) + p).
template <typename T>
__device__ __forceinline__ void store_stage_rows(T* dst, const T* buf, int ne, int t, int b0,
                                                 int B, int tid, int P = kProblems) {
  const int p = tid % P;
  if (b0 + p >= B) return;
  T* d = dst + (long long)t * ne * B + b0 + p;
  for (int e = tid / P; e < ne; e += kGroupThreads / kProblems)
    d[(long long)e * B] = buf[e * (P + 1) + p];
}

// 0, from an instruction the compiler cannot see through.  Every address
// of a stage loop adds it (B13's runtime-shape instance, B2 and the rollout
// in fp64), so that each stage derives its addresses anew instead of
// holding one per region, row and copy in registers across the loop.
__device__ __forceinline__ int opaque_zero() {
#ifdef __CUDA_ARCH__
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
#else
  return 0;
#endif
}

// The byte stride of a group's scratch: its size in whole 16-byte vectors,
// then 20 banks (mod 32) from the next group's.
__host__ __device__ constexpr size_t group_stride(size_t bytes) {
  size_t s = align16(bytes);
  while (s % 128 != 80) s += 16;
  return s;
}

}  // namespace traopt
