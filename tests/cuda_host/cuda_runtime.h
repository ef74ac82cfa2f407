// Host stand-in for the CUDA runtime: each block's threads run as OS threads
// that meet at real barriers (__syncthreads: the block, __syncwarp: the warp),
// dynamic shared memory is a per-block buffer, and a launch runs its blocks
// one after the other.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline double2 make_double2(double x, double y) { return {x, y}; }

inline thread_local dim3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// Two SMs of one block each (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// below): the large-nu rollout takes its feedback slot up to B = 64 and
// reads the feedback from device memory past it.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}

namespace traopt_emu {
struct Block {
  std::vector<unsigned char> smem;
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
};
inline thread_local Block* cur = nullptr;
inline unsigned char* smem() { return cur->smem.data(); }

template <class K, class A>
void launch(K kernel, dim3 grid, dim3 block, size_t bytes, const A& a) {
  const int n = block.x;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk;
      blk.smem.assign(bytes + 16, 0xAB);  // garbage, as on the card
      blk.all = std::make_unique<std::barrier<>>(n);
      for (int w = 0; w < (n + 31) / 32; ++w)
        blk.warps.push_back(std::make_unique<std::barrier<>>(std::min(32, n - 32 * w)));
      std::vector<std::thread> ts;
      for (int t = 0; t < n; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          blockDim = dim3(n);
          cur = &blk;
          kernel(a);
        });
      for (auto& t : ts) t.join();
    }
}
}  // namespace traopt_emu

inline void __syncthreads() { traopt_emu::cur->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  traopt_emu::cur->warps[threadIdx.x / 32]->arrive_and_wait();
}
