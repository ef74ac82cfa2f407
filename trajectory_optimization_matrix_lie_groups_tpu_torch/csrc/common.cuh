// Shared pieces of the kernel units: the scalar type and the exported
// C symbol names, both chosen by the build (_build.py compiles linearize.cu
// and pipeline.cu once with -DTRAOPT_SCALAR=float -DTRAOPT_SUFFIX=f32 and
// once with double / f64, and the mixed-precision polish.cu once with
// -DTRAOPT_SUFFIX=mx and no scalar), and the launch geometry.
#pragma once

#include <cuda_runtime.h>

#ifndef TRAOPT_SUFFIX
#error "build with -DTRAOPT_SUFFIX=f32|f64 -DTRAOPT_SCALAR=float|double, or -DTRAOPT_SUFFIX=mx"
#endif

#define TRAOPT_CAT2(a, b) a##_##b
#define TRAOPT_CAT(a, b) TRAOPT_CAT2(a, b)
#define TRAOPT_FN(name) TRAOPT_CAT(name, TRAOPT_SUFFIX)

namespace traopt {

#ifdef TRAOPT_SCALAR
using Scalar = TRAOPT_SCALAR;
#endif

// One thread per problem, 128 problems per block.
constexpr int kThreads = 128;

inline dim3 batch_grid(int B, int stages = 1) {
  return dim3((B + kThreads - 1) / kThreads, stages);
}

}  // namespace traopt
