// Shared device helpers for the port's resampling kernels.
//
// Every float operation that decides a sample position or a weight is
// written with the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn): they are never contracted into fused
// multiply-adds, so coordinates come out bit-identical to the JAX package's
// (and the plain PyTorch versions') separate multiply and add. That matters
// for alignment stage A, whose integer-snapped windows make the hat weights
// exactly one-hot only when the coordinates are exact; a contracted FMA
// would turn a lossless pixel copy into a blur. The files are also built
// with -fmad=false.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace frp {

// Round a float to the nearest bfloat16 (ties to even) and back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Bilinear hat weight max(0, 1 - |p - i|).
__device__ __forceinline__ float hat(float p, int i) {
  const float d = fabsf(__fsub_rn(p, static_cast<float>(i)));
  return fmaxf(0.0f, __fsub_rn(1.0f, d));
}

}  // namespace frp
