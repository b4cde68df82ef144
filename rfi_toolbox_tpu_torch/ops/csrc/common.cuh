// Device helpers shared by the port's kernels (no PyTorch headers).
//
// Every float operation whose rounding decides an exact result is spelt
// with an explicit round-to-nearest intrinsic, so that nvcc cannot fuse a
// multiply and an add into one FMA and the kernels match their plain
// PyTorch versions bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rfi {

constexpr unsigned kFullMask = 0xffffffffu;

// |re + i im| as the plain version (preprocess/pipeline.py:magnitude) and
// the reference compute it: max * sqrt(fma(r, r, 1)) with r = min / max,
// the fma and the square root taken in float64 and rounded to float32.
// NaN in either part gives NaN.
__device__ __forceinline__ float magnitude(float re, float im) {
  const float a = fabsf(re);
  const float b = fabsf(im);
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  const float larger = fmaxf(a, b);
  const float smaller = fminf(a, b);
  const float ratio = (larger == 0.0f || isinf(smaller))
                          ? 0.0f
                          : __fdiv_rn(smaller, larger);
  const double r = static_cast<double>(ratio);
  const float s = __double2float_rn(__fma_rn(r, r, 1.0));
  const float root = __double2float_rn(__dsqrt_rn(static_cast<double>(s)));
  return __fmul_rn(root, larger);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

}  // namespace rfi
