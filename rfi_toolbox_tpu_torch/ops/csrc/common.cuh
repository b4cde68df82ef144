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
// the fma taken in float64 and rounded to float32. The plain version takes
// the square root in float64 and rounds it; the float32 square root equals
// that bit for bit (a square root rounded to 53 bits and then to 24 is the
// square root rounded to 24, as 53 >= 2 * 24 + 2), at half the cost.
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
  return __fmul_rn(__fsqrt_rn(s), larger);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Constants and steps of the channel extraction, shared by K1, K2 and K4
// (preprocess/pipeline.py: extract_channels, extract_channel_planes).
constexpr float kLogMin = -3.0f;
constexpr float kLogSpan = 7.0f;  // LOG_MAX - LOG_MIN
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMean0 = 0.485f, kMean1 = 0.456f, kMean2 = 0.406f;
constexpr float kStd0 = 0.229f, kStd1 = 0.224f, kStd2 = 0.225f;

// clip to [0, 1], NaN kept
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// log10(|z| + 1e-10)
__device__ __forceinline__ float log_amplitude(float2 z) {
  return log10f(__fadd_rn(magnitude(z.x, z.y), 1e-10f));
}

}  // namespace rfi
