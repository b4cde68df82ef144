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

// Constants and steps of the channel extraction, shared by K1, K2 and K4
// (preprocess/pipeline.py: extract_channels, extract_channel_planes).
constexpr float kLogMin = -3.0f;
constexpr float kLogSpan = 7.0f;  // LOG_MAX - LOG_MIN
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMean0 = 0.485f, kMean1 = 0.456f, kMean2 = 0.406f;
constexpr float kStd0 = 0.229f, kStd1 = 0.224f, kStd2 = 0.225f;

// (x - lo) / span, or 0 where span is not positive (constant patch).
__device__ __forceinline__ float minmax(float x, float lo, float span) {
  return span > 0.0f ? __fdiv_rn(__fsub_rn(x, lo), span) : 0.0f;
}

// clip to [0, 1], NaN kept
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// ImageNet affine of one channel: (x - mean) / std
__device__ __forceinline__ float affine(float x, float mean, float std) {
  return __fdiv_rn(__fsub_rn(x, mean), std);
}

// log10(|z| + 1e-10)
__device__ __forceinline__ float log_amplitude(float2 z) {
  return log10f(__fadd_rn(magnitude(z.x, z.y), 1e-10f));
}

// The fixed log window [-3, 4] mapped to [0, 1], then its affine.
__device__ __forceinline__ float amp_channel(float log_amp) {
  return affine(clip01(__fdiv_rn(__fsub_rn(log_amp, kLogMin), kLogSpan)),
                kMean1, kStd1);
}

// atan2 phase mapped from [-pi, pi] to [0, 1], then its affine.
__device__ __forceinline__ float phase_channel(float2 z) {
  return affine(__fdiv_rn(__fadd_rn(atan2f(z.y, z.x), kPi), kTwoPi), kMean2,
                kStd2);
}

// sqrt(a^2 + b^2) without FMA contraction, as the plain version rounds it.
__device__ __forceinline__ float hypot_rn(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}

// Block-wide minimum of lo[j] and maximum of hi[j] for N values per
// thread, NaN skipped (fminf/fmaxf, like nanmin/nanmax); every thread gets
// the totals. blockDim.x is a multiple of 32. Call at most once per kernel.
template <int N>
__device__ __forceinline__ void block_min_max(float (&lo)[N], float (&hi)[N]) {
  __shared__ float partial[2 * N][32];
  __shared__ float total[2 * N];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lo[j] = warp_min(lo[j]);
    hi[j] = warp_max(hi[j]);
    if (lane == 0) {
      partial[j][warp] = lo[j];
      partial[N + j][warp] = hi[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float a = warp_min(lane < warps ? partial[j][lane] : INFINITY);
      const float b = warp_max(lane < warps ? partial[N + j][lane] : -INFINITY);
      if (lane == 0) {
        total[j] = a;
        total[N + j] = b;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lo[j] = total[j];
    hi[j] = total[N + j];
  }
}

}  // namespace rfi
