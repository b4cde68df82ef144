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

// Constants and steps of the channel extraction
// (preprocess/pipeline.py: extract_channels, extract_channel_planes), shared
// by K1, K2 and K4 (channel_planes.cu) and their strip kernel for larger
// patches (extract_strips.cu).
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

// The affines of the plain version with each division by a constant
// folded into a multiplication: x * scale + shift.
constexpr float kAmpScale = 1.0f / kLogSpan;          // (la - LOG_MIN) / span
constexpr float kAmpShift = -kLogMin / kLogSpan;
constexpr float kInvStd1 = 1.0f / kStd1;
constexpr float kShift0 = -kMean0 / kStd0;            // affine(0) of plane 0
constexpr float kShift1 = -kMean1 / kStd1;
constexpr float kPhaseScale = 1.0f / (kTwoPi * kStd2);  // atan2 -> affine
constexpr float kPhaseShift = (0.5f - kMean2) / kStd2;
constexpr float kPhaseZero = -kMean2 / kStd2;          // real input's phase

// An output store: streaming (evict first), as nothing reads it back.
template <int kPx>
__device__ __forceinline__ void store_out(float* p, const float (&v)[kPx]) {
  if constexpr (kPx == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// K4's store of kPx pixels' three channels, interleaved: 3 kPx floats.
template <int kPx>
__device__ __forceinline__ void store_channels(float* p, const float (&g)[kPx],
                                               const float (&a)[kPx],
                                               const float (&ph)[kPx]) {
  if constexpr (kPx == 4) {
    float4* o = reinterpret_cast<float4*>(p);
    __stcs(o, make_float4(g[0], a[0], ph[0], g[1]));
    __stcs(o + 1, make_float4(a[1], ph[1], g[2], a[2]));
    __stcs(o + 2, make_float4(ph[2], g[3], a[3], ph[3]));
  } else {
    __stcs(p, g[0]);
    __stcs(p + 1, a[0]);
    __stcs(p + 2, ph[0]);
  }
}

// min(max(x, 0), 1) with NaN kept, then the affine of plane `1`.
__device__ __forceinline__ float amp_value(float log_amp) {
  return fmaf(clip01(fmaf(log_amp, kAmpScale, kAmpShift)), kInvStd1, kShift1);
}

__device__ __forceinline__ float phase_value(float2 z) {
  return fmaf(atan2f(z.y, z.x), kPhaseScale, kPhaseShift);
}

// (x - lo) / span, then the plane's affine, as one FMA: scale is
// 1 / (span * std), or 0 where span is not positive (constant patch: every
// pixel gets affine(0), NaN included, as in the plain version).
struct Norm {
  float lo, scale, shift;
  bool pos;
  __device__ __forceinline__ Norm(float lo_, float hi, float std, float shift_)
      : lo(lo_), shift(shift_) {
    const float span = __fsub_rn(hi, lo_);
    pos = span > 0.0f;
    // a span of finite log-amplitudes is 0 or above 1e-15 (|log10 y| is 0
    // or above 2.6e-8 for float32 y), so the reciprocal does not overflow
    scale = pos ? __frcp_rn(__fmul_rn(span, std)) : 0.0f;
  }
  __device__ __forceinline__ float operator()(float x) const {
    return pos ? fmaf(__fsub_rn(x, lo), scale, shift) : shift;
  }
};

}  // namespace rfi
