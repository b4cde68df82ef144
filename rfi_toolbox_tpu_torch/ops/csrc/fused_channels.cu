// K4: fused 3-channel extraction, (N, H, W) complex64 or float32 ->
// (N, H, W, 3) float32, ImageNet-normalised.
//
// Replaces the TPU kernel rfi_toolbox_tpu/ops/fused_channels.py
// (fused_extract_channels, body _kernel). Its plain PyTorch version is
// preprocess/pipeline.py: imagenet_normalize(extract_channels(x)), which
// this kernel follows on every input; on real input that means the
// min-max log-amplitude and a zero phase channel, where the TPU kernel
// treats real input as complex with a zero imaginary part.
//
// Bound on the H100: bytes. Per pixel it reads 8 B (complex64) and writes
// 12 B, against some 40 flops and one log10 and one atan2, far below the
// card's 295 flop/B balance point.
//
// Design (first, simple version): one block per patch. The block reads
// re/im straight from the interleaved complex64 input, keeps the f32
// log-amplitude tile in shared memory (64 KB at 128 x 128), reduces the
// gradient's min and max across the block, and writes the three channels
// interleaved as NHWC, so no stack pass follows. The second pass re-reads
// the input for the phase (an L2 hit: the patch is 128 KB). Patches up to
// 128 x 128; the wrapper raises for larger ones.
#include "common.cuh"

namespace {

using namespace rfi;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixels = 128 * 128;

// Forward-difference gradient magnitude with a zero first row/column.
__device__ __forceinline__ float gradient(const float* log_amp, int p, int w) {
  const float la = log_amp[p];
  const float td = (p >= w) ? __fsub_rn(la, log_amp[p - w]) : 0.0f;
  const float fd = (p % w) ? __fsub_rn(la, log_amp[p - 1]) : 0.0f;
  return __fsqrt_rn(__fadd_rn(__fmul_rn(td, td), __fmul_rn(fd, fd)));
}

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
extract_channels_kernel(const float* __restrict__ in, float* __restrict__ out,
                        int h, int w) {
  extern __shared__ float log_amp[];  // h * w
  __shared__ float partial[4][kWarps];
  __shared__ float total[4];

  const int hw = h * w;
  const size_t patch = blockIdx.x;
  const float* src = in + patch * hw * (kComplex ? 2 : 1);
  float* dst = out + patch * hw * 3;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float la_lo = INFINITY, la_hi = -INFINITY;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    float mag;
    if (kComplex) {
      const float2 z = reinterpret_cast<const float2*>(src)[p];
      mag = rfi::magnitude(z.x, z.y);
    } else {
      mag = fabsf(src[p]);
    }
    const float la = log10f(__fadd_rn(mag, 1e-10f));
    log_amp[p] = la;
    la_lo = fminf(la_lo, la);  // fminf/fmaxf skip NaN, like nanmin/nanmax
    la_hi = fmaxf(la_hi, la);
  }
  __syncthreads();

  float g_lo = INFINITY, g_hi = -INFINITY;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float g = gradient(log_amp, p, w);
    g_lo = fminf(g_lo, g);
    g_hi = fmaxf(g_hi, g);
  }
  g_lo = rfi::warp_min(g_lo);
  g_hi = rfi::warp_max(g_hi);
  la_lo = rfi::warp_min(la_lo);
  la_hi = rfi::warp_max(la_hi);
  if (lane == 0) {
    partial[0][warp] = g_lo;
    partial[1][warp] = g_hi;
    partial[2][warp] = la_lo;
    partial[3][warp] = la_hi;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in_range = lane < kWarps;
    float v0 = in_range ? partial[0][lane] : INFINITY;
    float v1 = in_range ? partial[1][lane] : -INFINITY;
    float v2 = in_range ? partial[2][lane] : INFINITY;
    float v3 = in_range ? partial[3][lane] : -INFINITY;
    v0 = rfi::warp_min(v0);
    v1 = rfi::warp_max(v1);
    v2 = rfi::warp_min(v2);
    v3 = rfi::warp_max(v3);
    if (lane == 0) {
      total[0] = v0;
      total[1] = v1;
      total[2] = v2;
      total[3] = v3;
    }
  }
  __syncthreads();
  g_lo = total[0];
  const float g_span = __fsub_rn(total[1], g_lo);
  la_lo = total[2];
  const float la_span = __fsub_rn(total[3], la_lo);

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float g_norm = minmax(gradient(log_amp, p, w), g_lo, g_span);
    float amp_norm, phase_norm;
    if (kComplex) {
      const float2 z = reinterpret_cast<const float2*>(src)[p];
      amp_norm = clip01(__fdiv_rn(__fsub_rn(log_amp[p], kLogMin), kLogSpan));
      phase_norm = __fdiv_rn(__fadd_rn(atan2f(z.y, z.x), kPi), kTwoPi);
    } else {
      amp_norm = minmax(log_amp[p], la_lo, la_span);
      phase_norm = 0.0f;
    }
    float* o = dst + 3 * p;
    o[0] = __fdiv_rn(__fsub_rn(g_norm, kMean0), kStd0);
    o[1] = __fdiv_rn(__fsub_rn(amp_norm, kMean1), kStd1);
    o[2] = __fdiv_rn(__fsub_rn(phase_norm, kMean2), kStd2);
  }
}

}  // namespace

// in: (n, h, w) complex64 (is_complex != 0) or float32; out: (n, h, w, 3)
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_extract_channels(const void* in, void* out, int n,
                                          int h, int w, int is_complex,
                                          void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h * w > kMaxPixels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float);
  auto kernel = is_complex ? extract_channels_kernel<true>
                           : extract_channels_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxPixels * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
