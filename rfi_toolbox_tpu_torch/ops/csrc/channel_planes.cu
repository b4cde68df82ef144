// K2: variant-aware channel planes of base patches, and K1: the same
// extraction fused with the gather of the static selection.
//
// K2 replaces rfi_toolbox_tpu/ops/fused_channels.py
// (fused_extract_channel_planes, body _planes_kernel): (M, H, W) complex64
// or float32 base patches -> five ImageNet-normalised float32 planes, grad3 (3, M, H,
// W) with one gradient per zeroed-edge choice (fwd/fwd, down/fwd,
// fwd/down), log-amplitude (M, H, W) and phase (M, H, W). Its plain PyTorch
// version is preprocess/pipeline.py: extract_channel_planes.
//
// K1 replaces fused_gather_extract (body _gather_kernel): for each of K
// outputs it reads the base patch base_idx[i] and computes the gradient
// plane that pidx[i] selects, plus log-amplitude and phase, into three
// (K, H, W) planes in the base orientation (the caller applies the
// variant's flip/transpose). Its plain version is K2's plain version
// followed by a gather.
//
// Both follow their plain version on real input too, as K4 does: the
// log-amplitude plane is min-max normalised per patch and the phase plane
// is zero (the JAX package calls its TPU kernels on complex input only).
//
// Bound on the H100: bytes. K2 reads 8 B (4 B real) and writes 20 B per
// base pixel; K1 reads each selected base patch's 8 B (4 B) per pixel (the
// distinct ones at least once) and writes 12 B per output pixel. Some 60 flops, a log10 and
// an atan2 per pixel are far below the card's balance point.
//
// Design (first, simple version): one block per patch (K2) or per output
// (K1), as K4. The first pass reads the interleaved complex64 input once,
// keeps log10|z| in a shared-memory tile (64 KB at 128 x 128) and writes
// the amplitude and phase planes, which need no reduction (real input
// writes the phase plane only). The second pass reduces each gradient
// plane's min and max, and the log-amplitude's, across the block; the
// third recomputes the gradients from the tile and writes them normalised
// (and real input's amplitude plane). The
// phase uses atan2f, not the Pallas kernel's polynomial. Every rounding
// step is spelt with a _rn intrinsic so that no FMA contraction separates
// the kernel from its plain version. Patches up to 128 x 128; the wrappers
// raise for larger ones.
#include "common.cuh"

namespace {

using namespace rfi;

constexpr int kThreads = 512;
constexpr int kMaxPixels = 128 * 128;

// Forward differences of the log-amplitude tile at pixel p, zero at the
// edge they cannot reach: td_fwd / fd_fwd zero the first row / column,
// td_down / fd_down the last. Signs differ from np.diff where only the
// square is used.
struct Diffs {
  float td_fwd, td_down, fd_fwd, fd_down;
};

__device__ __forceinline__ Diffs diffs(const float* log_amp, int p, int h, int w) {
  const int r = p / w;
  const int c = p - r * w;
  const float la = log_amp[p];
  Diffs d;
  d.td_fwd = r > 0 ? __fsub_rn(la, log_amp[p - w]) : 0.0f;
  d.td_down = r < h - 1 ? __fsub_rn(log_amp[p + w], la) : 0.0f;
  d.fd_fwd = c > 0 ? __fsub_rn(la, log_amp[p - 1]) : 0.0f;
  d.fd_down = c < w - 1 ? __fsub_rn(log_amp[p + 1], la) : 0.0f;
  return d;
}

// log10(|x| + 1e-10) of pixel p of a complex64 or float32 patch.
template <bool kComplex>
__device__ __forceinline__ float log_amp_at(const float* src, int p) {
  if (kComplex) return log_amplitude(reinterpret_cast<const float2*>(src)[p]);
  return log10f(__fadd_rn(fabsf(src[p]), 1e-10f));
}

// First pass of both kernels: log10|x| into the tile and its min and max
// into la_lo / la_hi (NaN skipped). Complex input writes the amplitude
// plane (fixed window) and the phase plane straight out; real input
// writes the zero phase plane, and its min-max amplitude plane waits for
// the block's la_lo / la_hi.
template <bool kComplex>
__device__ __forceinline__ void amp_phase_pass(const float* __restrict__ src,
                                               float* log_amp,
                                               float* __restrict__ amp,
                                               float* __restrict__ phase,
                                               int hw, float& la_lo,
                                               float& la_hi) {
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float la = log_amp_at<kComplex>(src, p);
    log_amp[p] = la;
    la_lo = fminf(la_lo, la);
    la_hi = fmaxf(la_hi, la);
    if (kComplex) {
      amp[p] = amp_channel(la);
      phase[p] = phase_channel(reinterpret_cast<const float2*>(src)[p]);
    } else {
      phase[p] = affine(0.0f, kMean2, kStd2);
    }
  }
  __syncthreads();
}

// Real input's amplitude plane: log10|x| min-max normalised per patch.
__device__ __forceinline__ float real_amp_channel(float la, float lo, float span) {
  return affine(minmax(la, lo, span), kMean1, kStd1);
}

// kComplex: (n, h, w) complex64 input, else float32.
template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
channel_planes_kernel(const float* __restrict__ in, float* __restrict__ grad3,
                      float* __restrict__ amp, float* __restrict__ phase,
                      int n, int h, int w) {
  extern __shared__ float log_amp[];  // h * w
  const int hw = h * w;
  const size_t patch = blockIdx.x;
  // slots 0-2: the gradient planes; slot 3: log10|x|
  float lo[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  float hi[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  amp_phase_pass<kComplex>(in + patch * hw * (kComplex ? 2 : 1), log_amp,
                           amp + patch * hw, phase + patch * hw, hw, lo[3],
                           hi[3]);

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const Diffs d = diffs(log_amp, p, h, w);
    const float g[3] = {hypot_rn(d.td_fwd, d.fd_fwd),
                        hypot_rn(d.td_down, d.fd_fwd),
                        hypot_rn(d.td_fwd, d.fd_down)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lo[j] = fminf(lo[j], g[j]);
      hi[j] = fmaxf(hi[j], g[j]);
    }
  }
  block_min_max<4>(lo, hi);
  float span[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) span[j] = __fsub_rn(hi[j], lo[j]);

  const size_t plane = static_cast<size_t>(n) * hw;
  float* dst = grad3 + patch * hw;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const Diffs d = diffs(log_amp, p, h, w);
    const float g[3] = {hypot_rn(d.td_fwd, d.fd_fwd),
                        hypot_rn(d.td_down, d.fd_fwd),
                        hypot_rn(d.td_fwd, d.fd_down)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dst[j * plane + p] = affine(minmax(g[j], lo[j], span[j]), kMean0, kStd0);
    }
    if (!kComplex) amp[patch * hw + p] = real_amp_channel(log_amp[p], lo[3], span[3]);
  }
}

// The gradient plane that pidx selects: 0 fwd/fwd, 1 down/fwd, 2 fwd/down.
__device__ __forceinline__ float selected_gradient(const Diffs& d, int v) {
  return hypot_rn(v == 1 ? d.td_down : d.td_fwd, v == 2 ? d.fd_down : d.fd_fwd);
}

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
gather_extract_kernel(const float* __restrict__ in,
                      const int* __restrict__ base_idx,
                      const int* __restrict__ pidx, float* __restrict__ grad,
                      float* __restrict__ amp, float* __restrict__ phase, int h,
                      int w) {
  extern __shared__ float log_amp[];  // h * w
  const int hw = h * w;
  const size_t out = blockIdx.x;
  const size_t base = base_idx[out];
  const int v = pidx[out];
  // slot 0: the selected gradient plane; slot 1: log10|x|
  float lo[2] = {INFINITY, INFINITY};
  float hi[2] = {-INFINITY, -INFINITY};
  amp_phase_pass<kComplex>(in + base * hw * (kComplex ? 2 : 1), log_amp,
                           amp + out * hw, phase + out * hw, hw, lo[1], hi[1]);

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float g = selected_gradient(diffs(log_amp, p, h, w), v);
    lo[0] = fminf(lo[0], g);
    hi[0] = fmaxf(hi[0], g);
  }
  block_min_max<2>(lo, hi);
  const float span = __fsub_rn(hi[0], lo[0]);
  const float la_span = __fsub_rn(hi[1], lo[1]);

  float* dst = grad + out * hw;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float g = selected_gradient(diffs(log_amp, p, h, w), v);
    dst[p] = affine(minmax(g, lo[0], span), kMean0, kStd0);
    if (!kComplex) amp[out * hw + p] = real_amp_channel(log_amp[p], lo[1], la_span);
  }
}

cudaError_t allow_tile(const void* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxPixels * sizeof(float)));
}

}  // namespace

// in: (n, h, w) complex64 (is_complex != 0) or float32; grad3: (3, n, h,
// w), amp and phase: (n, h, w) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rfi_fused_extract_channel_planes(const void* in, void* grad3,
                                                void* amp, void* phase, int n,
                                                int h, int w, int is_complex,
                                                void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h * w > kMaxPixels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = is_complex ? channel_planes_kernel<true>
                           : channel_planes_kernel<false>;
  cudaError_t err = allow_tile(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float);
  kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(grad3),
      static_cast<float*>(amp), static_cast<float*>(phase), n, h, w);
  return static_cast<int>(cudaGetLastError());
}

// in: (m, h, w) complex64 (is_complex != 0) or float32 base patches;
// base_idx, pidx: (k,) int32 on the card, each base_idx in [0, m) and pidx
// in [0, 3) (the wrapper checks); grad, amp, phase: (k, h, w) float32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_gather_extract(const void* in, const void* base_idx,
                                        const void* pidx, void* grad, void* amp,
                                        void* phase, int k, int h, int w,
                                        int is_complex, void* stream) {
  if (k <= 0 || h <= 0 || w <= 0 || h * w > kMaxPixels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = is_complex ? gather_extract_kernel<true>
                           : gather_extract_kernel<false>;
  cudaError_t err = allow_tile(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float);
  kernel<<<k, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const int*>(base_idx),
      static_cast<const int*>(pidx), static_cast<float*>(grad),
      static_cast<float*>(amp), static_cast<float*>(phase), h, w);
  return static_cast<int>(cudaGetLastError());
}
