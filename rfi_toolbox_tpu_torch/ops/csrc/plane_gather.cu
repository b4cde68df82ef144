// K3: gather of the selected channel planes with the variant's
// flip/transpose, pure data movement.
//
// Replaces rfi_toolbox_tpu/ops/fused_channels.py
// (fused_plane_gather_transform, bodies _plane_gather_tf_kernel and
// _variant_transform_block). For each of K outputs it reads the gradient
// tile grad3[pidx[i], base_idx[i]] and the log-amplitude and phase tiles
// at base_idx[i], applies variant[i]'s transpose (variants 2, 3) and then
// its row flip (variants 1, 3), and writes three (K, h, h) float32 planes.
// Its plain version is preprocess/static_prep.py: transform_by_variant of
// the gathered planes, and the kernel's output is bit-equal to it.
//
// Bound on the H100: bytes. It reads each distinct selected tile once and
// writes 12 B per output pixel, and does no arithmetic.
//
// Design (first, simple version): one block per (output, plane). The Pallas
// kernel flips rows with an anti-identity matmul because Mosaic has no
// reverse; here the flip is plain index reversal. Variants 0 and 1 copy
// row by row, coalesced on both sides. Variants 2 and 3 stage the tile in
// shared memory with a row stride of h + 1 (66 KB at 128 x 128), so that
// the transposed reads hit 32 distinct banks. Square tiles up to 128 x 128;
// the wrapper raises for others.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSide = 128;

__global__ void __launch_bounds__(kThreads)
plane_gather_transform_kernel(const float* __restrict__ grad3,
                              const float* __restrict__ log_amp,
                              const float* __restrict__ phase,
                              const int* __restrict__ base_idx,
                              const int* __restrict__ pidx,
                              const int* __restrict__ variant,
                              float* __restrict__ grad_out,
                              float* __restrict__ amp_out,
                              float* __restrict__ phase_out, int m, int h) {
  extern __shared__ float tile[];  // h * (h + 1)
  const int hh = h * h;
  const size_t out = blockIdx.x;
  const int plane = blockIdx.y;
  const size_t base = base_idx[out];
  const int v = variant[out];
  const float* src;
  float* dst;
  if (plane == 0) {
    src = grad3 + (static_cast<size_t>(pidx[out]) * m + base) * hh;
    dst = grad_out + out * hh;
  } else if (plane == 1) {
    src = log_amp + base * hh;
    dst = amp_out + out * hh;
  } else {
    src = phase + base * hh;
    dst = phase_out + out * hh;
  }
  const bool flip = v == 1 || v == 3;

  if (v < 2) {  // out[r][c] = src[flip ? h-1-r : r][c]
    for (int p = threadIdx.x; p < hh; p += kThreads) {
      const int r = p / h;
      const int c = p - r * h;
      dst[p] = src[(flip ? h - 1 - r : r) * h + c];
    }
    return;
  }
  for (int p = threadIdx.x; p < hh; p += kThreads) {
    const int r = p / h;
    tile[r * (h + 1) + (p - r * h)] = src[p];
  }
  __syncthreads();
  // transpose, then flip rows: out[r][c] = src[c][flip ? h-1-r : r]
  for (int p = threadIdx.x; p < hh; p += kThreads) {
    const int r = p / h;
    const int c = p - r * h;
    dst[p] = tile[c * (h + 1) + (flip ? h - 1 - r : r)];
  }
}

}  // namespace

// grad3: (3, m, h, h), log_amp and phase: (m, h, h) float32; base_idx, pidx,
// variant: (k,) int32 on the card, each base_idx in [0, m), pidx in [0, 3)
// and variant in [0, 4) (the wrapper checks); outputs three (k, h, h)
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_plane_gather_transform(
    const void* grad3, const void* log_amp, const void* phase,
    const void* base_idx, const void* pidx, const void* variant,
    void* grad_out, void* amp_out, void* phase_out, int m, int k, int h,
    void* stream) {
  if (m <= 0 || k <= 0 || h <= 0 || h > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(h) * (h + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      plane_gather_transform_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSide * (kMaxSide + 1) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_gather_transform_kernel<<<dim3(k, 3), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad3), static_cast<const float*>(log_amp),
      static_cast<const float*>(phase), static_cast<const int*>(base_idx),
      static_cast<const int*>(pidx), static_cast<const int*>(variant),
      static_cast<float*>(grad_out), static_cast<float*>(amp_out),
      static_cast<float*>(phase_out), m, h);
  return static_cast<int>(cudaGetLastError());
}
