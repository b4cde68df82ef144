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
// Design (first, simple version): square tiles up to 128 x 128 take one
// block per (output, plane). The Pallas kernel flips rows with an
// anti-identity matmul because Mosaic has no reverse; here the flip is plain
// index reversal. Variants 0 and 1 copy row by row, coalesced on both
// sides. Variants 2 and 3 stage the tile in shared memory with a row stride
// of h + 1 (66 KB at 128 x 128), so that the transposed reads hit 32
// distinct banks.
//
// Larger tiles (and rectangular ones, which the wrapper of K1 gathers with
// variant 0 for patches above 128 x 128) take plane_gather_tiled_kernel: a
// block per 32 x 32 square of the output, (output, plane) in the grid's y
// (strided past 65535 outputs) and z. Variants 0 and 1 copy the square's
// rows; variants 2 and 3 stage the source square that lands there in a
// 32 x 33 shared tile, read along the source's rows and written along the
// output's (square tiles only: the wrappers never pass a transposing
// variant for h != w).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSide = 128;
constexpr int kTile = 32;   // side of the tiled kernel's squares
constexpr int kTileY = 8;   // thread rows of its blocks (32 x 8 threads)
constexpr int kMaxGridY = 65535;

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

__global__ void __launch_bounds__(kTile * kTileY)
plane_gather_tiled_kernel(const float* __restrict__ grad3,
                          const float* __restrict__ log_amp,
                          const float* __restrict__ phase,
                          const int* __restrict__ base_idx,
                          const int* __restrict__ pidx,
                          const int* __restrict__ variant,
                          float* __restrict__ grad_out,
                          float* __restrict__ amp_out,
                          float* __restrict__ phase_out, int m, int k, int h,
                          int w) {
  __shared__ float tile[kTile][kTile + 1];
  const int tiles_w = (w + kTile - 1) / kTile;
  const int r0 = static_cast<int>(blockIdx.x / tiles_w) * kTile;  // output rows
  const int c0 = static_cast<int>(blockIdx.x % tiles_w) * kTile;   // output columns
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t hw = static_cast<size_t>(h) * w;
  const int plane = blockIdx.z;
  for (int out = blockIdx.y; out < k; out += gridDim.y) {
    const size_t base = base_idx[out];
    const int v = variant[out];
    const float* src;
    float* dst;
    if (plane == 0) {
      src = grad3 + (static_cast<size_t>(pidx[out]) * m + base) * hw;
      dst = grad_out + out * hw;
    } else if (plane == 1) {
      src = log_amp + base * hw;
      dst = amp_out + out * hw;
    } else {
      src = phase + base * hw;
      dst = phase_out + out * hw;
    }
    const bool flip = v == 1 || v == 3;
    const int c = c0 + tx;
    if (v < 2) {  // out[r][c] = src[flip ? h-1-r : r][c]
      for (int a = ty; a < kTile; a += kTileY) {
        const int r = r0 + a;
        if (r < h && c < w) {
          dst[static_cast<size_t>(r) * w + c] =
              src[static_cast<size_t>(flip ? h - 1 - r : r) * w + c];
        }
      }
    } else {
      // out[r][c] = src[c][rr], rr = flip ? h-1-r : r (h == w): the source
      // rows c0.. and columns s0.. hold the square's values
      const int s0 = flip ? h - r0 - kTile : r0;
      for (int i = ty; i < kTile; i += kTileY) {
        const int sr = c0 + i, sc = s0 + tx;
        if (sr < h && sc >= 0 && sc < h) {
          tile[i][tx] = src[static_cast<size_t>(sr) * h + sc];
        }
      }
      __syncthreads();
      for (int a = ty; a < kTile; a += kTileY) {
        const int r = r0 + a;
        if (r < h && c < h) {
          dst[static_cast<size_t>(r) * h + c] = tile[tx][flip ? kTile - 1 - a : a];
        }
      }
    }
    __syncthreads();  // the next output reuses the tile
  }
}

}  // namespace

// grad3: (3, m, h, w), log_amp and phase: (m, h, w) float32; base_idx,
// pidx, variant: (k,) int32 on the card, each base_idx in [0, m), pidx in
// [0, 3) and variant in [0, 4), variants 2 and 3 only where h == w (the
// wrappers check); outputs three (k, h, w) float32. Square tiles up to
// 128 x 128 take one block per (output, plane), others 32 x 32 squares.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_plane_gather_transform(
    const void* grad3, const void* log_amp, const void* phase,
    const void* base_idx, const void* pidx, const void* variant,
    void* grad_out, void* amp_out, void* phase_out, int m, int k, int h,
    int w, void* stream) {
  if (m <= 0 || k <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h != w || h > kMaxSide) {
    const int tiles = ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
    plane_gather_tiled_kernel<<<dim3(tiles, min(k, kMaxGridY), 3), dim3(kTile, kTileY), 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grad3), static_cast<const float*>(log_amp),
        static_cast<const float*>(phase), static_cast<const int*>(base_idx),
        static_cast<const int*>(pidx), static_cast<const int*>(variant),
        static_cast<float*>(grad_out), static_cast<float*>(amp_out),
        static_cast<float*>(phase_out), m, k, h, w);
    return static_cast<int>(cudaGetLastError());
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
