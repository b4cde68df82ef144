// K4 and K2 on patches larger than the cluster kernel takes (H * W above
// 128 x 128): two launches over tiles of rows and columns, for any H and W.
//
// Replaces, for those sizes, rfi_toolbox_tpu/ops/fused_channels.py
// fused_extract_channels (K4, body _kernel: (N, H, W) complex64 or float32
// -> (N, H, W, 3) float32, [gradient, log-amplitude, phase] interleaved and
// ImageNet-normalised) and fused_extract_channel_planes (K2, body
// _planes_kernel: the five planes grad3 (3, N, H, W), log-amplitude and
// phase (N, H, W)). The Pallas kernels take a whole (h, w) patch a grid
// step; their plain PyTorch versions are preprocess/pipeline.py:
// imagenet_normalize(extract_channels(x)) and extract_channel_planes(x).
// Real input gets the min-max log-amplitude and a zero phase, as there.
//
// Why not the cluster kernel (channel_planes.cu): it keeps a patch's
// log-amplitude in the shared memory of one cluster, and a 1024 x 1024
// patch's float plane (4 MB) is larger than the distributed shared memory
// of the largest cluster (16 CTAs, some 3.6 MB).
//
// Bound on the H100: bytes. K4 reads 8 B (4 B real) and writes 12 B a
// pixel, K2 writes 20 B. This first design reads the input twice (the
// second read mostly from L2 at (32, 256, 256), from HBM at (128, 1024,
// 1024)) and takes log10|z| of a tile's halo again.
//
// Design. Each block takes a tile of kTileRows x kTileCols pixels of one
// patch (blockIdx.x the tile, blockIdx.y the patch, strided past 65535
// patches) and loads log10|x| of the tile and of one halo row and column
// around it into shared memory; outside the patch nothing is read, and the
// forward differences there are zero as in the plain version.
//   0. init_keys_kernel sets each patch's min keys to all ones and its max
//      keys to zero.
//   1. (kWrite false) each thread squares the gradients of its pixels, the
//      block reduces each plane's min and max (NaN skipped: fminf, fmaxf;
//      of the squares, whose correctly rounded roots order alike) and of
//      real input's log-amplitude, and combines them into the patch's with
//      atomicMin / atomicMax on order-preserving uint32 keys: min and max
//      do not depend on the order, so the result is deterministic.
//   2. (kWrite true) the tile again (complex input's phase taken from the
//      loads into a second shared tile), the gradients' roots normalised by
//      the patch's min and max, the affines folded into one FMA each
//      (common.cuh: Norm, amp_value, phase_value), and the stores: K4 three
//      16-byte streaming stores for 4 pixels' 12 floats, K2 one 16-byte
//      store a plane for 4 pixels. 1-pixel groups where w % 4 != 0 or an
//      output pointer is not 16-byte aligned.
// The magnitude and the gradients are bit-equal to the plain version's
// (common.cuh: magnitude; each square and sum rounded apart, no FMA
// contraction); the folded affines are within a few ulp of its divisions.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace rfi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;
constexpr int kTileCols = 128;
constexpr int kPitch = kTileCols + 2;  // a tile row and its two halo columns
constexpr int kMaxGridY = 65535;
// the kernel's two functions (kKind), numbered as channel_planes.cu's
constexpr int kK2 = 0;
constexpr int kK4 = 2;
// a patch's reduced values: slots 0-2 the squared gradient planes, 3 the
// log-amplitude (real input); keys [2 kSlots b + s] the min of slot s,
// [2 kSlots b + kSlots + s] its max
constexpr int kSlots = 4;

// Order-preserving map of float32 to uint32 (NaN never enters it).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned bits = __float_as_uint(f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void init_keys_kernel(unsigned* __restrict__ keys, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) keys[i] = (i % (2 * kSlots)) < kSlots ? 0xffffffffu : 0u;
}

// log10|x| of rows [r0 - 1, r0 + rows] and columns [c0 - 1, c0 + cols] of
// one patch into `tile` (0 outside the patch, where no difference is
// taken); with kPhase, complex input's phase channel of the tile's own
// pixels into `phase`.
template <bool kComplex, bool kPhase>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* tile,
                                          float* phase, int r0, int c0, int rows,
                                          int cols, int h, int w) {
  const int width = cols + 2;
  for (int i = threadIdx.x; i < (rows + 2) * width; i += kThreads) {
    const int lr = i / width;
    const int lc = i - lr * width;
    const int r = r0 + lr - 1;
    const int c = c0 + lc - 1;
    float la = 0.0f;
    if (r >= 0 && r < h && c >= 0 && c < w) {
      const size_t px = static_cast<size_t>(r) * w + c;
      if constexpr (kComplex) {
        const float2 z = reinterpret_cast<const float2*>(src)[px];
        la = log_amplitude(z);
        if constexpr (kPhase) {
          if (lr >= 1 && lr <= rows && lc >= 1 && lc <= cols) {
            phase[(lr - 1) * kTileCols + lc - 1] = phase_value(z);
          }
        }
      } else {
        la = log10f(__fadd_rn(fabsf(src[px]), 1e-10f));
      }
    }
    tile[lr * kPitch + lc] = la;
  }
}

// The gradients of kPx pixels at tile row lr, column lc (1-based: the halo
// row and column are 0), global row r and column c: g[0] fwd/fwd, g[1]
// down/fwd, g[2] fwd/down (those in `mask`), their squares where kRoot is
// false; la their log-amplitudes. As channel_planes.cu's `gradients`.
template <int kPx, bool kRoot>
__device__ __forceinline__ void tile_gradients(const float* tile, int lr, int lc, int r,
                                               int c, int h, int w, unsigned mask,
                                               float (&g)[3][kPx], float (&la)[kPx]) {
  const float* p = tile + lr * kPitch + lc;
  const bool has_up = r > 0, has_down = r < h - 1;
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    la[i] = p[i];
    const float td_fwd = has_up ? __fsub_rn(la[i], p[i - kPitch]) : 0.0f;
    const float td_down = has_down ? __fsub_rn(p[i + kPitch], la[i]) : 0.0f;
    const float fd_fwd = c + i > 0 ? __fsub_rn(la[i], p[i - 1]) : 0.0f;
    const float fd_down = c + i < w - 1 ? __fsub_rn(p[i + 1], la[i]) : 0.0f;
    const float tf2 = __fmul_rn(td_fwd, td_fwd);
    const float ff2 = __fmul_rn(fd_fwd, fd_fwd);
    if (mask & 1u) g[0][i] = __fadd_rn(tf2, ff2);
    if (mask & 2u) g[1][i] = __fadd_rn(__fmul_rn(td_down, td_down), ff2);
    if (mask & 4u) g[2][i] = __fadd_rn(tf2, __fmul_rn(fd_down, fd_down));
    if constexpr (kRoot) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (mask & (1u << v)) g[v][i] = __fsqrt_rn(g[v][i]);
      }
    }
  }
}

// kK4: out (n, h, w, 3), amp and phase unused. kK2: out = grad3 (3, n, h,
// w), amp and phase (n, h, w). kWrite false: pass 1 (the keys), true: pass
// 2 (the outputs). kPx: pixels a group (4 needs w % 4 == 0).
template <bool kComplex, int kKind, int kPx, bool kWrite>
__global__ void __launch_bounds__(kThreads)
strip_extract_kernel(const float* __restrict__ in, unsigned* __restrict__ keys,
                     float* __restrict__ out, float* __restrict__ amp,
                     float* __restrict__ phase, int n, int h, int w) {
  __shared__ float tile[(kTileRows + 2) * kPitch];
  __shared__ float phase_tile[kComplex && kWrite ? kTileRows * kTileCols : 1];
  __shared__ float part[2 * kSlots][kWarps];
  constexpr unsigned kMask = kKind == kK4 ? 1u : 7u;  // K4: the fwd/fwd gradient only
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tiles_w = (w + kTileCols - 1) / kTileCols;
  const int r0 = static_cast<int>(blockIdx.x / tiles_w) * kTileRows;
  const int c0 = static_cast<int>(blockIdx.x % tiles_w) * kTileCols;
  const int rows = min(kTileRows, h - r0);
  const int cols = min(kTileCols, w - c0);
  const int row_groups = cols / kPx;
  const int groups = rows * row_groups;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t plane = static_cast<size_t>(n) * hw;

  for (int b = blockIdx.y; b < n; b += gridDim.y) {
    load_tile<kComplex, kWrite>(in + static_cast<size_t>(b) * hw * (kComplex ? 2 : 1),
                                tile, phase_tile, r0, c0, rows, cols, h, w);
    __syncthreads();
    unsigned* patch_keys = keys + static_cast<size_t>(b) * 2 * kSlots;
    if constexpr (!kWrite) {
      float lo[kSlots], hi[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        lo[s] = INFINITY;
        hi[s] = -INFINITY;
      }
      for (int g = tid; g < groups; g += kThreads) {
        const int lr = g / row_groups;
        const int q = (g - lr * row_groups) * kPx;
        float gr[3][kPx], la[kPx];
        tile_gradients<kPx, false>(tile, lr + 1, q + 1, r0 + lr, c0 + q, h, w, kMask, gr,
                                   la);
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            if (!(kMask & (1u << v))) continue;
            lo[v] = fminf(lo[v], gr[v][i]);
            hi[v] = fmaxf(hi[v], gr[v][i]);
          }
          if constexpr (!kComplex) {
            lo[3] = fminf(lo[3], la[i]);
            hi[3] = fmaxf(hi[3], la[i]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        lo[s] = warp_min(lo[s]);
        hi[s] = warp_max(hi[s]);
        if (lane == 0) {
          part[s][warp] = lo[s];
          part[kSlots + s][warp] = hi[s];
        }
      }
      __syncthreads();
      if (tid < 2 * kSlots) {  // thread t: slot t % kSlots, its min (t < kSlots) or max
        const int s = tid % kSlots;
        const bool used = s < 3 ? ((kMask >> s) & 1u) != 0 : !kComplex;
        if (used) {
          float v = part[tid][0];
#pragma unroll
          for (int i = 1; i < kWarps; ++i) {
            v = tid < kSlots ? fminf(v, part[tid][i]) : fmaxf(v, part[tid][i]);
          }
          if (tid < kSlots) {
            atomicMin(patch_keys + tid, order_key(v));
          } else {
            atomicMax(patch_keys + tid, order_key(v));
          }
        }
      }
    } else {
      float lo[kSlots], hi[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        lo[s] = key_value(patch_keys[s]);
        hi[s] = key_value(patch_keys[kSlots + s]);
        if (s < 3) {  // the roots of the least and the largest square
          lo[s] = __fsqrt_rn(lo[s]);
          hi[s] = __fsqrt_rn(hi[s]);
        }
      }
      const Norm norm[3] = {Norm(lo[0], hi[0], kStd0, kShift0),
                            Norm(lo[1], hi[1], kStd0, kShift0),
                            Norm(lo[2], hi[2], kStd0, kShift0)};
      const Norm amp_norm(lo[3], hi[3], kStd1, kShift1);
      for (int g = tid; g < groups; g += kThreads) {
        const int lr = g / row_groups;
        const int q = (g - lr * row_groups) * kPx;
        float gr[3][kPx], la[kPx], a[kPx], p[kPx];
        tile_gradients<kPx, true>(tile, lr + 1, q + 1, r0 + lr, c0 + q, h, w, kMask, gr,
                                  la);
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            if (kMask & (1u << v)) gr[v][i] = norm[v](gr[v][i]);
          }
          if constexpr (kComplex) {
            a[i] = amp_value(la[i]);
            p[i] = phase_tile[lr * kTileCols + q + i];
          } else {
            a[i] = amp_norm(la[i]);
            p[i] = kPhaseZero;
          }
        }
        const size_t px = static_cast<size_t>(b) * hw +
                          static_cast<size_t>(r0 + lr) * w + c0 + q;
        if constexpr (kKind == kK4) {
          store_channels<kPx>(out + 3 * px, gr[0], a, p);
        } else {
#pragma unroll
          for (int v = 0; v < 3; ++v) store_out<kPx>(out + v * plane + px, gr[v]);
          store_out<kPx>(amp + px, a);
          store_out<kPx>(phase + px, p);
        }
      }
    }
    __syncthreads();  // the next patch reuses the tiles
  }
}

template <bool kComplex, int kKind, int kPx>
cudaError_t launch(const float* in, unsigned* keys, float* out, float* amp, float* phase,
                   int n, int h, int w, cudaStream_t stream) {
  const int tiles = ((h + kTileRows - 1) / kTileRows) * ((w + kTileCols - 1) / kTileCols);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(min(n, kMaxGridY)));
  const int count = n * 2 * kSlots;
  init_keys_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(keys, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  strip_extract_kernel<kComplex, kKind, kPx, false>
      <<<grid, kThreads, 0, stream>>>(in, keys, out, amp, phase, n, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  strip_extract_kernel<kComplex, kKind, kPx, true>
      <<<grid, kThreads, 0, stream>>>(in, keys, out, amp, phase, n, h, w);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t dispatch(const void* in, void* out, void* amp, void* phase, void* keys, int n,
                     int h, int w, int is_complex, cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(amp) |
                         reinterpret_cast<uintptr_t>(phase);
  const bool vec = w % 4 == 0 && bits % 16 == 0;
  auto args = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const float*>(in), static_cast<unsigned*>(keys),
                         static_cast<float*>(out), static_cast<float*>(amp),
                         static_cast<float*>(phase), n, h, w, stream);
  };
  if (is_complex) {
    return vec ? args(launch<true, kKind, 4>) : args(launch<true, kKind, 1>);
  }
  return vec ? args(launch<false, kKind, 4>) : args(launch<false, kKind, 1>);
}

}  // namespace

// kind 2 (K4): in (n, h, w) complex64 (is_complex != 0) or float32, out (n,
// h, w, 3) float32, amp and phase null. kind 0 (K2): out = grad3 (3, n, h,
// w), amp and phase (n, h, w) float32. keys: n * 8 uint32 of scratch. Any
// h and w. Launches three kernels on `stream` and returns
// cudaGetLastError().
extern "C" int rfi_extract_strips(int kind, const void* in, void* out, void* amp,
                                  void* phase, void* keys, int n, int h, int w,
                                  int is_complex, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kK4) {
    return static_cast<int>(
        dispatch<kK4>(in, out, nullptr, nullptr, keys, n, h, w, is_complex, s));
  }
  if (kind == kK2) {
    return static_cast<int>(dispatch<kK2>(in, out, amp, phase, keys, n, h, w, is_complex, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
