// K6a: y = [relu](conv3x3_SAME(x, W) + b), NHWC float32, and
// K6b: its weight gradient dW[ky, kx] = sum_{n,h,w} xpad[n, h+ky, w+kx, :]^T g[n, h, w, :].
//
// Replaces the TPU kernels of rfi_toolbox_tpu/ops/conv3x3.py: _conv_call
// (body _conv_kernel), which serves conv3x3_bias_relu, conv3x3 and the dx of
// their custom VJP, and _dw_call (body _dw_kernel). Their plain PyTorch
// versions are in ops/conv3x3.py.
//
// K6a is conv3x3_tile.cuh's direct convolution. The TPU kernel keeps a
// whole image, padded, in VMEM; 128 x 128 x 16 float32 is 1 MiB, over the
// 227 KB a block may hold here, so this one tiles the image (see there).
//
// K6b, bound on the H100: operations (2 * 9 * Ci * Co flops per pixel
// against 4 * (Ci + Co) bytes). The TPU kernel revisits one dW block from
// every grid step in order; blocks here run in parallel, so the reduction
// over pixels is split:
// - a block owns 16 input x 32 output channels of all 9 taps (36
//   accumulators a thread: one input channel x 4 output channels x 9 taps)
//   and a contiguous range of pixel segments (up to 128 pixels of one image:
//   whole rows of narrow maps, a 128-pixel run of a wide row);
// - for each segment it stages x with its halo and g in shared memory; a
//   thread walks the segment's rows keeping a 3 x 3 window of x in
//   registers, so each pixel costs it 3 shared loads and one float4 of g
//   for 36 FMAs;
// - the blocks of one channel tile each write their partial dW to a
//   scratch slot of their own, and a second pass sums the slots in a fixed
//   order: no float atomics, so dW is the same bits on every run.
#include "conv3x3_tile.cuh"

namespace {

using namespace rfi;

constexpr int kDwThreads = 128;
constexpr int kDwCI = 16;       // input channels of a block's tile
constexpr int kDwCO = 32;       // output channels of a block's tile
constexpr int kDwPixels = 128;  // pixels of one staged segment
constexpr int kDwMaxCols = 128;
constexpr int kDwTargetBlocks = 4 * 132;  // 4 waves of the H100's 132 SMs
// staged x of a segment of rh rows x twc columns, rh * twc <= 128, with its
// halo: at most (rh + 2) * (twc + 2) = 390 pixels (twc = 1 or 128)
constexpr int kDwXPixels = 390;

struct Segments {
  int twc, rh, col_tiles, row_groups, count;
};

__host__ __device__ inline Segments segments_of(int n, int h, int w) {
  Segments s;
  s.twc = w < kDwMaxCols ? w : kDwMaxCols;
  s.rh = kDwPixels / s.twc;
  s.col_tiles = (w + s.twc - 1) / s.twc;
  s.row_groups = (h + s.rh - 1) / s.rh;
  s.count = n * s.row_groups * s.col_tiles;
  return s;
}

__global__ void __launch_bounds__(kDwThreads)
    conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ partial, int n, int h, int w, int ci,
                      int co, int per_split) {
  __shared__ __align__(16) float s_g[kDwPixels * kDwCO];
  __shared__ float s_x[kDwXPixels * kDwCI];
  const Segments seg = segments_of(n, h, w);
  const int tiles_co = (co + kDwCO - 1) / kDwCO;
  const int ci0 = (blockIdx.x / tiles_co) * kDwCI;
  const int co0 = (blockIdx.x % tiles_co) * kDwCO;
  const int tid = threadIdx.x;
  const int cl = tid % kDwCI;  // the thread's input channel in the tile
  const int oq = tid / kDwCI;  // its quad of output channels
  const int xcols = seg.twc + 2;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.0f;

  const int s_begin = blockIdx.y * per_split;
  const int s_end = min(seg.count, s_begin + per_split);
  for (int s = s_begin; s < s_end; ++s) {
    const int ct = s % seg.col_tiles;
    const int rg = (s / seg.col_tiles) % seg.row_groups;
    const int img = s / (seg.col_tiles * seg.row_groups);
    const int r0 = rg * seg.rh, c0 = ct * seg.twc;
    __syncthreads();  // the previous segment's reads are done
    for (int i = tid; i < (seg.rh + 2) * xcols * kDwCI; i += kDwThreads) {
      const int c = i % kDwCI;
      const int pix = i / kDwCI;
      const int gh = r0 - 1 + pix / xcols, gw = c0 - 1 + pix % xcols;
      const int cc = ci0 + c;
      s_x[i] = (gh >= 0 && gh < h && gw >= 0 && gw < w && cc < ci)
                   ? __ldg(x + ((static_cast<size_t>(img) * h + gh) * w + gw) * ci + cc)
                   : 0.0f;
    }
    for (int i = tid; i < seg.rh * seg.twc * kDwCO; i += kDwThreads) {
      const int j = i % kDwCO;
      const int pix = i / kDwCO;
      const int gh = r0 + pix / seg.twc, gw = c0 + pix % seg.twc;
      const int oc = co0 + j;
      s_g[i] = (gh < h && gw < w && oc < co)
                   ? __ldg(g + ((static_cast<size_t>(img) * h + gh) * w + gw) * co + oc)
                   : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < seg.rh && r0 + r < h; ++r) {
      float win[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][0] = s_x[((r + ky) * xcols + 0) * kDwCI + cl];
        win[ky][1] = s_x[((r + ky) * xcols + 1) * kDwCI + cl];
      }
      for (int col = 0; col < seg.twc; ++col) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][2] = s_x[((r + ky) * xcols + col + 2) * kDwCI + cl];
        }
        const float4 gv =
            *reinterpret_cast<const float4*>(s_g + (r * seg.twc + col) * kDwCO + oq * 4);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float* a = acc[ky * 3 + kx];
            const float v = win[ky][kx];
            a[0] = fmaf(v, gv.x, a[0]);
            a[1] = fmaf(v, gv.y, a[1]);
            a[2] = fmaf(v, gv.z, a[2]);
            a[3] = fmaf(v, gv.w, a[3]);
          }
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
        }
      }
    }
  }

  const int cc = ci0 + cl;
  if (cc >= ci) return;
  float* out = partial + static_cast<size_t>(blockIdx.y) * 9 * ci * co;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = co0 + oq * 4 + j;
      if (oc < co) out[(static_cast<size_t>(t) * ci + cc) * co + oc] = acc[t][j];
    }
  }
}

// dw[i] = sum over the splits, in order, of partial[split][i]
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int splits, size_t total) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s = __fadd_rn(s, partial[k * total + i]);
    dw[i] = s;
  }
}

}  // namespace

// K6a. b may be null (no bias); relu 0 or 1.
extern "C" int rfi_conv3x3(const void* x, const void* w, const void* b, void* y, int n,
                           int h, int wd, int ci, int co, int relu, void* stream) {
  conv::ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.wt = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.y = static_cast<float*>(y);
  a.n = n;
  a.h = h;
  a.w = wd;
  a.ci = ci;
  a.co = co;
  a.relu = relu;
  return static_cast<int>(
      conv::launch_conv<false, false>(a, static_cast<cudaStream_t>(stream)));
}

// K6b's split of the pixel reduction: enough blocks for kDwTargetBlocks,
// at most one split per segment. The caller gives rfi_conv3x3_dw this
// number and, when it is above 1, splits * 9 * ci * co floats of partials.
extern "C" int rfi_conv3x3_dw_splits(int n, int h, int w, int ci, int co, int* splits) {
  if (n <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Segments seg = segments_of(n, h, w);
  const int tiles = ((ci + kDwCI - 1) / kDwCI) * ((co + kDwCO - 1) / kDwCO);
  const int want = (kDwTargetBlocks + tiles - 1) / tiles;
  *splits = seg.count < want ? seg.count : want;
  if (*splits > 65535) *splits = 65535;
  return static_cast<int>(cudaSuccess);
}

// K6b. partial holds splits * 9 * ci * co floats; with splits == 1 it may
// be dw itself, and the second pass is skipped.
extern "C" int rfi_conv3x3_dw(const void* x, const void* g, void* partial, void* dw, int n,
                              int h, int w, int ci, int co, int splits, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || splits <= 0 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const Segments seg = segments_of(n, h, w);
  const int per_split = (seg.count + splits - 1) / splits;
  const int tiles = ((ci + kDwCI - 1) / kDwCI) * ((co + kDwCO - 1) / kDwCO);
  float* first = splits == 1 ? static_cast<float*>(dw) : static_cast<float*>(partial);
  conv3x3_dw_kernel<<<dim3(tiles, splits), kDwThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), first, n, h, w, ci, co,
      per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(9) * ci * co;
  const int blocks = static_cast<int>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(dw), splits, total);
  return static_cast<int>(cudaGetLastError());
}
