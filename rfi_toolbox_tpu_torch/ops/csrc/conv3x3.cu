// K6a: y = [relu](conv3x3_SAME(x, W) + b), NHWC float32, and
// K6b: its weight gradient dW[ky, kx] = sum_{n,h,w} xpad[n, h+ky, w+kx, :]^T g[n, h, w, :].
//
// Replaces the TPU kernels of rfi_toolbox_tpu/ops/conv3x3.py: _conv_call
// (body _conv_kernel), which serves conv3x3_bias_relu, conv3x3 and the dx of
// their custom VJP, and _dw_call (body _dw_kernel). Their plain PyTorch
// versions are in ops/conv3x3.py.
//
// K6a is conv3x3_mma.cuh's implicit GEMM on the tensor cores in 3xTF32,
// as K7's convolutions, with a bias + ReLU epilogue and the kChunkSums
// accumulation: each 8-channel chunk's MMAs sum into a zeroed fragment
// that is added to the running sum in round-to-nearest, which keeps the
// tensor cores' truncating accumulation within K6a's 1e-5 gate at up to
// 512 input channels (see there). The TPU kernel keeps a whole image,
// padded, in VMEM; 128 x 128 x 16 float32 is 1 MiB, over the 227 KB a
// block may hold here, so this one tiles the image.
//
// K6b, bound on the H100: operations (2 * 9 * Ci * Co flops per pixel
// against 4 * (Ci + Co) bytes). It is an implicit GEMM on the tensor
// cores in 3xTF32 (mma_tf32.cuh: float32 accuracy):
//   dW^T (Co x 9 Ci) = G^T (Co x P) . X (P x 9 Ci),  P = N H W pixels,
// where column (tap, i) of X is input channel i shifted by the tap. A
// block owns 32 or 64 output channels x 32 input channels x all 9 taps
// (288 columns; with Ci <= 3, the first layer, the 9 Ci columns are packed
// into 32 so that few idle), and a range of pixel chunks: 64 pixels of
// one image (8 x 8 at 8 px wide, else 4 x 16).
// - cp.async stages each chunk in a 2-stage ring: g once, x once with its
//   1-pixel halo (zeros outside the image and past the channels), so the
//   copies of the next chunk overlap the MMAs of this one; a thread copies
//   a fixed 16-byte part of a column, row by row, with no division;
// - a warp reads its A fragments (g) once per 8 pixels and its B fragments
//   from the one staged x tile at each column's tap offset: the 9 taps
//   share the staged g and x, and 26 fragment values, split into hi and
//   lo, feed 54 m16n8k8 MMAs (2 x 9 tiles of 16 x 8, 3 MMAs each), sent
//   as all lo*hi, then all hi*lo, then all hi*hi (mma3_tiles); the loop is
//   bound by latency, so two blocks an SM matter more than spilling none;
// - the shared rows are padded to 8 mod 32 floats, so the fragment loads
//   of a warp hit 32 distinct banks;
// - the pixel reduction is split over blocks, at most 16 chunks a split:
//   the tensor cores' float32 accumulation truncates, so its error grows
//   with the length of a chain (tools/conv_kernel_turns.py, H100 80GB
//   HBM3 at 700 W: 5.1e-6, 8.4e-6 and 1.6e-5 of max |dW| at 8, 16 and 32
//   chunks, for 1.089x, 1.017x and 1x the time). Each block writes its
//   partial dW to a scratch slot of its own and a second pass sums the
//   slots in a fixed order: no float atomics, so dW is the same bits on
//   every run.
#include <type_traits>

#include "conv3x3_mma.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace rfi;

constexpr int kDwStages = 2;
constexpr int kDwPixels = 64;       // pixels of one chunk
constexpr int kDwMaxCols = 16;      // chunk width, a multiple of 8
constexpr int kDwXPixels = 6 * 18;  // most staged x pixels, (rh + 2)(cw + 2)
constexpr int kDwTargetBlocks = 4 * 132;  // 4 waves of the H100's 132 SMs
constexpr int kDwMaxChain = 16;           // chunks a split accumulates, at most

// A chunk is rh rows x cw columns of one image, cw = W rounded up to 8 (at
// most 16); pixels past the image's edge are staged with g = 0.
struct Chunks {
  int cw, rh, col_tiles, row_groups, count;
};

__host__ __device__ inline Chunks chunks_of(int n, int h, int w) {
  Chunks c;
  const int w8 = (w + 7) / 8 * 8;
  c.cw = w8 < kDwMaxCols ? w8 : kDwMaxCols;
  c.rh = kDwPixels / c.cw;
  c.col_tiles = (w + c.cw - 1) / c.cw;
  c.row_groups = (h + c.rh - 1) / c.rh;
  c.count = n * c.row_groups * c.col_tiles;
  return c;
}

// A block's tile: CO_T output channels (M) x 8 NT WN (tap, channel)
// columns (N), WM x WN warps of CO_T / WM x 8 NT each; XS is the staged
// x's per-pixel stride in floats.
template <int CO_T, int WM, int WN, int NT, int XS>
struct DwTile {
  static constexpr int kCoT = CO_T, kWM = WM, kNT = NT, kXS = XS;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMT = CO_T / (16 * WM);  // m16 tiles of a warp
  static constexpr int kCols = 8 * NT * WN;
  static constexpr int kCib = kCols / 9 < 32 ? kCols / 9 : 32;  // input channels
  static constexpr int kGS = CO_T + 8;  // staged g's per-pixel stride
  static constexpr int kXFloats = kDwXPixels * XS;
  static constexpr int kStage = kXFloats + kDwPixels * kGS;
  static constexpr int kSmemBytes = kDwStages * kStage * 4;
  static_assert(CO_T % (16 * WM) == 0, "whole m16 tiles");
  static_assert(XS % 4 == 0 && kGS % 4 == 0, "16-byte rows");
  static_assert(XS >= kCib, "staged channels");
};

using DwBig = DwTile<64, 2, 4, 9, 40>;     // Co > 32
using DwNarrow = DwTile<32, 1, 4, 9, 40>;  // Co <= 32
using DwSmall = DwTile<32, 1, 4, 1, 8>;    // Ci <= 3: 9 Ci columns of 32

enum DwKind { kBig, kNarrow, kSmall };

inline DwKind dw_kind(int ci, int co) {
  if (ci <= 3) return kSmall;
  return co <= 32 ? kNarrow : kBig;
}

template <typename T>
inline int dw_tiles(int ci, int co) {
  const int cib = ci < T::kCib ? ci : T::kCib;
  return ((ci + cib - 1) / cib) * ((co + T::kCoT - 1) / T::kCoT);
}

inline int dw_tiles_of(int ci, int co) {
  switch (dw_kind(ci, co)) {
    case kSmall: return dw_tiles<DwSmall>(ci, co);
    case kNarrow: return dw_tiles<DwNarrow>(ci, co);
    default: return dw_tiles<DwBig>(ci, co);
  }
}

// Stage chunk `chunk` of the block's (ci0, co0) tile into buf: x with halo
// at [pixel * XS + channel], g at [kXFloats + pixel * kGS + channel]. A
// thread copies a fixed 16-byte part (or channel) of a column, row by
// row: no division a copy (a division a copy cost K6b a tenth of its
// time on the H100).
template <typename T>
__device__ __forceinline__ void dw_stage(float* buf, const float* __restrict__ x,
                                         const float* __restrict__ g, const Chunks& geo,
                                         int chunk, int h, int w, int ci, int co, int ci0,
                                         int cib, int co0) {
  const int ct = chunk % geo.col_tiles;
  const int rg = (chunk / geo.col_tiles) % geo.row_groups;
  const int img = chunk / (geo.col_tiles * geo.row_groups);
  const int r0 = rg * geo.rh, c0 = ct * geo.cw;
  const int xw = geo.cw + 2, xh = geo.rh + 2;
  const float* ximg = x + static_cast<size_t>(img) * h * w * ci;
  const float* gimg = g + static_cast<size_t>(img) * h * w * co;
  // x: one thread per (column, part), rows 0..xh-1: 16-byte parts if
  // ci % 4 == 0 (then cib % 4 == 0 and ci0 % 4 == 0), else channels
  auto columns = [&](auto width, auto parts) {
    constexpr int kW = decltype(width)::value, kParts = decltype(parts)::value;
    const int c = (threadIdx.x % kParts) * kW;
    if (c >= cib) return;
    for (int col = threadIdx.x / kParts; col < xw; col += T::kThreads / kParts) {
      const int gw = c0 - 1 + col;
      const bool in = gw >= 0 && gw < w && ci0 + c < ci;
      const float* src = in ? ximg + static_cast<size_t>(gw) * ci + ci0 + c : x;
      float* dst = buf + col * T::kXS + c;
      for (int r = 0; r < xh; ++r) {
        const int gh = r0 - 1 + r;
        const bool ok = in && gh >= 0 && gh < h;
        const float* from = ok ? src + static_cast<size_t>(gh) * w * ci : x;
        if constexpr (kW == 4) {
          tf32::copy16(dst + r * xw * T::kXS, from, ok);
        } else {
          tf32::copy4(dst + r * xw * T::kXS, from, ok);
        }
      }
    }
  };
  if (ci % 4 == 0) {
    columns(std::integral_constant<int, 4>(),
            std::integral_constant<int, (T::kCib >= 4 ? T::kCib / 4 : 1)>());
  } else {
    columns(std::integral_constant<int, 1>(), std::integral_constant<int, T::kCib>());
  }
  // g: the chunk's kDwPixels pixels, cw (8 or 16) a row
  float* gs = buf + T::kXFloats;
  const int shift = geo.cw == 16 ? 4 : 3;
  if (co % 4 == 0) {
    constexpr int q = T::kCoT / 4;
    const int j = (threadIdx.x % q) * 4;
    for (int p = threadIdx.x / q; p < kDwPixels; p += T::kThreads / q) {
      const int gh = r0 + (p >> shift), gw = c0 + (p & (geo.cw - 1));
      const bool ok = gh < h && gw < w && co0 + j < co;
      tf32::copy16(gs + p * T::kGS + j,
                   ok ? gimg + (static_cast<size_t>(gh) * w + gw) * co + co0 + j : g, ok);
    }
  } else {
    const int j = threadIdx.x % T::kCoT;
    for (int p = threadIdx.x / T::kCoT; p < kDwPixels; p += T::kThreads / T::kCoT) {
      const int gh = r0 + (p >> shift), gw = c0 + (p & (geo.cw - 1));
      const bool ok = gh < h && gw < w && co0 + j < co;
      tf32::copy4(gs + p * T::kGS + j,
                  ok ? gimg + (static_cast<size_t>(gh) * w + gw) * co + co0 + j : g, ok);
    }
  }
}

// Two blocks an SM: at most 128 registers a thread for the 256 threads of
// DwBig (a few spill), which the second block's warps repay in hidden
// latency.
template <typename T>
__global__ void __launch_bounds__(T::kThreads, 2)
    conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ partial, int n, int h, int w, int ci, int co,
                      int per_split) {
  constexpr int kMT = T::kMT, NT = T::kNT, XS = T::kXS, GS = T::kGS;
  float* smem = tf32::dynamic_smem();
  const Chunks geo = chunks_of(n, h, w);
  const int cib = ci < T::kCib ? ci : T::kCib;
  const int tiles_co = (co + T::kCoT - 1) / T::kCoT;
  const int ci0 = (blockIdx.x / tiles_co) * cib;
  const int co0 = (blockIdx.x % tiles_co) * T::kCoT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % T::kWM, wn = warp / T::kWM;
  const int xw = geo.cw + 2;

  // the x offset of this lane's B column (tap, channel) in each n8 tile;
  // columns past 9 cib read channel 0 and are not stored
  int boff[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = (wn * NT + t) * 8 + gid;
    const int tap = col / cib, cl = col % cib;
    boff[t] = tap < 9 ? ((tap / 3) * xw + tap % 3) * XS + cl : 0;
  }

  float acc[kMT][NT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.0f;

  const int c_begin = blockIdx.y * per_split;
  const int chunks = max(0, min(geo.count, c_begin + per_split) - c_begin);
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < chunks) {
      dw_stage<T>(smem + s * T::kStage, x, g, geo, c_begin + s, h, w, ci, co, ci0, cib, co0);
    }
    tf32::commit();
  }
  for (int i = 0; i < chunks; ++i) {
    tf32::wait<kDwStages - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();              // everyone's, and chunk i - 1 is consumed
    const int next = i + kDwStages - 1;
    if (next < chunks) {
      dw_stage<T>(smem + (next % kDwStages) * T::kStage, x, g, geo, c_begin + next, h, w,
                  ci, co, ci0, cib, co0);
    }
    tf32::commit();
    const float* xs = smem + (i % kDwStages) * T::kStage;
    const float* gs = xs + T::kXFloats + wm * kMT * 16 + gid;
    for (int r = 0, p = 0; r < geo.rh; ++r) {
      for (int c = 0; c < geo.cw; c += 8, p += 8) {  // pixels p..p+7: row r, c..c+7
        uint32_t ah[kMT][4], al[kMT][4];
        const float* ga = gs + (p + tig) * GS;
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          tf32::split(ga[mi * 16], ah[mi][0], al[mi][0]);
          tf32::split(ga[mi * 16 + 8], ah[mi][1], al[mi][1]);
          tf32::split(ga[4 * GS + mi * 16], ah[mi][2], al[mi][2]);
          tf32::split(ga[4 * GS + mi * 16 + 8], ah[mi][3], al[mi][3]);
        }
        const float* xb = xs + (r * xw + c + tig) * XS;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          tf32::split(xb[boff[t]], bh[t][0], bl[t][0]);
          tf32::split(xb[4 * XS + boff[t]], bh[t][1], bl[t][1]);
        }
        tf32::mma3_tiles(acc, ah, al, bh, bl);
      }
    }
  }
  tf32::wait<0>();

  float* out = partial + static_cast<size_t>(blockIdx.y) * 9 * ci * co;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int oc = co0 + wm * kMT * 16 + mi * 16 + gid + (e >= 2 ? 8 : 0);
        const int col = (wn * NT + t) * 8 + 2 * tig + (e & 1);
        const int tap = col / cib, cc = ci0 + col % cib;
        if (tap < 9 && cc < ci && oc < co) {
          out[(static_cast<size_t>(tap) * ci + cc) * co + oc] = acc[mi][t][e];
        }
      }
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

template <typename T>
cudaError_t launch_dw(const float* x, const float* g, float* out, int n, int h, int w, int ci,
                      int co, int splits, int per_split, cudaStream_t s) {
  cudaError_t err = tf32::allow_smem<&conv3x3_dw_kernel<T>>(T::kSmemBytes);
  if (err != cudaSuccess) return err;
  conv3x3_dw_kernel<T><<<dim3(dw_tiles<T>(ci, co), splits), T::kThreads, T::kSmemBytes, s>>>(
      x, g, out, n, h, w, ci, co, per_split);
  return cudaGetLastError();
}

}  // namespace

// K6a. b may be null (no bias); relu 0 or 1.
extern "C" int rfi_conv3x3(const void* x, const void* w, const void* b, void* y, int n,
                           int h, int wd, int ci, int co, int relu, void* stream) {
  mmaconv::ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.wt = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(b);
  a.y = static_cast<float*>(y);
  a.n = n;
  a.h = h;
  a.w = wd;
  a.ci = ci;
  a.co = co;
  a.relu = relu;
  return static_cast<int>(
      mmaconv::launch_conv<false, false, true>(a, static_cast<cudaStream_t>(stream)));
}

// K6b's split of the pixel reduction: enough blocks for kDwTargetBlocks
// and at most kDwMaxChain chunks a split, at most one split per chunk. The
// caller gives rfi_conv3x3_dw this number and, when it is above 1,
// splits * 9 * ci * co floats of partials.
extern "C" int rfi_conv3x3_dw_splits(int n, int h, int w, int ci, int co, int* splits) {
  if (n <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chunks geo = chunks_of(n, h, w);
  const int tiles = dw_tiles_of(ci, co);
  int want = (kDwTargetBlocks + tiles - 1) / tiles;
  const int chained = (geo.count + kDwMaxChain - 1) / kDwMaxChain;
  if (chained > want) want = chained;
  int k = geo.count < want ? geo.count : want;
  if (k > 65535) k = 65535;
  const int per_split = (geo.count + k - 1) / k;
  *splits = (geo.count + per_split - 1) / per_split;  // none left empty
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
  const Chunks geo = chunks_of(n, h, w);
  const int per_split = (geo.count + splits - 1) / splits;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const float*>(g);
  float* first = splits == 1 ? static_cast<float*>(dw) : static_cast<float*>(partial);
  cudaError_t err;
  switch (dw_kind(ci, co)) {
    case kSmall:
      err = launch_dw<DwSmall>(xp, gp, first, n, h, w, ci, co, splits, per_split, s);
      break;
    case kNarrow:
      err = launch_dw<DwNarrow>(xp, gp, first, n, h, w, ci, co, splits, per_split, s);
      break;
    default:
      err = launch_dw<DwBig>(xp, gp, first, n, h, w, ci, co, splits, per_split, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(9) * ci * co;
  const int blocks = static_cast<int>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(dw), splits, total);
  return static_cast<int>(cudaGetLastError());
}
