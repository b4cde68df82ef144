// The 3x3 convolution forward on the tensor cores, in 3xTF32
// (mma_tf32.cuh: float32 accuracy), for K6a (conv3x3.cu: bias, ReLU) and
// K7 (double_conv_gn.cu: the GroupNorm options). NHWC float32
// activations, HWIO weights, SAME padding:
//
//   y[n, h, w, o] = sum_{ky, kx, i} x[n, h + ky - 1, w + kx - 1, i] * W[ky, kx, i, o]
//
// Bound on the H100: operations. At the UNet's shapes a layer does
// 2 * 9 * Ci flops per output value against 4 * (Ci + Co) / Co bytes.
// The design is an implicit GEMM, M = a tile of output pixels, N = a tile
// of output channels, K = 9 Ci taken one tap x 8 input channels at a time:
//
// - A block of 4 warps computes TH x TW pixels x CO_T channels; a warp a
//   (TH TW / WM) x (CO_T / WN) slab of m16n8k8 tiles: 32 to 64
//   accumulators a thread.
// - The input channels go by in chunks of 8. cp.async stages each chunk's
//   (TH + 2) x (TW + 2) input tile with its 1-pixel halo (zeros outside
//   the image and past Ci) and its 9 x 8 x CO_T weights in a 2-stage
//   ring, so the copies of the next chunk overlap this one's MMAs; two
//   stages rather than three leave room for 3-4 blocks an SM, and the
//   extra warps hide more latency than a deeper ring (measured).
// - Each of the 9 taps reads its A fragments from the one staged input
//   tile at the tap's offset, and its B fragments from the staged
//   weights; both are split into hi and lo in registers. A tap's MMAs go
//   out as all lo*hi, then all hi*lo, then all hi*hi, so that the three
//   dependent MMAs of a product are never back to back. Rows are padded
//   (12 floats a pixel, CO_T + 8 a weight row) so that the fragment loads
//   of a warp hit 32 distinct banks. The loop is bound by latency and
//   occupancy, not by the tensor cores' rate nor by its instruction count:
//   splitting the input once per chunk in shared memory, which takes a
//   third of the instructions off, was slower (it cost a block an SM).
// - The tile follows the output: 16 x 16 pixels for Co <= 16, 8 x 16 for
//   Co <= 32 and above, 8 x 8 where the image is at most 8 wide. Ragged Ci
//   and Co are zero-filled in shared memory and masked on store.
//
// The tensor cores add an MMA's products to its float32 accumulator and
// truncate the sum, so one accumulator over all 9 Ci products of an
// output drifts toward zero as Ci grows (in the CPU emulation of
// tests/test_torch_conv3x3.py, 2e-5 of the output's max at 256 input
// channels, 5e-5 at 512). The kChunkSums option (K6a) accumulates each
// chunk's 27 MMAs into a zeroed fragment and adds that to the running sum
// with an ordinary float32 add, which rounds to nearest: 8e-7 at either
// width in the emulation, for a second set of accumulators in registers. K7
// keeps the one accumulator, its error inside its 1e-4 gate. With the
// second set, the 64-accumulator TileWide runs 2 blocks an SM
// (TileWideSums: 255 registers, no spills): over K6a's 18 layers of the
// folded UNet16 that took 4.93-4.95 ms against 5.10 at 3 blocks (552
// bytes spilled) and 5.38-5.42 with 8 warps a block of 32 accumulators
// (tools/conv_kernel_turns.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// K6a's epilogue adds the bias (ConvArgs::bias, may be null) and applies
// the ReLU (ConvArgs::relu) before the store. Two options serve K7's
// GroupNorm without a pass of its own:
// - kStats: the block also reduces each output channel's sum and sum of
//   squares over its pixels, in float64, in a fixed order (a thread's
//   rows, then the 8 row groups of a warp by shuffles, then the warps in
//   order), and writes them to stats[(n * tiles + tile) * Co + o]; no
//   atomics, so runs are reproducible.
// - kGnIn: the input is a raw conv output, normalised by its image's
//   per-group mean and 1/sqrt(var + eps) (reduced from the kStats
//   partials by double_conv_gn.cu once per image); once a chunk has
//   landed the block applies relu((v - mean) * rstd * gamma + beta) in
//   shared memory to its in-image values only: the SAME padding stays
//   zero, as after the ReLU (relu(GN(0)) is not). A thread keeps one
//   channel of the chunk, so the pass is a few instructions a value.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace rfi {
namespace mmaconv {

constexpr int kStages = 2;
constexpr int kKC = 8;   // input channels of a chunk
constexpr int kXS = 12;  // staged input's per-pixel stride (floats)
constexpr int kMaxGroups = 64;

struct ConvArgs {
  const float* x;   // (n, h, w, ci)
  const float* wt;  // (3, 3, ci, co)
  float* y;         // (n, h, w, co)
  int n, h, w, ci, co;
  double2* stats_out;   // kStats: (n, tiles, co) (sum, sum of squares)
  const float2* gn_in;  // kGnIn: (n, groups) (mean, 1/sqrt(var + eps)) of x
  const float* gamma;   // kGnIn: (ci,)
  const float* beta;    // kGnIn: (ci,)
  int groups;           // kGnIn: groups of ci
  const float* bias;    // (co,) added before the store, or null
  int relu;             // 1: max(y, 0) before the store
};

template <int TH, int TW, int CO_T, int WM, int WN, int MAXB = 4>
struct Tile {
  static constexpr int kTH = TH, kTW = TW, kCoT = CO_T, kWM = WM;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMT = TH * TW / (16 * WM);  // m16 tiles of a warp
  static constexpr int kNT = CO_T / (8 * WN);      // n8 tiles of a warp
  static constexpr int kXW = TW + 2;
  static constexpr int kXPixels = (TH + 2) * kXW;
  static constexpr int kWS = CO_T + 8;  // staged weights' row stride
  static constexpr int kXFloats = kXPixels * kXS;  // staged input
  static constexpr int kStage = kXFloats + 9 * kKC * kWS;
  static constexpr int kSmemBytes = kStages * kStage * 4;
  static_assert(TH * TW % (16 * WM) == 0 && CO_T % (8 * WN) == 0, "whole MMA tiles");
  static_assert(TW % 8 == 0, "8 pixels of an m16 half lie in one row");
  static_assert(kStage % 4 == 0 && kWS % 4 == 0, "16-byte rows");
  // blocks an SM should hold: as many as the shared memory allows, at most
  // MAXB (4: 128 registers a thread). More warps hide more of the latency
  // the loop is bound by; a few spilled registers cost less (measured on
  // the H100).
  static constexpr int kMinBlocks =
      232448 / (kSmemBytes + 1024) < MAXB ? 232448 / (kSmemBytes + 1024) : MAXB;
};

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
}

// Stage input channels c0..c0+7 of the block's tile into buf: the input
// with halo at [pixel * kXS + channel], the weights at
// [kXFloats + (tap * 8 + channel) * kWS + o].
template <typename T>
__device__ __forceinline__ void stage(float* buf, const ConvArgs& a, int n, int h0, int w0,
                                      int co0, int c0) {
  const float* ximg = a.x + static_cast<size_t>(n) * a.h * a.w * a.ci;
  if (a.ci % 4 == 0) {
    for (int i = threadIdx.x; i < T::kXPixels * 2; i += T::kThreads) {
      const int pix = i / 2, c = (i % 2) * 4;
      const int gh = h0 - 1 + pix / T::kXW, gw = w0 - 1 + pix % T::kXW;
      const bool ok = gh >= 0 && gh < a.h && gw >= 0 && gw < a.w && c0 + c < a.ci;
      tf32::copy16(buf + pix * kXS + c,
                   ok ? ximg + (static_cast<size_t>(gh) * a.w + gw) * a.ci + c0 + c : a.x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < T::kXPixels * kKC; i += T::kThreads) {
      const int pix = i / kKC, c = i % kKC;
      const int gh = h0 - 1 + pix / T::kXW, gw = w0 - 1 + pix % T::kXW;
      const bool ok = gh >= 0 && gh < a.h && gw >= 0 && gw < a.w && c0 + c < a.ci;
      tf32::copy4(buf + pix * kXS + c,
                  ok ? ximg + (static_cast<size_t>(gh) * a.w + gw) * a.ci + c0 + c : a.x, ok);
    }
  }
  float* ws = buf + T::kXFloats;
  if (a.co % 4 == 0) {
    constexpr int q = T::kCoT / 4;
    for (int i = threadIdx.x; i < 9 * kKC * q; i += T::kThreads) {
      const int row = i / q, j = (i % q) * 4;  // row = tap * 8 + channel
      const int tap = row / kKC, c = row % kKC;
      const bool ok = c0 + c < a.ci && co0 + j < a.co;
      tf32::copy16(ws + row * T::kWS + j,
                   ok ? a.wt + (static_cast<size_t>(tap) * a.ci + c0 + c) * a.co + co0 + j
                      : a.wt,
                   ok);
    }
  } else {
    for (int i = threadIdx.x; i < 9 * kKC * T::kCoT; i += T::kThreads) {
      const int row = i / T::kCoT, j = i % T::kCoT;
      const int tap = row / kKC, c = row % kKC;
      const bool ok = c0 + c < a.ci && co0 + j < a.co;
      tf32::copy4(ws + row * T::kWS + j,
                  ok ? a.wt + (static_cast<size_t>(tap) * a.ci + c0 + c) * a.co + co0 + j
                     : a.wt,
                  ok);
    }
  }
}

template <typename T, bool kStats, bool kGnIn, bool kChunkSums>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) conv3x3_mma_kernel(ConvArgs a) {
  constexpr int kMT = T::kMT, kNT = T::kNT, kXW = T::kXW, kWS = T::kWS;
  float* smem = tf32::dynamic_smem();
  __shared__ float s_mean[kGnIn ? kMaxGroups : 1];
  __shared__ float s_rstd[kGnIn ? kMaxGroups : 1];

  const int tiles_w = (a.w + T::kTW - 1) / T::kTW;
  const int tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * T::kTH;
  const int w0 = (tile % tiles_w) * T::kTW;
  const int co0 = blockIdx.y * T::kCoT;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % T::kWM, wn = warp / T::kWM;
  const int m0 = wm * kMT * 16;  // the warp's first pixel of the tile
  const int n0 = wn * kNT * 8;   // its first channel of the tile

  if constexpr (kGnIn) {  // read after the main loop's first barrier
    for (int g = threadIdx.x; g < a.groups; g += T::kThreads) {
      const float2 v = a.gn_in[n * a.groups + g];
      s_mean[g] = v.x;
      s_rstd[g] = v.y;
    }
  }

  // staged-input offsets of the lane's A rows gid and gid + 8 at tap (0, 0)
  int aoff[kMT][2];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pm = m0 + mi * 16 + half * 8 + gid;
      aoff[mi][half] = ((pm / T::kTW) * kXW + pm % T::kTW) * kXS + tig;
    }
  }

  float acc[kMT][kNT][4];
  zero(acc);
  float part[kMT][kNT][4];  // kChunkSums: this chunk's sums

  const int chunks = (a.ci + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage<T>(smem + s * T::kStage, a, n, h0, w0, co0, s * kKC);
    tf32::commit();
  }
  for (int i = 0; i < chunks; ++i) {
    tf32::wait<kStages - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();            // everyone's, and chunk i - 1 is consumed
    const int next = i + kStages - 1;
    if (next < chunks) {
      stage<T>(smem + (next % kStages) * T::kStage, a, n, h0, w0, co0, next * kKC);
    }
    tf32::commit();
    float* xs = smem + (i % kStages) * T::kStage;
    if constexpr (kGnIn) {
      // a thread keeps one channel of the chunk (kKC divides the block),
      // so it loads that channel's mean, rstd * gamma and beta once
      static_assert(T::kThreads % kKC == 0, "a thread's channel is fixed");
      const int c = threadIdx.x % kKC, cc = i * kKC + c;
      if (cc < a.ci) {
        const int g = cc / (a.ci / a.groups);
        const float mean = s_mean[g], scale = __fmul_rn(s_rstd[g], __ldg(a.gamma + cc));
        const float shift = __ldg(a.beta + cc);
        // interior tiles have no halo outside the image: no checks
        const bool inside = h0 >= 1 && w0 >= 1 && h0 + T::kTH < a.h && w0 + T::kTW < a.w;
        for (int pix = threadIdx.x / kKC; pix < T::kXPixels; pix += T::kThreads / kKC) {
          const int gh = h0 - 1 + pix / kXW, gw = w0 - 1 + pix % kXW;
          if (inside || (gh >= 0 && gh < a.h && gw >= 0 && gw < a.w)) {
            float& v = xs[pix * kXS + c];
            v = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v, mean), scale), shift), 0.0f);
          }
        }
      }
      __syncthreads();
    }
    const float* ws = xs + T::kXFloats + n0 + gid;
    if constexpr (kChunkSums) zero(part);
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int toff = (ky * kXW + kx) * kXS;
        uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float* r0 = xs + aoff[mi][0] + toff;
          const float* r1 = xs + aoff[mi][1] + toff;
          tf32::split(r0[0], ah[mi][0], al[mi][0]);
          tf32::split(r1[0], ah[mi][1], al[mi][1]);
          tf32::split(r0[4], ah[mi][2], al[mi][2]);
          tf32::split(r1[4], ah[mi][3], al[mi][3]);
        }
        const float* wt = ws + ((ky * 3 + kx) * kKC + tig) * kWS;
#pragma unroll
        for (int nj = 0; nj < kNT; ++nj) {
          tf32::split(wt[nj * 8], bh[nj][0], bl[nj][0]);
          tf32::split(wt[4 * kWS + nj * 8], bh[nj][1], bl[nj][1]);
        }
        if constexpr (kChunkSums) {
          tf32::mma3_tiles(part, ah, al, bh, bl);
        } else {
          tf32::mma3_tiles(acc, ah, al, bh, bl);
        }
      }
    }
    if constexpr (kChunkSums) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], part[mi][nj][e]);
    }
  }
  tf32::wait<0>();

  // the lane's output rows: pixel pm of the tile -> (oh, ow)
  auto pixel_of = [&](int mi, int e, int& oh, int& ow) {
    const int pm = m0 + mi * 16 + gid + (e >= 2 ? 8 : 0);
    oh = h0 + pm / T::kTW;
    ow = w0 + pm % T::kTW;
    return oh < a.h && ow < a.w;
  };

  if constexpr (kStats) {
    double s1[kNT][2], s2[kNT][2];
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
#pragma unroll
      for (int k = 0; k < 2; ++k) s1[nj][k] = s2[nj][k] = 0.0;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int oh, ow;
          if (pixel_of(mi, e, oh, ow)) {
            const double v = acc[mi][nj][e];
            s1[nj][e & 1] += v;
            s2[nj][e & 1] += v * v;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over gid: the warp's rows
          s1[nj][k] += __shfl_xor_sync(kFullMask, s1[nj][k], o);
          s2[nj][k] += __shfl_xor_sync(kFullMask, s2[nj][k], o);
        }
      }
    }
    __syncthreads();  // the stage ring is free: reuse it for the sums
    double2* red = reinterpret_cast<double2*>(smem);  // (WM, CO_T)
    if (gid == 0) {
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          red[wm * T::kCoT + n0 + nj * 8 + 2 * tig + k] = make_double2(s1[nj][k], s2[nj][k]);
    }
    __syncthreads();
    if (threadIdx.x < T::kCoT && co0 + threadIdx.x < a.co) {
      double t1 = 0.0, t2 = 0.0;
      for (int q = 0; q < T::kWM; ++q) {
        const double2 r = red[q * T::kCoT + threadIdx.x];
        t1 += r.x;
        t2 += r.y;
      }
      a.stats_out[(static_cast<size_t>(n) * gridDim.x + tile) * a.co + co0 + threadIdx.x] =
          make_double2(t1, t2);
    }
  }

  if (a.bias != nullptr || a.relu) {
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int oc = co0 + n0 + nj * 8 + 2 * tig + k;
        const float b = a.bias != nullptr && oc < a.co ? __ldg(a.bias + oc) : 0.0f;
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
          for (int e = k; e < 4; e += 2) {
            float& v = acc[mi][nj][e];
            if (a.bias != nullptr) v = __fadd_rn(v, b);
            if (a.relu) v = fmaxf(v, 0.0f);
          }
        }
      }
    }
  }

  const bool pairs = a.co % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      int oh, ow;
      if (!pixel_of(mi, e, oh, ow)) continue;
      float* dst = a.y + ((static_cast<size_t>(n) * a.h + oh) * a.w + ow) * a.co;
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj) {
        const int oc = co0 + n0 + nj * 8 + 2 * tig;
        if (pairs && oc + 1 < a.co) {
          *reinterpret_cast<float2*>(dst + oc) = make_float2(acc[mi][nj][e], acc[mi][nj][e + 1]);
        } else {
          if (oc < a.co) dst[oc] = acc[mi][nj][e];
          if (oc + 1 < a.co) dst[oc + 1] = acc[mi][nj][e + 1];
        }
      }
    }
  }
}

using TileCo16 = Tile<16, 16, 16, 4, 1>;  // Co <= 16
using TileCo32 = Tile<8, 16, 32, 2, 2>;   // Co <= 32
using TileWide = Tile<8, 16, 64, 2, 2>;   // Co > 32, W > 8
using TileSmall = Tile<8, 8, 64, 2, 2>;   // Co > 32, W <= 8
using TileWideSums = Tile<8, 16, 64, 2, 2, 2>;  // kChunkSums, Co > 32, W > 8: 2 blocks an SM

template <typename T>
inline int tiles_of(int h, int w) {
  return ((h + T::kTH - 1) / T::kTH) * ((w + T::kTW - 1) / T::kTW);
}

// The number of pixel tiles per image of the tile for (w, co): the
// `tiles` of the kStats partials.
inline int conv_tiles(int h, int w, int co) {
  if (co <= 16) return tiles_of<TileCo16>(h, w);
  if (co <= 32) return tiles_of<TileCo32>(h, w);
  return w > 8 ? tiles_of<TileWide>(h, w) : tiles_of<TileSmall>(h, w);
}

template <typename T, bool kStats, bool kGnIn, bool kChunkSums>
inline cudaError_t launch_tile(const ConvArgs& a, cudaStream_t stream) {
  constexpr auto kernel = conv3x3_mma_kernel<T, kStats, kGnIn, kChunkSums>;
  const cudaError_t err = tf32::allow_smem<kernel>(T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_of<T>(a.h, a.w), (a.co + T::kCoT - 1) / T::kCoT, a.n);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// K7: launch_conv<kStats, kGnIn, false>; K6a: launch_conv<false, false, true>
template <bool kStats, bool kGnIn, bool kChunkSums>
inline cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  if (a.n <= 0 || a.h <= 0 || a.w <= 0 || a.ci <= 0 || a.co <= 0 || a.n > 65535) {
    return cudaErrorInvalidValue;
  }
  if (a.co <= 16) return launch_tile<TileCo16, kStats, kGnIn, kChunkSums>(a, stream);
  if (a.co <= 32) return launch_tile<TileCo32, kStats, kGnIn, kChunkSums>(a, stream);
  if (a.w > 8) {
    using Wide = std::conditional_t<kChunkSums, TileWideSums, TileWide>;
    return launch_tile<Wide, kStats, kGnIn, kChunkSums>(a, stream);
  }
  return launch_tile<TileSmall, kStats, kGnIn, kChunkSums>(a, stream);
}

}  // namespace mmaconv
}  // namespace rfi
