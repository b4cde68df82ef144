// The direct 3x3 convolution that K6a (conv3x3.cu) and K7
// (double_conv_gn.cu) share: NHWC float32 activations, HWIO weights, SAME
// padding, plain FP32 FMAs (no tensor cores).
//
//   y[n, h, w, o] = sum_{ky, kx, i} x[n, h + ky - 1, w + kx - 1, i] * W[ky, kx, i, o]
//
// Bound on the H100: operations. At the UNet's shapes a layer does
// 2 * 9 * Ci flops per output value against 4 * (Ci + Co) / Co bytes, far
// above the card's 20 flop/B float32 balance point; only the 3-channel
// first layer comes near it. So the design keeps the FMA pipes fed from
// registers and shared memory:
//
// - A block of 128 threads computes a tile of TH x TW output pixels for TCO
//   output channels; each thread 4 neighbouring pixels of one row x 8
//   channels, 32 accumulators in registers.
// - The input channels go by in chunks of 16. For each chunk the block
//   stages the (TH + 2) x (TW + 2) input tile with its 1-pixel halo (zeros
//   outside the image) as channel planes, and the chunk's 9 x 16 x TCO
//   weights, in shared memory. A thread reads 6 inputs of a row once for
//   the 3 horizontal taps and two float4 of weights per tap: 12 shared
//   loads per 96 FMAs. The odd row stride keeps the input reads at most
//   2-way bank conflicted; the weight reads are warp-wide broadcasts.
// - The tile follows the output width, so every block keeps 128 threads
//   busy: 16 x 16 pixels for Co <= 16, 8 x 16 for Co <= 32, 8 x 8 with
//   64-channel slices above. Ragged Ci and Co (3 input channels, a
//   decoder's 2 Co) are zero-filled in shared memory and masked on store.
//
// Two options serve K7's GroupNorm without a pass of its own:
// - kStats: the block also reduces each output channel's sum and sum of
//   squares over its pixels, in float64, in a fixed order, and writes them
//   to stats[(n * tiles + tile) * Co + o]; no atomics, so runs are
//   reproducible.
// - kGnIn: the input is a raw conv output; the block first reduces the
//   kStats partials of its image to each group's mean and 1/sqrt(var + eps)
//   and applies relu((v - mean) * rstd * gamma + beta) to every in-image
//   value as it stages it (the SAME padding stays zero, as after the ReLU).
#pragma once

#include "common.cuh"

namespace rfi {
namespace conv {

constexpr int kThreads = 128;
constexpr int kKC = 16;  // input channels staged per chunk
constexpr int kPX = 4;   // output pixels per thread, along W
constexpr int kCO = 8;   // output channels per thread
constexpr int kMaxGroups = 64;

template <int TH, int TW, int TCO>
struct Tile {
  static constexpr int kPxg = TH * TW / kPX;  // pixel groups
  static constexpr int kCog = TCO / kCO;      // channel groups
  static_assert(kPxg * kCog == kThreads, "one output slice per thread");
  static constexpr int kRow = TW + 3;  // odd: at most 2-way bank conflicts
  static constexpr int kPlane = (TH + 2) * kRow;
  static constexpr int kIn = kKC * kPlane;
  static constexpr int kW = 9 * kKC * TCO;
};

struct ConvArgs {
  const float* x;  // (n, h, w, ci)
  const float* wt;  // (3, 3, ci, co)
  const float* b;  // (co,) or null
  float* y;        // (n, h, w, co)
  int n, h, w, ci, co;
  int relu;
  double2* stats_out;       // kStats: (n, tiles, co) (sum, sum of squares)
  const double2* stats_in;  // kGnIn: the partials of the conv that wrote x
  const float* gamma;       // kGnIn: (ci,)
  const float* beta;        // kGnIn: (ci,)
  int groups;               // kGnIn: groups of ci
  float eps;
};

// Mean and 1/sqrt(var + eps) of each of the `groups` contiguous channel
// groups of image n, from the float64 per-tile, per-channel sums
// stats[(n * tiles + t) * c + ch] of `pixels` pixels per channel. The
// one-pass variance E[v^2] - mean^2 is taken in float64, where its
// cancellation stays below float32 rounding unless |mean| / std exceeds
// about 1e4. Every thread of the block calls it; the result is in
// mean[g], rstd[g] after its closing barrier.
__device__ inline void group_stats(const double2* stats, int n, int tiles, int c,
                                   int groups, int pixels, float eps, float* mean,
                                   float* rstd) {
  const int cg = c / groups;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const double2* p = stats + static_cast<size_t>(n) * tiles * c;
  for (int g = threadIdx.x / 32; g < groups; g += warps) {
    double s1 = 0.0, s2 = 0.0;
    for (int i = lane; i < tiles * cg; i += 32) {
      const double2 v = p[static_cast<size_t>(i / cg) * c + g * cg + i % cg];
      s1 += v.x;
      s2 += v.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(kFullMask, s1, o);
      s2 += __shfl_xor_sync(kFullMask, s2, o);
    }
    if (lane == 0) {
      const double count = static_cast<double>(pixels) * cg;
      const double m = s1 / count;
      const double var = fmax(s2 / count - m * m, 0.0);
      mean[g] = static_cast<float>(m);
      rstd[g] = rsqrtf(__fadd_rn(static_cast<float>(var), eps));
    }
  }
  __syncthreads();
}

template <int TH, int TW, int TCO, bool kStats, bool kGnIn>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs a) {
  using T = Tile<TH, TW, TCO>;
  __shared__ __align__(16) float smem[T::kW + T::kIn];
  __shared__ float s_mean[kGnIn ? kMaxGroups : 1];
  __shared__ float s_rstd[kGnIn ? kMaxGroups : 1];
  float* s_w = smem;
  float* s_in = smem + T::kW;

  const int tiles_w = (a.w + TW - 1) / TW;
  const int tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int pxg = tid % T::kPxg;
  const int cog = tid / T::kPxg;
  const int pr = pxg / (TW / kPX);          // tile row of the thread's pixels
  const int pc = (pxg % (TW / kPX)) * kPX;  // tile column of the first one
  const int ci = a.ci;

  if constexpr (kGnIn) {
    group_stats(a.stats_in, n, gridDim.x, ci, a.groups, a.h * a.w, a.eps, s_mean,
                s_rstd);
  }
  const int cg = kGnIn ? ci / a.groups : 1;

  float acc[kPX][kCO];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[p][j] = 0.0f;

  for (int c0 = 0; c0 < ci; c0 += kKC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < T::kW; i += kThreads) {
      const int j = i % TCO;
      const int c = (i / TCO) % kKC;
      const int tap = i / (TCO * kKC);
      const int cc = c0 + c, oc = co0 + j;
      s_w[i] = (cc < ci && oc < a.co)
                   ? __ldg(a.wt + (static_cast<size_t>(tap) * ci + cc) * a.co + oc)
                   : 0.0f;
    }
    for (int i = tid; i < kKC * (TH + 2) * (TW + 2); i += kThreads) {
      const int c = i % kKC;
      const int pix = i / kKC;
      const int col = pix % (TW + 2);
      const int r = pix / (TW + 2);
      const int gh = h0 - 1 + r, gw = w0 - 1 + col, cc = c0 + c;
      float v = 0.0f;
      if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.w && cc < ci) {
        v = __ldg(a.x + ((static_cast<size_t>(n) * a.h + gh) * a.w + gw) * ci + cc);
        if constexpr (kGnIn) {
          const int g = cc / cg;
          v = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v, s_mean[g]),
                                        __fmul_rn(s_rstd[g], __ldg(a.gamma + cc))),
                              __ldg(a.beta + cc)),
                    0.0f);
        }
      }
      s_in[c * T::kPlane + r * T::kRow + col] = v;
    }
    __syncthreads();

    const int kc = min(kKC, ci - c0);
#pragma unroll 2
    for (int c = 0; c < kc; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* row = s_in + c * T::kPlane + (pr + ky) * T::kRow + pc;
        float v[kPX + 2];
#pragma unroll
        for (int k = 0; k < kPX + 2; ++k) v[k] = row[k];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + ((ky * 3 + kx) * kKC + c) * TCO + cog * kCO);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kCO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPX; ++p)
#pragma unroll
            for (int j = 0; j < kCO; ++j) acc[p][j] = fmaf(v[p + kx], wv[j], acc[p][j]);
        }
      }
    }
  }

  const int oh = h0 + pr;
  const int oc0 = co0 + cog * kCO;
  if constexpr (kStats) {
    double s1[kCO], s2[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) s1[j] = s2[j] = 0.0;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      if (oh < a.h && w0 + pc + p < a.w) {
#pragma unroll
        for (int j = 0; j < kCO; ++j) {
          const double v = acc[p][j];
          s1[j] += v;
          s2[j] += v * v;
        }
      }
    }
    __syncthreads();  // the shared tiles are free: reuse them for the sums
    double2* red = reinterpret_cast<double2*>(smem);  // (kPxg, TCO)
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      red[pxg * TCO + cog * kCO + j] = make_double2(s1[j], s2[j]);
    }
    __syncthreads();
    if (tid < TCO && co0 + tid < a.co) {
      double t1 = 0.0, t2 = 0.0;
      for (int q = 0; q < T::kPxg; ++q) {
        const double2 r = red[q * TCO + tid];
        t1 += r.x;
        t2 += r.y;
      }
      a.stats_out[(static_cast<size_t>(n) * gridDim.x + tile) * a.co + co0 + tid] =
          make_double2(t1, t2);
    }
  }

  if (oh >= a.h) return;
  const bool whole = (a.co % 4 == 0) && (oc0 + kCO <= a.co);
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int ow = w0 + pc + p;
    if (ow >= a.w) continue;
    float out[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      float v = acc[p][j];
      if (a.b != nullptr && oc0 + j < a.co) v = __fadd_rn(v, __ldg(a.b + oc0 + j));
      out[j] = a.relu ? fmaxf(v, 0.0f) : v;
    }
    float* dst = a.y + ((static_cast<size_t>(n) * a.h + oh) * a.w + ow) * a.co + oc0;
    if (whole) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(out[0], out[1], out[2], out[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kCO; ++j)
        if (oc0 + j < a.co) dst[j] = out[j];
    }
  }
}

template <int TH, int TW, int TCO>
inline int tiles_of(int h, int w) {
  return ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
}

template <int TH, int TW, int TCO, bool kStats, bool kGnIn>
inline cudaError_t launch_tile(const ConvArgs& a, cudaStream_t stream) {
  const dim3 grid(tiles_of<TH, TW, TCO>(a.h, a.w), (a.co + TCO - 1) / TCO, a.n);
  conv3x3_kernel<TH, TW, TCO, kStats, kGnIn><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The tile for Co output channels, and the number of pixel tiles per image
// (the `tiles` of the kStats partials).
inline int conv_tiles(int h, int w, int co) {
  if (co <= 16) return tiles_of<16, 16, 16>(h, w);
  if (co <= 32) return tiles_of<8, 16, 32>(h, w);
  return tiles_of<8, 8, 64>(h, w);
}

template <bool kStats, bool kGnIn>
inline cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  if (a.n <= 0 || a.h <= 0 || a.w <= 0 || a.ci <= 0 || a.co <= 0 || a.n > 65535) {
    return cudaErrorInvalidValue;
  }
  if (a.co <= 16) return launch_tile<16, 16, 16, kStats, kGnIn>(a, stream);
  if (a.co <= 32) return launch_tile<8, 16, 32, kStats, kGnIn>(a, stream);
  return launch_tile<8, 8, 64, kStats, kGnIn>(a, stream);
}

}  // namespace conv
}  // namespace rfi
