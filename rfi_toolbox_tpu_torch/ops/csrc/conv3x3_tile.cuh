// K6a's direct 3x3 convolution (conv3x3.cu): NHWC float32 activations,
// HWIO weights, SAME padding, plain FP32 FMAs (no tensor cores). K6a alone
// uses this tile; K7 moved to conv3x3_mma.cuh's 3xTF32 tensor-core tile,
// and the next step moves K6a there too and deletes this header.
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
#pragma once

#include "common.cuh"

namespace rfi {
namespace conv {

constexpr int kThreads = 128;
constexpr int kKC = 16;  // input channels staged per chunk
constexpr int kPX = 4;   // output pixels per thread, along W
constexpr int kCO = 8;   // output channels per thread

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
};

template <int TH, int TW, int TCO>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs a) {
  using T = Tile<TH, TW, TCO>;
  __shared__ __align__(16) float smem[T::kW + T::kIn];
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

template <int TH, int TW, int TCO>
inline cudaError_t launch_tile(const ConvArgs& a, cudaStream_t stream) {
  const dim3 grid(tiles_of<TH, TW, TCO>(a.h, a.w), (a.co + TCO - 1) / TCO, a.n);
  conv3x3_kernel<TH, TW, TCO><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The tile follows Co.
inline cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  if (a.n <= 0 || a.h <= 0 || a.w <= 0 || a.ci <= 0 || a.co <= 0 || a.n > 65535) {
    return cudaErrorInvalidValue;
  }
  if (a.co <= 16) return launch_tile<16, 16, 16>(a, stream);
  if (a.co <= 32) return launch_tile<8, 16, 32>(a, stream);
  return launch_tile<8, 8, 64>(a, stream);
}

}  // namespace conv
}  // namespace rfi
