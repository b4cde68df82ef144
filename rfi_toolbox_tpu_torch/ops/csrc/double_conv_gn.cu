// K7: the GroupNorm UNet's DoubleConv forward,
//   y = relu(GN2(conv3x3(relu(GN1(conv3x3(x, W1))), W2))),
// GroupNorm over contiguous channel groups with eps, NHWC float32.
//
// Replaces the TPU kernel rfi_toolbox_tpu/ops/fused_doubleconv.py:
// double_conv_gn_relu (bodies _dc_kernel and _gn_relu_inplace). Its plain
// PyTorch version is the port's DoubleConv(norm="group") arithmetic, in
// ops/fused_doubleconv.py.
//
// Bound on the H100: operations, those of its two convolutions (see
// conv3x3_mma.cuh); GroupNorm adds a few flops per value.
//
// The TPU kernel keeps one whole image and its intermediate in VMEM. That
// does not fit a block here, and GroupNorm's statistics span the image, so
// they need a reduction across blocks. Five launches, one call:
// 1. conv1 (conv3x3_mma.cuh's 3xTF32 tensor-core tile, no bias) writes its
//    raw output and, per block, each channel's float64 sum and sum of
//    squares over its pixels;
// 2. a one-block-per-image pass reduces those partials to each group's
//    mean and 1/sqrt(var + eps), once, so that no conv block waits on it
//    (three launches, each conv2 and GN2 block reducing its image's
//    partials itself, took 5.81-5.85 ms over the GroupNorm UNet16's 9
//    DoubleConvs against 5.59-5.60 in turns: tools/conv_kernel_turns.py,
//    H100 80GB HBM3 at 700 W);
// 3. conv2 applies GN1's affine and the ReLU to each staged input chunk in
//    shared memory (in-image values only), and writes its raw output and
//    its own partials;
// 4. the same reduction of conv2's partials, then one elementwise pass
//    applies GN2 and the ReLU in place.
// The intermediate makes one round trip through device memory and nothing
// else does. The partials are float64 sums: the variance is the one-pass
// E[v^2] - mean^2 of the reference, whose cancellation float64 keeps below
// float32 rounding, and it costs no second pass over the data (Chan's
// merge of (count, mean, M2) would also be exact enough, at more
// arithmetic per block). The sums are taken in a fixed order, so the
// result is the same bits on every run.
#include "conv3x3_mma.cuh"

namespace {

using namespace rfi;

constexpr int kApplyThreads = 256;

// gn[n * groups + g] = (mean, 1/sqrt(var + eps)) of the `groups`
// contiguous channel groups of image n = blockIdx.x, from the float64
// per-tile, per-channel sums stats[(n * tiles + t) * c + ch] of `pixels`
// pixels per channel (one-pass variance in float64, see above).
__global__ void __launch_bounds__(kApplyThreads)
    group_stats_kernel(const double2* __restrict__ stats, float2* __restrict__ gn, int tiles,
                       int c, int groups, int pixels, float eps) {
  const int n = blockIdx.x;
  const int cg = c / groups;
  const int lane = threadIdx.x % 32;
  const double2* p = stats + static_cast<size_t>(n) * tiles * c;
  for (int g = threadIdx.x / 32; g < groups; g += kApplyThreads / 32) {
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
      gn[n * groups + g] =
          make_float2(static_cast<float>(m), rsqrtf(__fadd_rn(static_cast<float>(var), eps)));
    }
  }
}

// y = relu((y - mean) * rstd * gamma + beta) in place, four channels at a
// time (c % 4 == 0: the UNet's widths) or one.
template <int V>
__global__ void __launch_bounds__(kApplyThreads)
    gn_relu_kernel(float* __restrict__ y, const float2* __restrict__ gn,
                   const float* __restrict__ gamma, const float* __restrict__ beta, int hw,
                   int c, int groups) {
  __shared__ float s_mean[mmaconv::kMaxGroups];
  __shared__ float s_rstd[mmaconv::kMaxGroups];
  const int n = blockIdx.y;
  for (int g = threadIdx.x; g < groups; g += kApplyThreads) {
    const float2 v = gn[n * groups + g];
    s_mean[g] = v.x;
    s_rstd[g] = v.y;
  }
  __syncthreads();
  const int cg = c / groups;
  float* img = y + static_cast<size_t>(n) * hw * c;
  const size_t total = static_cast<size_t>(hw) * c / V;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[V];
    if constexpr (V == 4) {
      const float4 q = reinterpret_cast<const float4*>(img)[i];
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      v[0] = img[i];
    }
    const int ch0 = static_cast<int>(i * V % c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = ch0 + k, g = ch / cg;
      v[k] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(v[k], s_mean[g]),
                                       __fmul_rn(s_rstd[g], __ldg(gamma + ch))),
                             __ldg(beta + ch)),
                   0.0f);
    }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(img)[i] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      img[i] = v[0];
    }
  }
}

}  // namespace

// The double2 slots each of rfi_double_conv_gn's stats1 and stats2 needs:
// one per (image, pixel tile, channel) of the conv's tile for co, then one
// per (image, group) for its mean and 1/sqrt(var + eps). Fails unless
// groups divides co and is at most kMaxGroups.
extern "C" int rfi_double_conv_gn_workspace(int n, int h, int w, int co, int groups,
                                            long long* stats_slots) {
  if (n <= 0 || h <= 0 || w <= 0 || co <= 0 || groups <= 0 || groups > mmaconv::kMaxGroups ||
      co % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *stats_slots = static_cast<long long>(n) * (mmaconv::conv_tiles(h, w, co) * co + groups);
  return static_cast<int>(cudaSuccess);
}

// mid: (n, h, w, co) scratch for conv1's raw output; out: (n, h, w, co);
// stats1, stats2: the scratch rfi_double_conv_gn_workspace sizes.
extern "C" int rfi_double_conv_gn(const void* x, const void* w1, const void* g1,
                                  const void* b1, const void* w2, const void* g2,
                                  const void* b2, void* mid, void* out, void* stats1,
                                  void* stats2, int n, int h, int w, int ci, int co,
                                  int groups, float eps, void* stream) {
  if (groups <= 0 || groups > mmaconv::kMaxGroups || co % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = mmaconv::conv_tiles(h, w, co);
  // each stats scratch: the conv's partials, then (mean, rstd) per (image, group)
  const size_t partials = static_cast<size_t>(n) * tiles * co;
  float2* gn1 = reinterpret_cast<float2*>(static_cast<double2*>(stats1) + partials);
  float2* gn2 = reinterpret_cast<float2*>(static_cast<double2*>(stats2) + partials);
  mmaconv::ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.wt = static_cast<const float*>(w1);
  a.y = static_cast<float*>(mid);
  a.n = n;
  a.h = h;
  a.w = w;
  a.ci = ci;
  a.co = co;
  a.stats_out = static_cast<double2*>(stats1);
  cudaError_t err = mmaconv::launch_conv<true, false, false>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_stats_kernel<<<n, kApplyThreads, 0, s>>>(static_cast<const double2*>(stats1), gn1,
                                                 tiles, co, groups, h * w, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  a.x = static_cast<const float*>(mid);
  a.wt = static_cast<const float*>(w2);
  a.y = static_cast<float*>(out);
  a.ci = co;
  a.stats_out = static_cast<double2*>(stats2);
  a.gn_in = gn1;
  a.gamma = static_cast<const float*>(g1);
  a.beta = static_cast<const float*>(b1);
  a.groups = groups;
  err = mmaconv::launch_conv<true, true, false>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_stats_kernel<<<n, kApplyThreads, 0, s>>>(static_cast<const double2*>(stats2), gn2,
                                                 tiles, co, groups, h * w, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t per_image = static_cast<size_t>(h) * w * co;
  int blocks = static_cast<int>((per_image + 8 * kApplyThreads - 1) / (8 * kApplyThreads));
  blocks = blocks < 1 ? 1 : (blocks > 64 ? 64 : blocks);
  const auto apply = co % 4 == 0 ? gn_relu_kernel<4> : gn_relu_kernel<1>;
  apply<<<dim3(blocks, n), kApplyThreads, 0, s>>>(static_cast<float*>(out), gn2,
                                                  static_cast<const float*>(g2),
                                                  static_cast<const float*>(b2), h * w, co,
                                                  groups);
  return static_cast<int>(cudaGetLastError());
}
