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
// conv3x3_tile.cuh); GroupNorm adds a few flops per value.
//
// The TPU kernel keeps one whole image and its intermediate in VMEM. That
// does not fit a block here, and GroupNorm's statistics span the image, so
// they need a reduction across blocks. Three launches, one call:
// 1. conv1 (the shared tile, no bias) writes its raw output and, per block,
//    each channel's float64 sum and sum of squares over its pixels;
// 2. conv2 reduces those partials of its image to each group's mean and
//    1/sqrt(var + eps) on its first touch, applies GN1's affine and the ReLU
//    to its input tile as it stages it, and writes its raw output and its
//    own partials;
// 3. one elementwise pass reduces conv2's partials the same way and applies
//    GN2 and the ReLU in place.
// The intermediate makes one round trip through device memory and nothing
// else does. The partials are float64 sums: the variance is the one-pass
// E[v^2] - mean^2 of the reference, whose cancellation float64 keeps below
// float32 rounding, and it costs no second pass over the data (Chan's
// merge of (count, mean, M2) would also be exact enough, at more
// arithmetic per block). The sums are taken in a fixed order, so the
// result is the same bits on every run.
#include "conv3x3_tile.cuh"

namespace {

using namespace rfi;

constexpr int kApplyThreads = 256;

__global__ void __launch_bounds__(kApplyThreads)
    gn_relu_kernel(float* __restrict__ y, const double2* __restrict__ stats,
                   const float* __restrict__ gamma, const float* __restrict__ beta, int hw,
                   int c, int groups, int tiles, float eps) {
  __shared__ float s_mean[conv::kMaxGroups];
  __shared__ float s_rstd[conv::kMaxGroups];
  const int n = blockIdx.y;
  conv::group_stats(stats, n, tiles, c, groups, hw, eps, s_mean, s_rstd);
  const int cg = c / groups;
  float* img = y + static_cast<size_t>(n) * hw * c;
  const size_t total = static_cast<size_t>(hw) * c;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % c);
    const int g = ch / cg;
    img[i] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(img[i], s_mean[g]),
                                       __fmul_rn(s_rstd[g], __ldg(gamma + ch))),
                             __ldg(beta + ch)),
                   0.0f);
  }
}

}  // namespace

// The double2 slots each of rfi_double_conv_gn's stats1 and stats2 needs:
// one per (image, pixel tile, channel) of the conv's tile for co. Fails
// unless groups divides co and is at most kMaxGroups.
extern "C" int rfi_double_conv_gn_workspace(int n, int h, int w, int co, int groups,
                                            long long* stats_slots) {
  if (n <= 0 || h <= 0 || w <= 0 || co <= 0 || groups <= 0 || groups > conv::kMaxGroups ||
      co % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *stats_slots = static_cast<long long>(n) * conv::conv_tiles(h, w, co) * co;
  return static_cast<int>(cudaSuccess);
}

// mid: (n, h, w, co) scratch for conv1's raw output; out: (n, h, w, co);
// stats1, stats2: the scratch rfi_double_conv_gn_workspace sizes.
extern "C" int rfi_double_conv_gn(const void* x, const void* w1, const void* g1,
                                  const void* b1, const void* w2, const void* g2,
                                  const void* b2, void* mid, void* out, void* stats1,
                                  void* stats2, int n, int h, int w, int ci, int co,
                                  int groups, float eps, void* stream) {
  if (groups <= 0 || groups > conv::kMaxGroups || co % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  conv::ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.wt = static_cast<const float*>(w1);
  a.y = static_cast<float*>(mid);
  a.n = n;
  a.h = h;
  a.w = w;
  a.ci = ci;
  a.co = co;
  a.stats_out = static_cast<double2*>(stats1);
  cudaError_t err = conv::launch_conv<true, false>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  a.x = static_cast<const float*>(mid);
  a.wt = static_cast<const float*>(w2);
  a.y = static_cast<float*>(out);
  a.ci = co;
  a.stats_in = static_cast<const double2*>(stats1);
  a.stats_out = static_cast<double2*>(stats2);
  a.gamma = static_cast<const float*>(g1);
  a.beta = static_cast<const float*>(b1);
  a.groups = groups;
  a.eps = eps;
  err = conv::launch_conv<true, true>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles = conv::conv_tiles(h, w, co);
  const size_t per_image = static_cast<size_t>(h) * w * co;
  int blocks = static_cast<int>((per_image + 8 * kApplyThreads - 1) / (8 * kApplyThreads));
  blocks = blocks < 1 ? 1 : (blocks > 64 ? 64 : blocks);
  gn_relu_kernel<<<dim3(blocks, n), kApplyThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const double2*>(stats2),
      static_cast<const float*>(g2), static_cast<const float*>(b2), h * w, co, groups,
      tiles, eps);
  return static_cast<int>(cudaGetLastError());
}
