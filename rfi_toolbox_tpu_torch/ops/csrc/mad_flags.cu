// K5: per-patch MAD flags, (N, H, W) complex64 or float32 -> (N, H, W) bool.
//
// Replaces the TPU kernel rfi_toolbox_tpu/ops/mad_flags.py
// (mad_flag_patches_pallas, body _kernel and _rank_select_block). Its
// plain PyTorch version is preprocess/pipeline.py: mad_flag_patches, and
// the flags are bit-equal to it: the exact median and MAD, NaNs omitted
// from the ranks and never flagged.
//
// The median is found without sorting, by an exact radix select: 32
// passes that each count, across the block, the keys below a candidate
// prefix, for the lower and the upper middle rank together. The keys are
// an order-preserving map of the float bits (flip every bit of a negative
// value, set the sign bit of a positive one), so negative real input is
// ordered correctly; the TPU kernel orders raw bits and is right only for
// values >= 0. NaN maps to the largest key and is left out of the ranks.
// A second select over |x - median| gives the MAD; a last pass compares
// and writes one byte per pixel.
//
// Bound on the H100: operations. Per pixel it moves 9 B (8 in, 1 out) but
// does 2 selects x 32 passes x (2 compares + 2 adds) = 256 integer
// operations, against 8.4 M pixels at 512 x 128 x 128.
//
// Design (first, simple version): one block per patch, a block-stride
// loop over its pixels. The keys of a patch of up to kSharedKeys pixels
// (128 x 128) live in shared memory; a larger patch, up to a whole
// 1024 x 1024 waterfall, keeps them in a global scratch buffer that the
// wrapper allocates, and its passes stream through L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedKeys = 128 * 128;

struct BlockSums {
  int2 partial[kWarps];
  int2 total;
};

// Sums (a, b) over the block and hands the totals to every thread.
__device__ __forceinline__ int2 block_sum(int a, int b, BlockSums& s) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  a = rfi::warp_sum(a);
  b = rfi::warp_sum(b);
  if (lane == 0) s.partial[warp] = make_int2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int2 v = lane < kWarps ? s.partial[lane] : make_int2(0, 0);
    const int x = rfi::warp_sum(v.x);
    const int y = rfi::warp_sum(v.y);
    if (lane == 0) s.total = make_int2(x, y);
  }
  __syncthreads();
  return s.total;
}

__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <bool kComplex>
__device__ __forceinline__ float pixel(const float* src, int p) {
  if (kComplex) {
    const float2 z = reinterpret_cast<const float2*>(src)[p];
    return rfi::magnitude(z.x, z.y);
  }
  return src[p];
}

// The k_lo-th and k_hi-th smallest (0-indexed) values among `keys`.
__device__ float2 select_pair(const uint32_t* keys, int n, int k_lo, int k_hi,
                              BlockSums& sums) {
  uint32_t p_lo = 0, p_hi = 0;
  for (int b = 31; b >= 0; --b) {
    const uint32_t c_lo = p_lo | (1u << b);
    const uint32_t c_hi = p_hi | (1u << b);
    int below_lo = 0, below_hi = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t k = keys[i];
      below_lo += k < c_lo;
      below_hi += k < c_hi;
    }
    const int2 below = block_sum(below_lo, below_hi, sums);
    if (below.x <= k_lo) p_lo = c_lo;
    if (below.y <= k_hi) p_hi = c_hi;
  }
  return make_float2(key_value(p_lo), key_value(p_hi));
}

// (lo + hi) * 0.5 of the middle pair of `count` ranked keys, as
// jnp.nanmedian's midpoint.
__device__ float median_of(const uint32_t* keys, int n, int count,
                           BlockSums& sums) {
  const float2 m = select_pair(keys, n, (count - 1) / 2, count / 2, sums);
  return __fmul_rn(__fadd_rn(m.x, m.y), 0.5f);
}

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
mad_flags_kernel(const float* __restrict__ in, uint8_t* __restrict__ flags,
                 uint32_t* __restrict__ scratch, int hw, float sigma) {
  extern __shared__ uint32_t shared_keys[];
  __shared__ BlockSums sums;

  const size_t patch = blockIdx.x;
  const float* src = in + patch * hw * (kComplex ? 2 : 1);
  uint8_t* dst = flags + patch * hw;
  uint32_t* keys = scratch ? scratch + patch * hw : shared_keys;

  int valid = 0;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float x = pixel<kComplex>(src, p);
    keys[p] = order_key(x);
    valid += !isnan(x);
  }
  const int count = block_sum(valid, 0, sums).x;
  if (count == 0) {  // all NaN: no median, nothing flagged
    for (int p = threadIdx.x; p < hw; p += kThreads) dst[p] = 0;
    return;
  }
  const float median = median_of(keys, hw, count, sums);

  int valid_dev = 0;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float d = fabsf(__fsub_rn(key_value(keys[p]), median));
    keys[p] = order_key(d);
    valid_dev += !isnan(d);
  }
  const int count_dev = block_sum(valid_dev, 0, sums).x;
  const float mad = count_dev ? median_of(keys, hw, count_dev, sums)
                              : __int_as_float(0x7fc00000);

  const float spread = __fmul_rn(mad, sigma);
  const float upper = __fadd_rn(median, spread);
  const float lower = __fsub_rn(median, spread);
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float x = pixel<kComplex>(src, p);
    dst[p] = (x > upper) || (x < lower);  // NaN compares false
  }
}

}  // namespace

// in: (n, hw) complex64 (is_complex != 0) or float32; flags: (n, hw) bytes;
// scratch: NULL when hw <= 128 * 128 (keys in shared memory), else n * hw
// uint32 of device memory. Launches on `stream`, returns cudaGetLastError().
extern "C" int rfi_mad_flag_patches(const void* in, void* flags, void* scratch,
                                    int n, int hw, int is_complex, float sigma,
                                    void* stream) {
  if (n <= 0 || hw <= 0 || (!scratch && hw > kSharedKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = scratch ? 0 : static_cast<size_t>(hw) * sizeof(uint32_t);
  auto kernel = is_complex ? mad_flags_kernel<true> : mad_flags_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedKeys * sizeof(uint32_t)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<uint8_t*>(flags),
      static_cast<uint32_t*>(scratch), hw, sigma);
  return static_cast<int>(cudaGetLastError());
}
