// K5: per-patch MAD flags, (N, H, W) complex64 or float32 -> (N, H, W) bool.
//
// Replaces the TPU kernel rfi_toolbox_tpu/ops/mad_flags.py
// (mad_flag_patches_pallas, body _kernel and _rank_select_block). Its
// plain PyTorch version is preprocess/pipeline.py: mad_flag_patches, and
// the flags are bit-equal to it: the exact median and MAD, NaNs omitted
// from the ranks and never flagged.
//
// The median is found without sorting, by an exact radix select over an
// order-preserving map of the float bits (flip every bit of a negative
// value, set the sign bit of a positive one), so negative real input is
// ordered correctly; the TPU kernel orders raw bits and is right only for
// values >= 0. NaN maps to the largest key and is left out of the ranks.
// A second select over |x - median| gives the MAD; a last pass compares
// and writes one byte per pixel.
//
// Bound on the H100: bytes (8 in, 1 out per pixel); an exact median takes
// a few operations a pixel. What this design spends instead, per pixel:
// 2 selects x (4 digit passes x (2 to test the prefix, 2 for the digit,
// 1 shared atomic) + 2 for the least key above the lower rank), plus 8 to
// form a key of |x - median| at each of the MAD select's 6 reads of a key
// (count, 4 passes, least key).
//
// Design: one block of 512 threads per patch. A select fixes the k-th
// smallest key 8 bits at a time, most significant first: each of its 4
// passes counts, in a 256-bin histogram in shared memory, the digits of
// the keys that share the digits fixed so far, and a scan of the bins
// finds the one that holds rank k. A pair of warps counts into a copy of
// its own (8 copies), with one shared atomic a key. That beat aggregating
// the lanes of equal digits first, though a patch of noise puts nearly
// every key in one bin of the top digit: at (512, 128, 128) complex64,
// __match_any_sync 0.217 ms, a warp-uniform test 0.152, ballots 0.376,
// one atomic a key 0.126 (16 copies); adding runs of a thread's equal
// digits with one atomic cost 0.135 against 0.124, and 0.130 against
// 0.119 on patches of one value (tools/conv_kernel_turns.py, NVIDIA H100
// 80GB HBM3 at 700 W). The two middle
// ranks of an even count share one select: the upper one is the lower
// key itself when enough keys equal it, else the least key above it (one
// min-reduction). A patch of up to 128 x 128 pixels keeps its keys in
// registers (32 a thread, two blocks an SM), so shared memory holds only
// the histograms; the MAD's select forms each key of |x - median| as it
// reads the key of x, so the keys of x stay for the last pass, which
// flags from the registers without reading the input again. A larger
// patch, up to a whole 1024 x 1024 waterfall, keeps its keys in a global
// scratch buffer that the wrapper allocates, and its passes stream
// through L2 (one block per waterfall: slow, logged).
#include "common.cuh"

using rfi::kFullMask;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegisterKeys = 128 * 128;  // a patch's keys held in registers, at most
constexpr int kPerThread = kRegisterKeys / kThreads;
constexpr int kBins = 256;
constexpr int kCopies = 8;  // histograms a block counts into (a pair of warps each)
constexpr uint32_t kNanKey = 0xffffffffu;

struct Shared {
  int hist[kCopies][kBins];  // zero between passes
  int warp_total[kBins / 32];
  int3 pick;  // (bin, rank within the bin, keys in the bin)
  uint32_t partial[kWarps];
  uint32_t total;
};

__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return kNanKey;
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

// A patch's keys in registers: thread t holds pixels t, t + 512, ...
struct RegisterKeys {
  uint32_t k[kPerThread];
  int hw;

  // f(key, pixel) for each of the thread's pixels
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = j * kThreads + threadIdx.x;
      if (p < hw) f(k[j], p);
    }
  }
};

// A larger patch's keys in global scratch; a thread reads only the
// pixels it wrote.
struct GlobalKeys {
  const uint32_t* k;
  int hw;

  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    for (int p = threadIdx.x; p < hw; p += kThreads) f(k[p], p);
  }
};

// What a select ranks: the keys themselves (the median), or the keys of
// |x - median| (the MAD), computed as they are read, so that the keys of
// x stay for the flags.
struct Identity {
  __device__ __forceinline__ uint32_t operator()(uint32_t key) const { return key; }
};

struct Deviation {
  float median;
  __device__ __forceinline__ uint32_t operator()(uint32_t key) const {
    return order_key(fabsf(__fsub_rn(key_value(key), median)));  // NaN -> kNanKey
  }
};

// The sum (kMin false) or the least value (kMin true) of v over the
// block, handed to every thread.
template <bool kMin>
__device__ __forceinline__ uint32_t block_reduce(uint32_t v, Shared& s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = kMin ? __reduce_min_sync(kFullMask, v) : __reduce_add_sync(kFullMask, v);
  if (lane == 0) s.partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s.partial[lane] : (kMin ? kNanKey : 0u);
    v = kMin ? __reduce_min_sync(kFullMask, v) : __reduce_add_sync(kFullMask, v);
    if (lane == 0) s.total = v;
  }
  __syncthreads();
  return s.total;
}

// The rank-th smallest non-NaN key of map(keys) (0-indexed; rank < their
// number), and how many keys lie below it and equal it. NaN keys are
// counted too: they are the largest, so no rank below their number
// reaches them.
template <typename Keys, typename Map>
__device__ __forceinline__ uint32_t select_key(const Keys& keys, Map map, int rank, Shared& s,
                                               int& below, int& equal) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* hist = s.hist[warp % kCopies];
  uint32_t prefix = 0;
  int k = rank;  // the rank among the keys that share the prefix
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t high = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
    keys.each([&](uint32_t raw, int) {
      const uint32_t key = map(raw);
      if ((key & high) == prefix) atomicAdd(hist + ((key >> shift) & 0xffu), 1);
    });
    __syncthreads();
    // thread b < 256 owns bin b: it sums the copies (and zeroes them for
    // the next pass), then the bins are scanned, by shuffles within a
    // warp and over the 8 warps' totals
    int c = 0;
    if (threadIdx.x < kBins) {
#pragma unroll
      for (int w = 0; w < kCopies; ++w) {
        c += s.hist[w][threadIdx.x];
        s.hist[w][threadIdx.x] = 0;
      }
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += v;
    }
    if (threadIdx.x < kBins && lane == 31) s.warp_total[warp] = incl;
    __syncthreads();
    if (threadIdx.x < kBins) {
      for (int w = 0; w < warp; ++w) incl += s.warp_total[w];
      const int excl = incl - c;
      if (excl <= k && k < incl) s.pick = make_int3(threadIdx.x, k - excl, c);
    }
    __syncthreads();
    const int3 pick = s.pick;
    prefix |= static_cast<uint32_t>(pick.x) << shift;
    k = pick.y;
    equal = pick.z;
  }
  below = rank - k;
  return prefix;
}

// (lo + hi) * 0.5 of the middle pair of the `count` non-NaN map(keys), as
// jnp.nanmedian's midpoint.
template <typename Keys, typename Map>
__device__ __forceinline__ float median_of(const Keys& keys, Map map, int count, Shared& s) {
  const int k_lo = (count - 1) / 2, k_hi = count / 2;
  int below, equal;
  const uint32_t lo = select_key(keys, map, k_lo, s, below, equal);
  uint32_t hi = lo;
  if (k_hi >= below + equal) {  // rank k_hi lies above lo's keys
    uint32_t least = kNanKey;
    keys.each([&](uint32_t raw, int) {
      const uint32_t key = map(raw);
      least = key > lo && key < least ? key : least;
    });
    hi = block_reduce<true>(least, s);
  }
  return __fmul_rn(__fadd_rn(key_value(lo), key_value(hi)), 0.5f);
}

template <typename Keys, typename Map>
__device__ __forceinline__ int valid_count(const Keys& keys, Map map, Shared& s) {
  uint32_t valid = 0;
  keys.each([&](uint32_t raw, int) { valid += map(raw) != kNanKey; });
  return static_cast<int>(block_reduce<false>(valid, s));
}

template <typename Keys>
__device__ __forceinline__ void flag_patch(const Keys& keys, uint8_t* dst, float sigma,
                                           Shared& s) {
  const int count = valid_count(keys, Identity{}, s);
  if (count == 0) {  // all NaN: no median, nothing flagged
    keys.each([&](uint32_t, int p) { dst[p] = 0; });
    return;
  }
  const float median = median_of(keys, Identity{}, count, s);
  const Deviation dev{median};
  const int count_dev = valid_count(keys, dev, s);
  const float mad = count_dev ? median_of(keys, dev, count_dev, s) : __int_as_float(0x7fc00000);

  const float spread = __fmul_rn(mad, sigma);
  const float upper = __fadd_rn(median, spread);
  const float lower = __fsub_rn(median, spread);
  keys.each([&](uint32_t key, int p) {
    const float x = key_value(key);
    dst[p] = (x > upper) || (x < lower);  // NaN compares false
  });
}

// Two blocks an SM: the 32 keys a thread holds in registers leave at most
// 64 registers a thread for 1024 threads.
template <bool kComplex, bool kInRegisters>
__global__ void __launch_bounds__(kThreads, 2)
    mad_flags_kernel(const float* __restrict__ in, uint8_t* __restrict__ flags,
                     uint32_t* __restrict__ scratch, int hw, float sigma) {
  __shared__ Shared s;
  const size_t patch = blockIdx.x;
  const float* src = in + patch * hw * (kComplex ? 2 : 1);
  uint8_t* dst = flags + patch * hw;
  for (int i = threadIdx.x; i < kCopies * kBins; i += kThreads) (&s.hist[0][0])[i] = 0;
  if constexpr (kInRegisters) {
    RegisterKeys keys;
    keys.hw = hw;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = j * kThreads + threadIdx.x;
      keys.k[j] = p < hw ? order_key(pixel<kComplex>(src, p)) : kNanKey;
    }
    flag_patch(keys, dst, sigma, s);
  } else {
    uint32_t* k = scratch + patch * hw;
    for (int p = threadIdx.x; p < hw; p += kThreads) k[p] = order_key(pixel<kComplex>(src, p));
    flag_patch(GlobalKeys{k, hw}, dst, sigma, s);
  }
}

template <bool kComplex>
cudaError_t launch(const float* in, uint8_t* flags, uint32_t* scratch, int n, int hw,
                   float sigma, cudaStream_t stream) {
  if (scratch) {
    mad_flags_kernel<kComplex, false><<<n, kThreads, 0, stream>>>(in, flags, scratch, hw, sigma);
  } else {
    mad_flags_kernel<kComplex, true><<<n, kThreads, 0, stream>>>(in, flags, nullptr, hw, sigma);
  }
  return cudaGetLastError();
}

}  // namespace

// in: (n, hw) complex64 (is_complex != 0) or float32; flags: (n, hw) bytes;
// scratch: NULL when hw <= 128 * 128 (keys in registers), else n * hw
// uint32 of device memory. Launches on `stream`, returns cudaGetLastError().
extern "C" int rfi_mad_flag_patches(const void* in, void* flags, void* scratch, int n, int hw,
                                    int is_complex, float sigma, void* stream) {
  if (n <= 0 || hw <= 0 || (!scratch && hw > kRegisterKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const float*>(in);
  auto* f = static_cast<uint8_t*>(flags);
  auto* k = static_cast<uint32_t*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_complex ? launch<true>(x, f, k, n, hw, sigma, s)
                                     : launch<false>(x, f, k, n, hw, sigma, s));
}
