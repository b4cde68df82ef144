// K3: the selected channel planes gathered with each output's variant
// flip/transpose, pure data movement.
//
// Replaces rfi_toolbox_tpu/ops/fused_channels.py
// (fused_plane_gather_transform, bodies _plane_gather_tf_kernel and
// _variant_transform_block). For each of K outputs i it reads the gradient
// plane pidx[i] of base patch base_idx[i] and that patch's log-amplitude and
// phase planes, applies variant[i]'s transpose (variants 2, 3) and then its
// row flip (variants 1, 3), and writes the three planes either as three
// (K, h, w) float32 planes (pixel stride 1) or as one channels-last
// (K, h, w, 3) tensor of images (pixel stride 3). In identity mode (no
// base_idx) output i is patch i of three (K, h, w) planes (K1's outputs),
// transformed by variant[i]. The plain version is preprocess/static_prep.py's
// transform_by_variant of the gathered planes; the kernel is bit-equal to it.
//
// Bound on the H100: bytes. Each distinct selected source square read once,
// 12 B written an output pixel, no arithmetic.
//
// Design. The Pallas kernel takes one output a grid step and reads its tiles;
// on the card that reads a base patch's tiles again for each of the up to 4
// outputs that select it (the selection is shuffled, so L2 does not catch the
// repeats). Here a CTA owns source squares instead:
// - a tile is cut into kSide x kSide squares (ragged at the bottom and right);
//   the units (base patch, square), in base-major order, are split into equal
//   contiguous ranges, one a CTA of a grid of at most the CTAs resident;
// - on a new base patch the CTA scans base_idx (from L2, as channel_planes.cu's
//   K1 does) for the outputs that select it: kListCap of them are listed at a
//   time, with the gradient planes they need;
// - a square's log-amplitude, phase and needed gradient planes come in by TMA
//   (cp.async.bulk.tensor.2d, one 32 x 32 box a plane, on an mbarrier) into
//   shared memory under the 128-byte swizzle (16-byte chunk c of row r at
//   c ^ (r % 8)), in a ring of kStages stages: the next squares' loads, and
//   the next base patch's scan, run while this square is stored;
// - every output that selects the patch gets the square in its variant, at
//   its mirrored position where the variant flips or transposes. Variants 0
//   and 1: a warp takes 4 rows of the square, a lane a 16-byte chunk (8 lanes
//   a row: no bank conflict). Variants 2 and 3: a warp takes one column of
//   chunks, a lane the chunk of one of the 32 rows (8 consecutive rows a
//   quarter-warp: distinct banks under the swizzle), and each 4 lanes
//   transpose their 4 x 4 values by shuffles, so that a lane holds 4
//   consecutive pixels of an output row. Stores are 16-byte streaming stores:
//   one a plane (stride 1); for stride 3 a warp interleaves its 4 output rows'
//   pixels in shared memory first and stores each row's 96 floats as 24
//   consecutive 16-byte chunks (a lane's own three 16-byte stores, 48 bytes
//   apart, would write each 32-byte sector in halves).
// Where w % 4 != 0 or a pointer is not 16-byte aligned, the threads load the
// squares into the same layout and store pixel by pixel.
// The indices are checked here: a base_idx outside [0, m), a pidx outside
// [0, 3), a variant outside [0, 4), or a transposing variant where h != w
// traps (every CTA scans all of base_idx; the CTA that owns an output's base
// patch reads its pidx and variant; in identity mode the variant).
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

using namespace rfi;

constexpr int kSide = 32;              // a square's side: one TMA box of 128-byte rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // a warp per 4 rows, or per column of chunks
constexpr int kBlocksPerSm = 4;
constexpr int kSlots = 5;              // a stage: log-amplitude, phase, gradient planes 0-2
constexpr int kSquare = kSide * kSide;  // floats of a plane's square
constexpr int kStages = 2;          // squares in flight: one stored while the next loads
constexpr int kLists = kStages + 1;
// the two stages, and the 1024 bytes the swizzle's alignment may take
constexpr int kSmemBytes = kStages * kSlots * kSquare * 4 + 1024;
constexpr int kListCap = 64;  // a base patch's outputs listed at a time
constexpr int kScan = 8;      // base indices a thread loads at a time
// a wait for a square's loads that outlasts this many cycles, some 10 s,
// traps: a CUDA error at the next synchronisation instead of a hung card
constexpr long long kWaitCycles = 1LL << 34;
static_assert(kWarps * 4 == kSide, "8 warps of 4 rows, or of a chunk column each");

struct Params {
  CUtensorMap grad_map, amp_map, phase_map;  // kFast only
  const float* grad;      // (3, m, h, w) gradient planes; identity (k, h, w)
  const float* amp;       // (m, h, w)
  const float* phase;     // (m, h, w)
  const void* base_idx;   // (k,) int32 or int64; null: identity
  const void* pidx;       // (k,)
  const void* variant;    // (k,)
  float* out;             // stride 1: (3, k, h, w); stride 3: (k, h, w, 3)
  long long plane_step;   // floats from an output pixel's plane to the next
  long long units;        // m * squares
  int m, k, h, w;
  int sq_cols, squares;   // squares across a tile, squares a tile
  int idx64;
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The float offset of (row, col) in a square: 128-byte rows, the 16-byte
// chunk c of row r at c ^ (r % 8), as CU_TENSOR_MAP_SWIZZLE_128B writes it
// into a 1024-byte aligned box.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kSide + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ long long index_at(const void* p, int i, int idx64) {
  return idx64 ? __ldg(static_cast<const long long*>(p) + i)
               : static_cast<long long>(__ldg(static_cast<const int*>(p) + i));
}

// One 32 x 32 box of `map` at column x, row y into `dst`, completing on `bar`.
__device__ __forceinline__ void box_load(float* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = shared_address(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ float pick(const float4& a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}

__device__ __forceinline__ void put(float4& a, int i, float v) {
  if (i == 0) a.x = v;
  if (i == 1) a.y = v;
  if (i == 2) a.z = v;
  if (i == 3) a.w = v;
}

// Lanes 4g + l (l < 4) hold row l of a 4 x 4 block; each returns column l.
// Round s: lane l sends its element (l + s) % 4 and takes from lane
// (l - s) % 4 that lane's element l.
__device__ __forceinline__ float4 transpose4(float4 a, int lane) {
  const int l = lane & 3, group = lane & ~3;
  float4 b = a;
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    put(b, (l - s) & 3, __shfl_sync(kFullMask, pick(a, (l + s) & 3), group | ((l - s) & 3)));
  }
  return b;
}

__device__ __forceinline__ float4 square_chunk(const float* sq, int row, int col) {
  return *reinterpret_cast<const float4*>(sq + swizzled(row, col));
}

// 4 pixels of the three planes (stride 1) from pixel index px: 16-byte
// streaming stores.
__device__ __forceinline__ void store4(const Params& p, size_t px, float4 g, float4 a,
                                       float4 ph) {
  float* o = p.out + px;
  __stcs(reinterpret_cast<float4*>(o), g);
  __stcs(reinterpret_cast<float4*>(o + p.plane_step), a);
  __stcs(reinterpret_cast<float4*>(o + 2 * p.plane_step), ph);
}

template <int kStride>
__device__ __forceinline__ void store1(const Params& p, size_t px, float g, float a, float ph) {
  float* o = p.out + kStride * px;
  __stcs(o, g);
  __stcs(o + p.plane_step, a);
  __stcs(o + 2 * p.plane_step, ph);
}

// kFast: TMA loads and 16-byte stores (w % 4 == 0, every pointer 16-byte
// aligned); else per-thread loads and stores. kStride: 1 or 3.
template <bool kFast, int kStride>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
plane_gather_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  float* const stages =
      reinterpret_cast<float*>(smem_raw + ((1024u - (shared_address(smem_raw) & 1023u)) & 1023u));
  __shared__ uint64_t bars[kStages];
  // list slots, one a base patch, in a ring: the units in flight (at most
  // kStages) and the next one belong to at most kLists patches
  __shared__ int list_out[kLists][kListCap];
  __shared__ int list_info[kLists][kListCap];  // pidx | variant << 2
  __shared__ unsigned list_mask[kLists];       // the gradient planes of all the patch's outputs
  __shared__ int list_first[kLists];           // the rank of the slot's first entry
  __shared__ int list_total[kLists];           // the patch's outputs
  __shared__ int hits[2][kWarps];
  // stride 3: a warp's 4 output rows of 32 pixels, interleaved
  __shared__ __align__(16) float out_stage[kFast && kStride == 3 ? kWarps * 4 * 96 : 4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool identity = p.base_idx == nullptr;
  const int h = p.h, w = p.w;
  const size_t hw = static_cast<size_t>(h) * w;
  const long long u_begin = p.units * blockIdx.x / gridDim.x;
  const long long u_end = p.units * (blockIdx.x + 1) / gridDim.x;

  if (kFast && tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(&bars[s])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  unsigned parity = 0u;  // bit s: the phase of bars[s] that its next loads complete

  // The outputs that select base patch b, of rank [first, first + kListCap)
  // in the order of base_idx, into list slot s (a scan as K1's: a thread
  // takes kScan consecutive indices, a block-wide prefix sum of the matches
  // ranks them). Returns their count; list_mask[s] gets their gradient
  // planes, list_total[s] the count where first is 0. Traps on a bad index.
  auto collect = [&](int b, int first, int s) {
    if (identity) {
      if (tid == 0) {
        const long long v = index_at(p.variant, b, p.idx64);
        if (v < 0 || v > 3 || (v >= 2 && h != w)) __trap();
        list_out[s][0] = b;
        list_info[s][0] = static_cast<int>(v) << 2;
        list_mask[s] = 1u;
        list_first[s] = 0;
        list_total[s] = 1;
      }
      __syncthreads();
      return 1;
    }
    int seen = 0;
    unsigned bits = 0u;
    if (tid == 0) list_mask[s] = 0u;
    for (int e0 = 0, step = 0; e0 < p.k; e0 += kScan * kThreads, ++step) {
      const int e1 = e0 + tid * kScan;
      bool match[kScan];
      int count = 0;
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        match[u] = false;
        if (e1 + u < p.k) {
          const long long key = index_at(p.base_idx, e1 + u, p.idx64);
          if (key < 0 || key >= p.m) __trap();
          match[u] = key == b;
          count += match[u];
        }
      }
      int before = count;  // inclusive prefix sum in the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFullMask, before, o);
        if (lane >= o) before += t;
      }
      if (lane == 31) hits[step & 1][warp] = before;
      __syncthreads();
      before += seen - count;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int c = hits[step & 1][i];
        before += i < warp ? c : 0;
        seen += c;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (!match[u]) continue;
        const long long pl = index_at(p.pidx, e1 + u, p.idx64);
        const long long v = index_at(p.variant, e1 + u, p.idx64);
        if (pl < 0 || pl > 2 || v < 0 || v > 3 || (v >= 2 && h != w)) __trap();
        bits |= 1u << pl;
        if (before >= first && before - first < kListCap) {
          list_out[s][before - first] = e1 + u;
          list_info[s][before - first] = static_cast<int>(pl) | static_cast<int>(v) << 2;
        }
        ++before;
      }
    }
    if (bits) atomicOr(&list_mask[s], bits);
    if (tid == 0) {
      list_first[s] = first;
      if (first == 0) list_total[s] = seen;
    }
    __syncthreads();
    return seen;
  };

  // The first unit in [u, u_end) whose base patch some output selects (else
  // u_end), its outputs listed in slot s.
  auto find = [&](long long u, int s) {
    while (u < u_end) {
      const int b = static_cast<int>(u / p.squares);
      if (collect(b, 0, s) > 0) return u;
      u = static_cast<long long>(b + 1) * p.squares;
    }
    return u_end;
  };

  // Unit u's planes (list slot s gives the gradient planes) into stage st.
  auto issue = [&](long long u, int s, int st) {
    const int b = static_cast<int>(u / p.squares);
    const int sq = static_cast<int>(u - static_cast<long long>(b) * p.squares);
    const int r0 = (sq / p.sq_cols) * kSide, c0 = (sq % p.sq_cols) * kSide;
    float* const dst = stages + st * kSlots * kSquare;
    const unsigned mask = list_mask[s];
    if constexpr (kFast) {
      if (tid == 0) {
        // the stage's earlier generic reads before the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const unsigned bytes = (2u + __popc(mask)) * kSquare * 4u;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         shared_address(&bars[st])),
                     "r"(bytes)
                     : "memory");
        box_load(dst, &p.amp_map, c0, b * h + r0, &bars[st]);
        box_load(dst + kSquare, &p.phase_map, c0, b * h + r0, &bars[st]);
        for (int pl = 0; pl < 3; ++pl) {
          if (mask & (1u << pl)) {
            box_load(dst + (2 + pl) * kSquare, &p.grad_map, c0, (pl * p.m + b) * h + r0,
                     &bars[st]);
          }
        }
      }
    } else {
      for (int slot = 0; slot < kSlots; ++slot) {
        if (slot >= 2 && !(mask & (1u << (slot - 2)))) continue;
        const float* src = slot == 0   ? p.amp + b * hw
                           : slot == 1 ? p.phase + b * hw
                                       : p.grad + (static_cast<size_t>(slot - 2) * p.m + b) * hw;
        for (int i = tid; i < kSquare; i += kThreads) {
          const int row = i / kSide, col = i % kSide, r = r0 + row, c = c0 + col;
          dst[slot * kSquare + swizzled(row, col)] =
              r < h && c < w ? src[static_cast<size_t>(r) * w + c] : 0.0f;
        }
      }
    }
  };

  // Unit u's square, in stage st, to every output that selects its base
  // patch (list slot s), each in its variant.
  auto store = [&](long long u, int s, int st) {
    const int b = static_cast<int>(u / p.squares);
    const int sq = static_cast<int>(u - static_cast<long long>(b) * p.squares);
    const int r0 = (sq / p.sq_cols) * kSide, c0 = (sq % p.sq_cols) * kSide;
    const int nr = min(kSide, h - r0), nc = min(kSide, w - c0);
    const float* const amp = stages + st * kSlots * kSquare;
    const float* const phase = amp + kSquare;
    const int total = list_total[s];
    for (int first = 0; first < total; first += kListCap) {
      if (list_first[s] != first) {
        __syncthreads();  // every thread is done with the list
        collect(b, first, s);
      }
      const int n = min(total - first, kListCap);
      for (int i = 0; i < n; ++i) {
        const int info = list_info[s][i];
        const int v = info >> 2;
        const float* const grad = amp + (2 + (info & 3)) * kSquare;
        const size_t out0 = static_cast<size_t>(list_out[s][i]) * hw;
        if constexpr (kFast) {
          // A warp's 4 output rows rho of 32 pixels, a lane 4 pixels (t) of
          // one: variants 0, 1 the square's rows 4 warp + rho (a lane's
          // chunk of a row), 2, 3 its columns 4 warp + rho (a lane's chunk
          // of row lane, transposed in 4 x 4 by its 4 lanes).
          const bool flip = v == 1 || v == 3;
          int rho, t, lead, n_px, start;
          float4 g, a, ph;
          if (v < 2) {
            rho = lane >> 3;
            t = lane & 7;
            g = square_chunk(grad, 4 * warp + rho, 4 * t);
            a = square_chunk(amp, 4 * warp + rho, 4 * t);
            ph = square_chunk(phase, 4 * warp + rho, 4 * t);
            lead = r0, n_px = nc, start = c0;  // row r0 + 4 warp + rho, pixels c0..
          } else {
            rho = lane & 3;
            t = lane >> 2;
            g = transpose4(square_chunk(grad, lane, 4 * warp), lane);
            a = transpose4(square_chunk(amp, lane, 4 * warp), lane);
            ph = transpose4(square_chunk(phase, lane, 4 * warp), lane);
            lead = c0, n_px = nr, start = r0;  // row c0 + 4 warp + rho, pixels r0..
          }
          const int rows = v < 2 ? nr : nc;  // the square's rows or columns
          // the pixel index of output row rho's first pixel, -1 past the square
          auto row_px = [&](int rr) -> long long {
            const int q = 4 * warp + rr;
            if (q >= rows) return -1;
            return static_cast<long long>(out0) +
                   static_cast<long long>(flip ? h - 1 - lead - q : lead + q) * w + start;
          };
          if constexpr (kStride == 1) {
            const long long px = row_px(rho);
            if (px >= 0 && 4 * t < n_px) store4(p, px + 4 * t, g, a, ph);
          } else {
            // interleave the 12 floats in the warp's staging rows, then store
            // each row's 96 floats as 24 consecutive 16-byte chunks
            float* const staged = out_stage + warp * 4 * 96;
            const float gv[4] = {g.x, g.y, g.z, g.w}, av[4] = {a.x, a.y, a.z, a.w},
                        pv[4] = {ph.x, ph.y, ph.z, ph.w};
            float4* const mine = reinterpret_cast<float4*>(staged + rho * 96 + 12 * t);
            mine[0] = make_float4(gv[0], av[0], pv[0], gv[1]);
            mine[1] = make_float4(av[1], pv[1], gv[2], av[2]);
            mine[2] = make_float4(pv[2], gv[3], av[3], pv[3]);
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int f = 32 * j + lane, rr = f / 24, q = f - 24 * rr;
              const long long px = row_px(rr);
              if (px >= 0 && 4 * q < 3 * n_px) {
                __stcs(reinterpret_cast<float4*>(p.out + 3 * px) + q,
                       reinterpret_cast<const float4*>(staged)[f]);
              }
            }
            __syncwarp();  // the staging rows are reused by the next output
          }
        } else {
          for (int e = tid; e < nr * nc; e += kThreads) {
            int row, col;
            size_t px;
            if (v < 2) {
              row = e / nc;
              col = e - row * nc;
              px = static_cast<size_t>(v == 0 ? r0 + row : h - 1 - r0 - row) * w + c0 + col;
            } else {
              col = e / nr;
              row = e - col * nr;
              px = static_cast<size_t>(v == 2 ? c0 + col : h - 1 - c0 - col) * w + r0 + row;
            }
            const int off = swizzled(row, col);
            store1<kStride>(p, out0 + px, grad[off], amp[off], phase[off]);
          }
        }
      }
    }
  };

  // a ring of kStages stages: up to kStages - 1 units load while one is
  // stored; the units' list slots ring over the patches' ordinals
  long long q_unit[kStages];
  int q_list[kStages];
  int ordinal = 0, issued = 0, done = 0;
  long long next = find(u_begin, 0);
  auto queue = [&]() {  // issue `next`, then find the unit after it
    const int st = issued % kStages, slot = ordinal % kLists;
    q_unit[st] = next;
    q_list[st] = slot;
    issue(next, slot, st);
    ++issued;
    const long long after = next + 1;
    if (after < u_end && after / p.squares != next / p.squares) {
      ++ordinal;
      next = find(after, ordinal % kLists);
    } else {
      next = after;
    }
  };
  while (issued < kStages - 1 && next < u_end) queue();
  while (done < issued) {
    if (next < u_end) queue();
    const int st = done % kStages;
    if constexpr (kFast) {
      bar_wait(&bars[st], (parity >> st) & 1u);
      parity ^= 1u << st;
    } else {
      __syncthreads();
    }
    store(q_unit[st], q_list[st], st);
    __syncthreads();  // the stage is reused
    ++done;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, by the runtime's entry-point query (no -lcuda).
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// A map of `rows` float32 rows of w floats at `base`, read in 32 x 32 boxes
// under the 128-byte swizzle (rows past the end read as zeros).
cudaError_t encode(CUtensorMap* map, const void* base, int w, long long rows) {
  EncodeTiled fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w) * 4u};
  const cuuint32_t box[2] = {kSide, kSide};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// With `occupancy`: out[0] CTAs resident on an SM, out[1] on the card, out[2]
// dynamic shared memory bytes a CTA; launches nothing. Else the launch of a
// grid of at most the resident CTAs.
template <bool kFast, int kStride>
cudaError_t launch(const Params& prm, cudaStream_t stream, int* occupancy) {
  auto kernel = plane_gather_kernel<kFast, kStride>;
  static int per_sm[64] = {};  // by device, once
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm[device] == 0) {
    // the static staging rows (stride 3) and the stages exceed the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (fit <= 0) return cudaErrorInvalidConfiguration;
    per_sm[device] = fit;
  }
  const long long resident = static_cast<long long>(per_sm[device]) * sms;
  if (occupancy) {
    occupancy[0] = per_sm[device];
    occupancy[1] = static_cast<int>(resident);
    occupancy[2] = kSmemBytes;
    return cudaSuccess;
  }
  const long long grid = prm.units < resident ? prm.units : resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(prm);
  return cudaGetLastError();
}

cudaError_t dispatch(bool fast, int stride, const Params& prm, cudaStream_t stream,
                     int* occupancy) {
  if (stride == 3) {
    return fast ? launch<true, 3>(prm, stream, occupancy) : launch<false, 3>(prm, stream, occupancy);
  }
  return fast ? launch<true, 1>(prm, stream, occupancy) : launch<false, 1>(prm, stream, occupancy);
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// grad: (3, m, h, w) float32 gradient planes, amp and phase (m, h, w); base_idx,
// pidx, variant: (k,) int32 (idx64 0) or int64 (idx64 1) on the card, each
// base_idx in [0, m), pidx in [0, 3), variant in [0, 4), and 2 or 3 only where
// h == w (checked in the kernel: a bad index traps). Identity mode: base_idx
// and pidx null, m == k, grad (k, h, w): output i is patch i in variant[i].
// out: stride 1 three planes (3, k, h, w), stride 3 images (k, h, w, 3),
// float32. Launches one kernel on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_plane_gather_transform(const void* grad, const void* amp,
                                                const void* phase, const void* base_idx,
                                                const void* pidx, const void* variant, void* out,
                                                int m, int k, int h, int w, int stride,
                                                int idx64, void* stream) {
  const bool identity = base_idx == nullptr;
  if (m <= 0 || k <= 0 || h <= 0 || w <= 0 || (stride != 1 && stride != 3) ||
      identity != (pidx == nullptr) || (identity && m != k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  memset(&prm, 0, sizeof(prm));
  prm.grad = static_cast<const float*>(grad);
  prm.amp = static_cast<const float*>(amp);
  prm.phase = static_cast<const float*>(phase);
  prm.base_idx = base_idx;
  prm.pidx = pidx;
  prm.variant = variant;
  prm.out = static_cast<float*>(out);
  prm.plane_step = stride == 3 ? 1 : static_cast<long long>(k) * h * w;
  prm.m = m;
  prm.k = k;
  prm.h = h;
  prm.w = w;
  prm.sq_cols = (w + kSide - 1) / kSide;
  prm.squares = prm.sq_cols * ((h + kSide - 1) / kSide);
  prm.units = static_cast<long long>(m) * prm.squares;
  prm.idx64 = idx64 != 0;
  const bool fast =
      w % 4 == 0 && aligned(grad) && aligned(amp) && aligned(phase) && aligned(out);
  if (fast) {
    const long long rows = static_cast<long long>(m) * h;
    cudaError_t err = encode(&prm.grad_map, grad, w, (identity ? 1 : 3) * rows);
    if (err == cudaSuccess) err = encode(&prm.amp_map, amp, w, rows);
    if (err == cudaSuccess) err = encode(&prm.phase_map, phase, w, rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(dispatch(fast, stride, prm, static_cast<cudaStream_t>(stream), nullptr));
}

// The kernel's instance of TMA (fast != 0) or per-thread loads, pixel stride
// 1 or 3: out[0] CTAs resident on an SM, out[1] on the card, out[2] dynamic
// shared memory bytes a CTA. Launches nothing.
extern "C" int rfi_plane_gather_occupancy(int fast, int stride, int* out) {
  if (stride != 1 && stride != 3) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  memset(&prm, 0, sizeof(prm));
  return static_cast<int>(dispatch(fast != 0, stride, prm, nullptr, out));
}
