// K4, K2 and K1 on patches larger than the cluster kernel takes (H * W above
// 128 x 128) whose rows fit, cut into slabs, in the shared memory of the CTAs
// resident on the card: one launch, each patch held across the CTAs that
// hold its slabs, the input read once and every output written once.
//
// Replaces, for those sizes, rfi_toolbox_tpu/ops/fused_channels.py
// fused_extract_channels (K4, body _kernel: (N, H, W) complex64 or float32 ->
// (N, H, W, 3) float32, [gradient, log-amplitude, phase] interleaved and
// ImageNet-normalised), fused_extract_channel_planes (K2, body
// _planes_kernel: grad3 (3, N, H, W), log-amplitude and phase (N, H, W)) and
// fused_gather_extract (K1, body _gather_kernel: for each of K outputs the
// gradient plane pidx[i] of base patch base_idx[i], its log-amplitude and
// phase, (K, H, W) each). The Pallas kernels take a whole (h, w) patch a grid
// step; the plain PyTorch versions are preprocess/pipeline.py:
// imagenet_normalize(extract_channels(x)) and extract_channel_planes(x) (K1:
// then a gather). Real input gets the min-max log-amplitude and a zero phase.
//
// Why not one cluster (channel_planes.cu): a 1024 x 1024 patch's float plane
// (4 MB) exceeds a cluster's distributed shared memory (16 CTAs, some 3.6
// MB), but not that of the whole resident grid (132 SMs x 4 x 54 KB, some
// 28.5 MB). The two-pass strip kernel (extract_strips.cu) it replaces where the
// slabs fit reads the input twice in three launches, and K1 there goes
// through a scratch of planes and K3's gather.
//
// Bound on the H100: bytes. K4 reads 8 B (4 B real) and writes 12 B a pixel,
// K2 writes 20 B, K1 reads each selected base patch once and writes 12 B an
// output pixel. This kernel reads each pixel once from HBM, plus two halo
// rows a slab (mostly L2 hits: the neighbouring slabs are loaded at about the
// same time), and writes each output once.
//
// Design. The wrapper cuts a patch into G slabs of R whole rows
// (fused_channels.py:extract_route); a slab with its two halo rows fits in
// kSmemBudget of dynamic shared memory, four CTAs an SM. The grid is at most
// the CTAs resident on the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs), launched cooperatively, and the launch is refused where G is
// larger. CTAs take slabs in patch-major order from a ticket counter
// (atomicAdd):
//   A. cp.async.bulk (TMA) copies bring the slab's rows and its halo rows
//      where the input and a row are 16-byte aligned, in up to kMaxChunks
//      chunks of rows, each completing on its own mbarrier, so that the
//      first chunks are converted while the others load; per-thread loads
//      elsewhere. Each pixel becomes log10|x| in place
//      (complex input: (log10|z|, phase) in the place of (re, im), so K4's
//      stores stay interleaved and K1 writes the phase from shared memory).
//      K2 writes complex input's amplitude and phase planes, and real
//      input's zero phase, here: they do not depend on the patch's min and
//      max. Each gradient plane's min and max over the slab's rows (of the
//      squares, NaN skipped; their correctly rounded roots order alike), and
//      real input's log-amplitude's, are reduced per warp, then per block,
//      and combined into the patch's slots with atomicMax on
//      order-preserving uint32 keys (a min as the key's complement): the
//      result does not depend on the order. Then one thread arrives on the
//      patch's counter (release).
//   B. that thread waits (acquire) until the counter reaches G and reads the
//      keys; the block normalises the slab's gradient roots from shared
//      memory (common.cuh: Norm, amp_value) and stores: K4 three 16-byte
//      streaming stores for 4 pixels, K2 one store a plane, K1 the selected
//      gradient plane, the amplitude and the phase of every output that
//      selects the base patch, found by a scan of base_idx in order,
//      kListCap at a time (as channel_planes.cu). A base patch that no
//      output selects is neither read nor computed, and its slabs do not
//      arrive.
// No deadlock: a CTA arrives before it waits, and every CTA is resident: the
// launch is cooperative, so the grid starts only once all of it is held at
// once, whatever other streams run (where it never could be, the launch is
// refused and the wrapper raises). A waiting CTA holds a ticket of a patch
// whose tickets are not all taken; tickets go out in order, so only one
// patch can be in that state, and at most G - 1 of its CTAs wait: with G <=
// the grid, some CTA is free to take the next ticket. The scratch (the
// ticket counter, a counter and 8 keys a patch) is zeroed by cudaMemsetAsync
// before the launch: no other kernel.
// The magnitude and the gradients are bit-equal to the plain version's
// (common.cuh: magnitude; each square and sum rounded apart, no FMA
// contraction) and the affines are the cluster and strip kernels', so the
// outputs equal the strip kernel's bit for bit.
//
// Where the time goes (PERF.md; tools/extract_groups_variants.py stamps each
// slab's phases): the loads and the conversion (|z|, log10, atan2) are
// 46-63% of a slab's time, the wait for the patch's other slabs 17-25%. A
// patch of 1024-wide complex rows fits 4 rows a slab, and its halo rows,
// converted again, make K4 slower there than the strip kernel's second read;
// the wrapper then takes the strip kernel for K4
// (fused_channels.py:GROUP_MIN_ROWS).
// Tried on the H100 and not kept: 512 threads and 2 CTAs an SM (110 KB), or
// 1024 and 1 (220 KB), with more rows a slab: 6-29% slower at 256^2 at their
// best rows, and at (128, 1024, 1024) 2.38-2.45 ms against this 2.53 and the
// strip kernel's 2.06; one bulk copy a slab instead of chunks: 2-16% slower.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace rfi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
// dynamic shared memory of a CTA at most: a slab and its halo rows
// (GROUP_SMEM_BYTES in fused_channels.py); four such CTAs and their static
// shared memory fit in an SM's 228 KB
constexpr int kSmemBudget = 54 * 1024;
constexpr int kListCap = 64;  // K1: a base patch's outputs listed at a time
constexpr int kScan = 8;      // K1: base indices a thread loads at a time
constexpr int kMaxChunks = 16;  // bulk copies (each on its own mbarrier) a slab
// the kernel's three functions (its kKind), numbered as channel_planes.cu's
constexpr int kK2 = 0;
constexpr int kK1 = 1;
constexpr int kK4 = 2;
// a patch's reduced values: slots 0-2 the squared gradient planes, 3 the
// log-amplitude (real input); key s the complement of slot s's min, key
// kSlots + s its max
constexpr int kSlots = 4;
constexpr int kKeys = 2 * kSlots;
// a wait (for a bulk copy, for a patch's slabs) that outlasts this many
// cycles, some 10 s, traps: a CUDA error at the next synchronisation
// instead of a hung card (no wait should take a millisecond)
constexpr long long kWaitCycles = 1LL << 34;

// Order-preserving map of float32 to uint32 (NaN never enters it).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned bits = __float_as_uint(f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  const unsigned b = shared_address(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, unsigned parity) {
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

__device__ __forceinline__ void arrive_release(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* counter) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

// kPx pixels of the tile from `p` (the first one's slot): complex input's
// (log10|z|, phase) pairs or real input's log10|x|.
template <bool kComplex, int kPx>
__device__ __forceinline__ void tile_read(const float* p, float (&la)[kPx], float (&ph)[kPx]) {
  if constexpr (kComplex && kPx == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    la[0] = a.x, ph[0] = a.y, la[1] = a.z, ph[1] = a.w;
    la[2] = b.x, ph[2] = b.y, la[3] = b.z, ph[3] = b.w;
  } else if constexpr (kComplex) {
    la[0] = p[0], ph[0] = p[1];
  } else if constexpr (kPx == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    la[0] = a.x, la[1] = a.y, la[2] = a.z, la[3] = a.w;
  } else {
    la[0] = p[0];
  }
}

// The gradients of kPx pixels at tile row lr (the halo rows are 0 and rows +
// 1), column c, patch row r: g[0] fwd/fwd, g[1] down/fwd, g[2] fwd/down
// (those in `mask`), their squares where kRoot is false; la their
// log-amplitudes, ph complex input's phases. As channel_planes.cu's
// `gradients`, on a tile of `pitch` floats a row and kComplex ? 2 : 1 floats
// a pixel.
template <bool kComplex, int kPx, bool kRoot>
__device__ __forceinline__ void gradients(const float* tile, int pitch, int lr, int c, int r,
                                          int h, int w, unsigned mask, float (&g)[3][kPx],
                                          float (&la)[kPx], float (&ph)[kPx]) {
  constexpr int kE = kComplex ? 2 : 1;
  const float* row = tile + lr * pitch + c * kE;
  const bool has_up = r > 0, has_down = r < h - 1;
  float up[kPx] = {}, down[kPx] = {}, unused[kPx];
  tile_read<kComplex, kPx>(row, la, ph);
  if (has_up) tile_read<kComplex, kPx>(row - pitch, up, unused);
  if (has_down) tile_read<kComplex, kPx>(row + pitch, down, unused);
  // e: the kPx pixels with the pixel left and right of them
  float e[kPx + 2];
  e[0] = c > 0 ? row[-kE] : 0.0f;
  e[kPx + 1] = c + kPx < w ? row[kPx * kE] : 0.0f;
#pragma unroll
  for (int i = 0; i < kPx; ++i) e[i + 1] = la[i];
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const float td_fwd = has_up ? __fsub_rn(la[i], up[i]) : 0.0f;
    const float td_down = has_down ? __fsub_rn(down[i], la[i]) : 0.0f;
    const float fd_fwd = c + i > 0 ? __fsub_rn(la[i], e[i]) : 0.0f;
    const float fd_down = c + i < w - 1 ? __fsub_rn(e[i + 2], la[i]) : 0.0f;
    const float tf2 = __fmul_rn(td_fwd, td_fwd);
    const float ff2 = __fmul_rn(fd_fwd, fd_fwd);
    if (mask & 1u) g[0][i] = __fadd_rn(tf2, ff2);
    if (mask & 2u) g[1][i] = __fadd_rn(__fmul_rn(td_down, td_down), ff2);
    if (mask & 4u) g[2][i] = __fadd_rn(tf2, __fmul_rn(fd_down, fd_down));
    if constexpr (kRoot) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (mask & (1u << v)) g[v][i] = __fsqrt_rn(g[v][i]);
      }
    }
  }
}

// kK4: patch b's three channels into grad (= out, (n, h, w, 3)); amp and
// phase unused. kK2: b's planes into grad (= grad3, (3, n, h, w)), amp and
// phase ((n, h, w)). kK1: the planes of the outputs that select base patch b
// into grad, amp and phase ((k, h, w)). kPx: pixels a group (4 needs w % 4
// == 0 and 16-byte aligned outputs). scratch: [0] the ticket counter, [1, 1 +
// n) each patch's arrivals, then kKeys keys a patch, all zero at the launch.
// tma: the input and a row are 16-byte aligned.
template <bool kComplex, int kKind, int kPx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
group_extract_kernel(const float* __restrict__ in, const int* __restrict__ base_idx,
                     const int* __restrict__ pidx, float* __restrict__ grad,
                     float* __restrict__ amp, float* __restrict__ phase,
                     unsigned* __restrict__ scratch, int n, int k, int h, int w, int slab_rows,
                     int slabs, bool tma) {
  constexpr bool kGather = kKind == kK1;
  constexpr int kE = kComplex ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (slab_rows + 2) x pitch
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ float part[kKeys][kWarps];
  __shared__ float bounds[kKeys];  // the patch's min (0..3) and max of each slot
  __shared__ int list_out[kGather ? kListCap : 1];
  __shared__ int list_plane[kGather ? kListCap : 1];
  __shared__ int hits[2][kWarps];
  __shared__ unsigned plane_mask;
  __shared__ int ticket;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int pitch = w * kE;
  const int row_groups = w / kPx;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t plane = static_cast<size_t>(n) * hw;  // K2: a gradient plane of grad3
  const long long total = static_cast<long long>(n) * slabs;
  unsigned* const arrived = scratch + 1;
  unsigned* const keys = scratch + 1 + n;

  // a chunk of the slab's bulk copies: at least a group of every thread's
  // pixels, at most kMaxChunks chunks a slab
  const int chunk_rows = max((kThreads * kPx + w - 1) / w,
                             (slab_rows + 2 + kMaxChunks - 1) / kMaxChunks);
  if (tid == 0) {
    for (int c = 0; c < kMaxChunks; ++c) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(&bars[c])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  unsigned phases = 0u;  // bit c: the phase of bars[c] that the next copy completes

  // K1: a scan of base_idx, in order, for the outputs that select b (as
  // channel_planes.cu's `collect`: a thread takes kScan consecutive indices,
  // a block-wide prefix sum of the matches ranks them); the ones of rank
  // [first, first + kListCap) go to the list. Returns their count;
  // plane_mask gets the gradient planes they select.
  auto collect = [&](int b, int first) {
    int seen = 0;
    unsigned bits = 0u;
    if (tid == 0) plane_mask = 0u;
    for (int e0 = 0, step = 0; e0 < k; e0 += kScan * kThreads, ++step) {
      const int e1 = e0 + tid * kScan;
      int key[kScan];
      int count = 0;
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        key[u] = e1 + u < k ? base_idx[e1 + u] : -1;
        count += key[u] == b;
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
        if (key[u] != b) continue;
        const int v = pidx[e1 + u];
        bits |= 1u << v;
        if (before >= first && before - first < kListCap) {
          list_out[before - first] = e1 + u;
          list_plane[before - first] = v;
        }
        ++before;
      }
    }
    if (bits) atomicOr(&plane_mask, bits);
    __syncthreads();
    return seen;
  };

  for (;;) {
    if (tid == 0) ticket = static_cast<int>(atomicAdd(scratch, 1u));
    __syncthreads();
    const int t = ticket;
    if (t >= total) break;
    const int b = t / slabs;
    const int r0 = (t - b * slabs) * slab_rows;
    const int rows = min(slab_rows, h - r0);
    int n_out = 1, n_list = 1;
    unsigned mask = kKind == kK4 ? 1u : 7u;  // K4: the fwd/fwd gradient only
    if constexpr (kGather) {
      n_out = collect(b, 0);
      if (n_out == 0) continue;  // no output selects b: its slabs are skipped
      n_list = min(n_out, kListCap);
      mask = plane_mask;
    }

    // A. the rows [lo, hi) of the patch: the slab and its halo rows; tile row
    // j holds patch row r0 - 1 + j. The bulk copies go out in chunks of
    // chunk_rows rows, each completing on its own mbarrier, so that the
    // conversion of the first chunks overlaps the loads of the others.
    const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, h);
    const int first_px = (lo - (r0 - 1)) * w;
    const int span_rows = hi - lo;
    const int chunks = (span_rows + chunk_rows - 1) / chunk_rows;
    const float* src = in + (static_cast<size_t>(b) * hw + static_cast<size_t>(lo) * w) * kE;
    if (tma) {
      if (tid == 0) {
        // the previous slab's generic accesses before the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int c = 0; c < chunks; ++c) {
          const int c0 = c * chunk_rows;
          const int n_rows = min(span_rows - c0, chunk_rows);
          bulk_load(tile + (first_px + c0 * w) * kE, src + static_cast<size_t>(c0) * w * kE,
                    static_cast<unsigned>(n_rows * w * kE) * 4u, &bars[c]);
        }
      }
    } else {
      float* dst = tile + first_px * kE;
      for (int i = tid; i < span_rows * w * kE; i += kThreads) dst[i] = src[i];
      __syncthreads();
    }

    // log10|x| in place (complex input: and the phase of the slab's rows);
    // real input's min and max, K2's planes that do not wait for the
    // patch's min and max
    float lo_v[kSlots], hi_v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      lo_v[s] = INFINITY;
      hi_v[s] = -INFINITY;
    }
    for (int c = 0; c < chunks; ++c) {
      if (tma) bulk_wait(&bars[c], (phases >> c) & 1u);
      const int chunk_end = min(span_rows, (c + 1) * chunk_rows) * w;
      for (int q = c * chunk_rows * w + tid * kPx; q < chunk_end; q += kThreads * kPx) {
        const int p = first_px + q;  // tile pixel
        const int lr = p / w;
        const bool own = lr >= 1 && lr <= rows;  // else a halo row
        float* slot = tile + p * kE;
        float la[kPx], ph[kPx];
        if constexpr (kComplex) {
          float2 z[kPx];
          if constexpr (kPx == 4) {
            const float4 a = reinterpret_cast<const float4*>(slot)[0];
            const float4 d = reinterpret_cast<const float4*>(slot)[1];
            z[0] = make_float2(a.x, a.y), z[1] = make_float2(a.z, a.w);
            z[2] = make_float2(d.x, d.y), z[3] = make_float2(d.z, d.w);
          } else {
            z[0] = make_float2(slot[0], slot[1]);
          }
#pragma unroll
          for (int i = 0; i < kPx; ++i) la[i] = log_amplitude(z[i]);
          if (own) {
#pragma unroll
            for (int i = 0; i < kPx; ++i) ph[i] = phase_value(z[i]);
          } else {
#pragma unroll
            for (int i = 0; i < kPx; ++i) ph[i] = 0.0f;  // never read
          }
          if constexpr (kPx == 4) {
            reinterpret_cast<float4*>(slot)[0] = make_float4(la[0], ph[0], la[1], ph[1]);
            reinterpret_cast<float4*>(slot)[1] = make_float4(la[2], ph[2], la[3], ph[3]);
          } else {
            slot[0] = la[0], slot[1] = ph[0];
          }
        } else {
          float x[kPx];
          if constexpr (kPx == 4) {
            const float4 a = *reinterpret_cast<const float4*>(slot);
            x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
          } else {
            x[0] = slot[0];
          }
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            la[i] = log10f(__fadd_rn(fabsf(x[i]), 1e-10f));
            ph[i] = kPhaseZero;
          }
          if constexpr (kPx == 4) {
            *reinterpret_cast<float4*>(slot) = make_float4(la[0], la[1], la[2], la[3]);
          } else {
            slot[0] = la[0];
          }
        }
        if (!own) continue;
        if constexpr (!kComplex) {
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            lo_v[3] = fminf(lo_v[3], la[i]);
            hi_v[3] = fmaxf(hi_v[3], la[i]);
          }
        }
        if constexpr (kKind == kK2) {
          const size_t o = static_cast<size_t>(b) * hw +
                           static_cast<size_t>(r0 + lr - 1) * w + (p - lr * w);
          if constexpr (kComplex) {
            float a[kPx];
#pragma unroll
            for (int i = 0; i < kPx; ++i) a[i] = amp_value(la[i]);
            store_out<kPx>(amp + o, a);
          }
          store_out<kPx>(phase + o, ph);
        }
      }
    }
    if (tma) phases ^= (1u << chunks) - 1u;
    __syncthreads();

    // each plane's min and max over the slab's rows, into the patch's keys
    const int groups = rows * row_groups;
    for (int g = tid; g < groups; g += kThreads) {
      const int lr = g / row_groups;
      const int c = (g - lr * row_groups) * kPx;
      float gr[3][kPx], la[kPx], ph[kPx];
      gradients<kComplex, kPx, false>(tile, pitch, lr + 1, c, r0 + lr, h, w, mask, gr, la, ph);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (!(mask & (1u << v))) continue;
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          lo_v[v] = fminf(lo_v[v], gr[v][i]);
          hi_v[v] = fmaxf(hi_v[v], gr[v][i]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      lo_v[s] = warp_min(lo_v[s]);
      hi_v[s] = warp_max(hi_v[s]);
      if (lane == 0) {
        part[s][warp] = lo_v[s];
        part[kSlots + s][warp] = hi_v[s];
      }
    }
    __syncthreads();
    unsigned* const patch_keys = keys + static_cast<size_t>(b) * kKeys;
    if (tid < kKeys) {  // thread t: slot t % kSlots, its min (t < kSlots) or max
      const int s = tid % kSlots;
      const bool used = s < 3 ? ((mask >> s) & 1u) != 0 : !kComplex;
      if (used) {
        float v = part[tid][0];
#pragma unroll
        for (int i = 1; i < kWarps; ++i) {
          v = tid < kSlots ? fminf(v, part[tid][i]) : fmaxf(v, part[tid][i]);
        }
        atomicMax(patch_keys + tid, tid < kSlots ? ~order_key(v) : order_key(v));
      }
    }
    __syncthreads();

    // B. wait for the patch's other slabs, then its min and max
    if (tid == 0) {
      __threadfence();
      arrive_release(arrived + b);
      const long long t0 = clock64();
      while (load_acquire(arrived + b) < static_cast<unsigned>(slabs)) {
        if (clock64() - t0 > kWaitCycles) __trap();
        __nanosleep(64);
      }
#pragma unroll
      for (int s = 0; s < kKeys; ++s) {
        const unsigned key = __ldcg(patch_keys + s);
        bounds[s] = key_value(s < kSlots ? ~key : key);
      }
    }
    __syncthreads();
    float lo_b[kSlots], hi_b[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      lo_b[s] = bounds[s];
      hi_b[s] = bounds[kSlots + s];
      if (s < 3) {  // the roots of the least and the largest square
        lo_b[s] = __fsqrt_rn(lo_b[s]);
        hi_b[s] = __fsqrt_rn(hi_b[s]);
      }
    }
    const Norm norm[3] = {Norm(lo_b[0], hi_b[0], kStd0, kShift0),
                          Norm(lo_b[1], hi_b[1], kStd0, kShift0),
                          Norm(lo_b[2], hi_b[2], kStd0, kShift0)};
    const Norm amp_norm(lo_b[3], hi_b[3], kStd1, kShift1);
    for (int first = 0; first < n_out; first += kListCap) {
      if constexpr (kGather) {
        if (first > 0) {
          __syncthreads();  // every thread is done with the list
          collect(b, first);
          n_list = min(n_out - first, kListCap);
        }
      }
      for (int g = tid; g < groups; g += kThreads) {
        const int lr = g / row_groups;
        const int c = (g - lr * row_groups) * kPx;
        float gr[3][kPx], la[kPx], ph[kPx], a[kPx];
        gradients<kComplex, kPx, true>(tile, pitch, lr + 1, c, r0 + lr, h, w, mask, gr, la, ph);
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          if (!(mask & (1u << v))) continue;
#pragma unroll
          for (int i = 0; i < kPx; ++i) gr[v][i] = norm[v](gr[v][i]);
        }
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          if constexpr (kComplex) {
            a[i] = amp_value(la[i]);
          } else {
            a[i] = amp_norm(la[i]);
            ph[i] = kPhaseZero;
          }
        }
        const size_t o = static_cast<size_t>(r0 + lr) * w + c;
        if constexpr (kKind == kK4) {
          store_channels<kPx>(grad + 3 * (static_cast<size_t>(b) * hw + o), gr[0], a, ph);
        } else if constexpr (kKind == kK2) {
          const size_t at = static_cast<size_t>(b) * hw + o;
#pragma unroll
          for (int v = 0; v < 3; ++v) store_out<kPx>(grad + v * plane + at, gr[v]);
          if constexpr (!kComplex) store_out<kPx>(amp + at, a);
        } else {
          for (int i = 0; i < n_list; ++i) {
            const int v = list_plane[i];
            const size_t at = static_cast<size_t>(list_out[i]) * hw + o;
            float sel[kPx];
#pragma unroll
            for (int j = 0; j < kPx; ++j) {
              sel[j] = v == 0 ? gr[0][j] : (v == 1 ? gr[1][j] : gr[2][j]);
            }
            store_out<kPx>(grad + at, sel);
            store_out<kPx>(amp + at, a);
            store_out<kPx>(phase + at, ph);
          }
        }
      }
    }
    __syncthreads();  // the tile, the list and the ticket are reused by the next slab
  }
}

struct Args {
  const void* in;
  const void* base_idx;
  const void* pidx;
  void* grad;
  void* amp;
  void* phase;
  void* scratch;
  int n, k, h, w, rows;
  cudaStream_t stream;
};

// With `occupancy`: out[0] CTAs resident on one SM at kSmemBudget, out[1]
// that times the SMs, out[2] kSmemBudget; launches nothing. Else the launch.
template <bool kComplex, int kKind, int kPx>
cudaError_t launch(const Args& a, int* occupancy) {
  auto kernel = group_extract_kernel<kComplex, kKind, kPx>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int kE = kComplex ? 2 : 1;
  const size_t smem = occupancy ? static_cast<size_t>(kSmemBudget)
                                : static_cast<size_t>(a.rows + 2) * a.w * kE * sizeof(float);
  if (smem > static_cast<size_t>(kSmemBudget)) return cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    occupancy[0] = per_sm;
    occupancy[1] = per_sm * sms;
    occupancy[2] = kSmemBudget;
    return cudaSuccess;
  }
  const int slabs = (a.h + a.rows - 1) / a.rows;
  const long long total = static_cast<long long>(a.n) * slabs;
  const long long resident = static_cast<long long>(per_sm) * sms;
  // every slab of a patch must be held at once (see the header)
  if (slabs > resident || total + resident >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t words = 1 + static_cast<size_t>(a.n) * (1 + kKeys);
  err = cudaMemsetAsync(a.scratch, 0, words * sizeof(unsigned), a.stream);
  if (err != cudaSuccess) return err;
  const bool tma = reinterpret_cast<uintptr_t>(a.in) % 16 == 0 && (a.w * kE * 4) % 16 == 0;
  const int grid = static_cast<int>(total < resident ? total : resident);
  // a cooperative launch: the grid starts only once all of it is resident
  // (or the launch is refused), whatever runs on other streams
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(a.in), static_cast<const int*>(a.base_idx),
      static_cast<const int*>(a.pidx), static_cast<float*>(a.grad), static_cast<float*>(a.amp),
      static_cast<float*>(a.phase), static_cast<unsigned*>(a.scratch), a.n, a.k, a.h, a.w,
      a.rows, slabs, tma);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kKind>
cudaError_t dispatch(const Args& a, int is_complex, int* occupancy) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.grad) |
                         reinterpret_cast<uintptr_t>(a.amp) |
                         reinterpret_cast<uintptr_t>(a.phase);
  const bool vec = a.w % 4 == 0 && bits % 16 == 0;
  if (is_complex) {
    return vec ? launch<true, kKind, 4>(a, occupancy) : launch<true, kKind, 1>(a, occupancy);
  }
  return vec ? launch<false, kKind, 4>(a, occupancy) : launch<false, kKind, 1>(a, occupancy);
}

cudaError_t by_kind(int kind, const Args& a, int is_complex, int* occupancy) {
  if (kind == kK4) return dispatch<kK4>(a, is_complex, occupancy);
  if (kind == kK2) return dispatch<kK2>(a, is_complex, occupancy);
  if (kind == kK1) return dispatch<kK1>(a, is_complex, occupancy);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind 2 (K4): in (n, h, w) complex64 (is_complex != 0) or float32, out (n,
// h, w, 3) float32; base_idx, pidx, amp and phase null. kind 0 (K2): out =
// grad3 (3, n, h, w), amp and phase (n, h, w) float32. kind 1 (K1): n base
// patches, base_idx and pidx (k,) int32 on the card (each base_idx in [0, n),
// pidx in [0, 3): the wrapper checks), out, amp and phase (k, h, w) float32.
// rows: a slab's rows (fused_channels.py:extract_route). scratch: 1 + 9 n
// uint32. Zeroes the scratch and launches one kernel on `stream`; returns
// cudaErrorInvalidValue where a patch's slabs outnumber the resident CTAs,
// else cudaGetLastError().
extern "C" int rfi_extract_groups(int kind, const void* in, const void* base_idx,
                                  const void* pidx, void* out, void* amp, void* phase,
                                  void* scratch, int n, int k, int h, int w, int rows,
                                  int is_complex, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || rows <= 0 || (kind == kK1 && k <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{in, base_idx, pidx, out, amp, phase, scratch, n, k, h, w, rows,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(by_kind(kind, a, is_complex, nullptr));
}

// The resident grid of kind 0 (K2), 1 (K1) or 2 (K4) with 16-byte-aligned
// outputs: out[0] CTAs resident on one SM at the full slab budget, out[1]
// CTAs resident on the card, out[2] the budget in bytes of dynamic shared
// memory a CTA. Launches nothing.
extern "C" int rfi_extract_groups_occupancy(int kind, int is_complex, int* out) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, 4, 1,
               nullptr};
  return static_cast<int>(by_kind(kind, a, is_complex, out));
}
