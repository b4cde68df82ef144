// K2: variant-aware channel planes of base patches, K1: the same
// extraction fused with the gather of the static selection, and K4: the
// 3-channel extraction of patches into (N, H, W, 3), one kernel template.
//
// K2 replaces rfi_toolbox_tpu/ops/fused_channels.py
// (fused_extract_channel_planes, body _planes_kernel): (M, H, W) complex64
// or float32 base patches -> five ImageNet-normalised float32 planes, grad3
// (3, M, H, W) with one gradient per zeroed-edge choice (fwd/fwd, down/fwd,
// fwd/down), log-amplitude (M, H, W) and phase (M, H, W). Its plain PyTorch
// version is preprocess/pipeline.py: extract_channel_planes.
//
// K1 replaces fused_gather_extract (body _gather_kernel): for each of K
// outputs, the gradient plane that pidx[i] selects of base patch
// base_idx[i], plus its log-amplitude and phase, into three (K, H, W)
// planes in the base orientation (the caller applies the variant's
// flip/transpose). Its plain version is K2's plain version followed by a
// gather.
//
// K4 replaces fused_extract_channels (body _kernel): (N, H, W) complex64 or
// float32 -> (N, H, W, 3) float32, [gradient, log-amplitude, phase]
// interleaved and ImageNet-normalised. Its function is part of K2's: the
// gradient is K2's fwd/fwd plane (grad3[0]), the other two are K2's
// amplitude and phase planes. Its plain version is preprocess/pipeline.py:
// imagenet_normalize(extract_channels(x)).
//
// All three follow their plain version on real input too: the
// log-amplitude is min-max normalised per patch and the phase is zero (the
// JAX package calls its TPU kernels on complex input only).
//
// Bound on the H100: bytes. K2 reads 8 B (4 B real) and writes 20 B per
// base pixel; K1 reads each selected base patch's 8 B (4 B) per pixel once
// and writes 12 B per output pixel; K4 reads 8 B (4 B) and writes 12 B per
// pixel. The arithmetic (an exact magnitude, a log10, an atan2, three
// gradients, the affines) is some 150 instructions a base pixel (K4: one
// gradient, some 115), of the order of the byte bound: it was 40-45% of
// the time of the one-block-per-patch (K2) and one-block-per-output (K1)
// kernels this design replaces and 31% of the one-block-per-patch K4's,
// whose stores of 4 B at a 12 B stride took another 30%. So the
// arithmetic is done once per base pixel, with no division the 2e-5 gate
// does not need, and every store is 16 B where the shape allows.
//
// Design. One cluster of 4 CTAs per base patch, launched with
// cudaLaunchKernelEx; CTA r of the cluster owns rows [r R, (r + 1) R) with
// R = ceil(h / 4) (16 KB of log-amplitude at 128 x 128, 256 threads). A
// thread owns groups of 4 pixels of one row (16-byte loads and stores;
// 1 pixel where w is not a multiple of 4 or a pointer is not 16-byte
// aligned) and issues the loads of up to kUnroll groups before any math.
//   1. log10|z| of the CTA's rows into its shared tile; complex input
//      writes the amplitude (fixed window) and phase planes straight out,
//      real input the zero phase plane (its amplitude waits for the
//      patch's min and max). K4 writes nothing yet: it keeps the phase of
//      complex input in a second shared tile (atan2 of the loads in
//      registers, no second read of the input).
//   2. cluster barrier; the row above and the row below the CTA's rows
//      (halo) are read from the neighbouring CTAs' tiles through
//      distributed shared memory. Each gradient plane's min and max over
//      the CTA's rows (NaN skipped; of the squared gradients, whose
//      correctly rounded roots order alike) are reduced in each warp and
//      pushed into a slot of every CTA of the cluster.
//   3. cluster barrier; each CTA reduces the 4 x 8 warps' slots, then
//      recomputes the gradients from its tile and writes them normalised
//      (and real input's amplitude plane). K4 reduces and recomputes the
//      fwd/fwd gradient only, and writes a group's three channels as 3 kPx
//      interleaved floats (three 16-byte stores for 4 pixels). No CTA
//      touches another's shared memory after the second barrier, so none
//      waits before it exits.
// K1 launches one cluster per base patch (M clusters); each CTA finds the
// outputs that select its base patch by a scan of base_idx, in order,
// while its loads are in flight (K indices a CTA, from L2), computes the
// base patch once, reduces only the gradient planes its outputs select,
// and writes each output's three planes, kListCap outputs at a time. A
// base patch no output selects exits at once. Division by a constant or a
// per-patch span is a multiplication by a reciprocal and an FMA: within a
// few ulp of the plain version's divisions, far inside the 2e-5 gate; the
// magnitude and the gradients stay exact (equal to the plain version's).
// The outputs are stored streaming (evict first): 9% of K1's time. Patches
// up to 128 x 128 pixels (kMaxPixels); the wrappers send larger ones to the
// strip kernel (extract_strips.cu).
//
// Tried on the H100 at M = 512, K = 1920, 128 x 128, and not kept
// (PERF.md): grouping K1's outputs with torch.sort (0.062 ms, a third of the
// kernel); clusters of 8 CTAs (of 128 or 256 threads: 3-17% slower); 3 or
// 6 CTAs an SM instead of 4 (0-30% slower); 2 groups in flight a thread
// instead of 4 (3% slower); the JAX kernel's atan2 polynomial (2-3%
// faster, not worth a second atan2).
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rfi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;  // CTAs per patch
constexpr int kMaxPixels = 128 * 128;
constexpr int kUnroll = 4;  // groups a thread loads before any math
constexpr int kListCap = 64;  // K1: a base patch's outputs listed at a time
constexpr int kScan = 8;  // K1: base indices a thread loads at a time
// min and max of each gradient plane and of log10|x|: slots 2v, 2v + 1
constexpr int kValues = 8;
// the kernel's three functions (its kKind)
constexpr int kK2 = 0;  // every base patch's five planes
constexpr int kK1 = 1;  // the selected outputs' three planes
constexpr int kK4 = 2;  // every patch's three channels, (m, h, w, 3)

template <bool kComplex, int kPx>
struct Group {  // the input of kPx pixels of one row
  float2 z[kComplex ? kPx : 1];
  float x[kComplex ? 1 : kPx];
};

template <bool kComplex, int kPx>
__device__ __forceinline__ void load(const float* __restrict__ in, size_t px,
                                     Group<kComplex, kPx>& g) {
  if constexpr (kComplex && kPx == 4) {
    const float4* src = reinterpret_cast<const float4*>(in + 2 * px);
    const float4 a = src[0], b = src[1];
    g.z[0] = make_float2(a.x, a.y);
    g.z[1] = make_float2(a.z, a.w);
    g.z[2] = make_float2(b.x, b.y);
    g.z[3] = make_float2(b.z, b.w);
  } else if constexpr (kComplex) {
    g.z[0] = reinterpret_cast<const float2*>(in)[px];
  } else if constexpr (kPx == 4) {
    const float4 a = *reinterpret_cast<const float4*>(in + px);
    g.x[0] = a.x;
    g.x[1] = a.y;
    g.x[2] = a.z;
    g.x[3] = a.w;
  } else {
    g.x[0] = in[px];
  }
}

template <int kPx>
__device__ __forceinline__ void store(float* p, const float (&v)[kPx]) {
  if constexpr (kPx == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int kPx>
__device__ __forceinline__ void load_row(const float* p, float (&v)[kPx]) {
  if constexpr (kPx == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    v[0] = p[0];
  }
}

// The gradients of kPx pixels of local row `lr` (1-based in the tile; the
// halo rows are 0 and rows + 1) at columns c..c+kPx-1, global row r:
// g[0] fwd/fwd, g[1] down/fwd, g[2] fwd/down, each only if its bit is in
// `mask`; their squares where kRoot is false. Forward differences are zero at the edge they cannot reach, as
// the plain version pads them; the squares are rounded separately (no FMA
// contraction), so the gradients equal the plain version's.
template <int kPx, bool kRoot = true>
__device__ __forceinline__ void gradients(const float* tile, int lr, int c, int r,
                                          int h, int w, unsigned mask,
                                          float (&g)[3][kPx], float (&la)[kPx]) {
  const float* row = tile + lr * w;
  const bool has_up = r > 0, has_down = r < h - 1;
  // e: the row's kPx pixels with the pixel left and right of them
  float e[kPx + 2], up[kPx] = {}, down[kPx] = {};
  load_row<kPx>(row + c, la);
  if (has_up) load_row<kPx>(row - w + c, up);
  if (has_down) load_row<kPx>(row + w + c, down);
  e[0] = c > 0 ? row[c - 1] : 0.0f;
  e[kPx + 1] = c + kPx < w ? row[c + kPx] : 0.0f;
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

// kK2: base patch b's planes into grad (= grad3, (3, m, h, w)), amp and
// phase ((m, h, w)). kK1: the planes of the outputs that select b into
// grad, amp and phase ((k, h, w)). kK4: patch b's three channels into
// grad (= out, (m, h, w, 3)); amp and phase unused. kPx: pixels a group.
template <bool kComplex, int kKind, int kPx>
__global__ void __launch_bounds__(kThreads, 4)
cluster_extract_kernel(const float* __restrict__ in, const int* __restrict__ base_idx,
                       const int* __restrict__ pidx, float* __restrict__ grad,
                       float* __restrict__ amp, float* __restrict__ phase, int m,
                       int k, int h, int w) {
  constexpr bool kGather = kKind == kK1;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (rows + 2) x w
  __shared__ float slots[kValues][kCluster * kWarps];
  __shared__ int list_out[kGather ? kListCap : 1];
  __shared__ int list_plane[kGather ? kListCap : 1];
  __shared__ int hits[2][kWarps];
  __shared__ unsigned plane_mask;

  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() != kCluster) __trap();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rows = (h + kCluster - 1) / kCluster;
  // K4, complex input: the phase channel of the CTA's rows (rows x w),
  // kept from pass 1, where the input is in registers, to pass 3's stores
  float* stash = tile + (rows + 2) * w;
  const int r0 = min(h, rank * rows);
  const int nrows = min(h, r0 + rows) - r0;
  const size_t hw = static_cast<size_t>(h) * w;
  const int groups = nrows * w / kPx;
  const size_t slab = static_cast<size_t>(r0) * w;  // first pixel of the rows
  const float* src = in + (static_cast<size_t>(b) * hw + slab) * (kComplex ? 2 : 1);
  constexpr int kChunk = kUnroll * kThreads;

  Group<kComplex, kPx> x[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int g = u * kThreads + tid;
    if (g < groups) load<kComplex, kPx>(src, static_cast<size_t>(g) * kPx, x[u]);
  }

  // K1: a scan of base_idx, in order, for the outputs that select b (a
  // thread takes kScan consecutive indices; one block-wide prefix sum of
  // the matches a thread found ranks them); the ones of rank [first,
  // first + kListCap) go to the list. Returns their count; plane_mask
  // gets the gradient planes they select.
  auto collect = [&](int first) {
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
  int n_out = 1, n_list = 1;
  unsigned mask = kKind == kK4 ? 1u : 7u;  // K4: the fwd/fwd gradient only
  if constexpr (kGather) {
    n_out = collect(0);
    if (n_out == 0) return;  // the whole cluster: no output selects b
    n_list = min(n_out, kListCap);
    mask = plane_mask;
  }
  // offset of pixel q of the rows in listed output i's planes (K1) or b's (K2)
  auto at = [&](int i, int q) {
    return (kGather ? static_cast<size_t>(list_out[i]) : static_cast<size_t>(b)) * hw +
           slab + q;
  };

  // 1. log10|x| into the tile; amplitude and phase planes of complex input
  float la_lo = INFINITY, la_hi = -INFINITY;
  for (int g0 = 0; g0 < groups; g0 += kChunk) {
    if (g0 > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = g0 + u * kThreads + tid;
        if (g < groups) load<kComplex, kPx>(src, static_cast<size_t>(g) * kPx, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads + tid;
      if (g >= groups) continue;
      const int q = g * kPx;
      float la[kPx], a[kPx], p[kPx];
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        if constexpr (kComplex) {
          la[i] = log_amplitude(x[u].z[i]);
          if constexpr (kKind != kK4) a[i] = amp_value(la[i]);
          p[i] = phase_value(x[u].z[i]);
        } else {
          la[i] = log10f(__fadd_rn(fabsf(x[u].x[i]), 1e-10f));
          la_lo = fminf(la_lo, la[i]);
          la_hi = fmaxf(la_hi, la[i]);
          p[i] = kPhaseZero;
        }
      }
      store<kPx>(tile + w + q, la);
      if constexpr (kKind == kK4) {
        if constexpr (kComplex) store<kPx>(stash + q, p);
      } else {
        for (int i = 0; i < n_list; ++i) {
          if constexpr (kComplex) store_out<kPx>(amp + at(i, q), a);
          store_out<kPx>(phase + at(i, q), p);
        }
      }
    }
  }
  cluster.sync();

  // 2. halo rows from the neighbours' tiles, then each plane's min and max
  if (nrows > 0) {
    float* halo[2] = {tile, tile + (nrows + 1) * w};
    const float* from[2] = {
        r0 > 0 ? cluster.map_shared_rank(tile, rank - 1) + rows * w : nullptr,
        r0 + nrows < h ? cluster.map_shared_rank(tile, rank + 1) + w : nullptr};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!from[s]) continue;
      for (int c = tid * kPx; c < w; c += kThreads * kPx) {
        if constexpr (kPx == 4) {
          *reinterpret_cast<float4*>(halo[s] + c) =
              *reinterpret_cast<const float4*>(from[s] + c);
        } else {
          halo[s][c] = from[s][c];
        }
      }
    }
  }
  __syncthreads();

  // (of the squared gradients: the square root is monotonic and correctly
  // rounded, so the root of the least square is the least gradient)
  float lo[4] = {INFINITY, INFINITY, INFINITY, la_lo};
  float hi[4] = {-INFINITY, -INFINITY, -INFINITY, la_hi};
  for (int g = tid; g < groups; g += kThreads) {
    const int q = g * kPx;
    const int rl = q / w;
    float gr[3][kPx], la[kPx];
    gradients<kPx, false>(tile, rl + 1, q - rl * w, r0 + rl, h, w, mask, gr, la);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      if (!(mask & (1u << v))) continue;
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        lo[v] = fminf(lo[v], gr[v][i]);
        hi[v] = fmaxf(hi[v], gr[v][i]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    lo[v] = warp_min(lo[v]);
    hi[v] = warp_max(hi[v]);
  }
  if (lane < kCluster) {  // lane r pushes this warp's partials to CTA r
    float* dst = cluster.map_shared_rank(&slots[0][0], lane);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      dst[(2 * v) * kCluster * kWarps + rank * kWarps + warp] = lo[v];
      dst[(2 * v + 1) * kCluster * kWarps + rank * kWarps + warp] = hi[v];
    }
  }
  cluster.sync();

  // 3. the patch's min and max, then the normalised planes; a base patch
  // with more than kListCap outputs (K1) writes the rest kListCap at a
  // time, with the amplitude and phase recomputed
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    lo[v] = INFINITY;
    hi[v] = -INFINITY;
    for (int i = lane; i < kCluster * kWarps; i += 32) {
      lo[v] = fminf(lo[v], slots[2 * v][i]);
      hi[v] = fmaxf(hi[v], slots[2 * v + 1][i]);
    }
    lo[v] = warp_min(lo[v]);
    hi[v] = warp_max(hi[v]);
    if (v < 3) {
      lo[v] = __fsqrt_rn(lo[v]);
      hi[v] = __fsqrt_rn(hi[v]);
    }
  }
  const Norm norm[3] = {Norm(lo[0], hi[0], kStd0, kShift0),
                        Norm(lo[1], hi[1], kStd0, kShift0),
                        Norm(lo[2], hi[2], kStd0, kShift0)};
  const Norm amp_norm(lo[3], hi[3], kStd1, kShift1);
  const size_t plane = static_cast<size_t>(m) * hw;
  for (int first = 0; first < n_out; first += kListCap) {
    const bool rest = kGather && first > 0;
    if constexpr (kGather) {
      if (rest) {
        __syncthreads();  // every thread is done with the list
        collect(first);
        n_list = min(n_out - first, kListCap);
      }
    }
    for (int g = tid; g < groups; g += kThreads) {
      const int q = g * kPx;
      const int rl = q / w;
      float gr[3][kPx], la[kPx], a[kPx], p[kPx];
      gradients<kPx>(tile, rl + 1, q - rl * w, r0 + rl, h, w, mask, gr, la);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (!(mask & (1u << v))) continue;
#pragma unroll
        for (int i = 0; i < kPx; ++i) gr[v][i] = norm[v](gr[v][i]);
      }
      if constexpr (!kComplex) {
#pragma unroll
        for (int i = 0; i < kPx; ++i) a[i] = amp_norm(la[i]);
      } else if constexpr (kKind == kK4) {
#pragma unroll
        for (int i = 0; i < kPx; ++i) a[i] = amp_value(la[i]);
      }
      if constexpr (kGather) {
        if (rest) {
          Group<kComplex, kPx> z;
          load<kComplex, kPx>(src, q, z);
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            if constexpr (kComplex) {
              a[i] = amp_value(la[i]);
              p[i] = phase_value(z.z[i]);
            } else {
              p[i] = kPhaseZero;
            }
          }
        }
        for (int i = 0; i < n_list; ++i) {
          const int v = list_plane[i];
          float sel[kPx];
#pragma unroll
          for (int j = 0; j < kPx; ++j) sel[j] = v == 0 ? gr[0][j] : (v == 1 ? gr[1][j] : gr[2][j]);
          store_out<kPx>(grad + at(i, q), sel);
          if (!kComplex || rest) store_out<kPx>(amp + at(i, q), a);
          if (rest) store_out<kPx>(phase + at(i, q), p);
        }
      } else if constexpr (kKind == kK4) {
        if constexpr (kComplex) {
          load_row<kPx>(stash + q, p);
        } else {
#pragma unroll
          for (int i = 0; i < kPx; ++i) p[i] = kPhaseZero;
        }
        store_channels<kPx>(grad + 3 * at(0, q), gr[0], a, p);
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v) store_out<kPx>(grad + v * plane + at(0, q), gr[v]);
        if constexpr (!kComplex) store_out<kPx>(amp + at(0, q), a);
      }
    }
  }
}

template <bool kComplex, int kKind, int kPx>
cudaError_t launch(const float* in, const int* base_idx, const int* pidx, float* grad,
                   float* amp, float* phase, int m, int k, int h, int w,
                   cudaStream_t stream, int* occupancy) {
  auto kernel = cluster_extract_kernel<kComplex, kKind, kPx>;
  const int rows = (h + kCluster - 1) / kCluster;
  const int stash_rows = kKind == kK4 && kComplex ? rows : 0;
  const size_t smem = static_cast<size_t>(rows + 2 + stash_rows) * w * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(kCluster) * m);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  if (occupancy) {  // CTAs resident on one SM, clusters on the card, dynamic smem
    occupancy[2] = static_cast<int>(smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(&occupancy[1], kernel, &config);
  }
  err = cudaLaunchKernelEx(&config, kernel, in, base_idx, pidx, grad, amp, phase, m, k,
                           h, w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kKind>
cudaError_t dispatch(const void* in, const void* base_idx, const void* pidx, void* grad,
                     void* amp, void* phase, int m, int k, int h, int w, int is_complex,
                     void* stream, int* occupancy = nullptr) {
  if (m <= 0 || (kKind == kK1 && k <= 0) || h <= 0 || w <= 0 || h * w > kMaxPixels) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(amp) | reinterpret_cast<uintptr_t>(phase);
  const bool vec = w % 4 == 0 && bits % 16 == 0;
  auto args = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const float*>(in), static_cast<const int*>(base_idx),
                         static_cast<const int*>(pidx), static_cast<float*>(grad),
                         static_cast<float*>(amp), static_cast<float*>(phase), m, k, h,
                         w, static_cast<cudaStream_t>(stream), occupancy);
  };
  if (is_complex) {
    return vec ? args(launch<true, kKind, 4>) : args(launch<true, kKind, 1>);
  }
  return vec ? args(launch<false, kKind, 4>) : args(launch<false, kKind, 1>);
}

}  // namespace

// in: (n, h, w) complex64 (is_complex != 0) or float32; grad3: (3, n, h,
// w), amp and phase: (n, h, w) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rfi_fused_extract_channel_planes(const void* in, void* grad3,
                                                void* amp, void* phase, int n,
                                                int h, int w, int is_complex,
                                                void* stream) {
  return static_cast<int>(dispatch<kK2>(in, nullptr, nullptr, grad3, amp, phase, n, 0,
                                        h, w, is_complex, stream));
}

// in: (m, h, w) complex64 (is_complex != 0) or float32 base patches;
// base_idx, pidx: (k,) int32 on the card, each base_idx in [0, m) and pidx
// in [0, 3) (the wrapper checks); grad, amp, phase: (k, h, w) float32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_gather_extract(const void* in, const void* base_idx,
                                        const void* pidx, void* grad, void* amp,
                                        void* phase, int m, int k, int h, int w,
                                        int is_complex, void* stream) {
  return static_cast<int>(dispatch<kK1>(in, base_idx, pidx, grad, amp, phase, m, k, h, w,
                                        is_complex, stream));
}

// in: (n, h, w) complex64 (is_complex != 0) or float32; out: (n, h, w, 3)
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int rfi_fused_extract_channels(const void* in, void* out, int n, int h,
                                          int w, int is_complex, void* stream) {
  return static_cast<int>(dispatch<kK4>(in, nullptr, nullptr, out, nullptr, nullptr, n, 0,
                                        h, w, is_complex, stream));
}

// The launch K2 (kind 0), K1 (kind 1) or K4 (kind 2) makes for
// 16-byte-aligned (512, h, w) input: out[0] CTAs resident on one SM, out[1]
// clusters of 4 resident on the card (cudaOccupancyMaxActiveClusters),
// out[2] bytes of dynamic shared memory a CTA. Launches nothing.
extern "C" int rfi_channel_planes_occupancy(int kind, int is_complex, int h, int w,
                                            int* out) {
  const auto query = [&](auto dispatch_kind) {
    return static_cast<int>(dispatch_kind(nullptr, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, 512, 1, h, w, is_complex, nullptr, out));
  };
  if (kind == kK2) return query(dispatch<kK2>);
  if (kind == kK1) return query(dispatch<kK1>);
  if (kind == kK4) return query(dispatch<kK4>);
  return static_cast<int>(cudaErrorInvalidValue);
}
