// Tensor-core and copy primitives of the 3xTF32 conv kernels (K6b in
// conv3x3.cu, conv3x3_mma.cuh's forward tile for K6a and K7): inline PTX
// for sm_90a, no CUTLASS.
//
// 3xTF32 ("fast fp32", as CUTLASS's gemm/warp/mma_tensor_op_fast_f32.h):
// each float32 operand is split as hi = tf32(a), rounded to nearest with
// ties away from zero (cvt.rna), and lo = tf32(a - hi); a product is
// accumulated in float32 as lo*hi + hi*lo + hi*hi, the small terms first.
// The dropped lo*lo term and the rounding of lo leave about 2^-21 of
// each product, against 2^-11 for one TF32 product: float32 accuracy on
// the tensor cores at a third of their TF32 rate.
//
// mma.sync.m16n8k8 fragments (lane = 4 * gid + tig):
//   A (16 x 8, row major): a0 (gid, tig), a1 (gid + 8, tig),
//                          a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
//   B (8 x 8, column major): b0 (tig, gid), b1 (tig + 4, gid)
//   C (16 x 8): c0 (gid, 2 tig), c1 (gid, 2 tig + 1),
//               c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rfi {
namespace tf32 {

// a rounded to TF32 (cvt.rna), low 13 bits zero
__device__ __forceinline__ uint32_t round_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(a);
  lo = round_tf32(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] * b[n] in 3xTF32 for M x N tiles, as all lo*hi, then
// all hi*lo, then all hi*hi MMAs: a product's three MMAs are dependent
// (one accumulator), so they go out M N MMAs apart.
template <int M, int N>
__device__ __forceinline__ void mma3_tiles(float (&acc)[M][N][4], const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], a_lo[m], b_hi[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], a_hi[m], b_lo[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], a_hi[m], b_hi[n]);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is then
// not read). dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(shared_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero when !valid
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(shared_address(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The block's dynamic shared memory (the stage rings of the kernels).
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ __align__(16) float rfi_dynamic_smem[];
  return rfi_dynamic_smem;
}

// Allow `bytes` of dynamic shared memory for Kernel (above 48 KB it must
// be asked for); once per kernel, since bytes is fixed per kernel.
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

}  // namespace tf32
}  // namespace rfi
