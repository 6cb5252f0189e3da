// bf16 tensor-core tiles for sm_90a: mma.sync m16n8k16 with f32
// accumulators, operands fed from shared memory by ldmatrix, and tiles
// staged by cp.async. A warp computes a 32 x 32 output tile (2 x 4
// m16n8 products) per k16 step; a block stages a [rows][cols] bf16 tile a
// stage, each row padded by 8 elements (kPad) so that ldmatrix's eight
// 16-byte row reads fall in distinct banks.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16): lane l has gid = l / 4
// and tig = l % 4. An accumulator d[4] of an m16n8 tile holds rows gid
// (d[0], d[1]) and gid + 8 (d[2], d[3]), columns 2*tig and 2*tig + 1. A B
// fragment b[2] holds column gid, rows (k) 2*tig, 2*tig + 1 and those + 8:
// both halves of a register share the column, so a per-column transform of
// B (an affine, a ReLU) can be applied to the registers after ldmatrix.
//
// Used by csrc/fused_mlp.cu's bf16 dense forward (row 10: A from a [m][k]
// tile, load_a_mk; B from W's own [n][k] layout, load_b_nk) and backward
// (row 14: the g pass takes A from a [m][k] tile, the dW pass from a [k][m]
// tile, load_a_km; both take B from a [k][n] tile, load_b_kn).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma {

constexpr int kPad = 8;  // bf16 elements of padding a staged row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Stage 8 bf16 of a row into shared memory (16-byte aligned): `avail` of
// them are readable at src (the rest, and a row that is out, are zeros).
// 16-byte aligned full chunks go by cp.async, the ragged ones by plain
// loads; either way they are in place after cp_async_wait and a barrier.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool row_in,
                                       int avail, bool vec_ok) {
  if (row_in && avail >= 8 && vec_ok) {
    cp_async16(dst, src);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = (row_in && e < avail) ? src[e] : zero;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a @ b for one m16n8k16 tile, f32 accumulation on the tensor cores
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragments of rows m0 .. m0+31 (two m16 tiles), k0 .. k0+15, from a
// [m][k] tile with row stride ld elements
__device__ __forceinline__ void load_a_mk(uint32_t (&a)[2][4],
                                          const __nv_bfloat16* s, int ld,
                                          int m0, int k0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ldsm_x4(a[i], s + (m0 + 16 * i + (l & 15)) * ld + k0 + (l >> 4) * 8);
  }
}

// the same fragments from a [k][m] tile (m contiguous), transposed by
// ldmatrix
__device__ __forceinline__ void load_a_km(uint32_t (&a)[2][4],
                                          const __nv_bfloat16* s, int ld,
                                          int m0, int k0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ldsm_x4_trans(a[i], s + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 +
                            16 * i + ((l >> 3) & 1) * 8);
  }
}

// B fragments of columns n0 .. n0+31 (four n8 tiles), k0 .. k0+15, from a
// [k][n] tile (n contiguous), transposed by ldmatrix
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4][2],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t r[4];
    ldsm_x4_trans(r, s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 +
                         16 * j + (l >> 4) * 8);
    b[2 * j][0] = r[0];
    b[2 * j][1] = r[1];
    b[2 * j + 1][0] = r[2];
    b[2 * j + 1][1] = r[3];
  }
}

// the same fragments from a [n][k] tile (k contiguous): ldmatrix's rows
// are columns n, and lane l's pair (n = gid, k = 2*tig, 2*tig + 1) is what
// mma's "col" B operand wants, with no transpose
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4][2],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t r[4];
    ldsm_x4(r, s + (n0 + 16 * j + (l & 7) + (l >> 4) * 8) * ld + k0 +
                   ((l >> 3) & 1) * 8);
    b[2 * j][0] = r[0];
    b[2 * j][1] = r[1];
    b[2 * j + 1][0] = r[2];
    b[2 * j + 1][1] = r[3];
  }
}

// acc[i][j] += a[i] @ b[j]: the warp's 32 x 32 tile over one k16 step
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4],
                                         const uint32_t (&a)[2][4],
                                         const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j]);
  }
}

}  // namespace mma
