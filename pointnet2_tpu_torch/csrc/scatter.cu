// Deterministic row scatter-add: out[b, j, :] = sum over k with idx[b, k] == j
// of g[b, k, :], g (B, K, C) by idx (B, K) int32 -> (B, n, C). The backward
// of the row gather (gather.cu). An index outside [0, n) contributes
// nothing: the transpose of the gather's zero fill.
//
// Replaces pointnet2_tpu/ops/pallas/group.py:_scatter_rows (kernel body
// _scatter_kernel, C > 16) and _scatter_rows_t (_scatter_kernel_t,
// C <= 16), the backward of group_point_pallas and gather_point_pallas, and
// the mxu route's ops/grouping.py:onehot_scatter_rows. Those contract a
// one-hot block with g on the MXU, accumulating in f32 in a fixed order.
//
// Semantics held here:
// - sums in f32 registers, cast once to g's type at the store
//   (round to nearest even for bf16), as group.py:180-182,254-255;
// - deterministic: no atomics; each output element adds its rows in
//   ascending k, so two launches give the same bits;
// - any K: the cloud's indices are staged in shared memory in chunks of
//   kChunk, and K = 0 writes zeros.
//
// Design (simple first): one CTA per (cloud, tile of kWarps destination
// rows), one warp per destination row j. The warp scans the staged indices
// 32 at a time with __ballot_sync(idx == j) and, for each set bit in
// ascending k, adds row g[b, k, :] into f32 registers, lanes across
// channels (kPerLane channels a lane per pass, passes over wider rows).
// At C <= 16 (xyz gradients, C = 3) lanes past C idle: one row per warp is
// kept for the same order and code path at every width.
//
// Bound on this card: bytes. Each g row is read once, each index once from
// device memory and each output row written once: at the SA1 backward in
// bf16 (B=16, K=16384, n=1024, C=64) 33.6 MB of g, 1.0 MB of indices and
// 2.1 MB out, ~11 us at 3.35 TB/s. The ballot scan adds n*K/32 warp steps a
// cloud on shared memory, which this design does not hide; a stable
// counting sort into CSR followed by a segmented sum is the O(K*C)
// redesign for a later change.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;       // destination rows per CTA
constexpr int kPerLane = 4;     // channels a lane accumulates per pass
constexpr int kChunk = 4096;    // indices staged per chunk (16 KB)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    scatter_rows_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        T* __restrict__ out, int k_len, int n, int c) {
  __shared__ int s_idx[kChunk];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;  // this warp's destination row
  const int* ib = idx + static_cast<long long>(b) * k_len;
  const T* gb = g + static_cast<long long>(b) * k_len * c;

  for (int c0 = 0; c0 < c; c0 += 32 * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.0f;

    for (int k0 = 0; k0 < k_len; k0 += kChunk) {
      const int len = min(kChunk, k_len - k0);
      __syncthreads();  // the previous chunk is no longer read
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        s_idx[t] = ib[k0 + t];
      }
      __syncthreads();
      if (j < n) {  // uniform across the warp
        for (int s = 0; s < len; s += 32) {
          const int k = s + lane;
          const bool hit = k < len && s_idx[k] == j;
          unsigned bits = __ballot_sync(0xffffffffu, hit);
          while (bits) {  // set bits in ascending k: a fixed order
            const int l = __ffs(bits) - 1;
            bits &= bits - 1;
            const T* row = gb + static_cast<long long>(k0 + s + l) * c;
#pragma unroll
            for (int q = 0; q < kPerLane; ++q) {
              const int ch = c0 + lane + 32 * q;
              if (ch < c) acc[q] += load_f32(row + ch);
            }
          }
        }
      }
    }

    if (j < n) {
      T* orow = out + (static_cast<long long>(b) * n + j) * c;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int ch = c0 + lane + 32 * q;
        if (ch < c) store_f32(orow + ch, acc[q]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* g, const int* idx, void* out, int b, int k,
                   int n, int c, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  scatter_rows_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(g), idx, static_cast<T*>(out), k, n, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pn2_scatter_rows(const void* g, const void* idx, void* out,
                                int b, int k, int n, int c, int itemsize,
                                void* stream) {
  if (b <= 0 || n <= 0 || c <= 0) return cudaSuccess;  // empty output
  if (k < 0 || b > 65535) return cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) return launch<float>(g, ix, out, b, k, n, c, st);
  if (itemsize == 2) return launch<__nv_bfloat16>(g, ix, out, b, k, n, c, st);
  return cudaErrorInvalidValue;
}
