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
// - each output element adds its rows one after another in ascending k,
//   starting from +0.0: bit for bit the sequential loop that
//   Tensor.index_add_ runs on the CPU (ops/grouping.py scatter_rows_plain);
// - deterministic: no atomics anywhere, so two launches give the same bits;
// - any K (K = 0 writes zeros) and any n >= 1.
//
// Design: a stable counting sort of the indices into CSR, then a segmented
// sum. Four kernels, on scratch the wrapper allocates:
// 1. scatter_count_kernel: per cloud, per fixed chunk of kChunk indices (a
//    constant, never the card's SM count), the valid indices a destination
//    row receives, into count[b][row][chunk]; out-of-range indices go to a
//    spare row n. The chunk is sorted by row with CUB's block radix sort
//    (stable: k order kept among equal rows) and each run of equal rows
//    writes its length, so no atomics are needed.
// 2. scatter_offsets_kernel: one block a cloud, an exclusive scan of count
//    over (row, chunk) in row-major order: each (row, chunk)'s base in the
//    cloud's perm, and each row's CSR start off[b][row]; off[b][n] is the
//    number of valid indices.
// 3. scatter_place_kernel: each chunk sorted again, each index written to
//    perm[b][base(row, chunk) + its rank among its row's indices in the
//    chunk]. A rank from the stable sort follows k, so each row's span of
//    perm lists its k in ascending order; the spare row's span (the tail)
//    lists the out-of-range k.
// 4. scatter_rows_kernel: for each destination row, walk its span of perm
//    in order and add the rows of g in f32 registers, eight rows' loads in
//    flight. C > 16: a warp a row, lanes across channels with 2- to
//    16-byte loads; C <= 16 (the xyz gradient, C = 3): a lane a row, so no
//    lane idles. A row's sum stays on one thread per channel: a hot row is
//    serial.
//
// Bound on this card: bytes. Each g row is read once, each index once and
// each output row written once: at the SA1 backward in bf16 (B=16,
// K=16384, n=1024, C=64) 33.6 MB of g, 1.0 MB of indices and 2.1 MB out,
// ~11 us at 3.35 TB/s. The CSR adds two reads of the indices (count and
// place), the count table ((n+1) x K/kChunk ints a cloud) written, scanned
// and read, and perm written and read: ~4 MB at SA1.

#include "common.cuh"

#include <cuda_bf16.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;  // keys a thread: blocked, in k order
constexpr int kChunk = kSortThreads * kSortItems;  // indices a chunk
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kSmallC = 16;  // at or below: a lane a row in the sum
constexpr int kSumThreads = 256;
constexpr int kUnroll = 8;   // rows of g a lane loads before adding them

using ChunkSort = cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, int>;
using RankScan = cub::BlockScan<int, kSortThreads>;
using OffsetScan = cub::BlockScan<int, kScanThreads>;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

struct ChunkStorage {
  union {
    ChunkSort::TempStorage sort;
    RankScan::TempStorage scan;
  } tmp;
  unsigned first[kSortThreads];  // each thread's first sorted key
  unsigned last[kSortThreads];   // and its last
};

// Sort chunk `chunk` of cloud b's indices by destination row, stably: on
// return thread t holds sorted positions t*kSortItems + i (i < kSortItems)
// as key[i] (the row; n for an out-of-range index, n + 1 for padding past
// K), k[i] (its index into K), rank[i] (its position among the chunk's
// equal keys, in k order) and tail[i] (the last of its run).
__device__ __forceinline__ void sort_chunk(const int* __restrict__ idx,
                                           int k_len, int n, int chunk,
                                           ChunkStorage& s,
                                           unsigned (&key)[kSortItems],
                                           int (&k)[kSortItems],
                                           int (&rank)[kSortItems],
                                           bool (&tail)[kSortItems]) {
  const int t = threadIdx.x;
  const int* ib = idx + static_cast<long long>(blockIdx.y) * k_len;
  const int k0 = chunk * kChunk + t * kSortItems;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    k[i] = k0 + i;
    unsigned r = static_cast<unsigned>(n) + 1u;  // padding sorts last
    if (k[i] < k_len) {
      const int v = ib[k[i]];
      r = (v >= 0 && v < n) ? static_cast<unsigned>(v)
                            : static_cast<unsigned>(n);
    }
    key[i] = r;
  }
  const int bits = 32 - __clz(n + 1);  // keys lie in [0, n + 1]
  ChunkSort(s.tmp.sort).Sort(key, k, 0, bits);
  s.first[t] = key[0];
  s.last[t] = key[kSortItems - 1];
  __syncthreads();  // tmp is reused below; first/last are visible
  const unsigned prev = t > 0 ? s.last[t - 1] : 0xffffffffu;
  const unsigned next =
      t + 1 < kSortThreads ? s.first[t + 1] : 0xffffffffu;
  int start[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const unsigned before = i > 0 ? key[i - 1] : prev;
    const unsigned after = i + 1 < kSortItems ? key[i + 1] : next;
    start[i] = before != key[i] ? t * kSortItems + i : 0;
    tail[i] = after != key[i];
  }
  RankScan(s.tmp.scan).InclusiveScan(start, start, MaxOp());
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) rank[i] = t * kSortItems + i - start[i];
}

__device__ __forceinline__ long long count_at(int b, unsigned row, int n,
                                              int chunks, int chunk) {
  return (static_cast<long long>(b) * (n + 1) + row) * chunks + chunk;
}

// Pass 1: count[b][row][chunk] = the chunk's indices on row (spare row n
// included); count was zeroed, rows the chunk does not reach stay 0.
__global__ void __launch_bounds__(kSortThreads)
    scatter_count_kernel(const int* __restrict__ idx, int* __restrict__ count,
                         int k_len, int n, int chunks) {
  __shared__ ChunkStorage s;
  unsigned key[kSortItems];
  int k[kSortItems], rank[kSortItems];
  bool tail[kSortItems];
  sort_chunk(idx, k_len, n, blockIdx.x, s, key, k, rank, tail);
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (tail[i] && key[i] <= static_cast<unsigned>(n)) {
      count[count_at(blockIdx.y, key[i], n, chunks, blockIdx.x)] =
          rank[i] + 1;
    }
  }
}

// Pass 2: count (per cloud, (n+1) x chunks, row-major) scanned in place
// into each (row, chunk)'s base, and off[b][row] = base(row, 0).
__global__ void __launch_bounds__(kScanThreads)
    scatter_offsets_kernel(int* __restrict__ count, int* __restrict__ off,
                           int n, int chunks) {
  __shared__ OffsetScan::TempStorage tmp;
  const long long len = static_cast<long long>(n + 1) * chunks;
  int* cb = count + blockIdx.x * len;
  int* ob = off + static_cast<long long>(blockIdx.x) * (n + 1);
  int running = 0;
  for (long long base = 0; base < len;
       base += kScanThreads * kScanItems) {
    const long long i0 = base + threadIdx.x * kScanItems;
    int v[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) v[q] = i0 + q < len ? cb[i0 + q] : 0;
    int total;
    OffsetScan(tmp).ExclusiveSum(v, v, total);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const long long i = i0 + q;
      if (i < len) {
        cb[i] = running + v[q];
        if (i % chunks == 0) ob[i / chunks] = running + v[q];
      }
    }
    running += total;
    __syncthreads();  // tmp is reused by the next tile
  }
}

// Pass 3: perm[b][base(row, chunk) + rank] = k for every index of the chunk.
__global__ void __launch_bounds__(kSortThreads)
    scatter_place_kernel(const int* __restrict__ idx,
                         const int* __restrict__ base, int* __restrict__ perm,
                         int k_len, int n, int chunks) {
  __shared__ ChunkStorage s;
  unsigned key[kSortItems];
  int k[kSortItems], rank[kSortItems];
  bool tail[kSortItems];
  sort_chunk(idx, k_len, n, blockIdx.x, s, key, k, rank, tail);
  int* pb = perm + static_cast<long long>(blockIdx.y) * k_len;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (key[i] <= static_cast<unsigned>(n)) {
      pb[base[count_at(blockIdx.y, key[i], n, chunks, blockIdx.x)] +
         rank[i]] = k[i];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// V channels of one row, loaded or stored as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Pass 4: out[b, j, :] = T(sum over perm[off[j] : off[j+1]] of g rows),
// added in that order, kUnroll rows of g loaded before they are added.
// kLane (C <= 16): a lane a row, V of its channels a pass. Else a warp a
// row, lane l on channels [c0 + l*V, c0 + l*V + V) of each pass c0. A row's
// additions are serial, so the longest rows bound the kernel (the ball
// query takes the first points in scan order, so low indices recur in
// many balls); at most 64 registers a thread keeps four blocks an SM.
template <typename T, int V, bool kLane>
__global__ void __launch_bounds__(kSumThreads, 4)
    scatter_rows_kernel(const T* __restrict__ g, const int* __restrict__ off,
                        const int* __restrict__ perm, T* __restrict__ out,
                        int k_len, int n, int c) {
  const int b = blockIdx.y;
  const int j = kLane ? blockIdx.x * kSumThreads + threadIdx.x
                      : blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5);
  if (j >= n) return;
  const int* ob = off + static_cast<long long>(b) * (n + 1);
  const int* pb = perm + static_cast<long long>(b) * k_len;
  const T* gb = g + static_cast<long long>(b) * k_len * c;
  T* orow = out + (static_cast<long long>(b) * n + j) * c;
  const int s = ob[j], e = ob[j + 1];
  for (int c0 = 0; c0 < c; c0 += kLane ? V : 32 * V) {
    const int ch = kLane ? c0 : c0 + (threadIdx.x & 31) * V;
    if (ch >= c) break;  // c % V == 0: a pack is all in or all out
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    int p = s;
    for (; p + kUnroll <= e; p += kUnroll) {
      Pack<T, V> r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = *reinterpret_cast<const Pack<T, V>*>(
            gb + static_cast<long long>(pb[p + u]) * c + ch);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          acc[q] = __fadd_rn(acc[q], to_f32(r[u].v[q]));
        }
      }
    }
    for (; p < e; ++p) {
      const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(
          gb + static_cast<long long>(pb[p]) * c + ch);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], to_f32(r.v[q]));
    }
    Pack<T, V> w;
#pragma unroll
    for (int q = 0; q < V; ++q) from_f32(acc[q], &w.v[q]);
    *reinterpret_cast<Pack<T, V>*>(orow + ch) = w;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int V>
cudaError_t launch_sum(const void* g, const int* off, const int* perm,
                       void* out, int b, int k, int n, int c,
                       cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (c <= kSmallC) {
    const dim3 grid((n + kSumThreads - 1) / kSumThreads, b);
    scatter_rows_kernel<T, V, true>
        <<<grid, kSumThreads, 0, st>>>(gt, off, perm, ot, k, n, c);
  } else {
    constexpr int rows = kSumThreads / 32;
    const dim3 grid((n + rows - 1) / rows, b);
    scatter_rows_kernel<T, V, false>
        <<<grid, kSumThreads, 0, st>>>(gt, off, perm, ot, k, n, c);
  }
  return cudaGetLastError();
}

// V channels a lane: the widest pack (up to 16 bytes) that divides c and
// keeps g's and out's rows aligned; above kSmallC it grows only while one
// pass of 32 lanes does not cover c.
template <typename T>
cudaError_t launch_sum_vec(const void* g, const int* off, const int* perm,
                           void* out, int b, int k, int n, int c,
                           cudaStream_t st) {
  int v = 1;
  while (v * 2 * static_cast<int>(sizeof(T)) <= 16 && c % (v * 2) == 0 &&
         (c <= kSmallC || 32 * v < c) && aligned(g, v * 2 * sizeof(T)) &&
         aligned(out, v * 2 * sizeof(T))) {
    v *= 2;
  }
  switch (v) {
    case 1: return launch_sum<T, 1>(g, off, perm, out, b, k, n, c, st);
    case 2: return launch_sum<T, 2>(g, off, perm, out, b, k, n, c, st);
    case 4: return launch_sum<T, 4>(g, off, perm, out, b, k, n, c, st);
    default: break;
  }
  if constexpr (sizeof(T) == 2) {
    return launch_sum<T, 8>(g, off, perm, out, b, k, n, c, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out (b, n, c) of g's type (itemsize 4: f32, 2: bf16) from g (b, k, c) and
// idx (b, k) int32. Scratch: count (b, n+1, ceil(k / 2048)) int32; off
// (b, n+1) and perm (b, k) int32 hold the CSR afterwards (perm's span
// [off[n], k) lists the out-of-range k in ascending order).
extern "C" int pn2_scatter_rows(const void* g, const void* idx, void* out,
                                void* count, void* off, void* perm, int b,
                                int k, int n, int c, int itemsize,
                                void* stream) {
  if (b <= 0 || n <= 0 || c <= 0) return cudaSuccess;  // empty output
  if (k < 0 || n == 0x7fffffff || (itemsize != 4 && itemsize != 2)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  int* cnt = static_cast<int*>(count);
  int* of = static_cast<int*>(off);
  int* pm = static_cast<int*>(perm);
  const int chunks = (k + kChunk - 1) / kChunk;
  constexpr int kMaxGridY = 65535;
  if (b > kMaxGridY) {  // the clouds sit on gridDim.y: 65535 at a time
    for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
      const size_t rows = static_cast<size_t>(b0) * k;
      const int err = pn2_scatter_rows(
          static_cast<const char*>(g) + rows * c * itemsize, ix + rows,
          static_cast<char*>(out) +
              static_cast<size_t>(b0) * n * c * itemsize,
          cnt + static_cast<size_t>(b0) * (n + 1) * chunks,
          of + static_cast<size_t>(b0) * (n + 1), pm + rows,
          b - b0 < kMaxGridY ? b - b0 : kMaxGridY, k, n, c, itemsize, stream);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  cudaError_t err;
  if (chunks == 0) {  // K = 0: every row's span is empty
    err = cudaMemsetAsync(of, 0, sizeof(int) * static_cast<size_t>(b) *
                                     (n + 1), st);
    if (err != cudaSuccess) return err;
  } else {
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * static_cast<size_t>(b) *
                                      (n + 1) * chunks, st);
    if (err != cudaSuccess) return err;
    const dim3 grid(chunks, b);
    scatter_count_kernel<<<grid, kSortThreads, 0, st>>>(ix, cnt, k, n,
                                                        chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_offsets_kernel<<<b, kScanThreads, 0, st>>>(cnt, of, n, chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_place_kernel<<<grid, kSortThreads, 0, st>>>(ix, cnt, pm, k, n,
                                                        chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (itemsize == 4) {
    return launch_sum_vec<float>(g, of, pm, out, b, k, n, c, st);
  }
  return launch_sum_vec<__nv_bfloat16>(g, of, pm, out, b, k, n, c, st);
}
