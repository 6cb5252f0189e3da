// Fused set-abstraction chain: the BN-affine -> ReLU -> dense pass with its
// bias and, optionally, the BN column statistics of its output; the affine
// -> ReLU -> max-pool tail; the affine -> ReLU tail; and the train-mode
// backward, which rematerialises from the saved pre-BN activations: the top
// BN's reduction totals, each dense's backward, and the leading BN's dx.
//
// Replaces pointnet2_tpu/ops/pallas/fused_mlp.py:
//   fused_dense     <- _dense_fwd (:141, kernel body _dense_fwd_kernel :116)
//   fused_pool      <- _pool_fwd (:189, _pool_fwd_kernel :181)
//   fused_affine    <- _affine_fwd (:215, _affine_fwd_kernel :208)
//   fused_top_stats <- _top_stats (:288, _top_stats_kernel :257)
//   fused_dense_bwd <- _dense_bwd (:391, _dense_bwd_kernel :324)
//   fused_first_bwd <- _first_bwd (:478, _first_bwd_kernel :467)
// The TPU kernels take exact power-of-two row tiles into VMEM, contract on
// the MXU, and carry their sums (the statistics, T1/T2, dW, db) from one
// grid step to the next in one VMEM block. Here blocks run in parallel in
// no order: each block writes its own partial sums over a fixed part of the
// rows and a second kernel adds them up in an order that depends on the
// shape alone. No atomics anywhere: two launches give the same bits.
//
// Semantics held here (those of the Pallas kernels and of the plain
// versions in ops/fused_mlp.py); T is float or bf16, the activation type:
// - z = T(relu(x*a + b)), with the product and the sum rounded apart
//   (__fmul_rn, __fadd_rn: nvcc would contract them into an FMA, the
//   plain version's eager mul and add round twice); likewise every
//   elementwise step of the backward: out = y*a + b, yhat = (y - mu)*r,
//   dout = dz*(out > 0), dy = gr*((dout - m1) - yhat*m2), so dy, dx and the
//   tails are bit for bit their plain versions;
// - W is nn.Linear's (Cout, Cin) f32 weight, rounded to T (in bf16 once
//   per launch into a scratch, round_bf16_kernel);
// - acc = sum_k z*W in f32 (a bf16 product is exact in f32), y = T(acc +
//   bias): the plain version's z.float() @ w.float() up to summation order;
// - with statistics, the column sum and sum of squares of float(y), the
//   rounded y, in f32: each 64-row block's partial sums, in a fixed order,
//   go into its row of a (row blocks, Cout) scratch; a second kernel adds
//   the rows in an order fixed by their count (sum_rows_kernel);
// - pool: max over S of T(relu(y*a + b)); affine: T(relu(y*a + b));
// - backward (the pack p of a BN holds rows a, b, mu, r, gr, m1, m2): the
//   pooled cotangent goes to the first-occurrence argmax over S of
//   T(relu(y*a + b)), as torch.argmax and the TPU kernel pick it; dense k's
//   dy is rounded to T (dy_c) before both products, db sums the unrounded
//   dy, dW = dy_c^T @ z_{k-1} (Ck, Cp), g_{k-1} = T(dy_c @ T(W)), and
//   BN_{k-1}'s T1/T2 come from the rounded g_{k-1};
// - Any row count and any channel count >= 1: every ragged edge is masked
//   (the TPU kernels needed exact tiles, fused_chain_eligible). Offsets are
//   64-bit: cls_msg SA1's third scale at B=64 has 4.2 M rows.
//
// Bound on this card. fused_pool, fused_affine, fused_top_stats and
// fused_first_bwd are bound by bytes: each input element is read once and
// each output written once, neighbouring threads on neighbouring channels.
// fused_top_stats reads each group's s x c block once, and nears the byte
// rate only with many wide loads in flight: a thread owns 16 bytes of
// channels, loads kTopChunk rows before comparing any, keeps the y value
// at each channel's running argmax (the argmax row is never read again),
// and the lanes that took other rows of the same channels combine by
// shuffles in the sequential scan's own order; one warp an item, 8 items
// a block, so cls_ssg's top layers (8192 x 32 x 128, 2048 x 64 x 256 at
// B=16) give 1024 and 256 blocks of 256 threads. In bf16 an element costs
// about a dozen instructions (unpack, affine, ReLU, rounding, key, compare,
// three selects) against 2 bytes, so instruction throughput, not bytes,
// sets its pace near half the byte rate; f32 reads twice the bytes for
// the same work.
// Fewer registers (spills), more lanes across rows, or longer or shorter
// row chunks measured slower.
// fused_affine and fused_first_bwd are elementwise and share one walk: 4 bytes
// an element in bf16 for fused_affine (y read, out written), 6 for
// fused_first_bwd (x and g read, dx written), against a few and about fifteen
// instructions, so they reach the byte rate only with wide accesses, many of
// them in flight and nothing else per element. A thread owns 16 bytes of
// channels at an offset fixed for the launch (no division or modulo in the
// loop: a flat index's 64-bit modulo is a called routine, dozens of
// instructions an element), holds their a and b, or the seven pack values, in
// registers (loaded once), and loads kFirstRows = 4 rows of every input as
// 16-byte pieces before computing any. A row's vectors are spread over
// neighbouring lanes (8 at cls_ssg SA1's c = 64, 16 at SA2's 128) and the
// block's other lanes take the next rows, so a warp's accesses are contiguous;
// blocks of kFirstThreads = 128, one a row block up to kFirstBlocks = 65536
// (past it the grid strides). fused_first_bwd: about 80% of the byte rate in
// bf16 and 86% in f32 at cls_ssg's shapes; 256 or 512 threads, 2 or 8 rows in
// flight and a grid of 2-8 blocks an SM that strides measured no faster;
// evict-first loads and stores helped its largest shapes a little and hurt
// those that fit in L2. Ragged c and unaligned bases take the same walk
// element by element.
// fused_dense and fused_dense_bwd move few bytes for their work (bf16
// cls_ssg SA1 64 -> 128 at B=16: 101 MB forward, 30 us at 3.35 TB/s) and
// their bound is bytes against the tensor cores' rate.
// In f32, fused_dense and fused_dense_bwd do their products as f32 FMAs on
// the CUDA cores from shared memory: 64x64 output tiles, 128 threads, each
// with a 4x8 accumulator in registers, the contracted dimension in chunks
// of 32 staged through shared memory with the affine, the ReLU and the
// rounding applied as the operands are loaded. Each thread reads 12 shared
// values for 32 FMAs, so shared memory, not the FMA pipe, sets its pace;
// the f32 products stay there (no TF32: the f32 contract is full f32).
// In bf16 all three products (row 10's, row 14's g and dW) run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators; mma_bf16.cuh):
// warps of 32x32 output, operands staged by cp.async in a ring of 32-deep
// chunks. A bf16 product is exact in f32, so only the order and the depth
// of the f32 additions differ from the CUDA cores (each mma adds 16
// products and the accumulator in one step).
// Row 10 in bf16 moves few bytes a row for its work (cls_ssg SA2 128 ->
// 256 at B=16: 101 MB, 30 us at 3.35 TB/s, against 9 us of bf16 tensor
// work), so it is bound by bytes, and by the latency of getting them in:
// its grid is persistent (as many tiles at once as fit, each block walking
// its row tiles with one ring through all their chunks, so the next
// tile's x is in flight during a tile's epilogue), x is staged raw and
// each thread turns the pieces it staged into z = bf16(relu(x*a + b)) in
// place before the chunk's one barrier, B is W rounded to bf16 once per
// launch and read in its own (Cout, Cin) layout (mma's "col" B), and y
// leaves through shared memory, 16 bytes a thread along each row. What it
// pays over the bytes: x read once per column tile (from L2: the column
// tiles of a row tile run side by side), W once per row tile, and the
// transform once per column tile.
// fused_dense_bwd runs three passes: the elementwise dy pass (the pool
// routing recomputed, dy_c written to a scratch, db partials per 64 items),
// g_{k-1} = dy_c @ W over 64-row tiles with T1/T2 partials in the epilogue
// (bf16: W rounded to bf16 once into a scratch first), and dW over
// 1024-row slabs whose (Ck, Cp) partials are then added up (bf16: the
// affine and ReLU of z applied to the B fragments in registers, where
// each fragment's column is known); the slab size is a constant, never
// the card's SM count, so two cards give the same bits.

#include "common.cuh"
#include "mma_bf16.cuh"

#include <cuda_bf16.h>

#include <cmath>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kBM = 64;        // output rows a block
constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 32;        // input channels staged a step
constexpr int kThreads = 128;  // 16 x 8 threads, each 4 rows x 8 columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back (round to nearest even for bf16)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// v*a + b, two roundings
__device__ __forceinline__ float bn_out(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(v, a), b);
}

// relu(v*a + b), two roundings; v < 0 ? 0 : v keeps -0.0 and NaN as
// torch.relu does
__device__ __forceinline__ float affine_relu(float v, float a, float b) {
  const float o = bn_out(v, a, b);
  return o < 0.0f ? 0.0f : o;
}

// dz * (out > 0): the ReLU's backward as the plain version multiplies it
// (a negative dz times 0 gives -0.0)
__device__ __forceinline__ float relu_gate(float dz, float out) {
  return __fmul_rn(dz, out > 0.0f ? 1.0f : 0.0f);
}

// yhat = (v - mu) * r
__device__ __forceinline__ float bn_hat(float v, float mu, float r) {
  return __fmul_rn(__fsub_rn(v, mu), r);
}

// gr * ((dout - m1) - yhat*m2): the BN's input cotangent
__device__ __forceinline__ float bn_dy(float dout, float yhat, float gr,
                                       float m1, float m2) {
  return __fmul_rn(gr, __fsub_rn(__fsub_rn(dout, m1), __fmul_rn(yhat, m2)));
}

// The first index over s of the largest T(relu(y*a + b)) (a NaN counts as
// the largest), p pointing at one column of s rows c apart: torch.argmax's
// and the TPU kernel's pick.
template <typename T>
__device__ __forceinline__ int first_argmax(const T* p, int s, int c,
                                            float a, float b) {
  if (s == 1) return 0;
  float m = -INFINITY;
  int am = 0;
#pragma unroll 4
  for (int i = 0; i < s; ++i) {
    const float z =
        round_to<T>(affine_relu(to_f32(p[static_cast<long long>(i) * c]), a,
                                b));
    if (z > m || (z != z && m == m)) {
      m = z;
      am = i;
    }
  }
  return am;
}

// acc[i][j] += sum over the staged chunk of as[ty + 16i][k] * bs[tx + 8j][k]
__device__ __forceinline__ void tile_fma(const float (*as)[kBK + 1],
                                         const float (*bs)[kBK + 1],
                                         float (&acc)[4][8], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    float ar[4], br[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) ar[i] = as[ty + 16 * i][k];
#pragma unroll
    for (int j = 0; j < 8; ++j) br[j] = bs[tx + 8 * j][k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// A 64x64 tile's column partials: each thread's (s, ss) over its 4 rows of
// its 8 columns, the 16 row groups added per column in ascending row group
// through the scratch rs, rss (16 x kBN floats each, free shared memory),
// written to row `blk` of part_s, part_ss (cout wide).
__device__ __forceinline__ void write_column_partials(
    const float (&cs)[8], const float (&css)[8], float* rs, float* rss,
    int col0, int cout, long long blk, float* part_s, float* part_ss) {
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    rs[ty * kBN + tx + 8 * j] = cs[j];
    rss[ty * kBN + tx + 8 * j] = css[j];
  }
  __syncthreads();
  if (tid < kBN && col0 + tid < cout) {
    float s = 0.0f, ss = 0.0f;
    for (int t = 0; t < kThreads / 8; ++t) {
      s = __fadd_rn(s, rs[t * kBN + tid]);
      ss = __fadd_rn(ss, rss[t * kBN + tid]);
    }
    const long long at = blk * cout + col0 + tid;
    part_s[at] = s;
    part_ss[at] = ss;
  }
}

// Row 10 in f32 on the CUDA cores (bf16: fused_dense_mma_kernel)
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const float* __restrict__ x,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       float* __restrict__ part_s,
                       float* __restrict__ part_ss, long long rows, int cin,
                       int cout) {
  // +1: the staging stores (32 consecutive k of one row a warp) and the
  // compute loads (4 rows, 8 columns a warp) both hit 32 distinct banks
  __shared__ float zs[kBM][kBK + 1];
  __shared__ float ws[kBN][kBK + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // this thread's columns: tx + 8*j
  const int ty = tid >> 3;  // this thread's rows: ty + 16*i
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < cin; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e / kBK;
      const int k = e % kBK;
      const long long row = row0 + r;
      const int kk = k0 + k;
      float z = 0.0f;  // masked rows and channels contribute nothing
      if (row < rows && kk < cin) {
        z = affine_relu(x[row * cin + kk], a[kk], b[kk]);
      }
      zs[r][k] = z;
    }
#pragma unroll
    for (int q = 0; q < kBN * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int n = e / kBK;
      const int k = e % kBK;
      const int col = col0 + n;
      const int kk = k0 + k;
      float v = 0.0f;
      if (col < cout && kk < cin) {
        v = w[static_cast<long long>(col) * cin + kk];
      }
      ws[n][k] = v;
    }
    __syncthreads();
    tile_fma(zs, ws, acc, ty, tx);
    __syncthreads();  // the tiles are read before the next step restages
  }

  float bias_r[8];
  float cs[8], css[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + tx + 8 * j;
    bias_r[j] = col < cout ? bias[col] : 0.0f;
    cs[j] = 0.0f;
    css[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 8 * j;
      if (col >= cout) continue;
      const float f = __fadd_rn(acc[i][j], bias_r[j]);
      y[row * cout + col] = f;
      if (kStats) {
        cs[j] = __fadd_rn(cs[j], f);
        css[j] = __fadd_rn(css[j], __fmul_rn(f, f));
      }
    }
  }

  if (kStats) {
    // the staging tiles are free after the loop's last barrier
    write_column_partials(cs, css, &zs[0][0], &ws[0][0], col0, cout,
                          blockIdx.x, part_s, part_ss);
  }
}

constexpr int kSumCols = 32;   // columns a block of sum_rows_kernel
constexpr int kSumLanes = 32;  // lanes a column, over the partials' rows

// out[i] = the sum over rows of part (rows, width), in an order fixed by
// `rows` alone: lane l adds rows l, l + 32, l + 64, ... in ascending order,
// then the 32 lane sums are added in ascending lane. About rows/32 + 32
// roundings a sum, where one ascending loop would take `rows`, and 32 loads
// in flight a column.
__global__ void __launch_bounds__(kSumCols* kSumLanes)
    sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                    long long rows, long long width) {
  __shared__ float lanes[kSumLanes][kSumCols + 1];
  const long long col =
      static_cast<long long>(blockIdx.x) * kSumCols + threadIdx.x;
  float s = 0.0f;
  if (col < width) {
    for (long long r = threadIdx.y; r < rows; r += kSumLanes) {
      s = __fadd_rn(s, part[r * width + col]);
    }
  }
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.0f;
    for (int l = 0; l < kSumLanes; ++l) t = __fadd_rn(t, lanes[l][threadIdx.x]);
    out[col] = t;
  }
}

cudaError_t sum_rows(const float* part, float* out, long long rows,
                     long long width, cudaStream_t st) {
  sum_rows_kernel<<<static_cast<unsigned>((width + kSumCols - 1) / kSumCols),
                    dim3(kSumCols, kSumLanes), 0, st>>>(part, out, rows,
                                                        width);
  return cudaGetLastError();
}

template <typename T>
__global__ void fused_pool_kernel(const T* __restrict__ y,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  T* __restrict__ out, long long total, int s,
                                  int c) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long g = t / c;
    const int ch = static_cast<int>(t - g * c);
    const float av = a[ch], bv = b[ch];
    const T* p = y + g * s * c + ch;
    float m = -INFINITY;
    for (int i = 0; i < s; ++i) {
      const float v =
          round_to<T>(affine_relu(to_f32(p[static_cast<long long>(i) * c]),
                                  av, bv));
      m = (v > m || v != v) ? v : m;  // a NaN stays, as in torch.amax
    }
    out[t] = from_f32<T>(m);
  }
}

// --- backward ---------------------------------------------------------------

constexpr int kItems = 64;    // items (groups of s rows) a block, 8 a thread
constexpr int kSlab = 1024;   // rows of one dW partial
constexpr int kIx = 32;       // channels a block of the elementwise passes
constexpr int kIy = 8;        // item lanes a block of the elementwise passes

// The column partials of a (kIx x kIy) block: per channel, the kIy lanes'
// sums added in ascending lane, written to row blockIdx.x.
__device__ __forceinline__ void write_lane_partials(float v1, float v2,
                                                    int ch, int c,
                                                    float* part1,
                                                    float* part2) {
  __shared__ float r1[kIy][kIx], r2[kIy][kIx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  r1[ty][tx] = v1;
  r2[ty][tx] = v2;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int t = 0; t < kIy; ++t) {
      s1 = __fadd_rn(s1, r1[t][tx]);
      s2 = __fadd_rn(s2, r2[t][tx]);
    }
    const long long at = static_cast<long long>(blockIdx.x) * c + ch;
    part1[at] = s1;
    if (part2 != nullptr) part2[at] = s2;
  }
}

// Row 13: T1 = sum dout, T2 = sum dout*yhat of the top BN. An item is a
// pooled group of s rows (its cotangent g[item] goes to the argmax row) or,
// with s = 1, one row; y (items, s, c), g (items, c).
//
// One warp an item, kTopWarps items a block. A thread owns kTopVec<T>
// consecutive channels (16 bytes: 8 bf16 or 4 f32); tx lanes of the warp
// span the block's channel tile and the warp's other 32/tx lanes (ty) take
// the item's rows ty, ty + 32/tx, ... A lane loads kTopChunk rows before it
// compares any (its g piece is in flight meanwhile), keeps for each channel
// the running max of z, its row and the y value at that row (no reread of
// the argmax row), and the lanes of one channel vector then combine by xor
// shuffles in the sequential scan's own order, so the pick is
// first_argmax's bit for bit. kVec: rows and g start on 16-byte boundaries
// (c a multiple of kTopVec<T>, aligned bases) and load as one 16-byte
// piece; else element by element, masked at c. The warps' per-channel
// terms go to row blockIdx.x of part1/part2 in ascending warp order;
// sum_rows_kernel adds the rows.
constexpr int kTopWarps = 8;  // items a block, one a warp
constexpr int kTopChunk = 8;  // rows a lane loads before comparing
constexpr int kTopTx = 32;    // lanes across channels at most
constexpr int kTopCols = 256;  // channels a block at most
static_assert(kTopWarps * 32 >= kTopCols,
              "a thread a channel adds the warps' terms");

template <typename T>
constexpr int kTopVec = 16 / static_cast<int>(sizeof(T));

// element e of a 16-byte piece of T, as f32 (exact for bf16)
template <typename T>
__device__ __forceinline__ float piece_at(const uint4& u, int e) {
  const unsigned w = (&u.x)[sizeof(T) == 2 ? e >> 1 : e];
  if constexpr (sizeof(T) == 2) {
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(w);
  }
}

// the 16 bytes at p: one load with kVec, else the first `valid` elements
// one by one (the rest 0)
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_piece(const T* p, int valid) {
  if constexpr (kVec) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;
    const Bits* b = reinterpret_cast<const Bits*>(p);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kTopVec<T>; ++e) {
      if (e < valid) {
        const unsigned v = b[e];
        if constexpr (sizeof(T) == 2) {
          w[e >> 1] |= (e & 1) ? v << 16 : v;
        } else {
          w[e] = v;
        }
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// z's place in first_argmax's order, as an int: z = T(relu(y*a + b)) is
// -0.0, +0.0, a positive number, +inf or a NaN, and the card's arithmetic
// (and its rounding to bf16) gives the canonical NaN, so |bits| orders z
// as the scan compares it: -0.0 == +0.0, a NaN above +inf, NaNs equal.
// -1 stands for no row yet.
__device__ __forceinline__ int z_key(float z) {
  return __float_as_int(z) & 0x7fffffff;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kTopWarps * 32)
    fused_top_stats_kernel(const T* __restrict__ y, const T* __restrict__ g,
                           const float* __restrict__ p,
                           float* __restrict__ part1,
                           float* __restrict__ part2, long long items, int s,
                           int c, int tx_lanes) {
  constexpr int V = kTopVec<T>;
  __shared__ float r1[kTopWarps][kTopCols], r2[kTopWarps][kTopCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane % tx_lanes, ty = lane / tx_lanes;
  const int ty_lanes = 32 / tx_lanes;
  const int col = (blockIdx.y * tx_lanes + tx) * V;  // first channel
  const int valid = min(V, c - col);  // channels of this lane, <= 0: none
  const long long it = static_cast<long long>(blockIdx.x) * kTopWarps + warp;
  const bool live = it < items && valid > 0;
  uint4 gp = make_uint4(0u, 0u, 0u, 0u);
  if (live && ty == 0) gp = load_piece<T, kVec>(g + it * c + col, valid);
  float a[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = e < valid ? p[col + e] : 0.0f;
    b[e] = e < valid ? p[c + col + e] : 0.0f;
  }
  int mk[V], am[V];  // the running max's key and row
  float yv[V];       // y at that row
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mk[e] = -1;
    am[e] = 0x7fffffff;
    yv[e] = 0.0f;
  }
  const T* py = y + it * s * c + col;
  const int nr = live && ty < s ? (s - ty + ty_lanes - 1) / ty_lanes : 0;
  for (int i0 = 0; i0 < nr; i0 += kTopChunk) {
    uint4 raw[kTopChunk];
#pragma unroll
    for (int j = 0; j < kTopChunk; ++j) {
      const long long row = ty + static_cast<long long>(i0 + j) * ty_lanes;
      raw[j] = i0 + j < nr ? load_piece<T, kVec>(py + row * c, valid)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kTopChunk; ++j) {
      if (i0 + j >= nr) break;
      const int row = ty + (i0 + j) * ty_lanes;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = piece_at<T>(raw[j], e);
        const int key = z_key(round_to<T>(affine_relu(v, a[e], b[e])));
        if (key > mk[e]) {  // rows ascend: the first of equal keys stays
          mk[e] = key;
          am[e] = row;
          yv[e] = v;
        }
      }
    }
  }
  // the lanes of one channel vector: every one ends with the winner, the
  // larger key or, of equal keys, the lower row
  for (int off = tx_lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int ko = __shfl_xor_sync(0xffffffffu, mk[e], off);
      const int ro = __shfl_xor_sync(0xffffffffu, am[e], off);
      const float vo = __shfl_xor_sync(0xffffffffu, yv[e], off);
      if (ko > mk[e] || (ko == mk[e] && ro < am[e])) {
        mk[e] = ko;
        am[e] = ro;
        yv[e] = vo;
      }
    }
  }
  if (ty == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t1 = 0.0f, t2 = 0.0f;
      if (live && e < valid) {
        const float mu = p[2 * c + col + e], r = p[3 * c + col + e];
        t1 = relu_gate(piece_at<T>(gp, e), bn_out(yv[e], a[e], b[e]));
        t2 = __fmul_rn(t1, bn_hat(yv[e], mu, r));
      }
      r1[warp][tx * V + e] = t1;
      r2[warp][tx * V + e] = t2;
    }
  }
  __syncthreads();
  const int k = threadIdx.x;  // one channel of the block's tile a thread
  const int ch = blockIdx.y * tx_lanes * V + k;
  if (k < tx_lanes * V && ch < c) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int w = 0; w < kTopWarps; ++w) {
      s1 = __fadd_rn(s1, r1[w][k]);
      s2 = __fadd_rn(s2, r2[w][k]);
    }
    const long long at = static_cast<long long>(blockIdx.x) * c + ch;
    part1[at] = s1;
    part2[at] = s2;
  }
}

// Row 14, pass 1: dy of dense k's BN_k for every row, rounded to T into
// dyc, with the per-block partials of db = sum of the unrounded dy. Items
// as in fused_top_stats_kernel: a pooled group (the top layer) or a row.
template <typename T>
__global__ void __launch_bounds__(kIx* kIy)
    fused_dense_bwd_kernel(const T* __restrict__ yk, const T* __restrict__ g,
                           const float* __restrict__ pk, T* __restrict__ dyc,
                           float* __restrict__ part_db, long long items,
                           int s, int c) {
  const int ch = blockIdx.y * kIx + threadIdx.x;
  float db = 0.0f;
  if (ch < c) {
    const float a = pk[ch], b = pk[c + ch], mu = pk[2 * c + ch];
    const float r = pk[3 * c + ch], gr = pk[4 * c + ch];
    const float m1 = pk[5 * c + ch], m2 = pk[6 * c + ch];
    const long long it0 =
        static_cast<long long>(blockIdx.x) * kItems + threadIdx.y;
    if (s == 1) {  // rows: the 8 items' loads in flight at once
      constexpr int kQ = kItems / kIy;
      float v[kQ], gv[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const long long it = it0 + kIy * q;
        v[q] = it < items ? to_f32(yk[it * c + ch]) : 0.0f;
        gv[q] = it < items ? to_f32(g[it * c + ch]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const long long it = it0 + kIy * q;
        if (it >= items) break;
        const float dout = relu_gate(gv[q], bn_out(v[q], a, b));
        const float dy = bn_dy(dout, bn_hat(v[q], mu, r), gr, m1, m2);
        dyc[it * c + ch] = from_f32<T>(dy);
        db = __fadd_rn(db, dy);
      }
    } else {
      for (int q = 0; q < kItems / kIy; ++q) {
        const long long it = it0 + kIy * q;
        if (it >= items) break;
        const T* py = yk + it * s * c + ch;
        T* pd = dyc + it * s * c + ch;
        const int am = first_argmax<T>(py, s, c, a, b);
        const float gv = to_f32(g[it * c + ch]);
#pragma unroll 4
        for (int i = 0; i < s; ++i) {
          const long long off = static_cast<long long>(i) * c;
          const float v = to_f32(py[off]);
          const float dout = relu_gate(i == am ? gv : 0.0f, bn_out(v, a, b));
          const float dy = bn_dy(dout, bn_hat(v, mu, r), gr, m1, m2);
          pd[off] = from_f32<T>(dy);
          db = __fadd_rn(db, dy);
        }
      }
    }
  }
  write_lane_partials(db, 0.0f, ch, c, part_db, nullptr);
}

// Row 14, pass 2: g_{k-1} (rows, cp) = T(dyc @ T(w)) for dyc (rows, ck) of
// T and w (ck, cp) f32, and the per-64-row-block partials of BN_{k-1}'s T1
// and T2 from the rounded g and yp (rows, cp), pp BN_{k-1}'s pack.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_bwd_g_kernel(const T* __restrict__ dyc, const float* __restrict__ w,
                       const T* __restrict__ yp, const float* __restrict__ pp,
                       T* __restrict__ gp, float* __restrict__ part1,
                       float* __restrict__ part2, long long rows, int ck,
                       int cp) {
  __shared__ float as[kBM][kBK + 1];  // dyc rows, k
  __shared__ float bs[kBN][kBK + 1];  // w columns, k
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < ck; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e / kBK, k = e % kBK;  // a warp on one row's 32 k
      const long long row = row0 + r;
      const int kk = k0 + k;
      as[r][k] = (row < rows && kk < ck) ? to_f32(dyc[row * ck + kk]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBN * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int n = e % kBN, k = e / kBN;  // a warp on one row of w
      const int col = col0 + n;
      const int kk = k0 + k;
      bs[n][k] = (col < cp && kk < ck)
                     ? round_to<T>(w[static_cast<long long>(kk) * cp + col])
                     : 0.0f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }

  float pa[8], pb[8], pmu[8], pr[8], cs[8], css[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + tx + 8 * j;
    const bool in = col < cp;
    pa[j] = in ? pp[col] : 0.0f;
    pb[j] = in ? pp[cp + col] : 0.0f;
    pmu[j] = in ? pp[2 * cp + col] : 0.0f;
    pr[j] = in ? pp[3 * cp + col] : 0.0f;
    cs[j] = 0.0f;
    css[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 8 * j;
      if (col >= cp) continue;
      const T out = from_f32<T>(acc[i][j]);
      gp[row * cp + col] = out;
      const float v = to_f32(yp[row * cp + col]);
      // the totals from the rounded cotangent, as the next pass reads it
      const float dout = relu_gate(to_f32(out), bn_out(v, pa[j], pb[j]));
      cs[j] = __fadd_rn(cs[j], dout);
      css[j] = __fadd_rn(css[j], __fmul_rn(dout, bn_hat(v, pmu[j], pr[j])));
    }
  }
  write_column_partials(cs, css, &as[0][0], &bs[0][0], col0, cp, blockIdx.x,
                        part1, part2);
}

// Row 14, pass 3: the (ck, cp) partial of dW = dyc^T @ T(relu(yp*a + b))
// over the rows of slab blockIdx.x, into part[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_bwd_dw_kernel(const T* __restrict__ dyc, const T* __restrict__ yp,
                        const float* __restrict__ pp, float* __restrict__ part,
                        long long rows, int ck, int cp) {
  __shared__ float as[kBM][kBK + 1];  // dyc columns (ck), rows
  __shared__ float bs[kBN][kBK + 1];  // z columns (cp), rows
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const long long begin = static_cast<long long>(blockIdx.x) * kSlab;
  const long long end = rows < begin + kSlab ? rows : begin + kSlab;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (long long k0 = begin; k0 < end; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int m = e % kBM, k = e / kBM;  // a warp on one row's columns
      const long long row = k0 + k;
      const int col = m0 + m;
      as[m][k] = (row < end && col < ck) ? to_f32(dyc[row * ck + col]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBN * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int n = e % kBN, k = e / kBN;
      const long long row = k0 + k;
      const int col = n0 + n;
      bs[n][k] = (row < end && col < cp)
                     ? round_to<T>(affine_relu(to_f32(yp[row * cp + col]),
                                               pp[col], pp[cp + col]))
                     : 0.0f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.x) * ck * cp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= ck) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 8 * j;
      if (n < cp) out[static_cast<long long>(m) * cp + n] = acc[i][j];
    }
  }
}

// --- rows 10 and 14 in bf16 on the tensor cores ----------------------------

constexpr int kMmaStages = 3;              // cp.async ring depth, dW pass
constexpr int kGStages = 4;  // g pass: ck <= 128 is in flight at once
constexpr int kMmaK = 32;                  // contracted elements a stage
constexpr int kLdK = kMmaK + mma::kPad;    // [m][k] tile row (g pass A)
constexpr int kLdN = kBN + mma::kPad;      // [k][n] and [k][m] tile rows
static_assert(kBM == kBN, "the dW pass's A and B tiles share kLdN");

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// W f32 -> bf16, once per launch, for the B operand of row 10 (Cout, Cin)
// and of row 14's g pass (ck, cp)
__global__ void round_bf16_kernel(const float* __restrict__ w,
                                  __nv_bfloat16* __restrict__ out,
                                  long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    out[t] = __float2bfloat16_rn(w[t]);
  }
}

// both halves of a B register, z = bf16(relu(v*a + b)) of one column
__device__ __forceinline__ uint32_t z_pair(uint32_t r, float a, float b) {
  __nv_bfloat162 h;
  memcpy(&h, &r, sizeof(r));
  const float2 v = __bfloat1622float2(h);
  const __nv_bfloat162 z =
      __floats2bfloat162_rn(affine_relu(v.x, a, b), affine_relu(v.y, a, b));
  uint32_t out;
  memcpy(&out, &z, sizeof(out));
  return out;
}

// Row 14, pass 2 in bf16: gp (rows, cp) = bf16(dyc @ w16) for dyc (rows, ck)
// and w16 (ck, cp), with the T1/T2 partials of each 64-row block as
// dense_bwd_g_kernel takes them. One block a (64-row block, 64-column
// tile), blockIdx.x = row block * column tiles + column tile.
__global__ void __launch_bounds__(kThreads)
    dense_bwd_g_mma_kernel(const __nv_bfloat16* __restrict__ dyc,
                           const __nv_bfloat16* __restrict__ w16,
                           const __nv_bfloat16* __restrict__ yp,
                           const float* __restrict__ pp,
                           __nv_bfloat16* __restrict__ gp,
                           float* __restrict__ part1,
                           float* __restrict__ part2, long long rows, int ck,
                           int cp) {
  __shared__ __align__(16) __nv_bfloat16 as[kGStages][kBM][kLdK];
  __shared__ __align__(16) __nv_bfloat16 bs[kGStages][kMmaK][kLdN];
  __shared__ float red[2][2][kBN];  // T1/T2 of the two warp rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32x32 quarter
  const int ntiles = (cp + kBN - 1) / kBN;
  const long long rblk = blockIdx.x / ntiles;
  const int col0 = static_cast<int>(blockIdx.x % ntiles) * kBN;
  const long long row0 = rblk * kBM;
  const bool a_vec = ck % 8 == 0 && aligned16(dyc);
  const bool b_vec = cp % 8 == 0 && aligned16(w16);
  const int chunks = (ck + kMmaK - 1) / kMmaK;

  auto stage = [&](int st, int chunk) {
    const int k0 = chunk * kMmaK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // A: 64 rows x 4 pieces of 8
      const int e = tid + q * kThreads;
      const int r = e >> 2, c = (e & 3) * 8;
      const long long row = row0 + r;
      mma::stage8(&as[st][r][c], dyc + row * ck + k0 + c, row < rows,
                  ck - k0 - c, a_vec);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // B: 32 k x 8 pieces of 8 columns
      const int e = tid + q * kThreads;
      const int r = e >> 3, c = (e & 7) * 8;
      const int kk = k0 + r;
      mma::stage8(&bs[st][r][c],
                  w16 + static_cast<long long>(kk) * cp + col0 + c, kk < ck,
                  cp - col0 - c, b_vec);
    }
  };

  float acc[2][4][4] = {};
  for (int c = 0; c < kGStages - 1; ++c) {
    if (c < chunks) stage(c, c);
    mma::cp_async_commit();
  }
  // the epilogue's yp, pairs of columns (2*tig, 2*tig + 1) of this
  // thread's rows, loaded while the products' operands are in flight
  const int gid = lane >> 2, tig = lane & 3;
  const bool pairs = cp % 2 == 0 && reinterpret_cast<uintptr_t>(yp) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(gp) % 4 == 0;
  __nv_bfloat162 ypv[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + wm * 32 + 16 * i + 8 * h + gid;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn * 32 + 8 * j + 2 * tig;
        const __nv_bfloat16* p = yp + row * cp + col;
        if (row < rows && col < cp && pairs) {
          ypv[i][h][j] = *reinterpret_cast<const __nv_bfloat162*>(p);
        } else {
          const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
          ypv[i][h][j].x = row < rows && col < cp ? p[0] : zero;
          ypv[i][h][j].y = row < rows && col + 1 < cp ? p[1] : zero;
        }
      }
    }
  }
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<kGStages - 2>();
    __syncthreads();  // chunk c is in; the stage refilled below is read
    if (c + kGStages - 1 < chunks) {
      stage((c + kGStages - 1) % kGStages, c + kGStages - 1);
    }
    mma::cp_async_commit();
    const int st = c % kGStages;
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      mma::load_a_mk(a, &as[st][0][0], kLdK, wm * 32, kk);
      mma::load_b_kn(b, &bs[st][0][0], kLdN, wn * 32, kk);
      mma::warp_mma(acc, a, b);
    }
  }

  // epilogue: round, store, and the T1/T2 terms of the rounded g
  float pa[4][2], pb[4][2], pmu[4][2], pr[4][2], cs[4][2], css[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + wn * 32 + 8 * j + 2 * tig + e;
      const bool in = col < cp;
      pa[j][e] = in ? pp[col] : 0.0f;
      pb[j][e] = in ? pp[cp + col] : 0.0f;
      pmu[j][e] = in ? pp[2 * cp + col] : 0.0f;
      pr[j][e] = in ? pp[3 * cp + col] : 0.0f;
      cs[j][e] = 0.0f;
      css[j][e] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows in ascending order
      const long long row = row0 + wm * 32 + 16 * i + 8 * h + gid;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn * 32 + 8 * j + 2 * tig;
        const __nv_bfloat162 out = __floats2bfloat162_rn(
            acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        __nv_bfloat16* q = gp + row * cp + col;
        if (col + 1 < cp && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(q) = out;
        } else {
          if (col < cp) q[0] = out.x;
          if (col + 1 < cp) q[1] = out.y;
        }
        const float2 o = __bfloat1622float2(out);
        const float2 v = __bfloat1622float2(ypv[i][h][j]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= cp) continue;
          const float oe = e == 0 ? o.x : o.y, ve = e == 0 ? v.x : v.y;
          const float dout = relu_gate(oe, bn_out(ve, pa[j][e], pb[j][e]));
          cs[j][e] = __fadd_rn(cs[j][e], dout);
          css[j][e] = __fadd_rn(
              css[j][e], __fmul_rn(dout, bn_hat(ve, pmu[j][e], pr[j][e])));
        }
      }
    }
  }
  // the 8 row groups of a column, in a fixed butterfly; lanes 0-3 keep it
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs[j][e] = __fadd_rn(cs[j][e], __shfl_xor_sync(0xffffffffu,
                                                       cs[j][e], o));
        css[j][e] = __fadd_rn(css[j][e], __shfl_xor_sync(0xffffffffu,
                                                         css[j][e], o));
      }
      if (gid == 0) {
        red[0][wm][wn * 32 + 8 * j + 2 * tig + e] = cs[j][e];
        red[1][wm][wn * 32 + 8 * j + 2 * tig + e] = css[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < kBN && col0 + tid < cp) {
    const long long at = rblk * cp + col0 + tid;
    part1[at] = __fadd_rn(red[0][0][tid], red[0][1][tid]);
    part2[at] = __fadd_rn(red[1][0][tid], red[1][1][tid]);
  }
}

// Row 14, pass 3 in bf16: the (ck, cp) partial of dW = dyc^T @
// bf16(relu(yp*a + b)) over the rows of one 1024-row slab, into
// part[slab]. One block a (slab, 64x64 tile of dW), blockIdx.x = slab *
// tiles + tile: a slab's tiles run side by side and share its rows in L2.
__global__ void __launch_bounds__(kThreads)
    dense_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ dyc,
                            const __nv_bfloat16* __restrict__ yp,
                            const float* __restrict__ pp,
                            float* __restrict__ part, long long rows, int ck,
                            int cp) {
  __shared__ __align__(16) __nv_bfloat16 as[kMmaStages][kMmaK][kLdN];
  __shared__ __align__(16) __nv_bfloat16 bs[kMmaStages][kMmaK][kLdN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int ntiles = (cp + kBN - 1) / kBN;
  const int tiles = ((ck + kBM - 1) / kBM) * ntiles;
  const long long slab = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int m0 = (tile / ntiles) * kBM, n0 = (tile % ntiles) * kBN;
  const long long begin = slab * kSlab;
  const long long end = rows < begin + kSlab ? rows : begin + kSlab;
  const int chunks = static_cast<int>((end - begin + kMmaK - 1) / kMmaK);
  const bool a_vec = ck % 8 == 0 && aligned16(dyc);
  const bool b_vec = cp % 8 == 0 && aligned16(yp);

  auto stage = [&](int st, int chunk) {
    const long long r0 = begin + static_cast<long long>(chunk) * kMmaK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // 32 rows x 8 pieces of 8, A and B
      const int e = tid + q * kThreads;
      const int r = e >> 3, c = (e & 7) * 8;
      const long long row = r0 + r;
      mma::stage8(&as[st][r][c], dyc + row * ck + m0 + c, row < end,
                  ck - m0 - c, a_vec);
      mma::stage8(&bs[st][r][c], yp + row * cp + n0 + c, row < end,
                  cp - n0 - c, b_vec);
    }
  };

  // the affine of this thread's B columns (n0 + wn*32 + 8j + gid); rows
  // past the slab stage as zeros in both operands, and dyc's zero times
  // the finite relu(b) adds nothing
  const int gid = lane >> 2, tig = lane & 3;
  float za[4], zb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + 8 * j + gid;
    za[j] = col < cp ? pp[col] : 0.0f;
    zb[j] = col < cp ? pp[cp + col] : 0.0f;
  }

  float acc[2][4][4] = {};
  for (int c = 0; c < kMmaStages - 1; ++c) {
    if (c < chunks) stage(c, c);
    mma::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (c + kMmaStages - 1 < chunks) {
      stage((c + kMmaStages - 1) % kMmaStages, c + kMmaStages - 1);
    }
    mma::cp_async_commit();
    const int st = c % kMmaStages;
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      mma::load_a_km(a, &as[st][0][0], kLdN, wm * 32, kk);
      mma::load_b_kn(b, &bs[st][0][0], kLdN, wn * 32, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = z_pair(b[j][0], za[j], zb[j]);
        b[j][1] = z_pair(b[j][1], za[j], zb[j]);
      }
      mma::warp_mma(acc, a, b);
    }
  }

  float* out = part + slab * ck * cp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + 16 * i + 8 * h + gid;
      if (m >= ck) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + 8 * j + 2 * tig + e;
          if (n < cp) out[static_cast<long long>(m) * cp + n] =
              acc[i][j][2 * h + e];
        }
      }
    }
  }
}

// Row 10 in bf16: y (rows, cout) = bf16(z @ w16^T + bias) for z =
// bf16(relu(x*a + b)) of x (rows, cin) and w16 (cout, cin), both bf16, with
// the column sum and sumsq partials of float(y) per 64-row block when
// kStats. A tile is 32*kRowWarps rows by 32*kColWarps columns, warps of
// 32x32; its y goes out through shared memory, 16 bytes a thread along
// each row. The grid is persistent: block i keeps column tile i % ntiles
// and walks the row tiles i / ntiles, + gridDim.x / ntiles, ..., and one
// cp.async ring of kStages runs through all of its tiles' 32-deep chunks, so
// the next tile's x is in flight while a tile's epilogue runs. Blocks next
// to each other take the column tiles of one row tile, which share x in
// L2. Which block takes a tile changes no sum: two launches, on any card,
// give the same bits. Rows past `rows` stage as zeros and are neither
// stored nor summed.
template <int kRowWarps, int kColWarps, int kStages>
struct DenseMmaSmem {
  static constexpr int kRows = 32 * kRowWarps;
  static constexpr int kCols = 32 * kColWarps;
  static constexpr int kLdO = kCols + mma::kPad;  // the staged y tile's rows
  __nv_bfloat16 zs[kStages][kRows][kLdK];
  __nv_bfloat16 ws[kStages][kCols][kLdK];
  __nv_bfloat16 os[kRows][kLdO];
  float red[2][kRowWarps][kCols];  // column sums of each warp row
};

template <int kRowWarps, int kColWarps, int kStages, bool kStats>
__global__ void __launch_bounds__(32 * kRowWarps * kColWarps)
    fused_dense_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           const __nv_bfloat16* __restrict__ w16,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ y,
                           float* __restrict__ part_s,
                           float* __restrict__ part_ss, long long rows,
                           int cin, int cout) {
  using Smem = DenseMmaSmem<kRowWarps, kColWarps, kStages>;
  constexpr int kRows = Smem::kRows;
  constexpr int kCols = Smem::kCols;
  constexpr int kT = 32 * kRowWarps * kColWarps;
  extern __shared__ __align__(16) unsigned char dense_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dense_smem);
  auto& zs = sm.zs;
  auto& ws = sm.ws;
  auto& os = sm.os;
  auto& red = sm.red;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kColWarps, wn = warp % kColWarps;  // its 32x32
  const int gid = lane >> 2, tig = lane & 3;
  const int ntiles = (cout + kCols - 1) / kCols;
  const int col0 = static_cast<int>(blockIdx.x % ntiles) * kCols;
  const long long rt0 = blockIdx.x / ntiles;
  const long long rstep = gridDim.x / ntiles;
  const long long rtiles = (rows + kRows - 1) / kRows;
  const long long my_tiles =
      rt0 < rtiles ? (rtiles - rt0 + rstep - 1) / rstep : 0;
  const bool a_vec = cin % 8 == 0 && aligned16(x);
  const bool b_vec = cin % 8 == 0 && aligned16(w16);
  const int chunks = (cin + kMmaK - 1) / kMmaK;
  // kT is a multiple of 4, so this thread's pieces of x always start at k
  // offset kc of a chunk
  const int kc = (tid & 3) * 8;

  // the next chunk to stage: chunk sc of this block's tile sj
  long long sj = 0;
  int sc = 0;
  auto stage_next = [&](int st) {
    if (sj >= my_tiles) return;
    const long long row0 = (rt0 + sj * rstep) * kRows;
    const int k0 = sc * kMmaK;
#pragma unroll
    for (int e = tid; e < kRows * 4; e += kT) {  // x: rows x 4 pieces of 8
      const int r = e >> 2;
      const long long row = row0 + r;
      mma::stage8(&zs[st][r][kc], x + row * cin + k0 + kc, row < rows,
                  cin - k0 - kc, a_vec);
    }
#pragma unroll
    for (int e = tid; e < kCols * 4; e += kT) {  // w16: columns x 4 pieces
      const int n = e >> 2, c = (e & 3) * 8;
      const int col = col0 + n;
      mma::stage8(&ws[st][n][c],
                  w16 + static_cast<long long>(col) * cin + k0 + c,
                  col < cout, cin - k0 - c, b_vec);
    }
    if (++sc == chunks) {
      sc = 0;
      ++sj;
    }
  };
  // a and b at this thread's 8 k of chunk c (0 past cin), loaded a chunk
  // ahead of their use
  float av[8], bv[8];
  auto load_ab = [&](int c) {
    const int k0 = c * kMmaK + kc;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      av[t] = k0 + t < cin ? a[k0 + t] : 0.0f;
      bv[t] = k0 + t < cin ? b[k0 + t] : 0.0f;
    }
  };
  // z = bf16(relu(x*a + b)) over the pieces of x this thread staged, in
  // place: visible to this thread after its own cp_async_wait, to the
  // others after the chunk's barrier. Past cin, x stages as 0 and a and b
  // load as 0, so z = relu(0*0 + 0) = +0 (relu(b) would not be 0).
  auto transform = [&](int st) {
#pragma unroll
    for (int e = tid; e < kRows * 4; e += kT) {
      uint4* piece = reinterpret_cast<uint4*>(&zs[st][e >> 2][kc]);
      uint4 v = *piece;
      __nv_bfloat162 h[4];
      memcpy(h, &v, sizeof(v));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        h[q] = __floats2bfloat162_rn(affine_relu(f.x, av[2 * q], bv[2 * q]),
                                     affine_relu(f.y, av[2 * q + 1],
                                                 bv[2 * q + 1]));
      }
      memcpy(&v, h, sizeof(v));
      *piece = v;
    }
  };

  float bias_r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + wn * 32 + 8 * j + 2 * tig + e;
      bias_r[j][e] = col < cout ? bias[col] : 0.0f;
    }
  }
  const bool y_vec = cout % 8 == 0 && aligned16(y);

  // y = bf16(acc + bias) of the tile at row0 into os, then out along its
  // rows; the statistics of the rounded y from the registers: each
  // thread's rows in ascending order, the 8 row groups of a column in a
  // fixed xor tree, then the warp rows of each 64-row block in ascending
  // order, one partial row a 64 rows. os and red are written again only
  // after the next chunk's barrier.
  auto epilogue = [&](const float (&acc)[2][4][4], long long row0) {
    float cs[4][2] = {}, css[4][2] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + 16 * i + 8 * h + gid;
        const bool in = row0 + r < rows;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn * 32 + 8 * j + 2 * tig;
          const __nv_bfloat162 out = __floats2bfloat162_rn(
              __fadd_rn(acc[i][j][2 * h], bias_r[j][0]),
              __fadd_rn(acc[i][j][2 * h + 1], bias_r[j][1]));
          *reinterpret_cast<__nv_bfloat162*>(&os[r][c]) = out;
          if (kStats && in) {
            // columns past cout hold bias 0 and acc 0 (W staged as 0)
            const float2 o = __bfloat1622float2(out);
            cs[j][0] = __fadd_rn(cs[j][0], o.x);
            css[j][0] = __fadd_rn(css[j][0], __fmul_rn(o.x, o.x));
            cs[j][1] = __fadd_rn(cs[j][1], o.y);
            css[j][1] = __fadd_rn(css[j][1], __fmul_rn(o.y, o.y));
          }
        }
      }
    }
    if (kStats) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs[j][e] = __fadd_rn(cs[j][e], __shfl_xor_sync(0xffffffffu,
                                                           cs[j][e], o));
            css[j][e] = __fadd_rn(css[j][e], __shfl_xor_sync(
                                                 0xffffffffu, css[j][e], o));
          }
          if (gid == 0) {
            red[0][wm][wn * 32 + 8 * j + 2 * tig + e] = cs[j][e];
            red[1][wm][wn * 32 + 8 * j + 2 * tig + e] = css[j][e];
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = tid; e < kRows * kCols / 8; e += kT) {  // pieces of 8
      const int r = e / (kCols / 8), c = e % (kCols / 8) * 8;
      const long long row = row0 + r;
      const int col = col0 + c;
      if (row >= rows) continue;
      __nv_bfloat16* q = y + row * cout + col;
      if (y_vec && col + 8 <= cout) {
        *reinterpret_cast<uint4*>(q) =
            *reinterpret_cast<const uint4*>(&os[r][c]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (col + t < cout) q[t] = os[r][c + t];
        }
      }
    }
    if (!kStats) return;
    for (int t = tid; t < kRowWarps / 2 * kCols; t += kT) {
      const int half = t / kCols, cc = t % kCols;
      const long long prow = row0 / 64 + half;
      if (prow * 64 < rows && col0 + cc < cout) {
        const long long at = prow * cout + col0 + cc;
        part_s[at] = __fadd_rn(red[0][2 * half][cc], red[0][2 * half + 1][cc]);
        part_ss[at] =
            __fadd_rn(red[1][2 * half][cc], red[1][2 * half + 1][cc]);
      }
    }
  };

  for (int st = 0; st < kStages - 1; ++st) {
    stage_next(st);
    mma::cp_async_commit();
  }
  load_ab(0);
  float acc[2][4][4] = {};
  const long long total = my_tiles * chunks;
  int c = 0;  // the chunk consumed: chunk c of this block's tile j
  long long j = 0;
  for (long long q = 0; q < total; ++q) {
    const int st = static_cast<int>(q % kStages);
    mma::cp_async_wait<kStages - 2>();  // this thread's pieces of chunk q
    transform(st);
    __syncthreads();  // chunk q's z is in; the stage refilled below is read
    stage_next(static_cast<int>((q + kStages - 1) % kStages));
    mma::cp_async_commit();
    load_ab(c + 1 < chunks ? c + 1 : 0);
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
      mma::load_a_mk(af, &zs[st][0][0], kLdK, wm * 32, kk);
      mma::load_b_nk(bf, &ws[st][0][0], kLdK, wn * 32, kk);
      mma::warp_mma(acc, af, bf);
    }
    if (++c == chunks) {
      epilogue(acc, (rt0 + j * rstep) * kRows);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0f;
        }
      }
      c = 0;
      ++j;
    }
  }
}

// Rows 12 and 15, the elementwise passes over (rows, c) of T with f32
// values a channel: row 12's out = T(relu(y*a + b)) and row 15's dx =
// T(gr*((dout - m1) - yhat*m2)) of BN_0 from x and g. One walk serves both
// (channel_walk). A thread owns kTopVec<T> consecutive channels (16 bytes:
// 8 bf16 or 4 f32) at a channel offset fixed for the launch: tx lanes span
// a row's channel vectors (blockIdx.y tiles rows wider than kFirstThreads
// vectors), the block's kFirstThreads / tx row lanes take neighbouring
// rows, so a warp reads contiguous bytes. The thread keeps its channels'
// values (a, b; or the seven of the pack) in registers, walks rows with a
// grid stride and loads kFirstRows rows of every input before computing
// any; the loop has no division or modulo. kVec: every row starts on a
// 16-byte boundary (c a multiple of the vector, aligned bases) and the
// tensors move as 16-byte pieces; else element by element, masked at c.
constexpr int kFirstThreads = 128;  // threads a block
constexpr int kFirstRows = 4;       // rows a thread loads before computing
constexpr int kFirstBlocks = 65536;  // row blocks at most (a grid stride)

// the V floats in a 16-byte piece of T, each rounded to T (round to
// nearest even for bf16)
template <typename T>
__device__ __forceinline__ uint4 pack_piece(const float (&v)[kTopVec<T>]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      w[i] = static_cast<unsigned>(__bfloat16_as_ushort(
                 __float2bfloat16_rn(v[2 * i]))) |
             static_cast<unsigned>(__bfloat16_as_ushort(
                 __float2bfloat16_rn(v[2 * i + 1])))
                 << 16;
    } else {
      w[i] = __float_as_uint(v[i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a 16-byte piece to p: one store with kVec, else its first `valid`
// elements one by one
template <typename T, bool kVec>
__device__ __forceinline__ void store_piece(T* p, const uint4& u,
                                            int valid) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;
    Bits* b = reinterpret_cast<Bits*>(p);
#pragma unroll
    for (int e = 0; e < kTopVec<T>; ++e) {
      if (e < valid) {
        const unsigned w = (&u.x)[sizeof(T) == 2 ? e >> 1 : e];
        b[e] = static_cast<Bits>(sizeof(T) == 2 && (e & 1) ? w >> 16 : w);
      }
    }
  }
}

// The tensors of one elementwise pass: kIn inputs and the output (rows, c)
// of T, and kPack rows of c f32 values a channel.
template <typename T, int kIn, int kPack>
struct ChannelPass {
  const T* in[kIn];
  const float* pack[kPack];
  T* out;
};

// The walk of rows 12 and 15 (the map above): out = f(v, pk, e) for each
// element, v its kIn inputs as f32, pk the thread's channel values, e its
// place in the thread's vector.
template <typename T, bool kVec, int kIn, int kPack, typename F>
__device__ __forceinline__ void channel_walk(
    const ChannelPass<T, kIn, kPack>& t, long long rows, int c, int tx_lanes,
    F f) {
  constexpr int V = kTopVec<T>;
  const int tx = threadIdx.x % tx_lanes, ty = threadIdx.x / tx_lanes;
  const int ty_lanes = kFirstThreads / tx_lanes;
  const int col = (blockIdx.y * tx_lanes + tx) * V;  // first channel
  const int valid = min(V, c - col);  // channels of this thread
  if (ty >= ty_lanes || valid <= 0) return;
  float pk[kPack][V];
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      pk[k][e] = e < valid ? t.pack[k][col + e] : 0.0f;
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * ty_lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * ty_lanes + ty;
       r0 < rows; r0 += kFirstRows * step) {
    uint4 raw[kFirstRows][kIn];
#pragma unroll
    for (int j = 0; j < kFirstRows; ++j) {
      const long long at = (r0 + j * step) * c + col;
      if (r0 + j * step < rows) {
#pragma unroll
        for (int i = 0; i < kIn; ++i) {
          raw[j][i] = load_piece<T, kVec>(t.in[i] + at, valid);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFirstRows; ++j) {
      if (r0 + j * step >= rows) break;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v[kIn];
#pragma unroll
        for (int i = 0; i < kIn; ++i) v[i] = piece_at<T>(raw[j][i], e);
        o[e] = f(v, pk, e);
      }
      store_piece<T, kVec>(t.out + (r0 + j * step) * c + col,
                           pack_piece<T>(o), valid);
    }
  }
}

// Row 12: in y; pack a, b.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFirstThreads)
    fused_affine_kernel(const ChannelPass<T, 1, 2> t, long long rows, int c,
                        int tx_lanes) {
  channel_walk<T, kVec>(
      t, rows, c, tx_lanes,
      [](const float (&v)[1], const float (&pk)[2][kTopVec<T>], int e) {
        return affine_relu(v[0], pk[0][e], pk[1][e]);
      });
}

// Row 15: in x, g; pack a, b, mu, r, gr, m1, m2.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFirstThreads)
    fused_first_bwd_kernel(const ChannelPass<T, 2, 7> t, long long rows,
                           int c, int tx_lanes) {
  channel_walk<T, kVec>(
      t, rows, c, tx_lanes,
      [](const float (&v)[2], const float (&pk)[7][kTopVec<T>], int e) {
        const float dout = relu_gate(v[1], bn_out(v[0], pk[0][e], pk[1][e]));
        return bn_dy(dout, bn_hat(v[0], pk[2][e], pk[3][e]), pk[4][e],
                     pk[5][e], pk[6][e]);
      });
}

// Rows 12 and 15's launch: tx lanes span a row's channel vectors (at most
// kFirstThreads, more in blockIdx.y tiles), kFirstThreads / tx rows a
// block, as many row blocks as the rows need up to kFirstBlocks; the
// kernel's kVec instance where c is a multiple of the vector and every
// tensor starts on a 16-byte boundary.
template <typename T, int kIn, int kPack>
cudaError_t launch_channel_pass(
    void (*vec_kernel)(ChannelPass<T, kIn, kPack>, long long, int, int),
    void (*any_kernel)(ChannelPass<T, kIn, kPack>, long long, int, int),
    const ChannelPass<T, kIn, kPack>& t, long long rows, int c,
    cudaStream_t st) {
  constexpr int V = kTopVec<T>;
  const int vecs = (c + V - 1) / V;
  const int tx = vecs < kFirstThreads ? vecs : kFirstThreads;
  const long long per = static_cast<long long>(kFirstThreads / tx) *
                        kFirstRows;
  const long long want = (rows + per - 1) / per;
  const dim3 grid(static_cast<unsigned>(want < kFirstBlocks ? want
                                                            : kFirstBlocks),
                  (vecs + tx - 1) / tx);
  bool vec = c % V == 0 && aligned16(t.out);
  for (int i = 0; i < kIn; ++i) vec = vec && aligned16(t.in[i]);
  const auto kernel = vec ? vec_kernel : any_kernel;
  kernel<<<grid, kFirstThreads, 0, st>>>(t, rows, c, tx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_affine(const void* y, const float* a, const float* b,
                          void* out, long long rows, int c, cudaStream_t st) {
  const ChannelPass<T, 1, 2> t{
      {static_cast<const T*>(y)}, {a, b}, static_cast<T*>(out)};
  return launch_channel_pass(fused_affine_kernel<T, true>,
                             fused_affine_kernel<T, false>, t, rows, c, st);
}

unsigned grid_for(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return static_cast<unsigned>(want < 132LL * 32 ? want : 132LL * 32);
}

// The persistent row-10 bf16 kernel for one tile shape: as many row tiles
// at once as fit on the card, each with every column tile.
template <int kRowWarps, int kColWarps, int kStages, bool kStats>
cudaError_t launch_dense_mma(const void* x, const float* a, const float* b,
                             const __nv_bfloat16* w16, const float* bias,
                             void* y, float* part_s, float* part_ss,
                             long long rows, int cin, int cout,
                             cudaStream_t st) {
  using Smem = DenseMmaSmem<kRowWarps, kColWarps, kStages>;
  constexpr int kT = 32 * kRowWarps * kColWarps;
  constexpr int kSmem = sizeof(Smem);
  const auto kernel =
      fused_dense_mma_kernel<kRowWarps, kColWarps, kStages, kStats>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) !=
          cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kT, kSmem)) != cudaSuccess) {
    return err;
  }
  const long long ntiles = (cout + Smem::kCols - 1) / Smem::kCols;
  const long long rtiles = (rows + Smem::kRows - 1) / Smem::kRows;
  long long at_once = static_cast<long long>(sms) * per_sm / ntiles;
  at_once = at_once < 1 ? 1 : (at_once > rtiles ? rtiles : at_once);
  kernel<<<static_cast<unsigned>(at_once * ntiles), kT, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(x), a, b, w16, bias,
      static_cast<__nv_bfloat16*>(y), part_s, part_ss, rows, cin, cout);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_dense(const void* x, const float* a, const float* b,
                         const float* w, void* w16, const float* bias,
                         void* y, float* part_s, float* part_ss,
                         long long rows, int cin, int cout, int itemsize,
                         cudaStream_t st) {
  if (itemsize == 4) {
    const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                    (cout + kBN - 1) / kBN);
    fused_dense_kernel<kStats><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), a, b, w, bias, static_cast<float*>(y),
        part_s, part_ss, rows, cin, cout);
    return cudaGetLastError();
  }
  const long long wn = static_cast<long long>(cout) * cin;
  auto* w16b = static_cast<__nv_bfloat16*>(w16);
  round_bf16_kernel<<<grid_for(wn, 256), 256, 0, st>>>(w, w16b, wn);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // tiles by measurement on an H100 at the models' shapes: 128 x 64 with
  // a 4-deep ring up to 64 columns, 128 x 128 with a 3-deep one above
  if (cout <= 64) {
    return launch_dense_mma<4, 2, 4, kStats>(x, a, b, w16b, bias, y, part_s,
                                             part_ss, rows, cin, cout, st);
  }
  return launch_dense_mma<4, 4, 3, kStats>(x, a, b, w16b, bias, y, part_s,
                                           part_ss, rows, cin, cout, st);
}

}  // namespace

// y (rows, cout) = T(T(relu(x*a + b)) @ T(w)^T + bias) for x (rows, cin)
// of T, a, b (cin) f32, w (cout, cin) f32, bias (cout) f32; w16 a (cout,
// cin) bf16 scratch in bf16 (null in f32). With part_s non-null, also sum
// and sumsq (cout) f32 of float(y), through the (ceil(rows/64), cout) f32
// scratches part_s and part_ss.
extern "C" int pn2_fused_dense(const void* x, const void* a, const void* b,
                               const void* w, void* w16, const void* bias,
                               void* y, void* part_s, void* part_ss,
                               void* sum, void* sumsq, long long rows,
                               int cin, int cout, int itemsize,
                               void* stream) {
  if (rows <= 0 || cout <= 0) return cudaSuccess;  // empty output
  const long long rblocks = (rows + kBM - 1) / kBM;
  const long long tiles = (cout + kBN - 1) / kBN;
  if (cin <= 0 || (itemsize != 4 && itemsize != 2) ||
      (itemsize == 2 && w16 == nullptr) || tiles > 65535 ||
      rblocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* wf = static_cast<const float*>(w);
  const float* biasf = static_cast<const float*>(bias);
  float* ps = static_cast<float*>(part_s);
  float* pss = static_cast<float*>(part_ss);
  cudaError_t err =
      ps != nullptr
          ? launch_dense<true>(x, af, bf, wf, w16, biasf, y, ps, pss, rows,
                               cin, cout, itemsize, st)
          : launch_dense<false>(x, af, bf, wf, w16, biasf, y, nullptr,
                                nullptr, rows, cin, cout, itemsize, st);
  if (err != cudaSuccess || ps == nullptr) return err;
  err = sum_rows(ps, static_cast<float*>(sum), rblocks, cout, st);
  if (err != cudaSuccess) return err;
  return sum_rows(pss, static_cast<float*>(sumsq), rblocks, cout, st);
}

// out (groups, c) = max over s of T(relu(y*a + b)), y (groups, s, c) of T
extern "C" int pn2_fused_pool(const void* y, const void* a, const void* b,
                              void* out, long long groups, int s, int c,
                              int itemsize, void* stream) {
  if (groups <= 0 || c <= 0) return cudaSuccess;
  if (s <= 0) return cudaErrorInvalidValue;
  const long long total = groups * c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (itemsize == 4) {
    fused_pool_kernel<float><<<grid_for(total, 256), 256, 0, st>>>(
        static_cast<const float*>(y), af, bf, static_cast<float*>(out), total,
        s, c);
  } else if (itemsize == 2) {
    fused_pool_kernel<__nv_bfloat16><<<grid_for(total, 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), af, bf,
        static_cast<__nv_bfloat16*>(out), total, s, c);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out (rows, c) = T(relu(y*a + b)), y (rows, c) of T
extern "C" int pn2_fused_affine(const void* y, const void* a, const void* b,
                                void* out, long long rows, int c, int itemsize,
                                void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (itemsize == 4) return launch_affine<float>(y, af, bf, out, rows, c, st);
  if (itemsize == 2) {
    return launch_affine<__nv_bfloat16>(y, af, bf, out, rows, c, st);
  }
  return cudaErrorInvalidValue;
}

namespace {

unsigned item_blocks(long long items) {
  return static_cast<unsigned>((items + kItems - 1) / kItems);
}

// Row 13's grid: item blocks of kTopWarps by channel tiles of tx lanes
// (the channel vectors rounded up to a power of two, at most kTopTx) of
// kTopVec<T> channels; kVec where every row of y and g starts on a
// 16-byte boundary.
template <typename T>
cudaError_t launch_top_stats(const void* y, const void* g, const float* p,
                             float* part, float* sums, long long items, int s,
                             int c, cudaStream_t st) {
  constexpr int V = kTopVec<T>;
  const int vecs = (c + V - 1) / V;
  int tx = 1;
  while (tx < vecs && tx < kTopTx) tx <<= 1;
  const unsigned blocks =
      static_cast<unsigned>((items + kTopWarps - 1) / kTopWarps);
  const dim3 grid(blocks, (vecs + tx - 1) / tx);
  float* part2 = part + static_cast<long long>(blocks) * c;
  const bool vec = c % V == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(g);
  if (vec) {
    fused_top_stats_kernel<T, true><<<grid, kTopWarps * 32, 0, st>>>(
        yt, gt, p, part, part2, items, s, c, tx);
  } else {
    fused_top_stats_kernel<T, false><<<grid, kTopWarps * 32, 0, st>>>(
        yt, gt, p, part, part2, items, s, c, tx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = sum_rows(part, sums, blocks, c, st)) != cudaSuccess) return err;
  return sum_rows(part2, sums + c, blocks, c, st);
}

template <typename T>
cudaError_t launch_first_bwd(const void* x, const void* g, const float* p,
                             void* dx, long long rows, int c,
                             cudaStream_t st) {
  const ChannelPass<T, 2, 7> t{
      {static_cast<const T*>(x), static_cast<const T*>(g)},
      {p, p + c, p + 2 * c, p + 3 * c, p + 4 * c, p + 5 * c, p + 6 * c},
      static_cast<T*>(dx)};
  return launch_channel_pass(fused_first_bwd_kernel<T, true>,
                             fused_first_bwd_kernel<T, false>, t, rows, c,
                             st);
}

struct DenseBwd {
  const void* yk;
  const void* yp;
  const void* g;
  const float* pk;
  const float* pp;
  const float* w;
  void* w16;  // bf16 only: W rounded, (ck, cp)
  void* dyc;
  float* db_part;
  void* gp;
  float* t_part;
  float* dw_part;
  float* dw;
  float* db;
  float* t;
};

template <typename T>
cudaError_t launch_dense_bwd(const DenseBwd& a, long long items, int s,
                             int ck, int cp, cudaStream_t st) {
  const long long rows = items * s;
  const unsigned iblocks = item_blocks(items);
  fused_dense_bwd_kernel<T>
      <<<dim3(iblocks, (ck + kIx - 1) / kIx), dim3(kIx, kIy), 0, st>>>(
          static_cast<const T*>(a.yk), static_cast<const T*>(a.g), a.pk,
          static_cast<T*>(a.dyc), a.db_part, items, s, ck);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = sum_rows(a.db_part, a.db, iblocks, ck, st)) != cudaSuccess) {
    return err;
  }

  const long long rblocks = (rows + kBM - 1) / kBM;
  const long long slabs = (rows + kSlab - 1) / kSlab;
  float* t2_part = a.t_part + rblocks * cp;
  const int ntiles = (cp + kBN - 1) / kBN;
  const int tiles = ((ck + kBM - 1) / kBM) * ntiles;
  if constexpr (std::is_same_v<T, float>) {
    dense_bwd_g_kernel<T>
        <<<dim3(static_cast<unsigned>(rblocks), ntiles), kThreads, 0, st>>>(
            static_cast<const T*>(a.dyc), a.w, static_cast<const T*>(a.yp),
            a.pp, static_cast<T*>(a.gp), a.t_part, t2_part, rows, ck, cp);
  } else {
    const long long wn = static_cast<long long>(ck) * cp;
    round_bf16_kernel<<<grid_for(wn, 256), 256, 0, st>>>(
        a.w, static_cast<__nv_bfloat16*>(a.w16), wn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dense_bwd_g_mma_kernel<<<static_cast<unsigned>(rblocks * ntiles),
                             kThreads, 0, st>>>(
        static_cast<const T*>(a.dyc),
        static_cast<const __nv_bfloat16*>(a.w16),
        static_cast<const T*>(a.yp), a.pp, static_cast<T*>(a.gp), a.t_part,
        t2_part, rows, ck, cp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_rows(a.t_part, a.t, rblocks, cp, st)) != cudaSuccess ||
      (err = sum_rows(t2_part, a.t + cp, rblocks, cp, st)) != cudaSuccess) {
    return err;
  }

  if constexpr (std::is_same_v<T, float>) {
    dense_bwd_dw_kernel<T><<<dim3(static_cast<unsigned>(slabs),
                                  (ck + kBM - 1) / kBM, ntiles),
                             kThreads, 0, st>>>(
        static_cast<const T*>(a.dyc), static_cast<const T*>(a.yp), a.pp,
        a.dw_part, rows, ck, cp);
  } else {
    dense_bwd_dw_mma_kernel<<<static_cast<unsigned>(slabs * tiles), kThreads,
                              0, st>>>(
        static_cast<const T*>(a.dyc), static_cast<const T*>(a.yp), a.pp,
        a.dw_part, rows, ck, cp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_rows(a.dw_part, a.dw, slabs, static_cast<long long>(ck) * cp,
                  st);
}

}  // namespace

// T1, T2 (sums, 2 x c f32) of the top BN: y (items, s, c) of T, g (items,
// c) of T, p the (7, c) f32 pack; part a (2, ceil(items/kTopWarps), c) f32
// scratch (kTopWarps = 8). s = 1 is the unpooled chain. Any base address:
// rows that do not start on 16-byte boundaries load element by element.
extern "C" int pn2_fused_top_stats(const void* y, const void* g,
                                   const void* p, void* part, void* sums,
                                   long long items, int s, int c,
                                   int itemsize, void* stream) {
  if (items <= 0 || c <= 0) return cudaSuccess;
  if (s <= 0 || (items + kTopWarps - 1) / kTopWarps > 0x7fffffffLL ||
      (c + 127) / 128 > 65535) {  // channel tiles of 128 (f32) or 256
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  float* partf = static_cast<float*>(part);
  float* sumsf = static_cast<float*>(sums);
  if (itemsize == 4) {
    return launch_top_stats<float>(y, g, pf, partf, sumsf, items, s, c, st);
  }
  if (itemsize == 2) {
    return launch_top_stats<__nv_bfloat16>(y, g, pf, partf, sumsf, items, s,
                                           c, st);
  }
  return cudaErrorInvalidValue;
}

// Dense k's backward. yk (items, s, ck) and g (items, ck) of T (s = 1
// below the top layer), yp (items*s, cp) of T, pk and pp the (7, ck) and
// (7, cp) f32 packs of BN_k and BN_{k-1}, w (ck, cp) f32. Scratches: w16
// (ck, cp) bf16 (bf16 only; null for f32), dyc (rows, ck) T, db_part
// (ceil(items/64), ck), t_part (2, ceil(rows/64), cp), dw_part
// (ceil(rows/1024), ck, cp), all f32 but w16 and dyc. Outputs: gp (rows,
// cp) T, dw (ck, cp), db (ck), t (2, cp) f32.
extern "C" int pn2_fused_dense_bwd(const void* yk, const void* yp,
                                   const void* g, const void* pk,
                                   const void* pp, const void* w, void* w16,
                                   void* dyc, void* db_part, void* gp,
                                   void* t_part, void* dw_part, void* dw,
                                   void* db, void* t, long long items, int s,
                                   int ck, int cp, int itemsize,
                                   void* stream) {
  if (items <= 0 || ck <= 0 || cp <= 0) return cudaSuccess;
  const long long rows = items * s;
  const long long tiles = static_cast<long long>((ck + kBM - 1) / kBM) *
                          ((cp + kBN - 1) / kBN);
  if (s <= 0 || (ck + kBM - 1) / kBM > 65535 ||
      (cp + kBN - 1) / kBN > 65535 ||
      (rows + kBM - 1) / kBM * tiles > 0x7fffffffLL ||
      (itemsize == 2 && w16 == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const DenseBwd a{yk, yp, g,
                   static_cast<const float*>(pk),
                   static_cast<const float*>(pp),
                   static_cast<const float*>(w), w16, dyc,
                   static_cast<float*>(db_part), gp,
                   static_cast<float*>(t_part), static_cast<float*>(dw_part),
                   static_cast<float*>(dw), static_cast<float*>(db),
                   static_cast<float*>(t)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) return launch_dense_bwd<float>(a, items, s, ck, cp, st);
  if (itemsize == 2) {
    return launch_dense_bwd<__nv_bfloat16>(a, items, s, ck, cp, st);
  }
  return cudaErrorInvalidValue;
}

// dx (rows, c) = T(gr*((dout - m1) - yhat*m2)) of BN_0, x and g (rows, c)
// of T, p the (7, c) f32 pack. Any base address: rows that do not start on
// 16-byte boundaries move element by element.
extern "C" int pn2_fused_first_bwd(const void* x, const void* g,
                                   const void* p, void* dx, long long rows,
                                   int c, int itemsize, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  if (itemsize == 4) {
    return launch_first_bwd<float>(x, g, static_cast<const float*>(p), dx,
                                   rows, c, static_cast<cudaStream_t>(stream));
  }
  if (itemsize == 2) {
    return launch_first_bwd<__nv_bfloat16>(x, g,
                                           static_cast<const float*>(p), dx,
                                           rows, c,
                                           static_cast<cudaStream_t>(stream));
  }
  return cudaErrorInvalidValue;
}
