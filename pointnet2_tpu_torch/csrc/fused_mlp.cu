// Fused set-abstraction chain, forward (eval): the BN-affine -> ReLU ->
// dense pass with its bias and, optionally, the BN column statistics of its
// output; the affine -> ReLU -> max-pool tail; the affine -> ReLU tail.
//
// Replaces pointnet2_tpu/ops/pallas/fused_mlp.py:
//   fused_dense  <- _dense_fwd (:141, kernel body _dense_fwd_kernel :116)
//   fused_pool   <- _pool_fwd (:189, _pool_fwd_kernel :181)
//   fused_affine <- _affine_fwd (:215, _affine_fwd_kernel :208)
// The TPU kernels take exact power-of-two row tiles into VMEM, contract on
// the MXU, and carry the statistics from one grid step to the next in one
// VMEM block. Here blocks run in parallel in no order: each row block
// writes its own partial sums and a second kernel adds them up.
//
// Semantics held here (those of the Pallas kernels and of the plain
// versions in ops/fused_mlp.py); T is float or bf16, the activation type:
// - z = T(relu(x*a + b)), with the product and the sum rounded apart
//   (__fmul_rn, __fadd_rn: nvcc would contract them into an FMA, the
//   plain version's eager mul and add round twice);
// - W is nn.Linear's (Cout, Cin) f32 weight, rounded to T as it is loaded;
// - acc = sum_k z*W in f32 (a bf16 product is exact in f32), y = T(acc +
//   bias): the plain version's z.float() @ w.float() up to summation order;
// - with statistics, the column sum and sum of squares of float(y), the
//   rounded y, in f32: each 64-row block writes its partial sums, in a
//   fixed order, into row blockIdx.x of a (row blocks, Cout) scratch; a
//   second kernel adds the rows in ascending block order. No atomics: two
//   launches give the same bits;
// - pool: max over S of T(relu(y*a + b)); affine: T(relu(y*a + b)), with
//   the same two roundings, so both are bit for bit their plain versions.
// - Any row count and any Cin, Cout >= 1: every ragged edge is masked (the
//   TPU kernels needed exact tiles, fused_chain_eligible). Offsets are
//   64-bit: cls_msg SA1's third scale at B=64 has 4.2 M rows.
//
// Bound on this card. fused_pool and fused_affine are bound by bytes: each
// element of y is read once and each output written once, neighbouring
// threads on neighbouring channels. fused_dense moves few bytes for its
// work (bf16 cls_ssg SA1 64 -> 128 at B=16: 101 MB, 30 us at 3.35 TB/s)
// and its bound is bytes against the tensor cores' rate; this simple
// design does its products as f32 FMAs on the CUDA cores (64 us of FMAs
// for that layer at 67e12 op/s) from shared memory: 64x64 output tiles,
// 128 threads, each with a 4x8 accumulator in registers, Cin in chunks of
// 32 staged through shared memory with the affine, the ReLU and the
// rounding applied as x is loaded. Each thread reads 12 shared values for
// 32 FMAs, so shared memory, not the FMA pipe, sets its pace. A tensor-core
// (mma.sync / wgmma, TMA) redesign with the pool fused into the last dense
// is a later change.

#include "common.cuh"

#include <cuda_bf16.h>

#include <cmath>

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

// relu(v*a + b), two roundings; v < 0 ? 0 : v keeps -0.0 and NaN as
// torch.relu does
__device__ __forceinline__ float affine_relu(float v, float a, float b) {
  const float o = __fadd_rn(__fmul_rn(v, a), b);
  return o < 0.0f ? 0.0f : o;
}

template <typename T, bool kStats>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y,
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
        z = round_to<T>(affine_relu(to_f32(x[row * cin + kk]), a[kk], b[kk]));
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
        v = round_to<T>(w[static_cast<long long>(col) * cin + kk]);
      }
      ws[n][k] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float zr[4], wr[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) zr[i] = zs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) wr[j] = ws[tx + 8 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
      }
    }
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
      const T out = from_f32<T>(__fadd_rn(acc[i][j], bias_r[j]));
      y[row * cout + col] = out;
      if (kStats) {
        const float f = to_f32(out);  // statistics of the rounded y
        cs[j] = __fadd_rn(cs[j], f);
        css[j] = __fadd_rn(css[j], __fmul_rn(f, f));
      }
    }
  }

  if (kStats) {
    // the staging tiles are free after the loop's last barrier: per column,
    // the 16 row groups' sums, added in ascending row group
    float* rs = &zs[0][0];   // 16 x kBN
    float* rss = &ws[0][0];  // 16 x kBN
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
      const long long at = static_cast<long long>(blockIdx.x) * cout + col0 +
                           tid;
      part_s[at] = s;
      part_ss[at] = ss;
    }
  }
}

// sum[c] = sum over row blocks, ascending, of part[blk, c]
__global__ void column_sums_kernel(const float* __restrict__ part_s,
                                   const float* __restrict__ part_ss,
                                   float* __restrict__ sum,
                                   float* __restrict__ sumsq, long long blocks,
                                   int cout) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cout) return;
  float s = 0.0f, ss = 0.0f;
  for (long long blk = 0; blk < blocks; ++blk) {
    s = __fadd_rn(s, part_s[blk * cout + col]);
    ss = __fadd_rn(ss, part_ss[blk * cout + col]);
  }
  sum[col] = s;
  sumsq[col] = ss;
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

template <typename T>
__global__ void fused_affine_kernel(const T* __restrict__ y,
                                    const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    T* __restrict__ out, long long total,
                                    int c) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int ch = static_cast<int>(t % c);
    out[t] = from_f32<T>(affine_relu(to_f32(y[t]), a[ch], b[ch]));
  }
}

unsigned grid_for(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return static_cast<unsigned>(want < 132LL * 32 ? want : 132LL * 32);
}

template <typename T>
cudaError_t launch_dense(const void* x, const float* a, const float* b,
                         const float* w, const float* bias, void* y,
                         float* part_s, float* part_ss, long long rows,
                         int cin, int cout, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  (cout + kBN - 1) / kBN);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (part_s != nullptr) {
    fused_dense_kernel<T, true><<<grid, kThreads, 0, st>>>(
        xt, a, b, w, bias, yt, part_s, part_ss, rows, cin, cout);
  } else {
    fused_dense_kernel<T, false><<<grid, kThreads, 0, st>>>(
        xt, a, b, w, bias, yt, nullptr, nullptr, rows, cin, cout);
  }
  return cudaGetLastError();
}

}  // namespace

// y (rows, cout) = T(T(relu(x*a + b)) @ T(w)^T + bias) for x (rows, cin)
// of T, a, b (cin) f32, w (cout, cin) f32, bias (cout) f32. With part_s
// non-null, also sum and sumsq (cout) f32 of float(y), through the
// (ceil(rows/64), cout) f32 scratches part_s and part_ss.
extern "C" int pn2_fused_dense(const void* x, const void* a, const void* b,
                               const void* w, const void* bias, void* y,
                               void* part_s, void* part_ss, void* sum,
                               void* sumsq, long long rows, int cin, int cout,
                               int itemsize, void* stream) {
  if (rows <= 0 || cout <= 0) return cudaSuccess;  // empty output
  if (cin <= 0 || (rows + kBM - 1) / kBM > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* wf = static_cast<const float*>(w);
  const float* biasf = static_cast<const float*>(bias);
  float* ps = static_cast<float*>(part_s);
  float* pss = static_cast<float*>(part_ss);
  cudaError_t err;
  if (itemsize == 4) {
    err = launch_dense<float>(x, af, bf, wf, biasf, y, ps, pss, rows, cin,
                              cout, st);
  } else if (itemsize == 2) {
    err = launch_dense<__nv_bfloat16>(x, af, bf, wf, biasf, y, ps, pss, rows,
                                      cin, cout, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ps == nullptr) return err;
  column_sums_kernel<<<(cout + 127) / 128, 128, 0, st>>>(
      ps, pss, static_cast<float*>(sum), static_cast<float*>(sumsq),
      (rows + kBM - 1) / kBM, cout);
  return cudaGetLastError();
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
  const long long total = rows * c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (itemsize == 4) {
    fused_affine_kernel<float><<<grid_for(total, 256), 256, 0, st>>>(
        static_cast<const float*>(y), af, bf, static_cast<float*>(out), total,
        c);
  } else if (itemsize == 2) {
    fused_affine_kernel<__nv_bfloat16><<<grid_for(total, 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), af, bf,
        static_cast<__nv_bfloat16*>(out), total, c);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
