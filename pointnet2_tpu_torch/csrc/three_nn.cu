// Three nearest neighbours: xyz1 (B, N, 3) unknown points, xyz2 (B, M, 3)
// known points, f32 -> dist (B, N, 3) f32 squared distances ascending, idx
// (B, N, 3) int32 indices into M.
//
// Replaces pointnet2_tpu/ops/pallas/three_nn.py:three_nn_pallas (kernel body
// _three_nn_kernel). Same semantics, bit for bit: squared distances rounded
// op by op in the JAX package's order (sq_dist, common.cuh); the three
// smallest in lexicographic (dist, index) order, so a tie goes to the lowest
// index, as the Pallas kernel's three knock-out argmin passes give; a slot
// that no known point reaches (M < 3) keeps dist=+inf, idx=0. Any M: the
// Pallas kernel holds all M in one VMEM tile (the JAX package sends M > 65536
// to XLA); here the known points stream through shared memory in tiles.
//
// Bound on this card: operations. Each (unknown, known) pair costs 3 sub, 3
// mul, 2 add and at least one compare; the bytes (each cloud's points read
// once, 24 bytes of output per unknown point) are a tenth of that time at the
// sem_seg FP4 shape. One thread owns one unknown point and keeps its three
// best (dist, index) pairs in registers. The block stages the cloud's known
// points through shared memory kTile at a time, and every thread of the block
// reads the same known point at once (a broadcast, no bank conflict).
// Scanning j ascending with a strict < insertion keeps the lowest index among
// equal distances. The TPU kernel builds a (TN, M) distance tile and reduces
// it three times; that tile would not fit a block's shared memory here, and
// the insertion needs one pass.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;  // unknown points per block
constexpr int kTile = 1024;  // known points per shared-memory tile (12 KB)

__global__ void __launch_bounds__(kBlock)
    three_nn_kernel(const float* __restrict__ xyz1,
                    const float* __restrict__ xyz2, float* __restrict__ dist,
                    int* __restrict__ idx, int n, int m) {
  __shared__ float s_xyz[kTile * 3];
  const long long cloud = blockIdx.y;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool real = i < n;
  const float* known = xyz2 + cloud * m * 3;
  const long long q = cloud * n + i;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (real) {
    qx = xyz1[q * 3];
    qy = xyz1[q * 3 + 1];
    qz = xyz1[q * 3 + 2];
  }
  const float inf = __int_as_float(0x7f800000);
  float d0 = inf, d1 = inf, d2 = inf;
  int i0 = 0, i1 = 0, i2 = 0;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < 3 * count; k += kBlock) {
      s_xyz[k] = known[3LL * base + k];
    }
    __syncthreads();
    if (!real) continue;
    for (int j = 0; j < count; ++j) {
      const float d = sq_dist(qx, qy, qz, s_xyz[3 * j], s_xyz[3 * j + 1],
                              s_xyz[3 * j + 2]);
      if (d < d2) {
        const int jj = base + j;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = jj;
          } else {
            d1 = d;
            i1 = jj;
          }
        } else {
          d2 = d;
          i2 = jj;
        }
      }
    }
  }
  if (real) {
    dist[q * 3] = d0;
    dist[q * 3 + 1] = d1;
    dist[q * 3 + 2] = d2;
    idx[q * 3] = i0;
    idx[q * 3 + 1] = i1;
    idx[q * 3 + 2] = i2;
  }
}

}  // namespace

extern "C" int pn2_three_nn(const void* xyz1, const void* xyz2, void* dist,
                            void* idx, int b, int n, int m, void* stream) {
  if (b <= 0 || n <= 0) return cudaSuccess;
  if (m <= 0 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + kBlock - 1) / kBlock, b);
  three_nn_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<float*>(dist), static_cast<int*>(idx), n, m);
  return cudaGetLastError();
}
