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
// Bound on this card: operations. sq_dist costs 3 sub, 3 mul and 2 add a
// pair, and it may not be contracted into FMAs (that would change the bits);
// the bytes (each cloud's points read once, 24 bytes of output per unknown
// point) take under a tenth of even the bound below at the sem_seg FP4
// shape. So the walk computes sq_dist only for the few known points that
// can enter, and decides every other pair by a bit that takes 3 FMAs and a
// compare: the least work is then those 4 instructions a pair, plus
// sq_dist and the insertion for each point the ascending scan takes in.
// The pipe issues one instruction a lane a cycle, so any other instruction
// in the loop costs as much as one of those:
// - each known point sits in shared memory as one float4 (x, y, z, w): one
//   broadcast load a point, not three;
// - where the launch fills the card (kWide unknown points: sem_seg's FP4
//   has 131072 at B=16), a thread owns kQWide = 2 of them, so each known
//   point it loads serves two pairs; below that one a thread;
// - an unknown point's scan inserts about 21 of FP4's 1024 known points
//   (`chip_smoke.py` phase 12 counts them), but some lane of a warp's 32
//   inserts at far more of them, and the warp waits for it. So a thread
//   tests kBatch = 32 known points first, one bit a point that may beat its
//   third best at the batch's start, and then inserts those alone, in
//   ascending order, each lane its own, with sq_dist's own distance: a
//   point without its bit would not have entered the one-by-one scan
//   either (the third best only falls), so the result is that scan's;
// - the bit: with P = |p|^2 and Q = |q|^2, |q - p|^2 - Q = P - 2 q.p, so
//   f = fma(ax, px, fma(ay, py, fma(az, pz, w))) with a = -2q (exact) and
//   w = P(1 - 2^-18) (staged with the point), against the query's
//   t = fma(d2, 1 + 2^-18, 2^-100 - Q(1 - 2^-18)), once a batch; the bit
//   is set unless f > t. Only the bit is approximate: every distance that
//   enters is sq_dist's. Why no point that enters loses its bit (u =
//   2^-24, T the exact squared distance, e sq_dist's): e < d2 gives T <
//   d2 (1 + 5.001u) (two roundings of each difference, three of the sum);
//   f's three roundings and w's four are each within u of values no
//   larger than P + 2|q||p| <= 2(P + Q), so f <= T - Q + 6.001u Q +
//   (10u - 2^-18 (1 - 4u)) P, whose last term is negative; t's own
//   roundings take at most 7u (d2 + Q), so t > d2 (1 + 5.001u) -
//   Q (1 - 6.001u) + 2^-101 > f, the 2^-100 covering the absolute errors
//   of subnormal terms. Where Q or P could overflow an intermediate (2^120
//   or more), or is NaN, t is +inf or w is NaN, and the bit is set; a NaN
//   f sets it too, and sq_dist's NaN or +inf then never enters. Far from
//   the origin the margin 2^-18 (P + Q) lets more points take the bit:
//   each costs one exact test, never a wrong result;
// - a tile is padded with +inf points to a whole number of kUnroll steps:
//   an +inf point's distance is +inf or NaN, which never enters;
// - up to kDirect known points (sem_seg's FP1-FP2, part_seg's FP1), most
//   points enter, the batch's bits only add their fixed costs to a launch
//   that is all latency, and each point goes straight to sq_dist and the
//   insertion.
// Each unknown point scans j ascending with a strict < insertion, which
// keeps the lowest index among equal distances, in both walks.
// The TPU kernel builds a (TN, M) distance tile and reduces it three times;
// that tile would not fit a block's shared memory here, and the insertion
// needs one pass.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;   // threads a block
constexpr int kQWide = 2;     // unknown points a thread, at kWide and above
constexpr int kWide = 65536;  // unknown points that fill the card two a thread
constexpr int kBatch = 32;    // known points tested before inserting
constexpr int kUnroll = 4;    // the tail's step, and a tile's padding unit
constexpr int kTile = 1024;   // known points a shared-memory tile (16 KB)
constexpr int kDirect = 64;   // known points up to which none takes a bit
constexpr float kMargin = 0x1p-18f;  // the bit's relative margin
constexpr float kHuge = 0x1p120f;    // |p|^2, |q|^2 past it: always a bit
static_assert(kTile % kBatch == 0 && kBatch % kUnroll == 0 &&
                  kDirect <= kTile,
              "a padded tile never passes kTile");

// (d, i) into the ascending triple (dd, ii): strict < on d, which in an
// ascending scan keeps the lowest index among equal distances
__device__ __forceinline__ void insert(float d, int i, float (&dd)[3],
                                       int (&ii)[3]) {
  if (!(d < dd[2])) return;
  const bool l1 = d < dd[1], l0 = d < dd[0];
  dd[2] = l1 ? dd[1] : d;
  ii[2] = l1 ? ii[1] : i;
  dd[1] = l0 ? dd[0] : (l1 ? d : dd[1]);
  ii[1] = l0 ? ii[0] : (l1 ? i : ii[1]);
  dd[0] = l0 ? d : dd[0];
  ii[0] = l0 ? i : ii[0];
}

// kN known points s_pts[j0], ... (indices jbase + j0, ...) against the
// thread's Q unknown points: a bit for each point whose distance may beat
// the query's third best at the batch's start (f against t, see the note
// at the top), then the exact insertion of those points alone, in
// ascending order.
template <int Q, int kN>
__device__ __forceinline__ void scan(const float4* s_pts, int j0, int jbase,
                                     const float (&qx)[Q],
                                     const float (&qy)[Q],
                                     const float (&qz)[Q],
                                     const float (&nq)[Q],
                                     float (&dd)[Q][3], int (&ii)[Q][3]) {
  static_assert(kN <= 32, "one bit a point");
  unsigned hit[Q];
  float t[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    hit[k] = 0u;
    t[k] = fmaf(dd[k][2], 1.0f + kMargin, nq[k]);
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const float4 pt = s_pts[j0 + u];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const float f = fmaf(-2.0f * qx[k], pt.x,
                           fmaf(-2.0f * qy[k], pt.y,
                                fmaf(-2.0f * qz[k], pt.z, pt.w)));
      if (!(f > t[k])) hit[k] |= 1u << u;
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    while (hit[k] != 0u) {
      const int u = __ffs(hit[k]) - 1;
      hit[k] &= hit[k] - 1u;
      const float4 pt = s_pts[j0 + u];
      insert(sq_dist(qx[k], qy[k], qz[k], pt.x, pt.y, pt.z), jbase + j0 + u,
             dd[k], ii[k]);
    }
  }
}

// op by op, x*x + y*y + z*z: |p|^2 within 3.001u
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Q unknown points a thread: point k of lane l of a warp is the warp's
// point k * 32 + l.
template <int Q>
__global__ void __launch_bounds__(kBlock)
    three_nn_kernel(const float* __restrict__ xyz1,
                    const float* __restrict__ xyz2, float* __restrict__ dist,
                    int* __restrict__ idx, int n, int m) {
  __shared__ float4 s_pts[kTile];
  const long long cloud = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * (kBlock / 32) + warp) * 32 * Q + lane;
  const float* known = xyz2 + cloud * m * 3;

  float qx[Q], qy[Q], qz[Q], nq[Q];  // nq: 2^-100 - |q|^2 (1 - 2^-18)
  float dd[Q][3];
  int ii[Q][3];
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = first + k * 32;
    const long long q = cloud * n + i;
    qx[k] = i < n ? xyz1[q * 3] : 0.0f;
    qy[k] = i < n ? xyz1[q * 3 + 1] : 0.0f;
    qz[k] = i < n ? xyz1[q * 3 + 2] : 0.0f;
    const float q2 = norm2(qx[k], qy[k], qz[k]);
    nq[k] = q2 < kHuge ? __fadd_rn(0x1p-100f, -__fmul_rn(q2, 1.0f - kMargin))
                       : inf;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      dd[k][t] = inf;
      ii[k][t] = 0;
    }
  }

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    const int padded = (count + kUnroll - 1) / kUnroll * kUnroll;
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < padded; k += kBlock) {
      float4 v = make_float4(inf, inf, inf, __int_as_float(0x7fffffff));
      if (k < count) {
        const float* pt = known + 3LL * (base + k);
        const float p2 = norm2(pt[0], pt[1], pt[2]);
        v = make_float4(pt[0], pt[1], pt[2],
                        p2 < kHuge ? __fmul_rn(p2, 1.0f - kMargin)
                                   : __int_as_float(0x7fffffff));
      }
      s_pts[k] = v;
    }
    __syncthreads();
    if (m <= kDirect) {  // one tile, every point straight to the insertion
      for (int j = 0; j < count; ++j) {
        const float4 pt = s_pts[j];
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          insert(sq_dist(qx[k], qy[k], qz[k], pt.x, pt.y, pt.z), j, dd[k],
                 ii[k]);
        }
      }
      continue;
    }
    int j0 = 0;  // whole batches, then the tile's tail
    for (; j0 + kBatch <= padded; j0 += kBatch) {
      scan<Q, kBatch>(s_pts, j0, base, qx, qy, qz, nq, dd, ii);
    }
    for (; j0 < padded; j0 += kUnroll) {
      scan<Q, kUnroll>(s_pts, j0, base, qx, qy, qz, nq, dd, ii);
    }
  }

#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = first + k * 32;
    if (i >= n) break;
    const long long q = cloud * n + i;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      dist[q * 3 + t] = dd[k][t];
      idx[q * 3 + t] = ii[k][t];
    }
  }
}

constexpr int kMaxGridY = 65535;

template <int Q>
cudaError_t launch(const float* xyz1, const float* xyz2, float* dist,
                   int* idx, int b, int n, int m, cudaStream_t st) {
  const dim3 grid((n + kBlock * Q - 1) / (kBlock * Q), b);
  three_nn_kernel<Q><<<grid, kBlock, 0, st>>>(xyz1, xyz2, dist, idx, n, m);
  return cudaGetLastError();
}

}  // namespace

// q unknown points a thread (1 or kQWide), or 0 for the launch's own
// choice: kQWide from kWide unknown points on, else one. Another q than
// the launch's is for measuring that choice.
extern "C" int pn2_three_nn_q(const void* xyz1, const void* xyz2, void* dist,
                              void* idx, int b, int n, int m, int q,
                              void* stream) {
  if (b <= 0 || n <= 0) return cudaSuccess;
  if (m <= 0) return cudaErrorInvalidValue;
  if (q == 0) q = static_cast<long long>(b) * n >= kWide ? kQWide : 1;
  if (q != 1 && q != kQWide) return cudaErrorInvalidValue;
  const auto* x1 = static_cast<const float*>(xyz1);
  const auto* x2 = static_cast<const float*>(xyz2);
  auto* d = static_cast<float*>(dist);
  auto* i = static_cast<int*>(idx);
  const auto st = static_cast<cudaStream_t>(stream);
  // the clouds sit on gridDim.y: launches of at most 65535 of them, each at
  // its clouds' offsets
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const int nb = b - b0 < kMaxGridY ? b - b0 : kMaxGridY;
    const size_t o1 = static_cast<size_t>(b0) * n * 3;
    const size_t o2 = static_cast<size_t>(b0) * m * 3;
    const cudaError_t e =
        q == 1 ? launch<1>(x1 + o1, x2 + o2, d + o1, i + o1, nb, n, m, st)
               : launch<kQWide>(x1 + o1, x2 + o2, d + o1, i + o1, nb, n, m,
                                st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

extern "C" int pn2_three_nn(const void* xyz1, const void* xyz2, void* dist,
                            void* idx, int b, int n, int m, void* stream) {
  return pn2_three_nn_q(xyz1, xyz2, dist, idx, b, n, m, 0, stream);
}
