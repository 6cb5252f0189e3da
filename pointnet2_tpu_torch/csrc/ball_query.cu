// Fixed-radius ball query: xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries,
// f32 -> idx (B, M, nsample) int32, cnt (B, M) int32; with grouped xyz also
// grouped (B, M, nsample, 3) f32, the coordinates of every slot's point.
//
// Replaces pointnet2_tpu/ops/pallas/ball_query.py:ball_query_pallas (kernel
// body _ball_query_kernel, with_xyz=False), ball_query_group_xyz_pallas
// (with_xyz=True) and ball_query_multi_pallas (_ball_query_multi_kernel).
// Same semantics: the first nsample dataset points in scan order with
// d2 < r2, where r2 is float32(radius)**2 rounded in f32 by the caller; the
// remaining slots hold the first hit, an empty ball gives index 0,
// cnt = min(hits, nsample). grouped[b, m, s] is xyz1[b, idx[b, m, s]], a
// copy (the TPU kernel's masked sum turns a -0.0 coordinate into +0.0).
//
// Bound on this card: the distance work the data needs (each query stops at
// its nsample-th hit) and the latency of the scan, not bytes; at the
// classifiers' sizes a launch is a few microseconds of staging and of each
// warp's chain of ballots. More queries a block, more points a lane, larger
// tiles or fewer registers measured no faster.
// The TPU kernel ranks hits with an MXU cumsum over a whole (queries, N)
// tile. Here one warp owns one query and walks the dataset in scan order:
// __ballot_sync gives a 32-point chunk's hit mask, __popc of the lanes
// below a hit gives its slot, and the walk ends as soon as nsample hits
// are found.
//
// ball_query_kernel (rows 2 and 3, the latter its kWithXyz instance, as
// one pallas_call serves both): a block serves kQueryWarps queries of one
// cloud and stages that cloud into shared memory by cp.async, in tiles of
// kTile points, two buffers, so the next tile is in flight while the warps
// walk this one; between tiles __syncthreads_or ends the walk for the
// whole block once every query holds nsample hits. A cloud at most one
// tile long (the classifiers' 1024 and 512 points) is staged once. Each
// lane takes kLanePts points an iteration and computes all their
// distances before the chunks' ballots run in scan order, so a warp has
// several shared-memory loads and distance chains in flight instead of one
// L1/L2 latency an iteration; a tile's last iteration is padded with +inf
// points, so the walk has no bounds check. With grouped xyz the lane that
// owns a hit reads its coordinates from the staged tile and stores them
// to its slot, 12 bytes, so no second gather; the pad slots take the
// first hit's coordinates (point 0's for an empty ball), which every lane
// reads from the tile when that hit is found: no global load waits at the
// end of the walk (measured faster than reading them from the cloud
// there). Row 4 (ball_query_multi_kernel) keeps the warp that reads its
// points from L1/L2 one chunk at a time.
//
// The multi-radius kernel walks the dataset once for up to kMaxRadii radii:
// one squared distance a point, one ballot per radius that is not full yet,
// and the walk ends when every radius holds its nsample hits. Radii need
// not be sorted or nested: each keeps its own found/first and slots.

#include "common.cuh"

#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 8;  // queries a block of row 4
constexpr int kMaxRadii = 8;

constexpr int kQueryWarps = 8;  // queries a block of ball_query_kernel
constexpr int kTile = 1024;     // points a staged tile
constexpr int kLanePts = 4;     // points a lane an iteration
static_assert(kTile % (32 * kLanePts) == 0,
              "a tile is whole iterations: its padding stays inside");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// copy the np points of one tile (np * 3 floats) into shared memory as one
// cp.async group, 16 bytes a copy when `wide` (src 16-byte aligned, np % 4
// == 0), and fill the rest of the tile's last iteration with +inf
// coordinates, whose squared distance (+inf) is never under r2: the walk
// needs no bounds check
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int np, bool wide) {
  const int nf = np * 3;
  if (wide) {
    for (int i = 4 * threadIdx.x; i < nf; i += 4 * blockDim.x) {
      cp_async16(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < nf; i += blockDim.x) {
      cp_async4(dst + i, src + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  constexpr int kStep = 32 * kLanePts;
  const int end = (np + kStep - 1) / kStep * kStep * 3;
  for (int i = nf + threadIdx.x; i < end; i += blockDim.x) dst[i] = INFINITY;
}

// Rows 2 and 3. blockIdx.x = cloud * qtiles + query tile; warp w of the
// block owns query tile * kQueryWarps + w of the cloud, if there is one (a
// warp without a query still stages and syncs). kWithXyz: also grouped.
template <bool kWithXyz>
__global__ void __launch_bounds__(kQueryWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz1,
                      const float* __restrict__ xyz2, int* __restrict__ idx,
                      int* __restrict__ cnt, float* __restrict__ grouped,
                      int n, int m, int nsample, float r2, int qtiles,
                      int wide) {
  __shared__ __align__(16) float tile[2][kTile * 3];
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x / qtiles;
  const int qi = static_cast<int>(blockIdx.x - b * qtiles) * kQueryWarps +
                 (threadIdx.x >> 5);
  const bool live = qi < m;
  const long long q = b * m + qi;
  const float* data = xyz1 + b * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = xyz2[q * 3];
    qy = xyz2[q * 3 + 1];
    qz = xyz2[q * 3 + 2];
  }
  int* out = idx + q * nsample;
  float* gout = kWithXyz ? grouped + q * nsample * 3 : nullptr;
  const unsigned below = (1u << lane) - 1u;  // lanes ahead of this one

  int found = 0;  // warp-uniform: built from ballots only
  int first = 0;
  float fx = 0.f, fy = 0.f, fz = 0.f;  // kWithXyz: the pad slots' point
  const int tiles = (n + kTile - 1) / kTile;
  stage_tile(tile[0], data, min(n, kTile), wide);
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * kTile;
    if (t + 1 < tiles) {
      stage_tile(tile[(t + 1) & 1], data + (t0 + kTile) * 3LL,
                 min(n - t0 - kTile, kTile), wide);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile t is in place for every warp
    const float* pts = tile[t & 1];
    const int np = min(n - t0, kTile);
    if (kWithXyz && t == 0) {
      fx = pts[0];
      fy = pts[1];
      fz = pts[2];
    }
    if (live) {
      for (int base = 0; base < np && found < nsample;
           base += 32 * kLanePts) {
        float d2[kLanePts];
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) {
          const int k = base + 32 * j + lane;
          d2[j] = sq_dist(qx, qy, qz, pts[3 * k], pts[3 * k + 1],
                          pts[3 * k + 2]);
        }
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) {
          const bool hit = d2[j] < r2;  // a padded point: +inf
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (mask != 0u) {  // most chunks of a small ball have no hit
            const int k = base + 32 * j + lane;
            if (found == 0) first = t0 + base + 32 * j + __ffs(mask) - 1;
            if constexpr (kWithXyz) {
              if (found == 0) {  // the first hit's
                const int kf = first - t0;
                fx = pts[3 * kf];
                fy = pts[3 * kf + 1];
                fz = pts[3 * kf + 2];
              }
            }
            const int slot = found + __popc(mask & below);
            if (hit && slot < nsample) {
              out[slot] = t0 + k;
              if constexpr (kWithXyz) {
                gout[3 * slot] = pts[3 * k];
                gout[3 * slot + 1] = pts[3 * k + 1];
                gout[3 * slot + 2] = pts[3 * k + 2];
              }
            }
            found += __popc(mask);
          }
        }
      }
    }
    // every warp is done with tile t (its buffer is refilled next) and the
    // walk goes on only while some query lacks nsample hits
    if (!__syncthreads_or(live && found < nsample)) break;
  }
  // a walk that ended early leaves the next tile's copy in flight
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!live) return;
  const int c = min(found, nsample);
  for (int s = c + lane; s < nsample; s += 32) out[s] = first;
  if constexpr (kWithXyz) {
    // pad slots: the first hit's coordinates, point 0's for an empty ball
    // (taken from tile 0 before the walk), written as consecutive floats
    for (int i = 3 * c + lane; i < 3 * nsample; i += 32) {
      const int e = i % 3;
      gout[i] = e == 0 ? fx : (e == 1 ? fy : fz);
    }
  }
  if (lane == 0) cnt[q] = c;
}

struct MultiParams {
  int count;
  float r2[kMaxRadii];
  int nsample[kMaxRadii];
  int* idx[kMaxRadii];
  int* cnt[kMaxRadii];
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ball_query_multi_kernel(const float* __restrict__ xyz1,
                            const float* __restrict__ xyz2,
                            const MultiParams p, long long queries, int n,
                            int m) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= queries) return;
  const int lane = threadIdx.x & 31;
  const float* data = xyz1 + (q / m) * n * 3;
  const float qx = xyz2[q * 3];
  const float qy = xyz2[q * 3 + 1];
  const float qz = xyz2[q * 3 + 2];
  const unsigned below = (1u << lane) - 1u;

  int found[kMaxRadii];  // warp-uniform, as in ball_query_kernel
  int first[kMaxRadii];
#pragma unroll
  for (int i = 0; i < kMaxRadii; ++i) {
    found[i] = 0;
    first[i] = 0;
  }
  bool open = true;  // some radius still lacks nsample hits
  for (int base = 0; base < n && open; base += 32) {
    const int k = base + lane;
    float d2 = 0.f;
    if (k < n) {
      d2 = sq_dist(qx, qy, qz, data[3 * k], data[3 * k + 1], data[3 * k + 2]);
    }
    open = false;
#pragma unroll
    for (int i = 0; i < kMaxRadii; ++i) {
      if (i >= p.count || found[i] >= p.nsample[i]) continue;
      const bool hit = k < n && d2 < p.r2[i];
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0u) {
        if (found[i] == 0) first[i] = base + __ffs(mask) - 1;
        const int slot = found[i] + __popc(mask & below);
        if (hit && slot < p.nsample[i]) p.idx[i][q * p.nsample[i] + slot] = k;
        found[i] += __popc(mask);
      }
      open = open || found[i] < p.nsample[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRadii; ++i) {
    if (i >= p.count) continue;
    const int ns = p.nsample[i];
    const int c = min(found[i], ns);
    int* out = p.idx[i] + q * ns;
    for (int s = c + lane; s < ns; s += 32) out[s] = first[i];
    if (lane == 0) p.cnt[i][q] = c;
  }
}

// the grid of one launch over b*m queries, kWarpsPerBlock a block, or 0
// blocks when there is nothing to do; *err is set for arguments the kernels
// do not take
long long query_blocks(int b, int n, int m, int* err) {
  const long long queries = static_cast<long long>(b) * m;
  *err = cudaSuccess;
  if (queries <= 0) return 0;
  const long long blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n <= 0 || blocks > 0x7fffffffLL) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  return blocks;
}

// Rows 2 and 3's launch: a block a (cloud, tile of kQueryWarps queries),
// 16-byte copies when every cloud and tile starts on a 16-byte boundary.
template <bool kWithXyz>
int launch_ball_query(const void* xyz1, const void* xyz2, void* idx,
                      void* cnt, void* grouped, int b, int n, int m,
                      int nsample, float r2, void* stream) {
  if (nsample <= 0 || b <= 0 || m <= 0) return cudaSuccess;
  const long long qtiles = (m + kQueryWarps - 1) / kQueryWarps;
  const long long blocks = static_cast<long long>(b) * qtiles;
  if (n <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int wide = reinterpret_cast<uintptr_t>(xyz1) % 16 == 0 && n % 4 == 0;
  ball_query_kernel<kWithXyz><<<static_cast<unsigned>(blocks),
                                kQueryWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<int*>(idx), static_cast<int*>(cnt),
      static_cast<float*>(grouped), n, m, nsample, r2,
      static_cast<int>(qtiles), wide);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pn2_ball_query(const void* xyz1, const void* xyz2, void* idx,
                              void* cnt, int b, int n, int m, int nsample,
                              float r2, void* stream) {
  return launch_ball_query<false>(xyz1, xyz2, idx, cnt, nullptr, b, n, m,
                                  nsample, r2, stream);
}

extern "C" int pn2_ball_query_group_xyz(const void* xyz1, const void* xyz2,
                                        void* idx, void* cnt, void* grouped,
                                        int b, int n, int m, int nsample,
                                        float r2, void* stream) {
  return launch_ball_query<true>(xyz1, xyz2, idx, cnt, grouped, b, n, m,
                                 nsample, r2, stream);
}

// radii given as r2s[count] (each f32-rounded by the caller), nsamples
// [count], and per radius the output pointers idxs[i] (B, M, nsamples[i])
// and cnts[i] (B, M); count in [1, kMaxRadii].
extern "C" int pn2_ball_query_multi(const void* xyz1, const void* xyz2,
                                    const float* r2s, const int* nsamples,
                                    void* const* idxs, void* const* cnts,
                                    int count, int b, int n, int m,
                                    void* stream) {
  if (count < 1 || count > kMaxRadii) return cudaErrorInvalidValue;
  MultiParams p{};
  p.count = count;
  for (int i = 0; i < count; ++i) {
    if (nsamples[i] <= 0) return cudaErrorInvalidValue;
    p.r2[i] = r2s[i];
    p.nsample[i] = nsamples[i];
    p.idx[i] = static_cast<int*>(idxs[i]);
    p.cnt[i] = static_cast<int*>(cnts[i]);
  }
  int err;
  const long long blocks = query_blocks(b, n, m, &err);
  if (err != cudaSuccess || blocks == 0) return err;
  ball_query_multi_kernel<<<static_cast<unsigned>(blocks),
                            kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2), p,
      static_cast<long long>(b) * m, n, m);
  return cudaGetLastError();
}
