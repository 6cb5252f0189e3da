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
// tiles or fewer registers measured no faster (rows 2 and 3).
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
// there).
//
// ball_query_multi_kernel (row 4) walks the same staged tiles for up to
// kMaxRadii radii at once, one instance a radius count: each lane's
// squared distances once a point for every radius, then, per 32-point
// chunk, one ballot for each radius that is not full yet, with its own
// warp-uniform found/first in registers; the block leaves the tile loop
// once every radius of every query holds its nsample hits. Radii need not
// be sorted or nested. A first ballot a chunk against the largest r2 still
// open, to skip the per-radius ones of a chunk without a hit, measured
// 1.18x slower at cls_msg's radius sets: each chunk goes straight to its
// per-radius ballots.

#include "common.cuh"

#include <cmath>

namespace {

constexpr int kMaxRadii = 8;  // radii of one row-4 launch

constexpr int kQueryWarps = 8;  // queries a block of rows 2-4
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
  float r2[kMaxRadii];
  int nsample[kMaxRadii];
  int* idx[kMaxRadii];
  int* cnt[kMaxRadii];
};

// Row 4: ball_query_kernel's grid, staging and walk for kCount radii.
// found[i] and first[i] are warp-uniform (built from ballots only), and so
// is `open`: some radius of this warp's query lacks its nsample hits. Up
// to 128 registers a thread (two blocks an SM at least): under the 64 the
// compiler chose by itself the eight-radius instance spilled its pairs,
// and caps of 64, 80 or 48 measured slower at the MSG layers' shapes. One
// instance a radius count: the eight-radius instance serving every count
// (unused radii closed by nsample 0), under the same bounds and without
// spills, measured 1.85x slower at cls_msg's radius sets and 2.09x at
// part_seg_msg's.
template <int kCount>
__global__ void __launch_bounds__(kQueryWarps * 32, 2)
    ball_query_multi_kernel(const float* __restrict__ xyz1,
                            const float* __restrict__ xyz2,
                            const MultiParams p, int n, int m, int qtiles,
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
  const unsigned below = (1u << lane) - 1u;  // lanes ahead of this one

  int found[kCount];
  int first[kCount];
#pragma unroll
  for (int i = 0; i < kCount; ++i) {
    found[i] = 0;
    first[i] = 0;
  }
  bool open = true;
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
    if (live) {
      for (int base = 0; base < np && open; base += 32 * kLanePts) {
        float d2[kLanePts];
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) {
          const int k = base + 32 * j + lane;
          d2[j] = sq_dist(qx, qy, qz, pts[3 * k], pts[3 * k + 1],
                          pts[3 * k + 2]);
        }
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) {
          const int k = t0 + base + 32 * j + lane;
#pragma unroll
          for (int i = 0; i < kCount; ++i) {
            const int ns = p.nsample[i];
            if (found[i] >= ns) continue;
            const bool hit = d2[j] < p.r2[i];  // a padded point: +inf
            const unsigned mask = __ballot_sync(0xffffffffu, hit);
            if (mask != 0u) {
              if (found[i] == 0) first[i] = k - lane + __ffs(mask) - 1;
              const int slot = found[i] + __popc(mask & below);
              if (hit && slot < ns) p.idx[i][q * ns + slot] = k;
              found[i] += __popc(mask);
            }
          }
        }
        open = false;
#pragma unroll
        for (int i = 0; i < kCount; ++i) {
          open = open || found[i] < p.nsample[i];
        }
      }
    }
    // every warp is done with tile t (its buffer is refilled next) and the
    // walk goes on only while some query lacks some radius's nsample hits
    if (!__syncthreads_or(live && open)) break;
  }
  // a walk that ended early leaves the next tile's copy in flight
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kCount; ++i) {
    const int ns = p.nsample[i];
    const int c = min(found[i], ns);
    int* out = p.idx[i] + q * ns;
    for (int s = c + lane; s < ns; s += 32) out[s] = first[i];
    if (lane == 0) p.cnt[i][q] = c;
  }
}

// the grid of rows 2-4, a block a (cloud, tile of kQueryWarps queries):
// false for arguments the kernels do not take
bool query_grid(int b, int n, int m, long long* qtiles, long long* blocks) {
  *qtiles = (m + kQueryWarps - 1) / kQueryWarps;
  *blocks = static_cast<long long>(b) * *qtiles;
  return n > 0 && *blocks <= 0x7fffffffLL;
}

// 16-byte staging copies when every cloud and tile starts on a 16-byte
// boundary
int wide_staging(const void* xyz1, int n) {
  return reinterpret_cast<uintptr_t>(xyz1) % 16 == 0 && n % 4 == 0;
}

// Rows 2 and 3's launch.
template <bool kWithXyz>
int launch_ball_query(const void* xyz1, const void* xyz2, void* idx,
                      void* cnt, void* grouped, int b, int n, int m,
                      int nsample, float r2, void* stream) {
  if (nsample <= 0 || b <= 0 || m <= 0) return cudaSuccess;
  long long qtiles, blocks;
  if (!query_grid(b, n, m, &qtiles, &blocks)) return cudaErrorInvalidValue;
  ball_query_kernel<kWithXyz><<<static_cast<unsigned>(blocks),
                                kQueryWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<int*>(idx), static_cast<int*>(cnt),
      static_cast<float*>(grouped), n, m, nsample, r2,
      static_cast<int>(qtiles), wide_staging(xyz1, n));
  return cudaGetLastError();
}

// Row 4's launch of its kCount instance.
template <int kCount>
void launch_multi(const void* xyz1, const void* xyz2, const MultiParams& p,
                  int n, int m, long long qtiles, long long blocks,
                  cudaStream_t stream) {
  ball_query_multi_kernel<kCount>
      <<<static_cast<unsigned>(blocks), kQueryWarps * 32, 0, stream>>>(
          static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
          p, n, m, static_cast<int>(qtiles), wide_staging(xyz1, n));
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
  for (int i = 0; i < count; ++i) {
    if (nsamples[i] <= 0) return cudaErrorInvalidValue;
    p.r2[i] = r2s[i];
    p.nsample[i] = nsamples[i];
    p.idx[i] = static_cast<int*>(idxs[i]);
    p.cnt[i] = static_cast<int*>(cnts[i]);
  }
  if (b <= 0 || m <= 0) return cudaSuccess;
  long long qtiles, blocks;
  if (!query_grid(b, n, m, &qtiles, &blocks)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (count) {
    case 1: launch_multi<1>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 2: launch_multi<2>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 3: launch_multi<3>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 4: launch_multi<4>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 5: launch_multi<5>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 6: launch_multi<6>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    case 7: launch_multi<7>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
    default: launch_multi<8>(xyz1, xyz2, p, n, m, qtiles, blocks, s); break;
  }
  return cudaGetLastError();
}
