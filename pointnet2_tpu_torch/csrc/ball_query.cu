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
// its nsample-th hit) and the latency of the scan, not bytes: a cloud's
// points are read from L1/L2 by every query of that cloud. The TPU kernel
// ranks hits with an MXU cumsum over a whole (queries, N) tile; here one
// warp owns one query and walks the dataset 32 points at a time, in order:
// __ballot_sync gives the chunk's hit mask, __popc of the lanes below a hit
// gives its slot, and the walk ends as soon as nsample hits are found. The
// lane that owns a hit already holds its coordinates, so grouped xyz costs
// one store of 12 bytes a slot and no second gather.
//
// The multi-radius kernel walks the dataset once for up to kMaxRadii radii:
// one squared distance a point, one ballot per radius that is not full yet,
// and the walk ends when every radius holds its nsample hits. Radii need
// not be sorted or nested: each keeps its own found/first and slots.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxRadii = 8;

// One warp per query; the two kernels below are its two instances, named
// apart so that a profiler's trace tells them apart.
template <bool kWithXyz>
__device__ __forceinline__ void ball_query_warp(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    int* __restrict__ idx, int* __restrict__ cnt, float* __restrict__ grouped,
    long long queries, int n, int m, int nsample, float r2) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= queries) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* data = xyz1 + (q / m) * n * 3;
  const float qx = xyz2[q * 3];
  const float qy = xyz2[q * 3 + 1];
  const float qz = xyz2[q * 3 + 2];
  int* out = idx + q * nsample;
  float* gout = kWithXyz ? grouped + q * nsample * 3 : nullptr;
  const unsigned below = (1u << lane) - 1u;  // lanes ahead of this one

  int found = 0;  // warp-uniform: built from ballots only
  int first = 0;
  for (int base = 0; base < n && found < nsample; base += 32) {
    const int k = base + lane;
    bool hit = false;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (k < n) {
      px = data[3 * k];
      py = data[3 * k + 1];
      pz = data[3 * k + 2];
      hit = sq_dist(qx, qy, qz, px, py, pz) < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask != 0u) {
      if (found == 0) first = base + __ffs(mask) - 1;
      const int slot = found + __popc(mask & below);
      if (hit && slot < nsample) {
        out[slot] = k;
        if (kWithXyz) {
          gout[3 * slot] = px;
          gout[3 * slot + 1] = py;
          gout[3 * slot + 2] = pz;
        }
      }
      found += __popc(mask);
    }
  }
  const int c = min(found, nsample);
  for (int s = c + lane; s < nsample; s += 32) out[s] = first;
  if (kWithXyz) {
    // pad slots: the first hit's coordinates, point 0's for an empty ball
    const float fx = data[3 * first];
    const float fy = data[3 * first + 1];
    const float fz = data[3 * first + 2];
    for (int s = c + lane; s < nsample; s += 32) {
      gout[3 * s] = fx;
      gout[3 * s + 1] = fy;
      gout[3 * s + 2] = fz;
    }
  }
  if (lane == 0) cnt[q] = c;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ball_query_kernel(const float* __restrict__ xyz1,
                      const float* __restrict__ xyz2, int* __restrict__ idx,
                      int* __restrict__ cnt, long long queries, int n, int m,
                      int nsample, float r2) {
  ball_query_warp<false>(xyz1, xyz2, idx, cnt, nullptr, queries, n, m,
                         nsample, r2);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ball_query_group_xyz_kernel(const float* __restrict__ xyz1,
                                const float* __restrict__ xyz2,
                                int* __restrict__ idx, int* __restrict__ cnt,
                                float* __restrict__ grouped, long long queries,
                                int n, int m, int nsample, float r2) {
  ball_query_warp<true>(xyz1, xyz2, idx, cnt, grouped, queries, n, m, nsample,
                        r2);
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

}  // namespace

extern "C" int pn2_ball_query(const void* xyz1, const void* xyz2, void* idx,
                              void* cnt, int b, int n, int m, int nsample,
                              float r2, void* stream) {
  if (nsample <= 0) return cudaSuccess;
  int err;
  const long long blocks = query_blocks(b, n, m, &err);
  if (err != cudaSuccess || blocks == 0) return err;
  ball_query_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<int*>(idx), static_cast<int*>(cnt),
      static_cast<long long>(b) * m, n, m, nsample, r2);
  return cudaGetLastError();
}

extern "C" int pn2_ball_query_group_xyz(const void* xyz1, const void* xyz2,
                                        void* idx, void* cnt, void* grouped,
                                        int b, int n, int m, int nsample,
                                        float r2, void* stream) {
  if (nsample <= 0) return cudaSuccess;
  int err;
  const long long blocks = query_blocks(b, n, m, &err);
  if (err != cudaSuccess || blocks == 0) return err;
  ball_query_group_xyz_kernel<<<static_cast<unsigned>(blocks),
                                kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<int*>(idx), static_cast<int*>(cnt),
      static_cast<float*>(grouped), static_cast<long long>(b) * m, n, m,
      nsample, r2);
  return cudaGetLastError();
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
