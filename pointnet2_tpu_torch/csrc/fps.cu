// Farthest point sampling, (B, N, 3) f32 -> (B, npoint) int32, at any N.
//
// Replaces pointnet2_tpu/ops/pallas/fps.py:fps_pallas (kernel body
// _fps_kernel). Same semantics: the seed is index 0, each step selects the
// point with the largest running min squared distance to the selected set,
// the lowest index wins a tie, the initial min distance is 1e38.
//
// Bound on this card: latency. The npoint-1 selections form a serial chain;
// each one is a distance update over the cloud and an argmax over it. The
// bytes (one read of xyz, one write of idx) and the operations (~10 per point
// per step) are far below what the card could do in that time. Two routes
// split at kCtaPoints = 16384 points:
//
// N <= 16384, fps_kernel (every model's SA layers): one CTA per cloud, the
// cloud's xyz in shared memory (12 KB at N=1024), each thread's points and
// their running min distance in registers, and one __syncthreads a step.
// Each warp reduces its (distance, index) pairs with two redux.sync (the
// largest distance's bits, then the lowest index holding them: the bits of
// non-negative floats order as their values) and writes its partial into a
// shared buffer chosen by the step's parity; after the barrier every warp
// reduces all the partials itself, so every thread knows the step's pick
// without a second exchange. The parity keeps step s+1's writes off step
// s's buffer: a warp reaches step s+2's writes only after step s+1's
// barrier, which no warp passes before every warp has read step s's
// partials. Clouds run as independent CTAs, several per SM.
//
// N > 16384, fps_cluster_kernel: one thread-block cluster of C CTAs per
// cloud, C the smallest of 2, 4, 8, 16 with ceil(N / C) <= 16384. CTA r
// owns the contiguous slice [r*S, min(N, (r+1)*S)), S = ceil(N / C). Up to
// 16 x 16384 = 262144 points its 1024 threads hold the slice's points and
// running minima in registers, laid out as in fps_kernel; above that (C =
// 16) in a scratch of 16 bytes a point in device memory (x, y, z, min),
// which the wrapper allocates and each thread walks from L2 every step.
// No CTA holds the cloud: the picked point's coordinates travel with the
// winning partial. A step: the distance update (sq_dist, as above); the
// warps' partials (bits, idx, x, y, z) through a __syncthreads; warp 0
// reduces them and writes the CTA's partial into its slot for the step's
// parity; cluster.sync() (barrier.cluster arrive.release / wait.acquire);
// then warp 0 of every CTA reads the C slots through distributed shared
// memory, reduces them by the same rule and hands the pick and its
// coordinates to its CTA through shared memory and a second __syncthreads
// (one remote read of each slot a CTA: with every warp reading the C
// slots a C=16 step took 13.2 us on an H100, with warp 0 alone 5.1); CTA
// 0 writes the pick. The parity argument carries over to the cluster
// barrier: a CTA writes step s+2's slot only after step s+1's cluster
// barrier, which no CTA passes before every CTA has read step s's slots.
// One more cluster.sync() before exit keeps every CTA's shared memory
// alive while another may still read it. Ties: slices ascend by index and
// each thread's points ascend, and every merge keeps (largest bits,
// lowest index), so the pick is the lowest-index argmax over the whole
// cloud, as in fps_plain.

#include <cooperative_groups.h>

#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

// (bits, idx) <- the warp's largest distance bits and the lowest index
// holding them. A lane without a point holds (0, INT_MAX), which loses to
// every real point, a distance of 0 included, by its index.
__device__ __forceinline__ void warp_argmax(unsigned& bits, int& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  idx = __reduce_min_sync(0xffffffffu, bits == top ? idx : INT_MAX);
  bits = top;
}

template <int kBlock, int kPerThread>
__global__ void __launch_bounds__(kBlock)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int npoint) {
  constexpr int kWarps = kBlock / 32;
  extern __shared__ float s_xyz[];  // (n, 3), as in device memory
  __shared__ unsigned s_bits[2][kWarps];
  __shared__ int s_idx[2][kWarps];

  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* dst = out + static_cast<size_t>(blockIdx.x) * npoint;
  for (int k = threadIdx.x; k < 3 * n; k += kBlock) s_xyz[k] = cloud[k];
  __syncthreads();

  // thread t owns points t, t + kBlock, ...: ascending in j, so a strict >
  // while scanning j keeps the lowest index among its own ties
  float px[kPerThread], py[kPerThread], pz[kPerThread], dmin[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = threadIdx.x + j * kBlock;
    const bool real = k < n;
    px[j] = real ? s_xyz[3 * k] : 0.f;
    py[j] = real ? s_xyz[3 * k + 1] : 0.f;
    pz[j] = real ? s_xyz[3 * k + 2] : 0.f;
    dmin[j] = 1e38f;
  }
  if (threadIdx.x == 0) dst[0] = 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float lx = s_xyz[3 * last];
    const float ly = s_xyz[3 * last + 1];
    const float lz = s_xyz[3 * last + 2];
    // every distance is >= +0 (a sum of squares), so its bits order as its
    // value; the sentinel is bits 0 with the largest index
    unsigned best = 0;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int k = threadIdx.x + j * kBlock;
      if (k < n) {
        dmin[j] = fminf(dmin[j], sq_dist(px[j], py[j], pz[j], lx, ly, lz));
        const unsigned b = __float_as_uint(dmin[j]);
        if (b > best || best_i == INT_MAX) {
          best = b;
          best_i = k;
        }
      }
    }
    warp_argmax(best, best_i);
    const int p = s & 1;
    if (lane == 0) {
      s_bits[p][warp] = best;
      s_idx[p][warp] = best_i;
    }
    __syncthreads();  // the step's one barrier
    unsigned bits = lane < kWarps ? s_bits[p][lane] : 0u;
    last = lane < kWarps ? s_idx[p][lane] : INT_MAX;
    warp_argmax(bits, last);
    if (threadIdx.x == 0) dst[s] = last;
  }
}

template <int kBlock, int kPerThread>
cudaError_t launch(const float* xyz, int* out, int b, int n, int npoint,
                   cudaStream_t stream) {
  // the cloud, dynamic, beside the partials' static 16 bytes a warp: above
  // 48 KB in all only after the opt-in
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  if (smem + 16 * (kBlock / 32) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<kBlock, kPerThread>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<kBlock, kPerThread><<<b, kBlock, smem, stream>>>(xyz, out, n,
                                                              npoint);
  return cudaGetLastError();
}


// --- N > kCtaPoints: one thread-block cluster per cloud ---------------------

constexpr int kClusterBlock = 1024;
constexpr int kSlicePerThread = 16;
constexpr int kCtaPoints = kClusterBlock * kSlicePerThread;  // 16384
constexpr int kMaxCluster = 16;

namespace cg = cooperative_groups;

struct Partial {
  unsigned bits;
  int idx;
  float x, y, z;
};

// warp_argmax, and the winner's coordinates from the lane that holds its
// index (some lane does: the merged index is one of the lanes' own)
__device__ __forceinline__ void warp_argmax_xyz(Partial& p) {
  const int mine = p.idx;
  warp_argmax(p.bits, p.idx);
  const int src = __ffs(__ballot_sync(0xffffffffu, mine == p.idx)) - 1;
  p.x = __shfl_sync(0xffffffffu, p.x, src);
  p.y = __shfl_sync(0xffffffffu, p.y, src);
  p.z = __shfl_sync(0xffffffffu, p.z, src);
}

// point k of the slice is a candidate: a strict > while k ascends keeps the
// lowest index among a thread's ties; the first real point replaces the
// (0, INT_MAX) sentinel whatever its distance
__device__ __forceinline__ void consider(Partial& p, float d, int k, float x,
                                         float y, float z) {
  const unsigned b = __float_as_uint(d);
  if (b > p.bits || p.idx == INT_MAX) p = {b, k, x, y, z};
}

// kScratch: the slice's points and minima in `scratch` (B, N) float4, else
// in registers. The cluster is the CTAs blockIdx.x / C * C + [0, C).
template <bool kScratch>
__global__ void __launch_bounds__(kClusterBlock, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, int* __restrict__ out,
                       float4* __restrict__ scratch, int n, int slice,
                       int npoint) {
  constexpr int kWarps = kClusterBlock / 32;
  static_assert(kWarps == 32, "warp 0 reduces one partial a lane");
  __shared__ Partial s_warp[2][kWarps];
  __shared__ Partial s_cta[2];   // this CTA's partial, read by the cluster
  __shared__ Partial s_pick[2];  // the step's pick, from warp 0

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const size_t b = blockIdx.x / csize;
  const float* cloud = xyz + b * n * 3;
  int* dst = out + b * npoint;
  const int lo = rank * slice;
  const int len = max(0, min(n - lo, slice));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  constexpr int kRegs = kScratch ? 1 : kSlicePerThread;  // points a thread
  float px[kRegs], py[kRegs], pz[kRegs], dmin[kRegs];
  float4* mine = kScratch ? scratch + b * n + lo : nullptr;
  if constexpr (kScratch) {
    for (int k = t; k < len; k += kClusterBlock) {
      const float* q = cloud + 3 * static_cast<size_t>(lo + k);
      mine[k] = make_float4(q[0], q[1], q[2], 1e38f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int k = t + j * kClusterBlock;
      const bool real = k < len;
      const float* q = cloud + 3 * static_cast<size_t>(lo + k);
      px[j] = real ? q[0] : 0.f;
      py[j] = real ? q[1] : 0.f;
      pz[j] = real ? q[2] : 0.f;
      dmin[j] = 1e38f;
    }
  }
  if (rank == 0 && t == 0) dst[0] = 0;

  float lx = cloud[0], ly = cloud[1], lz = cloud[2];
  for (int s = 1; s < npoint; ++s) {
    Partial best = {0u, INT_MAX, 0.f, 0.f, 0.f};
    if constexpr (kScratch) {
      // each thread rereads and updates only its own points: no barrier
      for (int k = t; k < len; k += kClusterBlock) {
        const float4 q = mine[k];
        const float d = fminf(q.w, sq_dist(q.x, q.y, q.z, lx, ly, lz));
        if (d != q.w) reinterpret_cast<float*>(mine + k)[3] = d;
        consider(best, d, lo + k, q.x, q.y, q.z);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {
        const int k = t + j * kClusterBlock;
        if (k < len) {
          dmin[j] = fminf(dmin[j], sq_dist(px[j], py[j], pz[j], lx, ly, lz));
          consider(best, dmin[j], lo + k, px[j], py[j], pz[j]);
        }
      }
    }
    warp_argmax_xyz(best);
    const int p = s & 1;
    if (lane == 0) s_warp[p][warp] = best;
    __syncthreads();
    if (warp == 0) {
      Partial w = s_warp[p][lane];
      warp_argmax_xyz(w);
      if (lane == 0) s_cta[p] = w;
    }
    cluster.sync();  // the CTAs' partials of step s are written
    if (warp == 0) {  // one remote read a CTA's slot, not one a warp
      Partial c = {0u, INT_MAX, 0.f, 0.f, 0.f};
      if (lane < csize) c = *cluster.map_shared_rank(&s_cta[p], lane);
      warp_argmax_xyz(c);
      if (lane == 0) s_pick[p] = c;
    }
    __syncthreads();
    const Partial c = s_pick[p];
    lx = c.x;
    ly = c.y;
    lz = c.z;
    if (rank == 0 && t == 0) dst[s] = c.idx;
  }
  cluster.sync();  // no CTA leaves while another reads its partials
}

// C: the smallest of 2, 4, 8, 16 whose slices fit a CTA's registers, 16
// above that (the scratch route)
int cluster_size(int n) {
  int c = 2;
  while (c < kMaxCluster && (n - 1) / c + 1 > kCtaPoints) c *= 2;
  return c;
}

// whether a cluster of c CTAs of this kernel can be resident at all:
// cudaOccupancyMaxActiveClusters, asked once per device and configuration
// (0 unknown, 1 yes, else the error to return)
constexpr int kMaxDevices = 64;
std::atomic<int> cluster_ok[kMaxDevices][2][5];

template <bool kScratch>
cudaError_t launch_cluster(const float* xyz, int* out, float4* scratch,
                           int b, int n, int npoint, cudaStream_t st) {
  const int c = cluster_size(n);
  const int slice = (n - 1) / c + 1;  // ceil(n / c) without overflow
  if (static_cast<long long>(b) * c > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = fps_cluster_kernel<kScratch>;
  if (c > 8) {  // 16 CTAs: above the portable cluster size
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * c);
  cfg.blockDim = dim3(kClusterBlock);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int log2c = 0;
  while ((1 << log2c) < c) ++log2c;
  std::atomic<int>* ok =
      dev < kMaxDevices ? &cluster_ok[dev][kScratch][log2c] : nullptr;
  int state = ok != nullptr ? ok->load() : 0;
  if (state == 0) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    state = e != cudaSuccess ? static_cast<int>(e)
            : clusters > 0   ? 1
                             : static_cast<int>(cudaErrorLaunchOutOfResources);
    if (ok != nullptr) ok->store(state);
  }
  if (state != 1) return static_cast<cudaError_t>(state);
  e = cudaLaunchKernelEx(&cfg, kernel, xyz, out, scratch, n, slice, npoint);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// scratch: (b, n, 4) f32, x, y, z and the running minimum of each point,
// for clouds above kMaxCluster * kCtaPoints = 262144 points (the wrapper's
// sampling.fps_scratch); below that it may be null.
extern "C" int pn2_fps(const void* xyz, void* out, void* scratch, int b,
                       int n, int npoint, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || npoint <= 0) return cudaSuccess;
  if (n <= 0) return cudaErrorInvalidValue;
  if (n > kCtaPoints) {
    if (n <= kMaxCluster * kCtaPoints) {
      return launch_cluster<false>(x, o, nullptr, b, n, npoint, st);
    }
    if (scratch == nullptr) return cudaErrorInvalidValue;
    return launch_cluster<true>(x, o, static_cast<float4*>(scratch), b, n,
                                npoint, st);
  }
  // threads a cloud by measurement on an H100 (fewer points a thread won
  // up to 1024 threads; the reduction is two redux.sync whatever the warps)
  if (n <= 256) return launch<256, 1>(x, o, b, n, npoint, st);
  if (n <= 512) return launch<256, 2>(x, o, b, n, npoint, st);
  if (n <= 1024) return launch<1024, 1>(x, o, b, n, npoint, st);
  if (n <= 2048) return launch<1024, 2>(x, o, b, n, npoint, st);
  if (n <= 4096) return launch<1024, 4>(x, o, b, n, npoint, st);
  if (n <= 8192) return launch<1024, 8>(x, o, b, n, npoint, st);
  return launch<1024, 16>(x, o, b, n, npoint, st);
}
