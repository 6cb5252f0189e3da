// Farthest point sampling, (B, N, 3) f32 -> (B, npoint) int32.
//
// Replaces pointnet2_tpu/ops/pallas/fps.py:fps_pallas (kernel body
// _fps_kernel). Same semantics: the seed is index 0, each step selects the
// point with the largest running min squared distance to the selected set,
// the lowest index wins a tie, the initial min distance is 1e38.
//
// Bound on this card: latency. The npoint-1 selections form a serial chain;
// each one is a distance update over the cloud and a block-wide argmax. The
// bytes (one read of xyz, one write of idx) and the operations (~10 per point
// per step) are far below what the card could do in that time. The design
// therefore keeps everything on chip and makes one step as short as it can:
// one CTA per cloud, the cloud's xyz in shared memory (12 KB at N=1024),
// each thread's points and their running min distance in registers, and one
// __syncthreads a step. Each warp reduces its (distance, index) pairs with
// two redux.sync (the largest distance's bits, then the lowest index holding
// them: the bits of non-negative floats order as their values) and writes
// its partial into a shared buffer chosen by the step's parity; after the
// barrier every warp reduces all the partials itself, so every thread knows
// the step's pick without a second exchange. The parity keeps step s+1's
// writes off step s's buffer: a warp reaches step s+2's writes only after
// step s+1's barrier, which no warp passes before every warp has read step
// s's partials. Clouds run as independent CTAs, several per SM.

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

}  // namespace

// Largest N the kernel takes: 1024 threads x 16 points each.
extern "C" int pn2_fps_max_points() { return 1024 * 16; }

extern "C" int pn2_fps(const void* xyz, void* out, int b, int n, int npoint,
                       void* stream) {
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || npoint <= 0) return cudaSuccess;
  if (n <= 0 || n > pn2_fps_max_points()) return cudaErrorInvalidValue;
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
