// Step-1 per-key statistics (paper Fig. 5): g(k) = number of tuples with
// key k and c(k) = the sum of their costs, for k in [0, num_keys); keys
// outside that range are padding and ignored. float32 accumulation.
//
// Replaces: the Pallas kernel _key_stats_kernel in
//   src/repro/kernels/key_stats.py (public key_stats).
//
// What bounds it on an H100: bytes, as long as the atomics do not collide.
// Each tuple's key and cost are read once (8 B) and the two (num_keys,)
// outputs are written once (8 B a key): the least time is
// (8 N + 8 num_keys) bytes / 3.35 TB/s, about 12 us at N = 4M tuples and
// num_keys = 2^20. A skewed stream sends many atomics to one hot key; they
// serialise in L2 and can take longer than the bytes do.
//
// Design. The TPU kernel builds a (tuples x key-block) one-hot match matrix
// and contracts it on the MXU, because a TPU scatters poorly. A GPU has
// native float atomics in L2, so here each thread takes one tuple (in a
// grid-stride loop) and atomicAdds 1 and its cost into the zeroed global
// outputs: O(N) work instead of O(N x num_keys). A histogram privatised in
// shared memory would cut global atomics, but at num_keys = 2^20 the two
// outputs take 8 MB, far beyond a block's 227 KB; warp-aggregated atomics
// for hot keys are the next design. g(k) is exact while each count is below
// 2^24; c(k)'s last bits depend on the order the atomics land in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void key_stats_kernel(const int32_t* __restrict__ keys,
                                 const float* __restrict__ costs, int64_t n,
                                 int num_keys, float* __restrict__ freq,
                                 float* __restrict__ cost) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t k = keys[i];
    if (k >= 0 && k < num_keys) {
      atomicAdd(freq + k, 1.0f);
      atomicAdd(cost + k, costs[i]);
    }
  }
}

}  // namespace

// keys (n,) int32, costs (n,) float32, freq/cost (num_keys,) float32 zeroed,
// all on the device. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int key_stats_launch(const void* keys, const void* costs,
                                int64_t n, int num_keys, void* freq,
                                void* cost, int grid, int block,
                                void* stream) {
  key_stats_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(costs), n,
      num_keys, static_cast<float*>(freq), static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}
