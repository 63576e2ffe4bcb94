// Step-1 per-key statistics (paper Fig. 5): g(k) = number of tuples with
// key k and c(k) = the sum of their costs, for k in [0, num_keys); keys
// outside that range are padding and ignored. float32 accumulation.
//
// Replaces: the Pallas kernel _key_stats_kernel in
//   src/repro/kernels/key_stats.py (public key_stats).
//
// What bounds it on an H100: bytes, as long as the atomics keep up. Each
// tuple's key and cost are read once and the two (num_keys,) outputs are
// written once: the least time is (4 N + N x cost bytes + 8 num_keys) /
// 3.35 TB/s, about 12 us at N = 4M float32 tuples and num_keys = 2^20. In
// practice the L2's atomic units bound it: scattered adds run at some tens
// of billions a second, and a skewed stream sends many adds to one hot key,
// which serialise.
//
// Design. The TPU kernel builds a (tuples x key-block) one-hot match matrix
// and contracts it on the MXU, because a TPU scatters poorly. A GPU has
// native float atomics in L2, so here tuples are added into zeroed outputs:
// O(N) work instead of O(N x num_keys). The outputs are interleaved as
// (num_keys, 2) float32, so one vector atomic (atomicAdd on a float2, sm_90)
// adds a key's count and cost together: half the atomics of two arrays. Hot
// keys are aggregated in the warp: each lane loads 4 keys (int4) and their
// weights (float4, or two double2 for float64 weights, cast to float32 on
// load); for each of the 4, keys outside [0, num_keys) are masked first,
// __match_any_sync groups the lanes that share a key, the group sums its
// weights with shuffles in lane order, and its leader issues one atomic for
// the group. A key in half the tuples thus costs one atomic a warp round,
// not one a tuple. Then a hot-key cache per block: a key whose group had
// two lanes or more is inserted into a small open-addressing table in shared
// memory; a leader whose key is found there adds into it with shared
// atomics, and the block adds the table into the outputs once at its end.
// Other keys go straight to global atomics, so a stream with no repeats
// (the stats path's (dest, key) groups) leaves the table empty and pays one
// shared read a tuple. The cache halves the time on the zipf stream and on a
// hot key, and costs nothing on the others (PERF.md).
// A grid of a few persistent blocks per SM walks the tuples warp by warp.
// Numerics: g(k) is exact while each count is below 2^24 (the group counts
// are whole numbers of at most 32, then sums of them). c(k) is a float32 sum
// of the same terms as the plain version's in another order (groups, the
// cache, atomics landing in any order): each differs from the exact sum by
// at most (g(k) - 1) 2^-24 sum|costs of k|, so the two lie within
// 2 g(k) 2^-24 |c(k)| of each other for non-negative costs. That is the
// bound chip_smoke.py holds the kernel to.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCacheLog2 = 11;  // 2048 slots x 12 B = 24 KB a block
constexpr int kCacheSlots = 1 << kCacheLog2;
constexpr int kCacheProbes = 4;
constexpr int kEmpty = -1;  // no valid key is negative

struct Cache {
  int* keys;
  float* w1;
  float* w2;
};

// Adds (a, b) to key's cache slot; inserts the key first when `insert` and a
// slot is free. False when the key has no slot (the caller adds to global).
__device__ __forceinline__ bool cache_add(const Cache& c, int key, bool insert,
                                          float a, float b) {
  const uint32_t h =
      (static_cast<uint32_t>(key) * 0x9E3779B1u) >> (32 - kCacheLog2);
  for (int p = 0; p < kCacheProbes; ++p) {
    const int s = (h + p) & (kCacheSlots - 1);
    int cur = *static_cast<volatile int*>(c.keys + s);
    if (cur == kEmpty) {
      if (!insert) return false;
      cur = atomicCAS(c.keys + s, kEmpty, key);
      if (cur == kEmpty) cur = key;
    }
    if (cur == key) {
      atomicAdd(c.w1 + s, a);
      atomicAdd(c.w2 + s, b);
      return true;
    }
  }
  return false;
}

// One tuple per lane, all 32 lanes together. kCount: the first output counts
// tuples (w1 ignored); else it sums w1.
template <bool kCount>
__device__ __forceinline__ void add_tuple(int32_t k, int num_keys, float w1,
                                          float w2, float2* __restrict__ out,
                                          const Cache& cache) {
  const int key = (k >= 0 && k < num_keys) ? k : kEmpty;
  const unsigned group = __match_any_sync(kFull, key);
  const int lane = threadIdx.x & 31;
  const int size = __popc(group);
  float s1 = kCount ? 1.0f : w1, s2 = w2;
  const int rounds = __reduce_max_sync(kFull, static_cast<unsigned>(size));
  if (rounds > 1) {  // some lanes share a key: each sums its group
    float t1 = 0.0f, t2 = 0.0f;
    unsigned rest = group;
    for (int r = 0; r < rounds; ++r) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float v1 = kCount ? 0.0f : __shfl_sync(kFull, s1, src);
      const float v2 = __shfl_sync(kFull, s2, src);
      if (rest) {
        t1 += v1;
        t2 += v2;
        rest &= rest - 1;
      }
    }
    s1 = kCount ? static_cast<float>(size) : t1;
    s2 = t2;
  }
  if (key == kEmpty || lane != __ffs(group) - 1) return;
  if (cache_add(cache, key, size > 1, s1, s2)) return;
  atomicAdd(out + key, make_float2(s1, s2));
}

__device__ __forceinline__ float4 load4(const float* w, int64_t v) {
  return __ldcs(reinterpret_cast<const float4*>(w) + v);
}

__device__ __forceinline__ float4 load4(const double* w, int64_t v) {
  const double2 lo = __ldcs(reinterpret_cast<const double2*>(w) + 2 * v);
  const double2 hi = __ldcs(reinterpret_cast<const double2*>(w) + 2 * v + 1);
  return make_float4(static_cast<float>(lo.x), static_cast<float>(lo.y),
                     static_cast<float>(hi.x), static_cast<float>(hi.y));
}

// w1 is unread when kCount. keys and weights 16-byte aligned.
template <bool kCount, typename W>
__global__ void __launch_bounds__(kThreads, 4)
    key_stats_kernel(const int32_t* __restrict__ keys,
                     const W* __restrict__ w1, const W* __restrict__ w2,
                     int64_t n, int num_keys, float2* __restrict__ out) {
  __shared__ int cache_keys[kCacheSlots];
  __shared__ float cache_w1[kCacheSlots];
  __shared__ float cache_w2[kCacheSlots];
  const Cache cache{cache_keys, cache_w1, cache_w2};
  for (int s = threadIdx.x; s < kCacheSlots; s += kThreads) {
    cache_keys[s] = kEmpty;
    cache_w1[s] = 0.0f;
    cache_w2[s] = 0.0f;
  }
  __syncthreads();

  // warp-uniform loop over vectors of 4 tuples; the last one may be partial
  const int64_t n_full = n >> 2, n_vec = (n + 3) >> 2;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int4* kv = reinterpret_cast<const int4*>(keys);
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x -
            lane);
       base < n_vec; base += 32 * warps) {
    const int64_t v = base + lane;
    int4 k = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (v < n_full) {
      k = __ldcs(kv + v);
      if (!kCount) a = load4(w1, v);
      b = load4(w2, v);
    } else if (v < n_vec) {
      int* kk = &k.x;
      float* aa = &a.x;
      float* bb = &b.x;
      for (int j = 0; 4 * v + j < n; ++j) {
        kk[j] = keys[4 * v + j];
        if (!kCount) aa[j] = static_cast<float>(w1[4 * v + j]);
        bb[j] = static_cast<float>(w2[4 * v + j]);
      }
    }
    add_tuple<kCount>(k.x, num_keys, a.x, b.x, out, cache);
    add_tuple<kCount>(k.y, num_keys, a.y, b.y, out, cache);
    add_tuple<kCount>(k.z, num_keys, a.z, b.z, out, cache);
    add_tuple<kCount>(k.w, num_keys, a.w, b.w, out, cache);
  }

  // the block's cached sums, once each
  __syncthreads();
  for (int s = threadIdx.x; s < kCacheSlots; s += kThreads) {
    const int key = cache_keys[s];
    if (key != kEmpty)
      atomicAdd(out + key, make_float2(cache_w1[s], cache_w2[s]));
  }
}

template <bool kCount, typename W>
int launch(const void* keys, const void* w1, const void* w2, int64_t n,
           int num_keys, void* out, int grid, void* stream) {
  key_stats_kernel<kCount, W>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(keys), static_cast<const W*>(w1),
          static_cast<const W*>(w2), n, num_keys, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The C interface's version: 2 takes a weight type, an optional first weight
// and one interleaved output (1, the first port's, exported no such symbol).
// scripts/stream_kernels_ab.py reads it to call each version it times.
extern "C" int key_stats_abi() { return 2; }

// keys (n,) int32; w1, w2 (n,) float32 (wbytes 4) or float64 (wbytes 8);
// out (num_keys, 2) float32, zeroed: out[k][0] counts k's tuples (g(k)) when
// w1 == NULL, else sums their w1; out[k][1] sums their w2. All on the
// device, inputs 16-byte aligned, out 8-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int key_stats_launch(const void* keys, const void* w1,
                                const void* w2, int wbytes, int64_t n,
                                int num_keys, void* out, int grid,
                                void* stream) {
  if (grid < 1 || num_keys < 0 || (wbytes != 4 && wbytes != 8) ||
      !aligned(keys) || !aligned(w2) || (w1 && !aligned(w1)) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wbytes == 4)
    return w1 ? launch<false, float>(keys, w1, w2, n, num_keys, out, grid,
                                     stream)
              : launch<true, float>(keys, w1, w2, n, num_keys, out, grid,
                                    stream);
  return w1 ? launch<false, double>(keys, w1, w2, n, num_keys, out, grid,
                                    stream)
            : launch<true, double>(keys, w1, w2, n, num_keys, out, grid,
                                   stream);
}
