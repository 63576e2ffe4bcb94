// F(k) routing, paper Eq. 1: F(k) = A[k] if k is in the override table A,
// else fmix32(k ^ seed) % n_dest.
//
// Replaces: the Pallas kernel _routing_kernel in
//   src/repro/kernels/routing_lookup.py (public routing_lookup).
//
// What bounds it on an H100: bytes. Each key is read once (4 B) and each dest
// written once (4 B); the table (at most 192 KB up to 16,384 slots) is small
// beside them at the main path's N. The least time is 8 N bytes / 3.35 TB/s:
// 2.5 us at the dense N = 2^20 + 1, 10 us at N = 4M tuples. The arithmetic
// (two 32-bit mixes, a modulo and about one table probe per key) is far below
// the card's integer rate.
//
// Design. The TPU kernel pins the whole table in VMEM and compares every key
// against every slot (a BN x A match with an integer-max reduce), because the
// MXU/VPU make dense compares cheap and gathers dear. Here the wrapper builds
// an open-addressing hash table on the host, once per assignment version
// (kernels/routing_lookup.py, RoutingTable), and uploads it in one copy:
//   * a bucket is one int4 {key0, dest0, key1, dest1}; a slot whose dest is
//     -1 is empty. Empty slots are marked by the dest and not by a key, so no
//     int32 key (INT32_MIN included) can match one; dests are >= 0.
//   * the table holds each distinct caller key once with the dest of its
//     FIRST slot in the caller's order, so key -1 (the caller's empty-slot
//     key) takes the first empty slot's dest, as the JAX package's
//     ref.routing_lookup does, and a key below -1 matches nothing.
//   * a key's home bucket is __umulhi(fmix32(k ^ salt), n_home): the table's
//     own salt, not the routing seed, since one table serves any seed. Keys
//     are placed by linear probing over buckets in home order, so the
//     buckets between a key's home and its own are full. A lookup therefore
//     stops at its key, at the first bucket with an empty slot (a miss), or
//     after max_probe buckets (the longest chain, recorded by the builder).
//     RoutingTable gives each key 4 home buckets (8 slots), within 192 KB
//     for a table of up to 16,384 slots and without a cap past that (the
//     reference's table has no bound either), so most keys resolve in one
//     probe, and most warps too: a warp waits for its slowest lane. The
//     bucket index is 32-bit, the only bound on a table's size.
// One persistent block per SM probes the table where it lies, through the
// read-only cache (192 KB up to 16,384 slots: it stays in L2, and what a block
// touches in L1; a larger table is read the same way, 64 KB for each 1,024
// distinct keys). Staging the whole table into each block's shared memory with
// one cp.async.bulk under an mbarrier was measured too: no faster per tuple
// and slower on the dense domain, where a block routes only ~8K keys and waits
// for all of the table first (PERF.md). Keys are read and dests written as
// int4 with streaming cache hints; a base pointer off the 16-byte grid is
// handled by up to 3 scalar keys before the vectors and 3 after (the wrapper
// places the output at the keys' offset mod 16). The mixes are native uint32
// arithmetic, bit-identical to the host planner's Hash32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct Table {
  const int4* buckets;
  uint32_t n_home;  // home buckets; the rest are overflow
  int max_probe;
  uint32_t salt;
  uint32_t n_dest;
  uint32_t seed;
};

__device__ __forceinline__ int32_t route_one(const Table& t, int32_t k) {
  const uint32_t u = static_cast<uint32_t>(k);
  uint32_t b = __umulhi(fmix32(u ^ t.salt), t.n_home);
  for (int p = 0; p < t.max_probe; ++p, ++b) {
    const int4 e = __ldg(t.buckets + b);
    if (e.x == k && e.y >= 0) return e.y;
    if (e.z == k && e.w >= 0) return e.w;
    if ((e.y | e.w) < 0) break;  // a slot is empty: the chain ends here
  }
  return static_cast<int32_t>(fmix32(u ^ t.seed) % t.n_dest);
}

__device__ __forceinline__ int4 route_four(const Table& t, int4 k) {
  return make_int4(route_one(t, k.x), route_one(t, k.y), route_one(t, k.z),
                   route_one(t, k.w));
}

__global__ void __launch_bounds__(kThreads, 1)
    routing_lookup_kernel(const int32_t* __restrict__ keys, int64_t n,
                          int head, Table t, int32_t* __restrict__ out) {
  // the int4 body: keys [head, head + 4 n_vec), 16-byte aligned
  const int64_t n_vec = (n - head) >> 2;
  const int4* kv = reinterpret_cast<const int4*>(keys + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int4 a = make_int4(0, 0, 0, 0), b = a;
  if (v < n_vec) a = __ldcs(kv + v);
  if (v + stride < n_vec) b = __ldcs(kv + v + stride);

  // the scalar edges: up to 3 keys before the body and 3 after it
  const int64_t tail = head + 4 * n_vec;
  if (blockIdx.x == 0 && threadIdx.x < head + (n - tail)) {
    const int64_t i = threadIdx.x < head ? threadIdx.x
                                         : tail + (threadIdx.x - head);
    out[i] = route_one(t, keys[i]);
  }

  for (; v < n_vec; v += 2 * stride) {
    const int64_t next = v + 2 * stride;
    int4 na = make_int4(0, 0, 0, 0), nb = na;
    if (next < n_vec) na = __ldcs(kv + next);
    if (next + stride < n_vec) nb = __ldcs(kv + next + stride);
    __stcs(ov + v, route_four(t, a));
    if (v + stride < n_vec) __stcs(ov + v + stride, route_four(t, b));
    a = na;
    b = nb;
  }
}

}  // namespace

// The C interface's version: 2 is the hash table (1, the sorted table of the
// first port, exported no such symbol). scripts/stream_kernels_ab.py reads it
// to call each version it times.
extern "C" int routing_lookup_abi() { return 2; }

// keys (n,) int32 and out (n,) int32, on the device at the same address mod
// 16; buckets (n_buckets, 4) int32 from the host builder, 16-byte aligned.
// head = keys before the first 16-byte boundary (0-3, at most n). Grid: at
// most one block per SM. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int routing_lookup_launch(const void* keys, int64_t n, int head,
                                     const void* buckets, int n_buckets,
                                     int n_home, int max_probe, uint32_t salt,
                                     int n_dest, uint32_t seed, void* out,
                                     int grid, void* stream) {
  const uintptr_t k = reinterpret_cast<uintptr_t>(keys);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (n_buckets < 1 || n_home < 1 ||
      n_home > n_buckets || max_probe < 0 || n_dest < 1 || grid < 1 ||
      head < 0 || head > 3 || head > n || (k - o) % 16 != 0 ||
      (head < n && (k + 4 * static_cast<uintptr_t>(head)) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Table t{static_cast<const int4*>(buckets),
                static_cast<uint32_t>(n_home), max_probe, salt,
                static_cast<uint32_t>(n_dest), seed};
  routing_lookup_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, head, t,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
