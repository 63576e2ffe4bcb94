// Blocked online-softmax GQA attention, forward only: for each query row,
// softmax(q k^T * d^-1/2) v over the keys its mask admits, with f32
// accumulation and the output in the inputs' type (float32 or bfloat16).
// Queries are right-aligned against the keys (q_pos = i + S - T), so the
// same kernel serves a whole prompt (T == S) and chunked decode (T < S).
// A key k is admitted for query position p when k < S and, if causal,
// k <= p and, with a window, k > p - window. A row that admits no key
// gives 0.
//
// Replaces: the Pallas kernel _flash_kernel in
//   src/repro/kernels/flash_attention.py (public flash_attention,
//   ops.attention).
//
// What bounds it on an H100: operations. Each admitted (query, key) pair
// costs 4 D flops (2 D for q.k, 2 D for p.v), against reading q, k, v and
// writing o once. At the serve path's shapes (B=4, Hq=16, Hkv=8,
// T=S=2048, D=240, bf16) a global causal layer needs 129 GFLOP and
// 0.16 GB: 0.13 ms at the bf16 tensor-core peak (989 TFLOP/s) against
// 0.05 ms for the bytes.
//
// Design. The Pallas grid (B, Hq, T/BT, S/BS) runs in order on one core
// and carries the running max m, sum l and accumulator across the
// innermost key axis in VMEM scratch. Blocks on Hopper run in parallel and
// in no order, so here one CTA takes one (batch, query head, query tile)
// and walks the key tiles in a loop, with m, l and the accumulator in
// registers. The KV head is hq / (Hq / Hkv), as the Pallas index map
// computes it. A key tile wholly outside [q_lo - window + 1, q_hi] is
// skipped; that is exact, because a fully masked tile leaves (m, l, acc)
// unchanged in the recurrence (a sliding-window layer at T = S = 2048
// visits about 400 of 1024 64 x 64 tiles, a global causal one 528).
//
// Two kernels, chosen by the inputs' type:
//
// * bfloat16 (the model path): Hopper's TMA and wgmma under warp
//   specialisation. A CTA takes 128 query rows and has three warpgroups.
//   The producer warpgroup gives up its registers (setmaxnreg 24) and one
//   of its threads issues every TMA load: the CTA's Q tile once, then each
//   64-key K and V tile into a 2-stage ring, each stage with a full barrier
//   for K, one for V (armed with the byte count) and an empty barrier that
//   the consumers' warps arrive on. So the next tile's loads are in flight
//   while the consumers work on the current one. The two consumer
//   warpgroups (setmaxnreg 240) own 64 query rows each: S = Q K^T as
//   wgmma m64n64k16 with both operands in shared memory (K is K-major as
//   stored), the online softmax on the S accumulator in registers, then
//   O += P V as one wgmma m64n(64 NC)k16 per 16 keys, with P as the A
//   operand straight from registers (the S accumulator's layout is the A
//   fragment's, so P is rounded to bf16 in place; l sums the rounded
//   values, so each output row stays a convex combination of v) and V as
//   an MN-major B operand (transposed) in shared memory. O is 64 x 256 f32
//   per warpgroup, 128 registers a thread. The running maximum moves only
//   when a row's maximum grows by more than 2^8, so most tiles leave O
//   unscaled (exact: O and l share the maximum). Tiles sit in shared
//   memory in 128-byte swizzled chunks of 64 head-dim columns, as TMA
//   writes them and wgmma reads them: the head dim is loaded as
//   NC = ceil(D / 64) chunks and TMA fills the columns past D with zeros
//   (D = 240 is 4 chunks; the padding adds nothing to q.k or to o). Q, K,
//   V and O are described as 3-D tensors (B*H, rows, D), so a ragged tile
//   reads zeros, never the next head's rows, and the output tile, staged
//   in the warpgroup's Q tile, goes out by TMA store clipped to T and D.
//   Shared memory at D = 240: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
//   192 KB, one CTA per SM. The mask is applied only on the edge tiles of
//   each warpgroup's walk (the causal diagonal, the window's lower edge,
//   keys past S); a warpgroup skips the math of a tile its own rows do not
//   reach. The host encodes the tensor maps (cuTensorMapEncodeTiled,
//   reached through the runtime's driver entry point) and passes them as
//   __grid_constant__ parameters. TMA needs 16-byte row strides and base
//   addresses: the wrapper pads D to a multiple of 8 and aligns q, k, v.
// * float32 (the tests' shapes): CUDA-core fmaf, 64-row query tiles, with
//   the q, k, v tiles and the 64x64 probability tile in shared memory as
//   float32 (about 200 KB at D = 240, one CTA per SM). 256 threads,
//   16 x 16: a thread owns 4 query rows x 4 keys of the score tile and the
//   same 4 rows x ceil(D/16) output columns, so each row's rescale factor
//   is in its own registers. Row stride D + 1 keeps the key tile's column
//   reads free of bank conflicts. It keeps float32 products, which the
//   tests' 2e-5 tolerance needs.
//
// Query tiles are taken heaviest first (in reverse order), so the causal
// grid's longest walks start first.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 64;           // query rows per CTA
constexpr int kBS = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRows = kBT / 16;   // query rows per thread
constexpr int kCols = kBS / 16;   // keys per thread in the score tile
constexpr int kDMax = 256;
constexpr int kJMax = kDMax / 16; // output columns per thread, at most
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int group, int t, int s, int d, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                 // [kBT][ld]
  float* ks = qs + kBT * ld;        // [kBS][ld]
  float* vs = ks + kBS * ld;        // [kBS][ld]
  float* ps = vs + kBS * ld;        // [kBT][kBS + 1]
  constexpr int pld = kBS + 1;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int64_t q_base = ((int64_t)b * hq + h) * t * d;
  const int64_t kv_base = ((int64_t)b * hkv + h / group) * s * d;
  const int q_off = s - t;          // right alignment

  for (int e = tid; e < kBT * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    qs[r * ld + c] = i0 + r < t ? q[q_base + (int64_t)(i0 + r) * d + c] : 0.f;
  }

  // key tiles that hold any admitted key of this query tile
  const int q_lo = q_off + i0;
  const int q_hi = q_off + min(i0 + kBT, t) - 1;
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(s - 1, q_hi) : s - 1;
  const int tile_begin = k_lo / kBS;
  const int tile_end = k_hi >= k_lo ? k_hi / kBS + 1 : tile_begin;
  const int nj = (d + 15) / 16;

  float m[kRows], l[kRows], acc[kRows][kJMax];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJMax; ++j) acc[i][j] = 0.f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int key0 = tile * kBS;
    __syncthreads();   // the last tile's reads of ks, vs, ps are done
    for (int e = tid; e < kBS * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      const bool in = key0 + r < s;
      const int64_t g = kv_base + (int64_t)(key0 + r) * d + c;
      ks[r * ld + c] = in ? k[g] : 0.f;
      vs[r * ld + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + 16 * i;
      const int qp = q_off + i0 + row;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = key0 + tx + 16 * j;
        ok[j] = key < s && (!causal || key <= qp) &&
                (window <= 0 || key > qp - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[row * pld + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJMax; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBS; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + 16 * i) * pld + c];
#pragma unroll
      for (int j = 0; j < kJMax; ++j) {
        const int col = tx + 16 * j;
        if (j < nj && col < d) {
          const float vv = vs[c * ld + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= t) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kJMax; ++j) {
      const int col = tx + 16 * j;
      if (j < nj && col < d) o[q_base + (int64_t)row * d + col] = acc[i][j] / den;
    }
  }
}

// ---- bfloat16: TMA + wgmma, warp-specialised ------------------------------

using bf16 = __nv_bfloat16;
constexpr int kQRows = 128;              // query rows per CTA
constexpr int kKeys = 64;                // keys per K/V tile
constexpr int kChunkCols = 64;           // head-dim columns per swizzled chunk
constexpr int kChunkBytes = 64 * 128;    // a 64-row chunk: 64 x 128 bytes
constexpr int kWsThreads = 384;          // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;        // arrivals that empty a stage
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 columns x 64 rows of one head) of a 3-D tensor map into
// shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// a box of this CTA's shared memory (64 columns x 64 rows of one head) out
// to a 3-D tensor map; rows and columns past the tensor's edge are not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int row,
                                          int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major (q, k): the
// 8-row groups are 1024 bytes apart (SBO); LBO is unused. MN-major (v):
// 64-column blocks 8 KB apart (LBO), 8-key groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WGMMA_D32_OPS(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 f32) (+)= a (64 x 16, shared, K-major) * b (16 x 64, shared,
// K-major); d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef WGMMA_D32
#undef WGMMA_D32_OPS
// d (64 x 64 NC f32) += a (64 x 16 bf16, registers) * b (16 x 64 NC,
// shared, MN-major): one wgmma over the whole head dim, n = 64 NC
template <int NC>
__device__ __forceinline__ void wgmma_rs(float (&d)[32 * NC],
                                         const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<1>(float (&d)[32],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<2>(float (&d)[64],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<3>(float (&d)[96],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<4>(float (&d)[128],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^x by the special-function unit alone (2 ulp, subnormals flushed): the
// probabilities are rounded to bf16 next, so nothing finer is kept
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the key tiles [begin, end) that hold an admitted key of some query at
// positions [p_lo, p_hi]
struct TileRange {
  int begin, end;
};

__device__ __forceinline__ TileRange tile_range(int p_lo, int p_hi, int s,
                                                int causal, int window) {
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_hi = causal ? min(s - 1, p_hi) : s - 1;
  const int begin = k_lo / kKeys;
  return {begin, k_hi >= k_lo ? k_hi / kKeys + 1 : begin};
}

// The online softmax over one 64-key tile of a warpgroup's S accumulator.
// This thread holds rows r (hf = 0) and r + 8 (hf = 1) at positions qp[hf];
// element i is row hf = (i / 2) % 2, key key0 + 8 (i / 4) + 2 (lane % 4) +
// i % 2. Leaves the bf16 probabilities in p (the wgmma A fragment of P:
// p[i] packs elements 2i and 2i + 1), this thread's share of each row sum
// in l, and each row's rescale factor in alpha. MASK: an edge tile.
template <bool MASK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], uint32_t (&p)[16], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int key0, const int (&qp)[2], int s, int causal,
    int window, float sl2, int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hf + e];
        if (MASK) {
          const int key = key0 + 8 * j + 2 * (lane % 4) + e;
          const bool ok = key < s && (!causal || key <= qp[hf]) &&
                          (window <= 0 || key > qp[hf] - window);
          x = ok ? x : kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    // m is kept in raw score units and moves only when the row's maximum
    // has grown by more than 8 in the log2 domain: O and l share the stale
    // maximum, so the result is the same, p stays below 2^8, and most
    // tiles leave alpha at 1 and O unscaled
    const float m_max = fmaxf(m[hf], quad_max(mx));
    const bool moved = (m_max - m[hf]) * sl2 > 8.f;
    const float m_new = moved ? m_max : m[hf];
    alpha[hf] = moved ? exp2f((m[hf] - m_new) * sl2) : 1.f;
    m[hf] = m_new;
    const float off = -m_new * sl2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hf + e];
        x = (!MASK || x > kNegInf) ? ex2(fmaf(x, sl2, off)) : 0.f;
      }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // rounded here, so l sums exactly the weights p.v multiplies
    const __nv_bfloat162 h = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    sum[i % 2] += f.x + f.y;
  }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
}

// Where a consumer warp's time goes. Built with -DFLASH_PHASE_CLOCKS
// (scripts/flash_ab.py --phases), each consumer warp's lane 0 adds the SM
// clocks of each phase of its walk to g_phase_clocks, which
// flash_attention_phase_clocks() reads and clears; otherwise PhaseClock
// compiles to nothing.
enum Phase {
  kWaitQ, kWaitK, kGemmS, kSoftmax, kWaitV, kGemmPV, kSkipped, kEpilogue,
  kPhases
};
#ifdef FLASH_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhases];
__device__ __forceinline__ unsigned long long clock_now() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(now));
  return now;
}
struct PhaseClock {
  unsigned long long sum[kPhases], start;
  __device__ void begin() {
    for (int i = 0; i < kPhases; ++i) sum[i] = 0;
    start = clock_now();
  }
  __device__ void lap(Phase phase) {
    const unsigned long long now = clock_now();
    sum[phase] += now - start;
    start = now;
  }
  __device__ void flush(int lane) {
    if (lane == 0)
      for (int i = 0; i < kPhases; ++i) atomicAdd(&g_phase_clocks[i], sum[i]);
  }
};
#else
struct PhaseClock {
  __device__ void begin() {}
  __device__ void lap(Phase) {}
  __device__ void flush(int) {}
};
#endif

// NC: 64-column chunks of the head dim (ceil(D / 64))
template <int NC>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int hq,
                   int group, int t, int s, int causal, int window,
                   float scale) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [2][NC]
  const uint32_t k_s = q_s + 2 * NC * kChunkBytes;             // [stage][NC]
  const uint32_t v_s = k_s + 2 * NC * kChunkBytes;             // [stage][NC]
  // mbarriers: Q's, then per stage K full, V full and empty
  const uint32_t q_full = v_s + 2 * NC * kChunkBytes;
  const auto k_full = [=](int st) { return q_full + 8 + 24 * st; };
  const auto v_full = [=](int st) { return q_full + 16 + 24 * st; };
  const auto empty = [=](int st) { return q_full + 24 + 24 * st; };

  const int bh = blockIdx.x;               // b * hq + h
  const int kv_head = bh / hq * (hq / group) + bh % hq / group;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kQRows;
  const int q_off = s - t;                 // right alignment
  const TileRange cta = tile_range(q_off + i0,
                                   q_off + min(i0 + kQRows, t) - 1, s,
                                   causal, window);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && cta.begin < cta.end) {
      mbar_expect_tx(q_full, 2 * NC * kChunkBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < NC; ++c)
          tma_load(q_s + (half * NC + c) * kChunkBytes, &tq, q_full,
                   c * kChunkCols, i0 + 64 * half, bh);
      for (int tile = cta.begin; tile < cta.end; ++tile) {
        const int it = tile - cta.begin, st = it & 1;
        mbar_wait(empty(st), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(k_full(st), NC * kChunkBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(k_s + (st * NC + c) * kChunkBytes, &tk, k_full(st),
                   c * kChunkCols, tile * kKeys, kv_head);
        mbar_expect_tx(v_full(st), NC * kChunkBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(v_s + (st * NC + c) * kChunkBytes, &tv, v_full(st),
                   c * kChunkCols, tile * kKeys, kv_head);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int r0 = i0 + 64 * cw;               // first query row
    const int r_last = min(r0 + 64, t) - 1;    // last real query row
    const TileRange own =
        r0 <= r_last ? tile_range(q_off + r0, q_off + r_last, s, causal,
                                  window)
                     : TileRange{cta.end, cta.end};
    const int row = r0 + warp * 16 + lane / 4;  // and row + 8
    const int qp[2] = {q_off + row, q_off + row + 8};
    const float sl2 = scale * kLog2e;
    const uint32_t q_mine = q_s + cw * NC * kChunkBytes;

    // O, 64 x 64 NC: element i is row (i / 2) % 2 of this thread's two,
    // column 8 (i / 4) + 2 (lane % 4) + i % 2
    float acc[32 * NC];
#pragma unroll
    for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    PhaseClock clock;
    clock.begin();
    if (cta.begin < cta.end) mbar_wait(q_full, 0);
    clock.lap(kWaitQ);
    for (int tile = cta.begin; tile < cta.end; ++tile) {
      const int it = tile - cta.begin, st = it & 1;
      const uint32_t phase = (it >> 1) & 1;
      mbar_wait(k_full(st), phase);
      clock.lap(kWaitK);
      if (tile < own.begin || tile >= own.end) {
        // no row of this warpgroup reaches the tile
        mbar_wait(v_full(st), phase);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
        clock.lap(kSkipped);
        continue;
      }
      const int key0 = tile * kKeys;

      // descriptors advance by (bytes >> 4): 32 bytes a k-step of q and k
      // within a chunk, 2048 bytes (16 keys) a k-step of v
      const uint64_t dq = desc_sw128(q_mine, 16);
      const uint64_t dk = desc_sw128(k_s + st * NC * kChunkBytes, 16);
      float sc[32];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int off = (c * kChunkBytes + kk * 32) >> 4;
          wgmma_ss(sc, dq + off, dk + off, c + kk > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      clock.lap(kGemmS);

      // the mask is needed only where some key of the tile is refused to
      // some row of this warpgroup
      const bool edge = key0 + kKeys > s ||
                        (causal && key0 + kKeys - 1 > q_off + r0) ||
                        (window > 0 && key0 <= q_off + r_last - window);
      uint32_t p[16];
      float alpha[2];
      if (edge)
        online_softmax<true>(sc, p, m, l, alpha, key0, qp, s, causal, window,
                             sl2, lane);
      else
        online_softmax<false>(sc, p, m, l, alpha, key0, qp, s, causal,
                              window, sl2, lane);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32 * NC; ++i) acc[i] *= alpha[(i / 2) % 2];
      }
      clock.lap(kSoftmax);

      mbar_wait(v_full(st), phase);
      clock.lap(kWaitV);
      const uint64_t dv = desc_sw128(v_s + st * NC * kChunkBytes, kChunkBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<NC>(acc, p + 4 * kk, dv + ((kk * 2048) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      clock.lap(kGemmPV);
    }

    // epilogue: O / l, and 0 for a row that admitted no key
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float sum = quad_sum(l[hf]);
      inv[hf] = sum > 0.f ? 1.f / sum : 0.f;
    }
    // O goes out through this warpgroup's Q tile, which no wgmma reads
    // any more: written in TMA's 128-byte swizzled layout (conflict-free:
    // the 8 rows a store instruction covers sit in 8 different 16-byte
    // columns), then stored by one thread, which clips rows past t and
    // columns past d
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = warp * 16 + lane / 4 + 8 * hf;   // row in the tile
#pragma unroll
      for (int j = 0; j < 8 * NC; ++j) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf] * inv[hf],
                                  acc[4 * j + 2 * hf + 1] * inv[hf]);
        const uint32_t dst = q_mine + (j / 8) * kChunkBytes + r * 128 +
                             (((j % 8) ^ (r % 8)) << 4) + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                     "r"(*reinterpret_cast<const uint32_t*>(&h))
                     : "memory");
      }
    }
    // the writes, visible to the TMA unit, from all 128 threads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (threadIdx.x % 128 == 0 && r0 < t) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_store(&to, q_mine + c * kChunkBytes, c * kChunkCols, r0, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the CTA's shared memory stays until the stores have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    clock.lap(kEpilogue);
    clock.flush(lane);
  }
}

// cuTensorMapEncodeTiled, through the runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 (heads, rows, d) tensor as 64 x 64 boxes of one head, 128-byte
// swizzle; reads past rows or d give zeros. Returns 0 or a CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int heads, int rows,
               int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(max(rows, 1)),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d) * sizeof(bf16),
      static_cast<cuuint64_t>(max(rows, 1)) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {kChunkCols, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int t, int s, int d, int causal, int window,
                 float scale, cudaStream_t stream) {
  // with no keys (s == 0) no K or V tile is read; q stands in for their
  // empty storage so that the maps still encode
  CUtensorMap tq, tk, tv, to;
  int err = encode_map(&tq, q, b * hq, t, d);
  if (err == 0) err = encode_map(&to, o, b * hq, t, d);
  if (err == 0) err = encode_map(&tk, s > 0 ? k : q, b * hkv, s, d);
  if (err == 0) err = encode_map(&tv, s > 0 ? v : q, b * hkv, s, d);
  if (err != 0) return err;
  // the ring, Q, the barriers and the slack to align the first tile
  const size_t smem = 6 * NC * kChunkBytes + 64 + 1024;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(b * hq, (t + kQRows - 1) / kQRows);
  flash_wgmma_kernel<NC><<<grid, kWsThreads, smem, stream>>>(
      tq, tk, tv, to, hq, hq / hkv, t, s, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int t, int s, int d, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBT + 2 * kBS) * (d + 1) + kBT * (kBS + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBT - 1) / kBT, hq, b);
  flash_fma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hq / hkv, t,
      s, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// q (b, hq, t, d), k and v (b, hkv, s, d), o (b, hq, t, d), all contiguous
// on the device, float32 (dtype 0) or bfloat16 (dtype 1). hq % hkv == 0,
// 1 <= d <= 256, t >= 1; for bfloat16 also d % 8 == 0 and q, k, v 16-byte
// aligned (TMA's rule). Returns cudaGetLastError() after the launch
// (0 = launched), the CUresult of a tensor map that did not encode, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int b, int hq, int hkv, int t, int s,
                                      int d, int causal, int window,
                                      float scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || t < 1 || s < 0 || d < 1 ||
      d > kDMax || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fma(q, k, v, o, b, hq, hkv, t, s, d, causal, window, scale,
                      st);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (dtype != 1 || d % 8 != 0 || addr % 16 != 0 ||
      (t + kQRows - 1) / kQRows > 65535 ||
      static_cast<int64_t>(b) * hq > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // the head dim in 64-column chunks
  if (d <= 64)
    return launch_wgmma<1>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                           scale, st);
  if (d <= 128)
    return launch_wgmma<2>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                           scale, st);
  if (d <= 192)
    return launch_wgmma<3>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                           scale, st);
  return launch_wgmma<4>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                         scale, st);
}

#ifdef FLASH_PHASE_CLOCKS
// the consumer warps' clocks by phase (kPhases counters, see Phase) since
// the last call, which clears them; returns a cudaError_t
extern "C" int flash_attention_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks,
                                         sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
}
#endif
