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
// in no order, so here one CTA takes one (batch, query head, 64-row query
// tile) and walks the key tiles in a loop, with m, l and the accumulator
// in registers. The KV head is hq / (Hq / Hkv), as the
// Pallas index map computes it. Nothing is padded in memory: query rows
// past T and keys at k >= S are masked in the kernel. A key tile wholly
// outside [q_lo - window + 1, q_hi] is skipped; that is exact, because a
// fully masked tile leaves (m, l, acc) unchanged in the recurrence (a
// sliding-window layer at T = S = 2048 visits about 400 of 1024 tiles,
// a global causal one 528).
//
// Two kernels, chosen by the inputs' type:
//
// * bfloat16 (the model path): tensor cores through mma.sync m16n8k16
//   (bf16 in, f32 accumulate), FlashAttention-2's layout. 4 warps, each
//   owning 16 query rows of the 64-row tile. The q, k and v tiles sit in
//   shared memory as bf16 with the head dim padded with zeros to DP (a
//   multiple of 16: 240 stays 240), rows DP + 8 elements apart so every
//   ldmatrix is free of bank conflicts: 93 KB at D = 240, two CTAs per SM.
//   Scores stay in registers as mma accumulators; the softmax runs on them
//   (row max and sum over the 4 lanes that share a row), and the
//   probabilities, rounded to bf16 (the row sum l adds the rounded values,
//   so each output row stays a convex combination of v), are fed straight
//   back as the A operand of p.v, whose f32 accumulator (16 x DP per warp)
//   also stays in registers. Loads are plain 16-byte copies, not overlapped with the
//   math, and the tile walk is not pipelined: cp.async/TMA double
//   buffering and wgmma are the next design.
// * float32 (the tests' shapes): CUDA-core fmaf, with the q, k, v tiles
//   and the 64x64 probability tile in shared memory as float32 (about
//   200 KB at D = 240, one CTA per SM). 256 threads, 16 x 16: a thread
//   owns 4 query rows x 4 keys of the score tile and the same 4 rows x
//   ceil(D/16) output columns, so each row's rescale factor is in its own
//   registers. Row stride D + 1 keeps the key tile's column reads free of
//   bank conflicts. It keeps float32 products, which the tests' 2e-5
//   tolerance needs.
//
// Query tiles are taken in reverse order, so the causal grid's heaviest
// tiles start first.

#include <cstdint>
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

// ---- bfloat16: tensor cores (mma.sync m16n8k16) ------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;          // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + 64) of a (rows, d) bf16 matrix into a [64][DP + 8]
// shared tile, zero past `rows` and past column d. 16-byte copies when
// `vec` (d % 8 == 0 and 16-byte aligned rows), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int rows, int d,
                                          bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < 64 * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e - r * CH) * 8;
    uint4* out = reinterpret_cast<uint4*>(dst + r * LD + c);
    const bf16* in = src + (int64_t)(row0 + r) * d + c;
    if (row0 + r >= rows || c >= d) {
      *out = zero;
    } else if (vec) {
      *out = *reinterpret_cast<const uint4*>(in);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        tmp[x] = c + x < d ? in[x] : __float2bfloat16(0.f);
      *out = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                 int group, int t, int s, int d, int causal, int window,
                 float scale, int vec) {
  constexpr int LD = DP + 8;   // smem row stride (elements)
  constexpr int NT = DP / 8;   // 8-wide tiles of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* ks = qs + kBT * LD;                        // [64][LD]
  bf16* vs = ks + kBS * LD;                        // [64][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t q_base = ((int64_t)b * hq + h) * t * d;
  const int64_t kv_base = ((int64_t)b * (hq / group) + h / group) * s * d;
  const int q_off = s - t;
  const float sl2 = scale * kLog2e;   // scores in the log2 domain

  load_tile<DP>(qs, q + q_base, i0, t, d, vec);

  const int q_lo = q_off + i0;
  const int q_hi = q_off + min(i0 + kBT, t) - 1;
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(s - 1, q_hi) : s - 1;
  const int tile_begin = k_lo / kBS;
  const int tile_end = k_hi >= k_lo ? k_hi / kBS + 1 : tile_begin;

  // this thread's two rows of the warp's 16: r and r + 8
  const int r = warp * 16 + lane / 4;
  const int qp[2] = {q_off + i0 + r, q_off + i0 + r + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int key0 = tile * kBS;
    __syncthreads();
    load_tile<DP>(ks, k + kv_base, key0, s, d, vec);
    load_tile<DP>(vs, v + kv_base, key0, s, d, vec);
    __syncthreads();

    float sc[8][4];   // 8 key tiles of 8: (r, 2 keys), (r + 8, 2 keys)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nn], a, bk[0], bk[1]);
        mma_bf16(sc[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + j * 8 + (lane % 4) * 2 + e;
          const bool ok = key < s && (!causal || key <= qp[hf]) &&
                          (window <= 0 || key > qp[hf] - window);
          float& x = sc[j][2 * hf + e];
          x = ok ? x * sl2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hf], max4(mx));
      alpha[hf] = exp2f(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // rounded here, so l sums exactly the weights p.v multiplies
          float& x = sc[j][2 * hf + e];
          x = x > kNegInf ? __bfloat162float(__float2bfloat16(exp2f(x - m_new)))
                          : 0.f;
          sum += x;
        }
      l[hf] = alpha[hf] * l[hf] + sum4(sum);
      m[hf] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {     // 16 keys at a time
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  nn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nn], a, bv[0], bv[1]);
        mma_bf16(acc[2 * nn + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = i0 + r + 8 * hf;
    if (row >= t) continue;
    const float den = fmaxf(l[hf], 1e-30f);
    bf16* out = o + q_base + (int64_t)row * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + (lane % 4) * 2 + e;
        if (col < d) out[col] = __float2bfloat16(acc[n][2 * hf + e] / den);
      }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int t, int s, int d, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(kBT + 2 * kBS) * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = d % 8 == 0 && addr % 16 == 0;
  const dim3 grid((t + kBT - 1) / kBT, hq, b);
  flash_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hq / hkv, t, s,
      d, causal, window, scale, vec);
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
// 1 <= d <= 256, t >= 1. Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for arguments it does not take.
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // the head dim, padded to the smallest compiled multiple of 16
  if (d <= 16)
    return launch_mma<16>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                          scale, st);
  if (d <= 32)
    return launch_mma<32>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                          scale, st);
  if (d <= 64)
    return launch_mma<64>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                          scale, st);
  if (d <= 128)
    return launch_mma<128>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                           scale, st);
  if (d <= 240)
    return launch_mma<240>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                           scale, st);
  return launch_mma<256>(q, k, v, o, b, hq, hkv, t, s, d, causal, window,
                         scale, st);
}
