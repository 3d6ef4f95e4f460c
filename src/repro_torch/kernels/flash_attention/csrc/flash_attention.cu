// flash_attention: blocked GQA attention forward (prefill), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// `flash_attention_pallas`).  The plain PyTorch version of the same
// function is ../ref.py.
//
// What it computes: q (B, Hq, S, D), k/v (B, Hkv, Sk, D), addressed
// through their batch/head/row strides with a contiguous last dimension;
// query head h reads KV head h / (Hq / Hkv).  Scores (q . k) / sqrt(D),
// an f32 online softmax (running max m, sum l, accumulator acc), output
// acc / l in the input dtype, 0 for a row with no unmasked column.  Under
// `causal`, row r sees column c only when c <= r + (Sk - S) -- the offset
// of the reference's attention_ref (the wrapper rejects S > Sk).  The
// ragged tails of S and Sk are masked here; nothing needs to divide a
// tile.
//
// What bounds it on an H100: at granite's prefill (q 8 x 32 x 512 x 128,
// k/v 8 x 8 x 512 x 128, bf16, causal) the bytes, 83.9 MB -> 25.0 us at
// 3.35 TB/s, barely over the causal half of the two products, 17.2 GFLOP
// -> 17.4 us at the 989 TFLOP/s bf16 tensor-core peak.  At the Jamba
// cut's (q 8 x 64 x 2048 x 128 over 8 KV heads) the products bound it:
// 550 GFLOP -> 0.556 ms.  At deepseek-v2's MLA prefill (q, k, v and o
// each 8 x 128 x 512 x 192, V zero-padded from 128) the bytes again:
// 805 MB -> 0.240 ms, over 103 GFLOP -> 0.104 ms.
//
// Two kernels, chosen by dtype in the wrapper:
//
// * bf16 (`tc::flash_fwd_tc`, the serving path): the products on the
//   tensor cores with wgmma, loads overlapped with the math.  One CTA of
//   two warpgroups per (128-row q tile, q head, batch); the heaviest
//   causal q tiles are scheduled first (the q tile is the slowest grid
//   axis, walked in reverse).  Q and a two-stage ring of K/V tiles sit in
//   shared memory in the 128-byte-swizzled layout that wgmma reads, D
//   zero-padded to a whole number of 64-column swizzle atoms; every
//   thread copies its 16-byte chunks with cp.async (zero-filling the
//   ragged rows and the padded columns), and tile j+1 is in flight while
//   tile j's products and softmax run.  Each warpgroup owns 64 q rows:
//   S = Q K^T is D/16 wgmma m64nBNk16 with both operands in shared memory
//   and the f32 scores in registers; the online softmax runs on those
//   registers (ex2.approx with log2(e)/sqrt(D) folded into one multiply,
//   row max and sum over the 4 lanes sharing a row); P is rounded to bf16
//   in registers and is the A operand of the BN/16 wgmma m64n(64 NA)k16
//   of O += P V, with V read from shared memory as an MN-major B operand.
//   P never touches shared memory.  The causal mask is applied only on
//   tiles that cross the diagonal or Sk, and tiles above the diagonal are
//   never loaded.  The output goes through shared memory (the
//   warpgroup's own Q rows) to 16-byte stores.  Warpgroup 1 issues its
//   Q K^T after warpgroup 0's (a named barrier), so that one's softmax
//   overlaps the other's products.  Two instantiations, (NA column atoms,
//   BN KV rows a tile):
//   - D <= 128: (2, 128).  Q 32 KB + 2 x (K, V) of 32 KB = 161 KB of
//     shared memory; S and O 64 f32 registers each (255 a thread in all).
//   - 128 < D <= 192 (MLA's nope 128 + rope 64): (3, 64).  A 128-row tile
//     of 192 columns is 48 KB, so 128-row K/V tiles would need 240 KB, and
//     O (96 registers) beside a 64-register S would spill; 64-row K/V
//     tiles halve S to 32 registers (m64n64k16, 12 k-steps) and the ring
//     to 2 x (24 + 24) KB: 145 KB in all.  O is one m64n192k16 a k-step.
//   What it leaves on the table: the copies are cp.async issued by the
//   consumers themselves (not TMA from a producer warp); within a
//   warpgroup the softmax does not overlap the next tile's Q K^T; the two
//   warpgroups meet at a CTA barrier on every tile; and at D 192 the zero
//   columns of MLA's padded V are multiplied (a kernel taking Dv < Dqk
//   would skip a third of the P V products).
// * f32 (`simt::flash_fwd_kernel`): the tensor cores cannot meet the f32
//   tolerance (rel err 5e-5; bf16 or tf32 operands keep 8 or 10 mantissa
//   bits), so f32 runs the first port's SIMT kernel on the f32 FMA pipes:
//   one CTA of 256 threads per (64-row q tile, q head, batch), Q, K and V
//   tiles of 64 rows staged as f32 in shared memory (167 KB at D 192), a
//   16 x 16 thread grid of 4 x 4 scores and 4 x 12 outputs, P through
//   shared memory.  No serving path runs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 192;

namespace simt {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // KV rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPS = kBK + 16;      // row stride of the P tile
constexpr int kCols = kMaxD / 64;  // 64-column groups of the output
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch
}

// rows [0, 64) of a tile into dst (row stride dp floats), as f32; rows at
// or past `rows_valid` and columns at or past d are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride,
                                          int rows_valid, int d, int d4,
                                          int dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < 64; r += kThreads / 32) {
    const bool rv = r < rows_valid;
    const T* row = src + (rv ? (long long)r * row_stride : 0);
    for (int c = lane; c < d4; c += 32)
      dst[r * dp + c] = (rv && c < d) ? to_f32(row[c]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_heads,
                 int n_kv_heads, int s_len, int sk_len, int d,
                 long long qsb, long long qsh, long long qss, long long ksb,
                 long long ksh, long long kss, long long vsb, long long vsh,
                 long long vss, long long osb, long long osh, long long oss,
                 int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int dp = d4 + 4;
  float* qs = smem;                  // kBQ x dp
  float* ks = qs + kBQ * dp;         // kBK x dp
  float* vs = ks + kBK * dp;         // kBK x dp
  float* ps = vs + kBK * dp;         // kBQ x kPS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int off = sk_len - s_len;    // causal offset, >= 0

  const T* qb = q + b * qsb + h * qsh + q0 * qss;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  load_tile(qs, qb, qss, min(kBQ, s_len - q0), d, d4, dp);

  int n_tiles = (sk_len + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, s_len) - 1 + off;
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's reads are done
    load_tile(ks, kb + k0 * kss, kss, min(kBK, sk_len - k0), d, d4, dp);
    load_tile(vs, vb + k0 * vss, vss, min(kBK, sk_len - k0), d, d4, dp);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * dp + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * dp + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int pos = q0 + row + off;          // absolute query position
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = col < sk_len && (!causal || col <= pos);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[row * kPS + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns 4 tx + 64 kk .. + 3
    const int n_valid = min(kBK, sk_len - k0);
    for (int j = 0; j < n_valid; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int kk = 0; kk < kCols; ++kk) {
        const int c = 4 * tx + 64 * kk;
        if (c < d4) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * dp + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * kk + 0] = fmaf(p[i], vv.x, acc[i][4 * kk + 0]);
            acc[i][4 * kk + 1] = fmaf(p[i], vv.y, acc[i][4 * kk + 1]);
            acc[i][4 * kk + 2] = fmaf(p[i], vv.z, acc[i][4 * kk + 2]);
            acc[i][4 * kk + 3] = fmaf(p[i], vv.w, acc[i][4 * kk + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s_len) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + b * osb + h * osh + r * oss;
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * tx + 64 * kk + e;
        if (c < d) store(orow + c, acc[i][4 * kk + e] / li);
      }
  }
}

size_t smem_bytes(int d) {
  const int dp = ((d + 3) & ~3) + 4;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * dp + kBQ * kPS);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int s_len, int sk_len, int d,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_len + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n_heads, n_kv_heads,
      s_len, sk_len, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // q rows per CTA (2 warpgroups)
constexpr int kThreads = 256;

// The shared-memory plan of one instantiation: NA 64-column swizzle atoms
// a row (D <= 64 NA), BN KV rows a tile.  An atom of R rows is R x 128
// bytes; a tile is NA atoms side by side.
template <int NA, int BN>
struct Plan {
  static constexpr int kQAtom = kBM * 128;
  static constexpr int kKVAtom = BN * 128;
  static constexpr int kQTile = NA * kQAtom;
  static constexpr int kKVTile = NA * kKVAtom;
  // Q, 2 stages of (K, V), and room to align to 1024 bytes
  static constexpr int kSmem = kQTile + 2 * 2 * kKVTile + 1024;
  static constexpr int kSRegs = BN / 2;  // S = Q K^T, f32 a thread
  static constexpr int kORegs = NA * 32; // O, f32 a thread
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of ROWS
// rows: 64-column atoms of ROWS x 128 bytes, chunks XOR-swizzled by row % 8
// (the 128-byte swizzle that wgmma's descriptors and TMA use)
template <int ROWS>
__device__ __forceinline__ uint32_t sw(int row, int chunk) {
  return (chunk >> 3) * (ROWS * 128) + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's generic-proxy shared-memory accesses with wgmma's
// (async-proxy) ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [0, rows_valid) of a ROWS-row tile, columns [0, d), as 16-byte
// cp.async chunks; the other rows and columns (up to 64 NA) are
// zero-filled
template <int ROWS, int NA>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long row_stride,
                                          int rows_valid, int d) {
  constexpr int kChunks = NA * 8;        // 16-byte chunks a row
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = i / kChunks, chunk = i % kChunks;
    const bool ok = row < rows_valid && chunk * 8 < d;
    cp_async16(dst + sw<ROWS>(row, chunk),
               src + (ok ? row * row_stride + chunk * 8 : 0), ok ? 16 : 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading byte offset (between 64-column atoms of an MN-major operand;
// unused by a K-major one) and the stride byte offset (between 8-row
// groups), all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_D96                                                          \
  WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
#define WG_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_R96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

// d (64 x 128, f32) (+)= A (64 x 16, K-major in shared memory)
//                       * B (16 x 128, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory)
//                      * B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers)
//                      * B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192, f32) += A (64 x 16, bf16 in registers)
//                      * B (16 x 192, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_R96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_D96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// 2^x on the SFU alone (exp2f adds a subnormal fix-up around it; a
// probability below 2^-126 flushes to 0, far under bf16's resolution)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of a wgmma m64nN (per warpgroup thread t: warp
// w = t / 32, lane l): register i holds row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2.  So each thread holds two rows
// ("halves" r = 0, 1) and the 4 lanes of a quad share them.
template <int NA, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int n_heads,
             int n_kv_heads, int s_len, int sk_len, int d, long long qsb,
             long long qsh, long long qss, long long ksb, long long ksh,
             long long kss, long long vsb, long long vsh, long long vss,
             long long osb, long long osh, long long oss, int causal,
             float scale_log2) {
  using P = Plan<NA, BN>;
  constexpr int SR = P::kSRegs, OR = P::kORegs;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t s_q = base, s_kv = base + P::kQTile;  // stage: K, then V

  const int h = blockIdx.x, b = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // heaviest first
  const int hk = h / (n_heads / n_kv_heads);
  const int off = sk_len - s_len;                      // causal offset
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);  // half 0's row

  int n_end = sk_len;
  if (causal) n_end = min(sk_len, min(m0 + kBM, s_len) + off);
  const int n_tiles = (n_end + BN - 1) / BN;

  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  load_tile<kBM, NA>(s_q, q + b * qsb + h * qsh + m0 * qss, qss, s_len - m0,
                     d);
  load_tile<BN, NA>(s_kv, kb, kss, sk_len, d);
  load_tile<BN, NA>(s_kv + P::kKVTile, vb, vss, sk_len, d);
  cp_async_commit();

  float acc[OR], m[2], l[2];
#pragma unroll
  for (int i = 0; i < OR; ++i) acc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t s_k = s_kv + (j & 1) * 2 * P::kKVTile;
    const uint32_t s_v = s_k + P::kKVTile;
    if (j + 1 < n_tiles) {
      const int n1 = (j + 1) * BN;
      const uint32_t nk = s_kv + ((j + 1) & 1) * 2 * P::kKVTile;
      load_tile<BN, NA>(nk, kb + n1 * kss, kss, sk_len - n1, d);
      load_tile<BN, NA>(nk + P::kKVTile, vb + n1 * vss, vss, sk_len - n1, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T over D in steps of 16 (the padded columns are skipped)
    // warpgroup 1 issues after warpgroup 0, so that one's softmax runs
    // while the other's product is on the tensor cores
    float s[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) s[i] = 0.f;
    if (wg == 1) asm volatile("bar.sync 3, 256;\n" ::: "memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      if (kk * 16 < d) {
        const uint32_t col = (kk & 3) * 32;
        wgmma_ss(s,
                 desc(s_q + wg * 64 * 128 + (kk >> 2) * P::kQAtom + col, 16,
                      1024),
                 desc(s_k + (kk >> 2) * P::kKVAtom + col, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    if (wg == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    wgmma_wait();
    fence_regs(s);

    // mask (only tiles crossing Sk or this warpgroup's diagonal)
    const int n0 = j * BN;
    if (n0 + BN > sk_len || (causal && n0 + BN - 1 > m0 + wg * 64 + off)) {
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= sk_len || (causal && col > row + off)) s[i] = -INFINITY;
      }
    }

    // online softmax on the registers; rescale the accumulator
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < SR; ++i)
        if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2((m[r] - m_use) * scale_log2);
      const float bias = m_use * scale_log2;
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < SR; ++i)
        if (((i >> 1) & 1) == r) {
          s[i] = ex2(fmaf(s[i], scale_log2, -bias));
          sum += s[i];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int i = 0; i < OR; ++i)
        if (((i >> 1) & 1) == r) acc[i] *= alpha;
    }

    // O += P V: P in bf16 registers as the A operand (k = the tile's rows)
    uint32_t p[BN / 4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, p + 4 * kk, desc(s_v + kk * 16 * 128, P::kKVAtom, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_proxy_async();
    __syncthreads();              // both warpgroups are done with the stage
  }

  // normalise, stage the warpgroup's 64 rows in its own Q rows, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
#pragma unroll
  for (int i = 0; i < OR; i += 2) {
    const int half = (i >> 1) & 1;
    const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(smem + sw<kBM>(row, col >> 3) +
                                 (col & 7) * 2) =
        pack_bf16(acc[i] * l[half], acc[i + 1] * l[half]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  bf16* ob = o + b * osb + h * osh;
  constexpr int kChunks = NA * 8;
#pragma unroll
  for (int it = 0; it < 64 * kChunks / 128; ++it) {
    const int i = t + it * 128;
    const int row = i / kChunks, chunk = i % kChunks;
    const int grow = m0 + wg * 64 + row;
    if (grow < s_len && chunk * 8 < d)
      *reinterpret_cast<uint4*>(ob + grow * oss + chunk * 8) =
          *reinterpret_cast<const uint4*>(smem +
                                          sw<kBM>(wg * 64 + row, chunk));
  }
}

template <int NA, int BN>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int s_len, int sk_len, int d,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = Plan<NA, BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<NA, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_heads, batch, (s_len + kBM - 1) / kBM);
  flash_fwd_tc<NA, BN><<<grid, kThreads, kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n_heads,
      n_kv_heads, s_len, sk_len, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (the SIMT kernel), 1 bfloat16 (the tensor-core
// kernel), for q, k, v and o alike.  Strides are in elements: (batch,
// head, row) for q, k, v, then o.  The bf16 kernel needs d % 8 == 0 and
// 16-byte aligned rows (the wrapper checks and names the constraint).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int n_heads, int n_kv_heads, int s_len, int sk_len, int d,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int causal,
    float scale, void* stream) {
  if (d < 1 || d > kMaxD || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      batch < 1 || s_len < 1 || sk_len < 1 || (causal && s_len > sk_len) ||
      batch > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return simt::launch<float>(q, k, v, o, batch, n_heads, n_kv_heads,
                               s_len, sk_len, d, st, causal, scale, s);
  if (dtype == 1) {
    for (long long x : st)
      if (x % 8) return (int)cudaErrorInvalidValue;
    if (d % 8 || (s_len + tc::kBM - 1) / tc::kBM > 65535)
      return (int)cudaErrorInvalidValue;
    // D <= 128: two column atoms, 128-row K/V tiles; up to 192: three
    // column atoms, 64-row K/V tiles (see the header)
    if (d <= 128)
      return tc::launch<2, 128>(q, k, v, o, batch, n_heads, n_kv_heads,
                                s_len, sk_len, d, st, causal, scale, s);
    return tc::launch<3, 64>(q, k, v, o, batch, n_heads, n_kv_heads, s_len,
                             sk_len, d, st, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
