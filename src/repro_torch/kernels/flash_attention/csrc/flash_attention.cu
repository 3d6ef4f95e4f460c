// flash_attention: blocked GQA attention forward (prefill), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// `flash_attention_pallas`).  The plain PyTorch version of the same
// function is ../ref.py; the two agree to f32 rounding.
//
// What it computes: q (B, Hq, S, D), k/v (B, Hkv, Sk, D), addressed
// through their batch/head/row strides with a contiguous last dimension;
// query head h reads KV head h / (Hq / Hkv).  Scores (q . k) / sqrt(D)
// in f32, an f32 online softmax (running max m, sum l, accumulator acc),
// output acc / l in the input dtype, 0 for a row with no unmasked column.
// Under `causal`, row r sees column c only when c <= r + (Sk - S) -- the
// offset of the reference's attention_ref (the wrapper rejects S > Sk).
// The ragged tails of S and Sk are masked here; nothing needs to divide
// a tile.
//
// What bounds it on an H100: at the serving slice's prefill
// (q 8 x 32 x 512 x 128, k/v 8 x 8 x 512 x 128, bf16, causal) the bytes
// are q + k + v + o = 83.9 MB -> 25.0 us at 3.35 TB/s, and the causal
// half of the two products is 17.2 GFLOP -> 17.4 us at the 989 TFLOP/s
// bf16 tensor-core peak.  So bytes bound it, barely.
//
// Design (simple first): one CTA of 256 threads per (q tile of 64 rows,
// q head, batch); the TPU's sequential 4th grid axis becomes a loop over
// KV tiles of 64 rows inside the CTA, so K/V of a head are streamed once
// per q tile and m, l and acc never leave registers.  Q, K and V tiles
// are staged in shared memory as f32 (rows padded by 4 floats so the
// float4 reads are bank-conflict free).  A 16 x 16 thread grid computes
// the 64 x 64 score tile, 4 x 4 per thread; each thread owns four query
// rows, so the row max / sum are 16-lane shuffles and the rescale of
// its 4 x 8 accumulator slice is local.  P goes through shared memory to
// the P.V product.  Tiles above the causal diagonal are never loaded.
//
// What the simple design leaves on the table: the products run on the
// f32 FMA pipes (67 TFLOP/s peak), not the tensor cores (wgmma, 989 bf16);
// loads are synchronous (no TMA / cp.async double buffering), so a tile's
// load is not overlapped with the previous tile's math; and the 119 KB
// of shared memory holds one CTA (8 warps) per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // KV rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxD = 128;
constexpr int kPS = kBK + 16;      // row stride of the P tile
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

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
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
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns 4 tx + 64 kk .. + 3
    const int n_valid = min(kBK, sk_len - k0);
    for (int j = 0; j < n_valid; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
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
    for (int kk = 0; kk < 2; ++kk)
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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  Strides are in
// elements: (batch, head, row) for q, k, v, then o.  Returns the CUDA
// error of the launch (0 on success).
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
    return launch<float>(q, k, v, o, batch, n_heads, n_kv_heads, s_len,
                         sk_len, d, st, causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, batch, n_heads, n_kv_heads,
                                 s_len, sk_len, d, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
