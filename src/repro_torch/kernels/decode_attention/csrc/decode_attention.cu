// decode_attention: one query token per sequence over a KV cache, GQA,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/decode_attention/decode_attention.py (launched by
// `decode_attention_pallas`).  The plain PyTorch version of the same
// function is ../ref.py; the two agree to f32 rounding.
//
// What it computes: q (B, Hq, D) against the cache-native k/v
// (B, S, Hkv, D), all contiguous; query head h = hk * G + g reads KV head
// hk (G = Hq / Hkv).  Cache rows at or past lengths[b] are masked (and
// never read); scores (q . k) / sqrt(D) in f32, an f32 streaming softmax,
// output acc / l in q's dtype -- 0 when lengths[b] == 0, the Pallas
// kernel's `l == 0` guard.  q and the cache may differ in dtype (an f32
// model keeps a bf16 cache, as the reference does).
//
// What bounds it on an H100: bytes.  At the serving slice's decode (8
// sequences, 8 KV heads, D 128, bf16, length 544) the K/V rows read are
// 8 x 544 x 8 x 128 x 2 x 2 = 17.8 MB -> 5.3 us at 3.35 TB/s; the
// products are 71 MFLOP, nothing.
//
// Design (simple first): one CTA of 256 threads per (KV head, sequence),
// so the G query heads of a group share every K/V tile read.  The TPU's
// sequential grid axis becomes a loop over cache tiles of 64 rows, up to
// lengths[b] only.  Each tile's K and V rows are staged in shared memory
// as f32 (K rows padded by one float, so the per-key dot products are
// bank-conflict free); the G x 64 scores go to shared memory, one warp
// per query head updates its running max and sum, and each thread
// rescales and accumulates its fixed (head, column) pairs of the G x D
// output in registers.
//
// What the simple design leaves on the table: only B x Hkv CTAs run (64
// at the slice's shape, on 132 SMs), each streaming its whole cache
// slice with synchronous loads and no double buffering, so the card's
// memory rate is far from reached.  A split-S (flash-decoding) grid with
// a second reduction pass, and TMA/cp.async pipelining, are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;            // cache rows per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxPairs = 16;      // (head, column) pairs per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int group, int d) {
  return sizeof(float) *
         ((size_t)group * d + kBS * (d + 1) + kBS * d + group * kBS +
          3 * group);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int32_t* __restrict__ lengths,
              TQ* __restrict__ o, int s_len, int n_kv_heads, int group,
              int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kp = d + 1;
  float* qs = smem;                  // group x d
  float* ks = qs + group * d;        // kBS x kp
  float* vs = ks + kBS * kp;         // kBS x d
  float* ps = vs + kBS * d;          // group x kBS: scores, then P
  float* m_s = ps + group * kBS;     // group: running max
  float* l_s = m_s + group;          // group: running sum
  float* a_s = l_s + group;          // group: this tile's rescale

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pairs = group * d;
  const int len = max(0, min(lengths[b], s_len));
  const long long row = (long long)n_kv_heads * d;   // cache row stride

  const long long qoff = ((long long)b * n_kv_heads + hk) * pairs;
  for (int i = tid; i < pairs; i += kThreads) qs[i] = to_f32(q[qoff + i]);
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;
  __syncthreads();

  const TKV* kb = k + (long long)b * s_len * row + (long long)hk * d;
  const TKV* vb = v + (long long)b * s_len * row + (long long)hk * d;
  for (int s0 = 0; s0 < len; s0 += kBS) {
    const int n = min(kBS, len - s0);
    for (int r = warp; r < n; r += kWarps) {
      const TKV* kr = kb + (long long)(s0 + r) * row;
      const TKV* vr = vb + (long long)(s0 + r) * row;
      for (int c = lane; c < d; c += 32) {
        ks[r * kp + c] = to_f32(kr[c]);
        vs[r * d + c] = to_f32(vr[c]);
      }
    }
    __syncthreads();

    // scores of every (head, row) of the tile
    for (int idx = tid; idx < group * kBS; idx += kThreads) {
      const int g = idx / kBS, j = idx - g * kBS;
      float sc = kNegInf;
      if (j < n) {
        const float* qg = qs + g * d;
        const float* kj = ks + j * kp;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qg[c], kj[c], dot);
        sc = dot * scale;
      }
      ps[idx] = sc;
    }
    __syncthreads();

    // streaming softmax, one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      float* pg = ps + g * kBS;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kBS; j += 32) {
        const float p = j < n ? expf(pg[j] - m_new) : 0.f;
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's (head, column) pairs
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < pairs) {
        const int g = idx / d, c = idx - g * d;
        const float* pg = ps + g * kBS;
        float a = acc[i] * a_s[g];
        for (int j = 0; j < n; ++j) a = fmaf(pg[j], vs[j * d + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();                 // before the next tile overwrites
  }

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < pairs) {
      const float l = l_s[idx / d];
      store(o + qoff + idx, acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v,
           const void* lengths, void* o, int batch, int s_len,
           int n_kv_heads, int group, int d, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(group, d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_kv_heads, batch);
  decode_kernel<TQ, TKV><<<grid, kThreads, bytes, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const int32_t*)lengths,
      (TQ*)o, s_len, n_kv_heads, group, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 float32, 1 bfloat16.  q (B, Hkv * group, D),
// k/v (B, S, Hkv, D), lengths (B,) int32 and o (like q), all contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int q_dtype, int kv_dtype,
                                    int batch, int s_len, int n_kv_heads,
                                    int group, int d, float scale,
                                    void* stream) {
  if (d < 1 || d > kMaxD || group < 1 || group * d > kThreads * kMaxPairs ||
      batch < 1 || batch > 65535 || s_len < 1 || n_kv_heads < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int which = q_dtype * 2 + kv_dtype;
  switch (which) {
    case 0:
      return launch<float, float>(q, k, v, lengths, o, batch, s_len,
                                  n_kv_heads, group, d, scale, s);
    case 1:
      return launch<float, __nv_bfloat16>(q, k, v, lengths, o, batch, s_len,
                                          n_kv_heads, group, d, scale, s);
    case 2:
      return launch<__nv_bfloat16, float>(q, k, v, lengths, o, batch, s_len,
                                          n_kv_heads, group, d, scale, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, lengths, o, batch, s_len, n_kv_heads, group, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
