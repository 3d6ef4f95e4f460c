// decode_attention: one query token per sequence over a KV cache, GQA,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/decode_attention/decode_attention.py (launched by
// `decode_attention_pallas`).  The plain PyTorch versions of the same
// function are ../ref.py: `decode_attention_ref` (one pass over the
// cache) and `decode_attention_split_ref` (the kernels' two stages); all
// agree to the rounding of the products' inputs.
//
// What it computes: q (B, Hq, D) against the cache-native k/v
// (B, S, Hkv, D), all contiguous; query head h = hk * G + g reads KV head
// hk (G = Hq / Hkv).  Cache rows at or past lengths[b] are masked (and
// never read); scores (q . k) / sqrt(D), an f32 streaming softmax,
// output acc / l in q's dtype -- 0 when lengths[b] == 0, the Pallas
// kernel's `l == 0` guard.  q and the cache may differ in dtype (an f32
// model keeps a bf16 cache, as the reference does).
//
// What bounds it on an H100: bytes.  At granite's decode (8 sequences, 8
// KV heads, D 128, bf16, length 544) the K/V rows read are 17.8 MB ->
// 5.3 us at 3.35 TB/s; at the Jamba cut's (2080 rows) 68.2 MB -> 20.4 us.
// The products are a few hundred MFLOP, nothing -- unless they run on
// the f32 pipes with their operands re-read from shared memory, where
// the instructions alone take as long as the bytes.
//
// Design: split-S (flash-decoding) in one launch.  The grid is
// (n_split, Hkv x head tiles, B); each CTA owns `rows_per_split` cache
// rows (a multiple of the 64-row tile) of one (sequence, KV head), for
// the query heads of that KV head, so they share every K/V read.  The
// split plan comes from the host (`ops.split_plan`: S, B, Hkv and the SM
// count only -- reading `lengths` there would cost a host sync per
// layer); a CTA whose rows start at or past lengths[b] writes an empty
// partial (m = -inf, l = 0) and reads nothing.  K and V tiles are copied
// with 16-byte cp.async (8 bf16 a lane, consecutive lanes on consecutive
// chunks of a row) and stay in the cache's dtype in shared memory,
// 16-byte chunks XOR-swizzled by row so that row-parallel and
// column-parallel reads are both conflict-free.  Each CTA writes its
// partial (m, l, acc) in f32 to scratch; the last CTA of a (b, hk) to
// arrive -- an arrival counter bumped after a __threadfence -- combines
// the partials by log-sum-exp, writes the output, and resets the counter
// to 0 for the next launch.  With one split the CTA writes the output
// directly.  Two kernels, by dtype:
//
// * bf16 q over a bf16 cache (`tc::decode_kernel_tc`, the serving path):
//   the products on the tensor cores with mma.sync m16n8k16.  The G query
//   heads of a KV head are the 16 rows of the A operand (a KV head with G
//   > 16 gets one CTA per 16 heads); 4 warps each own 16 rows of every
//   64-row tile: S = Q K^T from ldmatrix fragments, an online softmax on
//   the registers (exp2, log2(e)/sqrt(D) folded into one multiply), P
//   rounded to bf16 in registers as the A operand of O += P V, V through
//   ldmatrix.trans.  Each warp keeps its own (m, l, O) over the split;
//   the four meet by log-sum-exp at the end.  The copy ring has two
//   slots, a K tile and a V tile, each its own cp.async group: Q K^T
//   starts while V is in flight, and each slot is refilled with the next
//   tile's rows as soon as every warp is done with it.  (A ring of two
//   whole K/V tiles doubles the shared memory, holds 3 CTAs per SM
//   instead of 5, and measured slower at the Jamba cut's decode.)
// * f32 q or an f32 cache (`simt::decode_kernel`): the f32 pipes, since
//   bf16 products cannot meet the f32 tolerance (rel err 5e-5).  256
//   threads: scores one thread per (row, 4 heads) with q pre-scaled in
//   shared memory, softmax one warp per head, P V one thread per (16-byte
//   column chunk, heads, row group) in registers; a ring of two K/V tiles
//   when a split has more than one.  No serving path runs it.
//
// What it leaves on the table: the last CTA's combine is serial after
// the split CTAs (it reads n_split partials of G x D f32 from L2); the
// tensor-core kernel pads G to 16 rows; and the arrival counters make
// two launches on two streams that share the counter buffer unsafe (the
// port decodes on one stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;            // cache rows per tile
constexpr int kMaxD = 128;
constexpr int kMaxGroup = 128;
constexpr int kMaxSplits = 32;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// the 16-byte chunk `c` of row `r` of a tile whose rows are `pitch`
// chunks (a multiple of 8) apart: chunks XOR-swizzled by r % 8
__device__ __forceinline__ int chunk_at(int r, int c, int pitch) {
  return r * pitch + (c ^ (r & 7));
}

// cache rows [s0, s0 + 64) of one head into a tile (rows at or past c1
// and chunks at or past nch zero-filled), `nchp` 16-byte cp.async chunks
// a row
template <typename TKV>
__device__ __forceinline__ void copy_rows(uint4* dst, const TKV* src,
                                          long long row, int s0, int c1,
                                          int nch, int nchp, int pitch) {
  constexpr int kEpc = 16 / sizeof(TKV);
  for (int i = threadIdx.x; i < kBS * nchp; i += blockDim.x) {
    const int r = i / nchp, c = i - r * nchp;
    const bool ok = s0 + r < c1 && c < nch;
    cp_async16(dst + chunk_at(r, c, pitch),
               src + (ok ? (s0 + r) * row + c * kEpc : 0), ok ? 16 : 0);
  }
}

// The end of every CTA: acc_s (heads x d f32, not yet divided by l),
// m_s (log2 domain) and l_s in shared memory.  With one split, the
// output; else this split's partial -- an empty split writes m = -inf,
// l = 0 only -- and, in the last CTA of its (b, hk) to arrive, the
// log-sum-exp combine of every split.  `slot` is the heads' stride in the
// partials; w_s holds n_split x heads floats.
template <typename TQ>
__device__ void finish(const float* acc_s, float* m_s, const float* l_s,
                       float* w_s, int* last_s, bool empty, TQ* out,
                       float2* part_ml, float* part_acc, int* counters,
                       int pair, int split, int n_split, int heads, int slot,
                       int d) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = nthreads >> 5;
  if (n_split == 1) {
    for (int i = tid; i < heads * d; i += nthreads) {
      const float l = l_s[i / d];
      store(out + i, l == 0.f ? 0.f : acc_s[i] / l);
    }
    return;
  }
  const long long part = (long long)pair * n_split + split;
  for (int g = tid; g < heads; g += nthreads)
    part_ml[part * slot + g] = make_float2(m_s[g], l_s[g]);
  if (!empty)
    for (int i = tid * 4; i < heads * d; i += nthreads * 4)
      *reinterpret_cast<float4*>(part_acc + part * slot * d + i) =
          *reinterpret_cast<const float4*>(acc_s + i);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;

  __threadfence();
  if (tid == 0) counters[pair] = 0;  // ready for the next launch
  const float2* ml = part_ml + (long long)pair * n_split * slot;
  for (int g = warp; g < heads; g += n_warps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float2 x = __ldcg(ml + sp * slot + g);
      if (x.y > 0.f) mx = fmaxf(mx, x.x);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float2 x = __ldcg(ml + sp * slot + g);
      const float w = x.y > 0.f ? exp2f(x.x - mx) : 0.f;
      w_s[sp * heads + g] = w;
      l += w * x.y;
    }
    l = warp_sum(l);
    if (lane == 0) m_s[g] = l == 0.f ? 0.f : 1.f / l;
  }
  __syncthreads();
  const float* pa = part_acc + (long long)pair * n_split * slot * d;
  for (int i = tid * 4; i < heads * d; i += nthreads * 4) {
    const int g = i / d;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < n_split; sp0 += 8) {
      float w[8];
      float4 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {      // eight loads in flight at once
        const int sp = sp0 + j;
        w[j] = sp < n_split ? w_s[sp * heads + g] : 0.f;
        x[j] = w[j] > 0.f ? __ldcg(reinterpret_cast<const float4*>(
                                pa + (long long)sp * slot * d + i))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum.x = fmaf(w[j], x[j].x, sum.x);
        sum.y = fmaf(w[j], x[j].y, sum.y);
        sum.z = fmaf(w[j], x[j].z, sum.z);
        sum.w = fmaf(w[j], x[j].w, sum.w);
      }
    }
    const float inv = m_s[g];
    store(out + i, sum.x * inv);
    store(out + i + 1, sum.y * inv);
    store(out + i + 2, sum.z * inv);
    store(out + i + 3, sum.w * inv);
  }
}

namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the 16/sizeof(T) values of a 16-byte chunk, as f32
__device__ __forceinline__ void unpack(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename TKV>
struct Layout {
  static constexpr int kEpc = 16 / sizeof(TKV);   // values per chunk
  // heads per thread in P V: G * D <= 4096 needs 4 for bf16 and 8 for
  // f32 at any D (see the wrapper's limits)
  static constexpr int kHeads = sizeof(TKV) == 2 ? 4 : 8;
};

size_t smem_bytes(int chunk_bytes_per_tile, int stages, int group, int d) {
  return (size_t)stages * 2 * chunk_bytes_per_tile +
         sizeof(float) * ((size_t)group * d + group * kBS + 3 * group) + 16;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int32_t* __restrict__ lengths,
              TQ* __restrict__ o, float2* __restrict__ part_ml,
              float* __restrict__ part_acc, int* __restrict__ counters,
              int s_len, int n_kv_heads, int group, int d, float scale_log2,
              int rows_per_split, int stages) {
  constexpr int kEpc = Layout<TKV>::kEpc;
  constexpr int kHeads = Layout<TKV>::kHeads;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nch = d / kEpc;                 // 16-byte chunks per row
  const int pitch = (nch + 7) & ~7;
  const int tile_chunks = kBS * pitch;
  uint4* ring = reinterpret_cast<uint4*>(smem);   // stages x (K, V)
  float* qs = reinterpret_cast<float*>(ring + stages * 2 * tile_chunks);
  float* ps = qs + group * d;               // group x kBS: scores, then P
  float* m_s = ps + group * kBS;            // running max (log2 domain)
  float* l_s = m_s + group;                 // running sum
  float* a_s = l_s + group;                 // this tile's rescale
  int* last_s = reinterpret_cast<int*>(a_s + group);

  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = max(0, min(lengths[b], s_len));
  const int c0 = split * rows_per_split;
  const int c1 = min(c0 + rows_per_split, len);
  const int n_t = c1 > c0 ? (c1 - c0 + kBS - 1) / kBS : 0;
  const int pair = b * n_kv_heads + hk;
  const long long row = (long long)n_kv_heads * d;   // cache row stride
  const TKV* kb = k + (long long)b * s_len * row + (long long)hk * d;
  const TKV* vb = v + (long long)b * s_len * row + (long long)hk * d;

  auto issue = [&](int t) {                 // tile t into stage t % stages
    uint4* ks = ring + (t % stages) * 2 * tile_chunks;
    copy_rows(ks, kb, row, c0 + t * kBS, c1, nch, nch, pitch);
    copy_rows(ks + tile_chunks, vb, row, c0 + t * kBS, c1, nch, nch, pitch);
    cp_async_commit();
  };
  for (int t = 0; t < min(stages, n_t); ++t) issue(t);

  const long long qoff = (long long)pair * group * d;
  for (int i = tid; i < group * d; i += kThreads)
    qs[i] = to_f32(q[qoff + i]) * scale_log2;
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  // P V ownership: a 16-byte column chunk pc, heads hg, hg + n_hg, ...
  // and rows rg, rg + n_rg, ... of each tile.  Row groups keep every
  // thread busy when G x chunks < 256; their sums meet at the end.
  const int n_u = kThreads / nch;
  const int n_hg = min(group, n_u), n_rg = n_u / n_hg;
  const int pc = tid % nch, u = tid / nch;
  const int hg = u % n_hg, rg = u / n_hg;
  const bool pv = u < n_hg * n_rg;
  float acc[kHeads][kEpc];
#pragma unroll
  for (int i = 0; i < kHeads; ++i)
#pragma unroll
    for (int e = 0; e < kEpc; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    if (stages > 1 && t + 1 < n_t)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const TKV* ks = reinterpret_cast<const TKV*>(
        ring + (t % stages) * 2 * tile_chunks);
    const TKV* vs = ks + tile_chunks * kEpc;
    const int s0 = c0 + t * kBS;

    // scores (log2 domain) of row sr for heads sg, sg + 4, ...
    {
      const int sr = tid & (kBS - 1), sg = tid / kBS;
      const bool valid = s0 + sr < c1;
      for (int g0 = sg; g0 < group; g0 += 16) {
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < nch; ++c) {
          float kx[kEpc];
          unpack(ks + chunk_at(sr, c, pitch) * kEpc, kx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int g = g0 + 4 * i;
            if (g < group) {
              const float* qg = qs + g * d + c * kEpc;
#pragma unroll
              for (int e = 0; e < kEpc; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                dot[i] = fmaf(qv.x, kx[e], dot[i]);
                dot[i] = fmaf(qv.y, kx[e + 1], dot[i]);
                dot[i] = fmaf(qv.z, kx[e + 2], dot[i]);
                dot[i] = fmaf(qv.w, kx[e + 3], dot[i]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = g0 + 4 * i;
          if (g < group) ps[g * kBS + sr] = valid ? dot[i] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // streaming softmax, one warp per head
    for (int g = warp; g < group; g += kWarps) {
      float* pg = ps + g * kBS;
      const float x0 = pg[lane], x1 = pg[lane + 32];
      const float mx = warp_max(fmaxf(x0, x1));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(x0 - m_use), p1 = exp2f(x1 - m_use);
      pg[lane] = p0;
      pg[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's chunk, heads and rows
    if (pv) {
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        const int g = hg + n_hg * i;
        if (g < group) {
          const float alpha = a_s[g];
#pragma unroll
          for (int e = 0; e < kEpc; ++e) acc[i][e] *= alpha;
        }
      }
      const int n_rows = min(kBS, c1 - s0);
      for (int j = rg; j < n_rows; j += n_rg) {
        float vx[kEpc];
        unpack(vs + chunk_at(j, pc, pitch) * kEpc, vx);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          const int g = hg + n_hg * i;
          if (g < group) {
            const float p = ps[g * kBS + j];
#pragma unroll
            for (int e = 0; e < kEpc; ++e)
              acc[i][e] = fmaf(p, vx[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();                 // before the stage and P are reused
    if (t + stages < n_t) issue(t + stages);
  }
  __syncthreads();                   // m_s / l_s of an empty split too

  // the row groups' sums (one head per thread when n_rg > 1) meet in
  // the ring, whose copies are all complete, beyond acc_s (G x D)
  float* acc_s = reinterpret_cast<float*>(ring);
  const bool owner = pv && rg == 0;
  if (n_rg > 1 && n_t > 0) {
    if (pv && rg > 0) {
      float* dst = acc_s + ((rg * group + hg) * d + pc * kEpc);
#pragma unroll
      for (int e = 0; e < kEpc; ++e) dst[e] = acc[0][e];
    }
    __syncthreads();
    if (owner) {
      for (int r = 1; r < n_rg; ++r) {
        const float* src = acc_s + ((r * group + hg) * d + pc * kEpc);
#pragma unroll
        for (int e = 0; e < kEpc; ++e) acc[0][e] += src[e];
      }
    }
  }
  if (owner) {
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int g = hg + n_hg * i;
      if (g < group) {
#pragma unroll
        for (int e = 0; e < kEpc; ++e)
          acc_s[g * d + pc * kEpc + e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  finish(acc_s, m_s, l_s, ps, last_s, n_t == 0, o + qoff, part_ml,
         part_acc, counters, pair, split, n_split, group, group, d);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v,
           const void* lengths, void* o, void* part_ml, void* part_acc,
           void* counters, int batch, int s_len, int n_kv_heads, int group,
           int d, float scale, int rows_per_split, int n_split,
           cudaStream_t stream) {
  constexpr int kEpc = Layout<TKV>::kEpc;
  const int nch = d / kEpc;
  const int n_u = kThreads / nch;
  if (d % kEpc || group > Layout<TKV>::kHeads * n_u)
    return (int)cudaErrorInvalidValue;
  const int stages = rows_per_split > kBS ? 2 : 1;
  const size_t bytes =
      smem_bytes(kBS * ((nch + 7) & ~7) * 16, stages, group, d);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_split, n_kv_heads, batch);
  decode_kernel<TQ, TKV><<<grid, kThreads, bytes, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const int32_t*)lengths,
      (TQ*)o, (float2*)part_ml, (float*)part_acc, (int*)counters, s_len,
      n_kv_heads, group, d, scale * 1.4426950408889634f, rows_per_split,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps, 16 rows of each tile apiece
constexpr int kM = 16;             // query heads per CTA: the mma's rows
constexpr int kMinCtas = 5;        // per SM: at most 102 registers a thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments (lane l, g = l / 4, c = 2 (l % 4)): an m16n8 accumulator
// holds rows g and g + 8, columns c and c + 1.  Here the rows are query
// heads and, in S, the columns are the warp's cache rows; in O, head
// dimensions.
__global__ void __launch_bounds__(kThreads, kMinCtas)
decode_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const int32_t* __restrict__ lengths, bf16* __restrict__ o,
                 float2* __restrict__ part_ml, float* __restrict__ part_acc,
                 int* __restrict__ counters, int s_len, int n_kv_heads,
                 int group, int d, float scale_log2,
                 int rows_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nch = d / 8, dp = (d + 15) & ~15, nchp = dp / 8;
  const int pitch = (nchp + 7) & ~7;
  const int tile_chunks = kBS * pitch;
  uint4* ring = reinterpret_cast<uint4*>(smem);   // a K tile, a V tile
  uint4* k_s = ring;
  uint4* v_s = ring + tile_chunks;
  uint4* q_s = ring + 2 * tile_chunks;            // kM rows
  float* m_w = reinterpret_cast<float*>(q_s + kM * pitch);  // 4 x kM
  float* l_w = m_w + 4 * kM;                      // 4 x kM
  float* m_s = l_w + 4 * kM;                      // kM (log2 domain)
  float* l_s = m_s + kM;                          // kM
  int* last_s = reinterpret_cast<int*>(l_s + kM);

  const int n_ht = (group + kM - 1) / kM;         // head tiles per KV head
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y / n_ht, h0 = (blockIdx.y % n_ht) * kM;
  const int heads = min(kM, group - h0), slot = min(kM, group);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = max(0, min(lengths[b], s_len));
  const int c0 = split * rows_per_split;
  const int c1 = min(c0 + rows_per_split, len);
  const int n_t = c1 > c0 ? (c1 - c0 + kBS - 1) / kBS : 0;
  const int pair = b * gridDim.y + blockIdx.y;
  const long long row = (long long)n_kv_heads * d;   // cache row stride
  const bf16* kb = k + (long long)b * s_len * row + (long long)hk * d;
  const bf16* vb = v + (long long)b * s_len * row + (long long)hk * d;
  const long long qoff = ((long long)b * n_kv_heads + hk) * group * d +
                         (long long)h0 * d;

  // the copy ring: K and V of a tile are two cp.async groups, and each
  // slot is refilled with the next tile's rows as soon as every warp is
  // done with it -- K while this tile's softmax and P V run, V while the
  // next tile's Q K^T does.  Q (heads x d, zero-padded to 16 x dp) goes
  // with the first K.
  if (n_t > 0) {
    for (int i = tid; i < kM * nchp; i += kThreads) {
      const int r = i / nchp, c = i - r * nchp;
      const bool ok = r < heads && c < nch;
      cp_async16(q_s + chunk_at(r, c, pitch),
                 q + qoff + (ok ? r * d + c * 8 : 0), ok ? 16 : 0);
    }
    copy_rows(k_s, kb, row, c0, c1, nch, nchp, pitch);
    cp_async_commit();
    copy_rows(v_s, vb, row, c0, c1, nch, nchp, pitch);
    cp_async_commit();
  }

  float acc[16][4];                 // O: heads x (16 column tiles of 8)
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int mi = lane >> 3, mr = lane & 7;        // ldmatrix: matrix, row
  const uint32_t q_addr = smem_u32(q_s);

  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  for (int t = 0; t < n_t; ++t) {
    const int s0 = c0 + t * kBS;
    const bool more = t + 1 < n_t;
    const int wr = warp * 16;                     // the warp's tile rows
    cp_async_wait<1>();                           // K (V may be in flight)
    __syncthreads();

    // S (16 heads x the warp's 16 rows) = Q K^T
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk * 16 < dp) {
        uint32_t a[4], bk[4];
        ldsm_x4(q_addr + chunk_at((mi & 1) * 8 + mr, 2 * kk + (mi >> 1),
                                  pitch) * 16, a);
        ldsm_x4(k_addr + chunk_at(wr + (mi >> 1) * 8 + mr,
                                  2 * kk + (mi & 1), pitch) * 16, bk);
        mma(s[0], a, bk[0], bk[1]);
        mma(s[1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();                              // every warp is off K
    if (more) {
      copy_rows(k_s, kb, row, s0 + kBS, c1, nch, nchp, pitch);
      cp_async_commit();
    }

    // mask rows at or past c1; online softmax per head (the quad's rows)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + wr + 8 * j + 2 * (lane & 3) + (e & 1) >= c1)
          s[j][e] = -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m[r] - m_use) * scale_log2);
      const float bias = m_use * scale_log2;
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -bias));
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P (16 heads x the warp's 16 rows) as the A operand
    const uint32_t p[4] = {pack_bf16(s[0][0], s[0][1]),
                           pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[1][2], s[1][3])};
    if (more)
      cp_async_wait<1>();                         // V (the next K may not)
    else
      cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (jj * 16 < dp) {
        uint32_t bv[4];
        ldsm_x4_t(v_addr + chunk_at(wr + (mi & 1) * 8 + mr,
                                    2 * jj + (mi >> 1), pitch) * 16, bv);
        mma(acc[2 * jj], p, bv[0], bv[1]);
        mma(acc[2 * jj + 1], p, bv[2], bv[3]);
      }
    }
    __syncthreads();                              // every warp is off V
    if (more) {
      copy_rows(v_s, vb, row, s0 + kBS, c1, nch, nchp, pitch);
      cp_async_commit();
    }
  }

  // the four warps' (m, l, O) meet by log-sum-exp: warps 1-3 put theirs
  // in the ring (free now), warp 0 combines into acc_s beyond them
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int g0 = lane >> 2, cq = 2 * (lane & 3);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_w[warp * kM + g0 + 8 * r] = m[r];
      l_w[warp * kM + g0 + 8 * r] = l[r];
    }
  }
  float* o_w = reinterpret_cast<float*>(ring);    // warps 1-3: kM x dp
  float* acc_s = o_w + 3 * kM * dp;               // heads x d
  if (warp > 0 && n_t > 0) {
    float* dst = o_w + (warp - 1) * kM * dp;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j * 8 < dp)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[(g0 + 8 * (e >> 1)) * dp + 8 * j + cq + (e & 1)] = acc[j][e];
  }
  __syncthreads();
  if (warp == 0) {
    float wt[4][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = g0 + 8 * r;
      float top = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (l_w[w * kM + g] > 0.f) top = fmaxf(top, m_w[w * kM + g]);
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float lw = l_w[w * kM + g];
        wt[w][r] = lw > 0.f ? exp2f((m_w[w * kM + g] - top) * scale_log2)
                            : 0.f;
        lsum += wt[w][r] * lw;
      }
      if ((lane & 3) == 0) {
        m_s[g] = top == -INFINITY ? -INFINITY : top * scale_log2;
        l_s[g] = lsum;
      }
    }
    if (n_t > 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = g0 + 8 * (e >> 1), c = 8 * j + cq + (e & 1);
          if (j * 8 < dp && g < heads && c < d) {
            float x = wt[0][e >> 1] * acc[j][e];
#pragma unroll
            for (int w = 1; w < 4; ++w)
              x = fmaf(wt[w][e >> 1], o_w[((w - 1) * kM + g) * dp + c], x);
            acc_s[g * d + c] = x;
          }
        }
    }
  }
  __syncthreads();
  finish(acc_s, m_s, l_s, reinterpret_cast<float*>(q_s), last_s, n_t == 0,
         o + qoff, part_ml, part_acc, counters, pair, split, n_split, heads,
         slot, d);
}

int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part_ml, void* part_acc, void* counters,
           int batch, int s_len, int n_kv_heads, int group, int d,
           float scale, int rows_per_split, int n_split,
           cudaStream_t stream) {
  if (d % 8) return (int)cudaErrorInvalidValue;
  const int pitch = ((d + 15) / 16 * 2 + 7) & ~7;
  const size_t bytes = (size_t)2 * kBS * pitch * 16 +
                       (size_t)kM * pitch * 16 + sizeof(float) * 10 * kM +
                       16;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_ht = (group + kM - 1) / kM;
  if ((long long)n_kv_heads * n_ht > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n_split, n_kv_heads * n_ht, batch);
  decode_kernel_tc<<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int32_t*)lengths,
      (bf16*)o, (float2*)part_ml, (float*)part_acc, (int*)counters, s_len,
      n_kv_heads, group, d, scale * 1.4426950408889634f, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// shape: q_dtype, kv_dtype, batch, s_len, n_kv_heads, group, d,
// rows_per_split, n_split (one array, so that a call passes few
// arguments).  q_dtype / kv_dtype: 0 float32, 1 bfloat16; bf16 over bf16
// runs the tensor-core kernel, anything else the SIMT one.  q (B, Hkv *
// group, D), k/v (B, S, Hkv, D), lengths (B,) int32 and o (like q), all
// contiguous and 16-byte aligned, D * sizeof(kv) a multiple of 16.  With
// n_split > 1: part_ml (pairs x n_split x slot float2), part_acc (pairs x
// n_split x slot x D f32) and counters (pairs int32, zero before the
// launch and zero after it), where a pair is a (sequence, KV head) --
// times ceil(group / 16) head tiles for the tensor-core kernel, whose
// slot is min(group, 16); the SIMT kernel's slot is group.
// rows_per_split is a multiple of 64 and n_split * rows_per_split >= S.
// Returns the CUDA error of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* part_ml, void* part_acc,
                                    void* counters, const int* shape,
                                    float scale, void* stream) {
  const int q_dtype = shape[0], kv_dtype = shape[1], batch = shape[2];
  const int s_len = shape[3], n_kv_heads = shape[4], group = shape[5];
  const int d = shape[6], rows_per_split = shape[7], n_split = shape[8];
  if (d < 1 || d > kMaxD || group < 1 || group > kMaxGroup || batch < 1 ||
      batch > 65535 || s_len < 1 || n_kv_heads < 1 || n_kv_heads > 65535 ||
      rows_per_split < kBS || rows_per_split % kBS || n_split < 1 ||
      n_split > kMaxSplits || (long long)n_split * rows_per_split < s_len ||
      (n_split > 1 && (!part_ml || !part_acc || !counters)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return tc::launch(q, k, v, lengths, o, part_ml, part_acc, counters,
                      batch, s_len, n_kv_heads, group, d, scale,
                      rows_per_split, n_split, s);
  const int which = q_dtype * 2 + kv_dtype;
#define DECODE_LAUNCH(TQ, TKV)                                          \
  simt::launch<TQ, TKV>(q, k, v, lengths, o, part_ml, part_acc, counters, \
                        batch, s_len, n_kv_heads, group, d, scale,       \
                        rows_per_split, n_split, s)
  switch (which) {
    case 0:
      return DECODE_LAUNCH(float, float);
    case 1:
      return DECODE_LAUNCH(float, __nv_bfloat16);
    case 2:
      return DECODE_LAUNCH(__nv_bfloat16, float);
  }
#undef DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
