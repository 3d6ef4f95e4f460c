// slstm_scan: the sLSTM's scalar-memory recurrence over a whole sequence,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` (src/repro/models/xlstm.py, `slstm_forward` stepping
// `_slstm_step`, through `layers.chunked_remat_scan`), which XLA compiles
// into one device loop.  This kernel is that loop on the card.  The plain
// PyTorch version of the same function is ../ref.py; the two agree to f32
// rounding.
//
// What it computes: pre_x = x @ w_in (B, S, 4d) in the activation dtype
// (f32 or bf16), read through its batch and time strides, and the
// block-diagonal recurrence r_rec (H, ph, 4 ph), contiguous, in the same
// dtype (d = H ph).  Per sequence the state c, n (d) and m (H) start at 0,
// 0 and -1e30 in f32 and h (d) at 0 in the activation dtype, and each
// step computes
//     rec  = per head h_prev[h] @ r_rec[h]  (f32 sums, rounded), read as
//            one row of 4d (so with H = 4, z's term is head 0's, i's head
//            1's, f's head 2's and o's head 3's)
//     pre  = f32(pre_x_t) + f32(rec);  z, i, f, o = pre in four of d
//     lf   = log_sigmoid(f);  m' = max(max_head(lf) + m, max_head(i))
//     fp   = exp(lf + m - m');  ip = exp(i - m')
//     c    = fp c + ip tanh(z);  n = fp n + ip
//     h    = sigmoid(o) c / max(n, 1e-6), rounded
// and writes h (B, S, d), contiguous, in the activation dtype.
//
// What bounds it on an H100: the step-to-step dependency.  Every step's
// recurrent product needs all of h_prev, so no step can start before the
// last one is done on every head.  Counted as work, the served prefill
// (B 8, S 2048, d 768, H 4) is 19.3 GFLOP and 0.126 GB of pre_x and h:
// 0.038 ms by bytes, 0.29 ms on the f32 pipes.  Neither is near: the
// floor is the chain of S dependent steps, each a 4 d x ph product.
//
// The design, the simple one: one CTA a sequence, so the whole h_prev is
// exchanged through shared memory and a step is four barriers.  Each
// thread owns a group of 16 bytes of consecutive output columns of one
// head and sums its product over a range of r_rec's rows (the ph rows cut
// in `split` ranges, so 2 x 384 threads at the served width), kBatch
// 16-byte loads in flight at a time, straight from device memory (1.18
// MB in bf16 at the served width, which stays in the 50 MB L2 across
// steps); the gates, the per-head stabiliser (one warp a head, shuffles)
// and the state update run on shared-memory rows of d and 4d, and each
// thread's pre_x of the next step is loaded while this one runs.  The
// time a step is the SM's L2 read of r_rec.  A thread-block
// cluster a sequence, with r_rec split across its CTAs' shared memory and
// h exchanged through distributed shared memory, is the faster design
// (ROADMAP Queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxUnits = 2;        // units of d a thread (launch ensures)
constexpr int kBatch = 8;           // rows of r_rec loaded at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch
}
template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int G>
struct alignas(G * sizeof(T)) Pack {
  T v[G];
};

struct Args {
  const void* pre;
  const void* r;
  void* h;
  int s_len, d, n_heads, split;
  long long sp0, sp1;
};

// Shared memory (f32): h_prev (d); the recurrent product's partial sums,
// `split` rows of 4d (the first then holds the step's pre-activations: z,
// i, lf, o in place); c and n (d each); m and m' (H each).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) slstm_scan_kernel(Args g) {
  constexpr int G = 16 / (int)sizeof(T);      // columns a 16-byte load
  extern __shared__ __align__(16) float sm[];
  const int d = g.d;
  const int H = g.n_heads;
  const int ph = d / H;
  const int w4 = 4 * ph;                      // r_rec's row width
  float* hs = sm;
  float* pre = hs + d;
  float* cs = pre + g.split * 4 * d;
  float* ns = cs + d;
  float* ms = ns + d;
  float* mn = ms + H;

  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const T* px = (const T*)g.pre + b * g.sp0;
  const T* r = (const T*)g.r;
  T* out = (T*)g.h + (long long)b * g.s_len * d;

  for (int u = tid; u < d; u += nt) {
    hs[u] = 0.f;
    cs[u] = 0.f;
    ns[u] = 0.f;
  }
  for (int i = tid; i < H; i += nt) ms[i] = -1e30f;

  // this thread's product work: column group `grp` over rows [p0, p1)
  const int n_groups = 4 * d / G;
  const int part = tid / n_groups;
  const int grp = tid - part * n_groups;
  const bool prod = part < g.split;
  const int rows = (ph + g.split - 1) / g.split;
  const int p0 = min(part * rows, ph);
  const int p1 = min(p0 + rows, ph);
  const int j0 = grp * G;
  const int head = j0 / w4;
  const T* rp = r + (long long)head * ph * w4 + (j0 - head * w4);
  const float* hp = hs + head * ph;

  // pre_x of the next step, for this thread's units
  float nx[kMaxUnits][4];
  auto fetch = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k) {
      const int u = tid + k * nt;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        nx[k][q] = (u < d && t < g.s_len)
                       ? to_f32(px[t * g.sp1 + q * d + u]) : 0.f;
    }
  };
  fetch(0);
  __syncthreads();

  for (int t = 0; t < g.s_len; ++t) {
    float xs[kMaxUnits][4];
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) xs[k][q] = nx[k][q];
    fetch(t + 1);     // in flight through the step
    // the recurrent product: partial sums over rows [p0, p1)
    if (prod) {
      float acc[G];
#pragma unroll
      for (int e = 0; e < G; ++e) acc[e] = 0.f;
      int p = p0;
      for (; p + kBatch <= p1; p += kBatch) {
        Pack<T, G> w[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          w[i] = *(const Pack<T, G>*)(rp + (long long)(p + i) * w4);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const float hv = hp[p + i];
#pragma unroll
          for (int e = 0; e < G; ++e)
            acc[e] = fmaf(hv, to_f32(w[i].v[e]), acc[e]);
        }
      }
      for (; p < p1; ++p) {
        const Pack<T, G> w = *(const Pack<T, G>*)(rp + (long long)p * w4);
        const float hv = hp[p];
#pragma unroll
        for (int e = 0; e < G; ++e) acc[e] = fmaf(hv, to_f32(w.v[e]), acc[e]);
      }
      float* dst = pre + part * 4 * d + j0;
#pragma unroll
      for (int e = 0; e < G; ++e) dst[e] = acc[e];
    }
    __syncthreads();
    // rec rounded to the activation dtype, plus pre_x; f made log_sigmoid
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k) {
      const int u = tid + k * nt;
      if (u >= d) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float sum = pre[q * d + u];
        for (int sp = 1; sp < g.split; ++sp)
          sum += pre[sp * 4 * d + q * d + u];
        v[q] = rounded<T>(sum) + xs[k][q];
      }
      const float nf = -v[2];
      v[2] = -(fmaxf(nf, 0.f) + log1pf(expf(-fabsf(nf))));
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[q * d + u] = v[q];
    }
    __syncthreads();
    // the stabiliser, one warp a head
    for (int hh = warp; hh < H; hh += n_warps) {
      float mf = -INFINITY, mi = -INFINITY;
      for (int u = hh * ph + lane; u < (hh + 1) * ph; u += 32) {
        mf = fmaxf(mf, pre[2 * d + u]);
        mi = fmaxf(mi, pre[d + u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mf = fmaxf(mf, __shfl_xor_sync(kFull, mf, off));
        mi = fmaxf(mi, __shfl_xor_sync(kFull, mi, off));
      }
      if (lane == 0) mn[hh] = fmaxf(mf + ms[hh], mi);
    }
    __syncthreads();
    // the state and the output
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k) {
      const int u = tid + k * nt;
      if (u >= d) continue;
      const int hh = u / ph;
      const float m_old = ms[hh];
      const float m_new = mn[hh];
      const float fp = expf(pre[2 * d + u] + m_old - m_new);
      const float ip = expf(pre[d + u] - m_new);
      const float c = cs[u] * fp + ip * tanhf(pre[u]);
      const float n = ns[u] * fp + ip;
      cs[u] = c;
      ns[u] = n;
      const float sig = 1.f / (1.f + expf(-pre[3 * d + u]));
      const T hv = from_f32<T>(sig * (c / fmaxf(n, 1e-6f)));
      hs[u] = to_f32(hv);
      out[(long long)t * d + u] = hv;
    }
    __syncthreads();
    for (int i = tid; i < H; i += nt) ms[i] = mn[i];
    // the next step's first reads of ms come after two barriers
  }
}

// Threads: enough for the column groups of 16 bytes, times `split` row
// ranges of the product while that fits in a block, and at least d /
// kMaxUnits for the per-unit work.
template <typename T>
int launch(Args g, int b, cudaStream_t stream) {
  constexpr int G = 16 / (int)sizeof(T);
  const int groups = 4 * g.d / G;
  if (groups > kMaxThreads) return (int)cudaErrorInvalidValue;
  g.split = kMaxThreads / groups;
  if (g.split > 4) g.split = 4;
  int threads = ((groups * g.split + 31) / 32) * 32;
  const int min_units = ((g.d + kMaxUnits - 1) / kMaxUnits + 31) / 32 * 32;
  if (threads < min_units) threads = min_units;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)(3 * g.d + 4 * g.d * g.split + 2 * g.n_heads) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  slstm_scan_kernel<T><<<b, threads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (pre_x, r_rec and h alike).  pre_x (B, S,
// 4d) with the given batch and time strides (elements) and a contiguous
// last dimension; r_rec (H, d / H, 4 d / H) contiguous and 16-byte
// aligned, its rows a multiple of 16 bytes; h (B, S, d) contiguous.  d at
// most 256 x (16 / element size): 1024 in f32, 2048 in bf16 (a thread a
// 16-byte column group).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int slstm_scan_fwd(const void* pre, const void* r, void* h,
                              int dtype, int b, int s_len, int d,
                              int n_heads, long long sp0, long long sp1,
                              void* stream) {
  if (b < 1 || s_len < 1 || n_heads < 1 || d < 1 ||
      d % n_heads || d > 2048)
    return (int)cudaErrorInvalidValue;
  Args g{pre, r, h, s_len, d, n_heads, 1, sp0, sp1};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, b, st);
  if (dtype == 1) return launch<__nv_bfloat16>(g, b, st);
  return (int)cudaErrorInvalidValue;
}
