// ssm_scan: the Mamba-1 selective scan over a whole sequence, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/ssm_scan/ssm_scan.py (launched by `ssm_scan_pallas`).
// The plain PyTorch version of the same function is ../ref.py; the two
// agree to f32 rounding.
//
// What it computes: x and dt (BH, T, P), b and c (BH, T, N), a (P, N) and
// d (P,) in f32.  Every input is upcast to f32; the state h (BH, P, N)
// starts at zero, and each step t computes
//     h   = h * exp(dt_t * a) + (dt_t * x_t) (outer) b_t
//     y_t = <h, c_t> + d * x_t
// and writes y_t in x's dtype.  x, dt, b and c are read through their
// strides (the last dimension contiguous), so b and c may be column
// slices of one projection (row stride dt_rank + 2N in the Mamba layer);
// y is contiguous.  Any T >= 1 and any P >= 1 work: the Pallas kernel's
// `T % chunk == 0` requirement is gone, and the ragged channel tail is
// masked.  N <= 16 (Mamba-1 uses 16); a smaller N is padded with b = c =
// a = 0, which leaves those state entries at 0.
//
// What bounds it on an H100: the exponentials and the instruction issue.
// Every step of every channel needs N exponentials -- at the serving
// slice's prefill (BH 8, T 2048, P 16384, N 16) 4.29 G -- and 4 other f32
// instructions per state entry.  The special-function units compute 16
// ex2 a clock per SM and the 4 schedulers issue 128 lanes of instructions
// a clock per SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0).  With every exponential on the
// SFU, as here, the floor is 4.29 G / (16 x 132 x 1.98 GHz) = 1.03 ms.
// Moving about a fifth of them to the f32 pipes as a 7-instruction
// polynomial exp2 balances the two units at 0.82 ms, the card's floor for
// this function (chip_smoke.py's scan_floor).  The bytes (x, dt and y in
// bf16, 805 MB, 0.24 ms at 3.35 TB/s) come after.  exp is one ex2.approx
// with log2(e) folded into a once per thread.
//
// Design (simple first): one thread per channel (sequence, p), holding
// its N f32 state values and its row of a in registers for the whole of
// T -- the TPU's sequential chunk axis with the state in VMEM becomes a
// time loop inside the thread.  A CTA covers 128 neighbouring channels of
// one sequence (8 x 16384 / 128 = 1024 CTAs at the slice's shape, about
// one wave of 8 CTAs per SM), so x and dt are read, and y written,
// coalesced across the warp.  b_t and c_t are the same for every channel
// of a sequence: the CTA stages them in shared memory as f32, kChunk
// steps at a time, and every thread reads them as broadcasts.  Each
// thread loads the next step's x and dt before it computes this one.
//
// What the simple design leaves on the table: the exponentials sit on
// the SFU pipe alone; evaluating part of them on the f32 pipes (a
// polynomial exp2), or a chunked SSD-style scan on the tensor cores, are
// the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // channels per CTA
constexpr int kChunk = 64;         // steps of b and c staged at a time
constexpr int kMaxN = 16;
constexpr int kBlocksPerSM = 8;    // one wave at the slice's shape
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ b, const T* __restrict__ c,
                const float* __restrict__ a, const float* __restrict__ dskip,
                T* __restrict__ y, int t_len, int p_len, int n,
                long long sx0, long long sx1, long long sdt0,
                long long sdt1, long long sb0, long long sb1,
                long long sc0, long long sc1) {
  __shared__ __align__(16) float bs[kChunk][kMaxN];
  __shared__ __align__(16) float cs[kChunk][kMaxN];

  const int seq = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < p_len;

  float a2[kMaxN], h[kMaxN];
#pragma unroll
  for (int k = 0; k < kMaxN; ++k) {
    a2[k] = (live && k < n) ? a[(long long)p * n + k] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  const float dk = live ? dskip[p] : 0.f;

  const T* xp = x + seq * sx0 + p;
  const T* dtp = dt + seq * sdt0 + p;
  const T* bq = b + seq * sb0;
  const T* cq = c + seq * sc0;
  T* yp = y + (long long)seq * t_len * p_len + p;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int steps = min(kChunk, t_len - t0);
    __syncthreads();                 // the last chunk's reads are done
    for (int i = threadIdx.x; i < kChunk * kMaxN; i += kThreads) {
      const int s = i / kMaxN, k = i - s * kMaxN;
      float bv = 0.f, cv = 0.f;
      if (s < steps && k < n) {
        bv = to_f32(bq[(t0 + s) * sb1 + k]);
        cv = to_f32(cq[(t0 + s) * sc1 + k]);
      }
      bs[s][k] = bv;
      cs[s][k] = cv;
    }
    __syncthreads();
    if (!live) continue;

    float xn = to_f32(xp[t0 * sx1]);
    float dn = to_f32(dtp[t0 * sdt1]);
    for (int s = 0; s < steps; ++s) {
      const float xv = xn, dv = dn;
      if (s + 1 < steps) {           // the next step's loads in flight
        xn = to_f32(xp[(t0 + s + 1) * sx1]);
        dn = to_f32(dtp[(t0 + s + 1) * sdt1]);
      }
      const float u = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxN; ++k) {
        const float da = ex2(dv * a2[k]);
        h[k] = fmaf(h[k], da, u * bs[s][k]);
        acc = fmaf(h[k], cs[s][k], acc);
      }
      store(yp + (long long)(t0 + s) * p_len, acc + dk * xv);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* d, void* y, int bh, int t_len,
           int p_len, int n, long long sx0, long long sx1, long long sdt0,
           long long sdt1, long long sb0, long long sb1, long long sc0,
           long long sc1, cudaStream_t stream) {
  dim3 grid((p_len + kThreads - 1) / kThreads, bh);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dt, (const T*)b, (const T*)c, (const float*)a,
      (const float*)d, (T*)y, t_len, p_len, n, sx0, sx1, sdt0, sdt1, sb0,
      sb1, sc0, sc1);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt, b, c and y alike).  x/dt (BH, T, P)
// and b/c (BH, T, N) with the given batch and time strides (elements) and
// a contiguous last dimension; a (P, N) and d (P,) contiguous f32; y
// (BH, T, P) contiguous.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* b,
                            const void* c, const void* a, const void* d,
                            void* y, int dtype, int bh, int t_len, int p_len,
                            int n, long long sx0, long long sx1,
                            long long sdt0, long long sdt1, long long sb0,
                            long long sb1, long long sc0, long long sc1,
                            void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || p_len < 1 || n < 1 ||
      n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, b, c, a, d, y, bh, t_len, p_len, n, sx0,
                         sx1, sdt0, sdt1, sb0, sb1, sc0, sc1, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, b, c, a, d, y, bh, t_len, p_len, n,
                                 sx0, sx1, sdt0, sdt1, sb0, sb1, sc0, sc1,
                                 s);
  return (int)cudaErrorInvalidValue;
}
