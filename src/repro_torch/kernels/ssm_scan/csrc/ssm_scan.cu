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
// a = 0, which leaves those state entries at 0.  The kernel computes the
// general function: nothing assumes how a was initialised.
//
// What bounds it on an H100: the exponentials and the instruction issue.
// Every step of every channel needs N exponentials -- at the serving
// slice's prefill (BH 8, T 2048, P 16384, N 16) 4.29 G -- and 4 other f32
// instructions per state entry.  The special-function units compute 16
// ex2 a clock per SM and the 4 schedulers issue 128 lanes of instructions
// a clock per SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0): 1.03 ms with every exponential on
// the SFU, 0.82 ms with about a fifth of them on the f32 pipes
// (chip_smoke.py's scan_floor).  The bytes (x, dt and y in bf16, 805 MB,
// 0.24 ms at 3.35 TB/s) come after.
//
// What the card does instead (PERF.md; src/repro_torch/tools/
// scan_variants.py builds and times variants of this source): the SFU's time for the exponentials and the
// issue of every other instruction add up rather than overlap, so every
// instruction beside the 16 ex2 costs time.  The first design (one
// channel a thread) issued 138 instructions per channel and step, 8 of
// them 16-byte shared-memory loads of b_t and c_t and a dozen address
// arithmetic for its global loads and stores.  This design issues 95.5,
// 64 of them the recurrence's own:
//
// * A thread carries kC neighbouring channels (kC x N f32 states and
//   rows of a in registers), and reads the step's b_t and c_t as f32
//   broadcasts 16 bytes at a time, four state entries at a time, so one
//   broadcast serves kC channels: 8 / kC loads per channel and step.
// * x, dt, b and c are staged in shared memory kChunk steps at a time,
//   double-buffered with 16-byte cp.async copies (zero-filled past T, P
//   and N), so no global latency sits in the step loop; b and c are
//   converted to f32 once per CTA.  Inputs whose strides or addresses are
//   not 16-byte aligned are staged by plain loads instead.
// * y goes through shared memory and out as 16-byte stores per chunk.
// * Every exponential is an ex2 on the SFU.  A polynomial exp2 on the
//   f32 pipes (Cody-Waite split, degree-5 fit) takes 12 issue slots
//   against the SFU's 8 clocks for an ex2, and since the two add up on
//   this card, every share of the exponentials moved to it measured
//   slower than none.
// * A chunked SSD-style scan on the tensor cores does not fit Mamba-1:
//   the decay exp(dt * a[p, n]) differs per (p, n), so no chunk matrix
//   factors out.
//
// The tile and chunk are the fastest measured: 2 channels a thread, 128
// threads, 128 registers, 4 CTAs an SM (one wave of the 512 CTAs at the
// Jamba cut's shape), 16 steps a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 2;                     // channels per thread
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;             // CTAs an SM: 128 registers
constexpr int kTile = kC * kThreads;      // channels per CTA
constexpr int kChunk = 16;                // steps staged at a time
constexpr int kMaxN = 16;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int C>
struct alignas(C * sizeof(T)) Pack {
  T v[C];
};

struct Args {
  const void *x, *dt, *b, *c;
  const float *a, *d;
  void* y;
  int t_len, p_len, n;
  long long sx0, sx1, sdt0, sdt1, sb0, sb1, sc0, sc1;
  int vec_in, vec_bc, vec_out;   // 16-byte copies allowed
};

// Shared memory, in bytes: two staging buffers of x, dt (kChunk x kTile)
// and b, c (kChunk x kMaxN) in the input type, then b and c of the
// current chunk as f32 (kChunk x 2 kMaxN), then y (kChunk x kTile).
template <typename T>
struct Layout {
  static constexpr int kXs = kChunk * kTile * (int)sizeof(T);
  static constexpr int kBs = kChunk * kMaxN * (int)sizeof(T);
  static constexpr int kBuf = 2 * kXs + 2 * kBs;
  static constexpr int kBcf = 2 * kBuf;
  static constexpr int kYs = kBcf + kChunk * 2 * kMaxN * 4;
  static constexpr int kBytes = kYs + kXs;
  static __device__ T* xs(char* s, int buf) { return (T*)(s + buf * kBuf); }
  static __device__ T* ds(char* s, int buf) {
    return (T*)(s + buf * kBuf + kXs);
  }
  static __device__ T* bs(char* s, int buf) {
    return (T*)(s + buf * kBuf + 2 * kXs);
  }
  static __device__ T* cs(char* s, int buf) {
    return (T*)(s + buf * kBuf + 2 * kXs + kBs);
  }
  static __device__ float* bcf(char* s) { return (float*)(s + kBcf); }
  static __device__ T* ys(char* s) { return (T*)(s + kYs); }
};

// Copies rows [t0, t0 + kChunk) of one (T, width) operand -- `width`
// elements from column `col0` of a row -- into smem rows of `cols`
// elements, zero past T and past `limit` columns.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long srow, int t0,
                                           int t_len, int col0, int limit,
                                           int cols, bool vec) {
  if (vec) {
    constexpr int kE = 16 / (int)sizeof(T);
    const int per_row = cols / kE;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int s = i / per_row;
      const int q = (i - s * per_row) * kE;
      const int t = t0 + s;
      const int live = t < t_len ? min(max(limit - (col0 + q), 0), kE) : 0;
      const T* from = live ? src + t * srow + col0 + q : src;
      cp16(dst + s * cols + q, from, live * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols; i += kThreads) {
      const int s = i / cols;
      const int q = i - s * cols;
      const int t = t0 + s;
      dst[i] = (t < t_len && col0 + q < limit) ? src[t * srow + col0 + q]
                                               : from_f32<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(const Args& g, char* sm, int buf,
                                      int t0, int seq, int p0) {
  using Ly = Layout<T>;
  stage_rows<T>(Ly::xs(sm, buf), (const T*)g.x + seq * g.sx0, g.sx1, t0,
                g.t_len, p0, g.p_len, kTile, g.vec_in);
  stage_rows<T>(Ly::ds(sm, buf), (const T*)g.dt + seq * g.sdt0, g.sdt1, t0,
                g.t_len, p0, g.p_len, kTile, g.vec_in);
  stage_rows<T>(Ly::bs(sm, buf), (const T*)g.b + seq * g.sb0, g.sb1, t0,
                g.t_len, 0, g.n, kMaxN, g.vec_bc);
  stage_rows<T>(Ly::cs(sm, buf), (const T*)g.c + seq * g.sc0, g.sc1, t0,
                g.t_len, 0, g.n, kMaxN, g.vec_bc);
}

// y of the chunk starting at t0 from shared memory to device memory
template <typename T>
__device__ __forceinline__ void flush(const Args& g, char* sm, int t0,
                                      int seq, int p0) {
  const T* ys = Layout<T>::ys(sm);
  T* y = (T*)g.y + (long long)seq * g.t_len * g.p_len;
  if (g.vec_out) {
    constexpr int kE = 16 / (int)sizeof(T);
    constexpr int per_row = kTile / kE;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int s = i / per_row;
      const int q = (i - s * per_row) * kE;
      const int t = t0 + s;
      if (t < g.t_len && p0 + q < g.p_len)
        *(uint4*)(y + (long long)t * g.p_len + p0 + q) =
            *(const uint4*)(ys + s * kTile + q);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int s = i / kTile;
      const int q = i - s * kTile;
      const int t = t0 + s;
      if (t < g.t_len && p0 + q < g.p_len)
        y[(long long)t * g.p_len + p0 + q] = ys[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(Args g) {
  extern __shared__ __align__(16) char sm[];
  using Ly = Layout<T>;
  const int seq = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int my = kC * threadIdx.x;          // my first channel in the tile

  float a2[kC][kMaxN], h[kC][kMaxN], dk[kC];
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    const int p = p0 + my + ch;
    const bool live = p < g.p_len;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      a2[ch][k] =
          (live && k < g.n) ? g.a[(long long)p * g.n + k] * kLog2e : 0.f;
      h[ch][k] = 0.f;
    }
    dk[ch] = live ? g.d[p] : 0.f;
  }

  const int n_chunks = (g.t_len + kChunk - 1) / kChunk;
  stage<T>(g, sm, 0, 0, seq, p0);
  cp_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int buf = j & 1;
    const int t0 = j * kChunk;
    cp_wait_all();
    __syncthreads();      // chunk j is in; chunk j - 1's steps are done
    {
      const T* bs = Ly::bs(sm, buf);
      const T* cs = Ly::cs(sm, buf);
      float* bcf = Ly::bcf(sm);
      for (int i = threadIdx.x; i < kChunk * 2 * kMaxN; i += kThreads) {
        const int s = i / (2 * kMaxN);
        const int k = i - s * 2 * kMaxN;
        bcf[i] = to_f32(k < kMaxN ? bs[s * kMaxN + k]
                                  : cs[s * kMaxN + k - kMaxN]);
      }
    }
    if (j > 0) flush<T>(g, sm, t0 - kChunk, seq, p0);
    if (j + 1 < n_chunks) {
      stage<T>(g, sm, buf ^ 1, t0 + kChunk, seq, p0);
      cp_commit();
    }
    __syncthreads();      // b and c in f32; y's buffer is free

    const T* xs = Ly::xs(sm, buf) + my;
    const T* ds = Ly::ds(sm, buf) + my;
    const float4* bc4 = (const float4*)Ly::bcf(sm);
    T* ys = Ly::ys(sm) + my;
    const int steps = min(kChunk, g.t_len - t0);
    for (int s = 0; s < steps; ++s) {
      const Pack<T, kC> xp = *(const Pack<T, kC>*)(xs + s * kTile);
      const Pack<T, kC> dp = *(const Pack<T, kC>*)(ds + s * kTile);
      float xv[kC], dv[kC], u[kC], acc[kC];
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        xv[ch] = to_f32(xp.v[ch]);
        dv[ch] = to_f32(dp.v[ch]);
        u[ch] = dv[ch] * xv[ch];
        acc[ch] = 0.f;
      }
      // four state entries at a time: one 16-byte broadcast of b_t and
      // one of c_t serve them for every channel of the thread
#pragma unroll
      for (int q = 0; q < kMaxN / 4; ++q) {
        const float4 bv = bc4[s * 2 * kMaxN / 4 + q];
        const float4 cv = bc4[s * 2 * kMaxN / 4 + kMaxN / 4 + q];
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * q + kk;
            const float da = ex2(dv[ch] * a2[ch][k]);
            h[ch][k] = fmaf(h[ch][k], da, u[ch] * bq[kk]);
            acc[ch] = fmaf(h[ch][k], cq[kk], acc[ch]);
          }
        }
      }
      Pack<T, kC> yp;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch)
        yp.v[ch] = from_f32<T>(acc[ch] + dk[ch] * xv[ch]);
      *(Pack<T, kC>*)(ys + s * kTile) = yp;
    }
  }
  __syncthreads();
  flush<T>(g, sm, (n_chunks - 1) * kChunk, seq, p0);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shared-memory attribute past 48 KB is the device's: it is set once
// per device (of the first kMaxDevices; on every launch past them).
template <typename T>
int launch(Args g, int bh, cudaStream_t stream) {
  static bool granted[kMaxDevices] = {};
  const int bytes = Layout<T>::kBytes;
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !granted[dev]) {
      err = cudaFuncSetAttribute(
          ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) granted[dev] = true;
    }
  }
  const long long es = sizeof(T);
  g.vec_in = aligned16(g.x) && aligned16(g.dt) &&
             (g.sx0 * es) % 16 == 0 && (g.sx1 * es) % 16 == 0 &&
             (g.sdt0 * es) % 16 == 0 && (g.sdt1 * es) % 16 == 0;
  g.vec_bc = aligned16(g.b) && aligned16(g.c) && (g.sb0 * es) % 16 == 0 &&
             (g.sb1 * es) % 16 == 0 && (g.sc0 * es) % 16 == 0 &&
             (g.sc1 * es) % 16 == 0;
  g.vec_out = aligned16(g.y) && (g.p_len * es) % 16 == 0;
  dim3 grid((g.p_len + kTile - 1) / kTile, bh);
  ssm_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(g);
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
  Args g{x,   dt,  b,    c,    (const float*)a, (const float*)d,
         y,   t_len, p_len, n, sx0, sx1, sdt0, sdt1, sb0, sb1, sc0, sc1,
         0,   0,   0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, bh, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, bh, s);
  return (int)cudaErrorInvalidValue;
}
