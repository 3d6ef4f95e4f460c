// mlstm_scan: the mLSTM's matrix-memory recurrence over a whole sequence,
// stepped, for Hopper (sm_90a) -- the recurrent design of two.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` (src/repro/models/xlstm.py, `mlstm_forward`'s `step`, through
// `layers.chunked_remat_scan`), which XLA compiles into one device loop.
// The served path (bf16, P a multiple of 32 up to 384) runs the chunkwise
// design, mlstm_chunkwise.cu, which computes the same function a chunk of
// 32 steps at a time on the tensor cores; ../ops.py `launch_plan` keeps
// this kernel for f32 (whose 5e-5 bar bf16 tensor-core operands would not
// keep) and every other shape, and it stays beside the chunkwise one as
// the second design its error is told apart from.  The plain PyTorch
// version of the function is ../ref.py `mlstm_scan_ref`; the two agree to
// f32 rounding.
//
// What it computes: q, k, v (B, S, H, P) in the activation dtype (f32 or
// bf16), read through their strides (the last dimension contiguous), and
// the log gates li, lf (B, S, H) f32, also strided.  Per (b, h) the state
// C (P x P), n (P) and m start at 0, 0 and -1e30 in f32, and each step
//     m'  = max(lf + m, li);  fp = exp(lf + m - m');  ip = exp(li - m')
//     C   = fp C + (ip v) k^T;  n = fp n + ip k
//     h   = C q / max(|n . q|, 1)
// writes h (B, S, H, P), contiguous, in the activation dtype.
//
// What bounds it on an H100: the stepped form's f32 arithmetic on the
// state.  Every step touches each of the P^2 state entries three times (a
// product, a fused multiply-add for the update, one for C q): at the
// served prefill (B 8, S 2048, H 4, P 384) 29 G instructions a lane,
// 0.98 ms at 128 lanes a clock on 132 SMs, against 48.5 GFLOP / 67
// TFLOP/s = 0.72 ms counted as flops; the bytes (q, k, v and h in bf16,
// 0.2 GB) take 0.06 ms.  That floor is the recurrent form's own, which is
// why the served path moved to the chunkwise form (its bound the bytes'
// 0.060 ms, see its header).
//
// The design: each row of C evolves alone given the step's gates and k,
// so a CTA owns kRows rows of one (b, h) and needs nothing from any other
// CTA.  A warp holds kRowsPerWarp rows; lane l holds columns l, l + 32,
// ... (CPL of them) of those rows and of n in registers.  The warp reduces
// its rows' partial C q sums with a transposing butterfly (9 shuffles for
// 8 rows) and n . q with a plain one (5 shuffles); n is kept, updated and
// reduced redundantly by every warp.  q and k (all P columns), the CTA's
// v rows and the gates are staged in shared memory kChunk steps at a
// time, double-buffered with 16-byte cp.async copies (plain loads where
// an address or stride is not 16-byte aligned), so no device-memory
// latency sits in the step loop; h goes out through shared memory per
// chunk.  The state stays in registers for the whole sequence, so C never
// touches device memory.  At P 384 that is 12 CTAs a (b, h).
//
// Limits: P must be a multiple of 32 up to 512 (ops.py checks): the
// kernel is instantiated for CPL = 1, 2, 4, 8, 12, 16 columns a lane and
// a P between them runs on the next wider one with the extra columns
// zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows of C a CTA
constexpr int kChunk = 16;                     // steps staged at a time
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

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

struct Args {
  const void *q, *k, *v;
  const float *li, *lf;
  void* h;
  int s_len, n_heads, p_len;
  long long sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2;
  long long si0, si1, si2, sf0, sf1, sf2;
  int vec;                       // 16-byte copies allowed
};

// Shared memory, in bytes: two staging buffers, each q and k (kChunk x
// kCols) and the CTA's v rows (kChunk x kRows) in the input type and the
// gates li, lf (2 x kChunk) in f32; then h (kChunk x kRows).
template <typename T, int CPL>
struct Layout {
  static constexpr int kCols = 32 * CPL;
  static constexpr int kQ = kChunk * kCols * (int)sizeof(T);
  static constexpr int kV = kChunk * kRows * (int)sizeof(T);
  static constexpr int kG = 2 * kChunk * 4;
  static constexpr int kBuf = 2 * kQ + kV + kG;
  static constexpr int kBytes = 2 * kBuf + kV;
  static __device__ T* qs(char* s, int b) { return (T*)(s + b * kBuf); }
  static __device__ T* ks(char* s, int b) {
    return (T*)(s + b * kBuf + kQ);
  }
  static __device__ T* vs(char* s, int b) {
    return (T*)(s + b * kBuf + 2 * kQ);
  }
  static __device__ float* gs(char* s, int b) {
    return (float*)(s + b * kBuf + 2 * kQ + kV);
  }
  static __device__ T* ys(char* s) { return (T*)(s + 2 * kBuf); }
};

// Rows [t0, t0 + kChunk) of one (S, width) operand -- `cols` elements
// from column `col0` of a row -- into smem rows of `cols`, zero past S and
// past column `limit`.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long srow, int t0, int s_len,
                                           int col0, int limit, int cols,
                                           bool vec) {
  if (vec) {
    constexpr int kE = 16 / (int)sizeof(T);
    const int per_row = cols / kE;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int s = i / per_row;
      const int c = (i - s * per_row) * kE;
      const int t = t0 + s;
      const bool live = t < s_len && col0 + c < limit;
      cp16(dst + s * cols + c, live ? src + t * srow + col0 + c : src,
           live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols; i += kThreads) {
      const int s = i / cols;
      const int c = i - s * cols;
      const int t = t0 + s;
      dst[i] = (t < s_len && col0 + c < limit) ? src[t * srow + col0 + c]
                                               : from_f32<T>(0.f);
    }
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void stage(const Args& g, char* sm, int buf,
                                      int t0, const T* q, const T* k,
                                      const T* v, int r0) {
  using Ly = Layout<T, CPL>;
  stage_rows<T>(Ly::qs(sm, buf), q, g.sq1, t0, g.s_len, 0, g.p_len,
                Ly::kCols, g.vec);
  stage_rows<T>(Ly::ks(sm, buf), k, g.sk1, t0, g.s_len, 0, g.p_len,
                Ly::kCols, g.vec);
  stage_rows<T>(Ly::vs(sm, buf), v, g.sv1, t0, g.s_len, r0, g.p_len, kRows,
                g.vec);
}

// this thread's gate of the chunk starting at t0 (threads < 2 kChunk)
__device__ __forceinline__ float load_gate(const Args& g, const float* li,
                                           const float* lf, int t0) {
  const int i = threadIdx.x;
  const int t = t0 + (i < kChunk ? i : i - kChunk);
  if (i >= 2 * kChunk || t >= g.s_len) return 0.f;
  return i < kChunk ? li[t * g.si1] : lf[t * g.sf1];
}

template <typename T>
__device__ __forceinline__ void flush(const Args& g, const T* ys, int t0,
                                      int steps, int b, int hh, int r0) {
  T* out = (T*)g.h;
  for (int i = threadIdx.x; i < steps * kRows; i += kThreads) {
    const int s = i / kRows;
    const int r = i - s * kRows;
    if (r0 + r < g.p_len) {
      const long long t = t0 + s;
      out[((b * (long long)g.s_len + t) * g.n_heads + hh) * g.p_len + r0 +
          r] = ys[i];
    }
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads) mlstm_scan_kernel(Args g) {
  extern __shared__ __align__(16) char sm[];
  using Ly = Layout<T, CPL>;
  const int bh = blockIdx.y;
  const int b = bh / g.n_heads;
  const int hh = bh - b * g.n_heads;
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = g.s_len;

  const T* q = (const T*)g.q + b * g.sq0 + hh * g.sq2;
  const T* k = (const T*)g.k + b * g.sk0 + hh * g.sk2;
  const T* v = (const T*)g.v + b * g.sv0 + hh * g.sv2;
  const float* li = g.li + b * g.si0 + hh * g.si2;
  const float* lf = g.lf + b * g.sf0 + hh * g.sf2;

  float c[kRowsPerWarp][CPL];
  float n[CPL];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int jc = 0; jc < CPL; ++jc) c[j][jc] = 0.f;
#pragma unroll
  for (int jc = 0; jc < CPL; ++jc) n[jc] = 0.f;
  float m = -1e30f;

  // the row whose full C q sum this lane ends up holding (see below)
  const int my_row =
      ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);

  const int n_chunks = (S + kChunk - 1) / kChunk;
  stage<T, CPL>(g, sm, 0, 0, q, k, v, r0);
  cp_commit();
  float gate = load_gate(g, li, lf, 0);
  if (threadIdx.x < 2 * kChunk) Ly::gs(sm, 0)[threadIdx.x] = gate;
  for (int j = 0; j < n_chunks; ++j) {
    const int buf = j & 1;
    const int t0 = j * kChunk;
    cp_wait_all();
    __syncthreads();      // chunk j is in; chunk j - 1's steps are done
    if (j > 0) flush<T>(g, Ly::ys(sm), t0 - kChunk, kChunk, b, hh, r0);
    if (j + 1 < n_chunks) {
      stage<T, CPL>(g, sm, buf ^ 1, t0 + kChunk, q, k, v, r0);
      cp_commit();
      gate = load_gate(g, li, lf, t0 + kChunk);
    }
    __syncthreads();      // h's buffer is free

    const T* qs = Ly::qs(sm, buf);
    const T* ks = Ly::ks(sm, buf);
    const T* vs = Ly::vs(sm, buf) + warp * kRowsPerWarp;
    const float* gs = Ly::gs(sm, buf);
    T* ys = Ly::ys(sm) + warp * kRowsPerWarp + my_row;
    const int steps = min(kChunk, S - t0);
    for (int s = 0; s < steps; ++s) {
      const float lfs = gs[kChunk + s];
      const float lis = gs[s];
      const float m_new = fmaxf(lfs + m, lis);
      const float fp = expf(lfs + m - m_new);
      const float ip = expf(lis - m_new);
      m = m_new;

      float kv[CPL], qv[CPL];
      float nq = 0.f;
#pragma unroll
      for (int jc = 0; jc < CPL; ++jc) {
        kv[jc] = to_f32(ks[s * Ly::kCols + lane + 32 * jc]);
        qv[jc] = to_f32(qs[s * Ly::kCols + lane + 32 * jc]);
        n[jc] = fmaf(n[jc], fp, ip * kv[jc]);
        nq = fmaf(n[jc], qv[jc], nq);
      }
      float part[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float a = ip * to_f32(vs[s * kRows + r]);
        float acc = 0.f;
#pragma unroll
        for (int jc = 0; jc < CPL; ++jc) {
          c[r][jc] = fmaf(c[r][jc], fp, a * kv[jc]);
          acc = fmaf(c[r][jc], qv[jc], acc);
        }
        part[r] = acc;
      }
      // n . q over the warp: every lane gets the sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        nq += __shfl_xor_sync(kFull, nq, off);
      // the 8 rows' sums: at each level a lane keeps half of its values
      // and adds the partner's copy of the same rows, so lane l ends with
      // row my_row summed over the 8 lanes that differ in bits 4, 8, 16;
      // the last two shuffles sum over bits 1 and 2
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool up = lane & 16;
        const float send = up ? part[r] : part[r + 4];
        const float keep = up ? part[r + 4] : part[r];
        part[r] = keep + __shfl_xor_sync(kFull, send, 16);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool up = lane & 8;
        const float send = up ? part[r] : part[r + 2];
        const float keep = up ? part[r + 2] : part[r];
        part[r] = keep + __shfl_xor_sync(kFull, send, 8);
      }
      {
        const bool up = lane & 4;
        const float send = up ? part[0] : part[1];
        const float keep = up ? part[1] : part[0];
        part[0] = keep + __shfl_xor_sync(kFull, send, 4);
      }
      part[0] += __shfl_xor_sync(kFull, part[0], 2);
      part[0] += __shfl_xor_sync(kFull, part[0], 1);
      if ((lane & 3) == 0) {
        const float den = fmaxf(fabsf(nq), 1.f);
        ys[s * kRows] = from_f32<T>(part[0] / den);
      }
    }
    if (j + 1 < n_chunks && threadIdx.x < 2 * kChunk)
      Ly::gs(sm, buf ^ 1)[threadIdx.x] = gate;
  }
  __syncthreads();
  const int t_last = (n_chunks - 1) * kChunk;
  flush<T>(g, Ly::ys(sm), t_last, S - t_last, b, hh, r0);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shared-memory attribute past 48 KB is the device's: it is set once
// per device and instantiation (of the first kMaxDevices; on every launch
// past them).
template <typename T, int CPL>
int launch_cpl(const Args& g, int bh, cudaStream_t stream) {
  static bool granted[kMaxDevices] = {};
  const int bytes = Layout<T, CPL>::kBytes;
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !granted[dev]) {
      err = cudaFuncSetAttribute(mlstm_scan_kernel<T, CPL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) granted[dev] = true;
    }
  }
  dim3 grid((g.p_len + kRows - 1) / kRows, bh);
  mlstm_scan_kernel<T, CPL><<<grid, kThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Args g, int bh, cudaStream_t stream) {
  const long long es = sizeof(T);
  g.vec = aligned16(g.q) && aligned16(g.k) && aligned16(g.v);
  for (long long st : {g.sq0, g.sq1, g.sq2, g.sk0, g.sk1, g.sk2, g.sv0,
                       g.sv1, g.sv2})
    g.vec = g.vec && (st * es) % 16 == 0;
  const int cpl = g.p_len / 32;
  if (cpl <= 1) return launch_cpl<T, 1>(g, bh, stream);
  if (cpl <= 2) return launch_cpl<T, 2>(g, bh, stream);
  if (cpl <= 4) return launch_cpl<T, 4>(g, bh, stream);
  if (cpl <= 8) return launch_cpl<T, 8>(g, bh, stream);
  if (cpl <= 12) return launch_cpl<T, 12>(g, bh, stream);
  return launch_cpl<T, 16>(g, bh, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h alike).  q, k, v (B, S, H,
// P) with the given batch, time and head strides (elements) and a
// contiguous last dimension; li, lf (B, S, H) f32 with theirs; h (B, S,
// H, P) contiguous.  P a multiple of 32 up to 512.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* li, const void* lf, void* h,
                              int dtype, int b, int s_len, int n_heads,
                              int p_len, long long sq0, long long sq1,
                              long long sq2, long long sk0, long long sk1,
                              long long sk2, long long sv0, long long sv1,
                              long long sv2, long long si0, long long si1,
                              long long si2, long long sf0, long long sf1,
                              long long sf2, void* stream) {
  if (b < 1 || n_heads < 1 || (long long)b * n_heads > 65535 ||
      s_len < 1 || p_len < 32 || p_len > 512 || p_len % 32)
    return (int)cudaErrorInvalidValue;
  Args g{q,     k,       v,     (const float*)li, (const float*)lf, h,
         s_len, n_heads, p_len, sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2,
         si0,   si1,     si2,   sf0, sf1, sf2, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, b * n_heads, st);
  if (dtype == 1) return launch<__nv_bfloat16>(g, b * n_heads, st);
  return (int)cudaErrorInvalidValue;
}
