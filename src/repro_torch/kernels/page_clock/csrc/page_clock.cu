// page_clock: the page-granular busy-clock timing model, for Hopper (sm_90a).
//
// Replaces the reference's `simulate` / `simulate_fleet`
// (src/repro/core/timing.py), a `lax.scan` (vmapped over devices) that XLA
// compiles into one on-device loop; it has no Pallas counterpart.  The
// plain PyTorch version of the same function is ../ref.py; the two agree
// bit for bit.
//
// For each device row d and request i in order:
//   start     = max(lun_free[lun], ch_free[ch])
//   done_xfer = start + t_xfer
//   done      = done_xfer + t_op[op]
//   if valid: lun_free[lun] = done, ch_free[ch] = done_xfer
//   completion[d, i] = valid ? done : 0
// and the row's makespan is max(lun_free).  The clocks start at 0.
//
// Exactness: the recurrence has two f32 adds and a max per request and no
// multiply, so nothing can contract into an FMA; the adds are written as
// __fadd_rn, which the compiler may not fuse or reorder.  Each request
// depends on the clocks the one before it left, so the requests of a row
// are stepped one after another in stream order.  A parallel max-plus
// scan over the requests would be faster, but it would reassociate the
// f32 additions and no longer equal the reference, so there is none.
//
// What bounds it on an H100: the dependent chain of one request (a
// shared-memory load of two clocks, a max, two adds, the stores that the
// next request may load), tens of nanoseconds a request; the 13 bytes a
// request moves through device memory are far below that.
//
// Design: one CTA of 128 threads per device row.  Thread 0 steps the
// stream with the row's clocks in shared memory (at most kMaxResources
// LUNs and channels).  Warps 1-3 meanwhile stage the next chunk of
// kChunk requests from device memory into shared memory, each packed into
// one word (lun, channel, op, valid), check every index, and write the
// completions of the chunk before out to device memory, coalesced; one
// barrier a chunk.  An index out of range is reported through an error
// word the wrapper reads back (the request is stepped as index 0, never
// silently used).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStagers = kThreads - 32;      // warps 1-3
constexpr int kChunk = 2048;                 // requests staged at a time
constexpr int kMaxResources = 1024;          // LUNs, and channels
constexpr uint32_t kIndexMask = 0xfff;       // 12 bits each for lun, ch

// Packs requests [begin, begin + len) of row `base` into `dst`: lun in bits
// 0-11, channel in 12-23, op in 24-25, valid in 26.  A bad index raises
// the error word and is replaced by 0.
__device__ __forceinline__ void stage(
    uint32_t* __restrict__ dst, const int32_t* __restrict__ ops,
    const int32_t* __restrict__ luns, const int32_t* __restrict__ chans,
    const bool* __restrict__ valid, long long base, int begin, int len,
    int n_luns, int n_channels, int* __restrict__ err, int t, int stride) {
  for (int j = t; j < len; j += stride) {
    const long long idx = base + begin + j;
    int op = ops[idx], lun = luns[idx], ch = chans[idx];
    if ((unsigned)lun >= (unsigned)n_luns ||
        (unsigned)ch >= (unsigned)n_channels || (unsigned)op > 2u) {
      atomicOr(err, 1);
      op = lun = ch = 0;
    }
    dst[j] = (uint32_t)lun | ((uint32_t)ch << 12) | ((uint32_t)op << 24) |
             ((uint32_t)(valid[idx] ? 1 : 0) << 26);
  }
}

__device__ __forceinline__ void flush(const float* __restrict__ src,
                                      float* __restrict__ done,
                                      long long base, int begin, int len,
                                      int t, int stride) {
  for (int j = t; j < len; j += stride) done[base + begin + j] = src[j];
}

__global__ void __launch_bounds__(kThreads) page_clock_kernel(
    const int32_t* __restrict__ ops, const int32_t* __restrict__ luns,
    const int32_t* __restrict__ chans, const bool* __restrict__ valid,
    const float* __restrict__ t_op, const float* __restrict__ t_xfer,
    float* __restrict__ done, float* __restrict__ makespan,
    int* __restrict__ err, int n, int n_luns, int n_channels) {
  __shared__ uint32_t req[2][kChunk];
  __shared__ float out[2][kChunk];
  __shared__ float lun_free[kMaxResources];
  __shared__ float ch_free[kMaxResources];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * n;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  for (int i = tid; i < n_luns; i += kThreads) lun_free[i] = 0.0f;
  for (int i = tid; i < n_channels; i += kThreads) ch_free[i] = 0.0f;
  if (n_chunks > 0)
    stage(req[0], ops, luns, chans, valid, base, 0, min(kChunk, n), n_luns,
          n_channels, err, tid, kThreads);
  __syncthreads();
  const float tx = *t_xfer, t0 = t_op[0], t1 = t_op[1], t2 = t_op[2];
  for (int k = 0; k < n_chunks; ++k) {
    const int b = k & 1;
    if (tid == 0) {
      const uint32_t* r = req[b];
      float* o = out[b];
      const int len = min(kChunk, n - k * kChunk);
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const uint32_t w = r[j];
        const int lun = w & kIndexMask, ch = (w >> 12) & kIndexMask;
        const int op = (w >> 24) & 3;
        const float start = fmaxf(lun_free[lun], ch_free[ch]);
        const float dx = __fadd_rn(start, tx);
        const float d = __fadd_rn(dx, op == 0 ? t0 : (op == 1 ? t1 : t2));
        const bool ok = (w >> 26) & 1u;
        if (ok) {
          lun_free[lun] = d;
          ch_free[ch] = dx;
        }
        o[j] = ok ? d : 0.0f;
      }
    } else if (tid >= 32) {
      const int next = (k + 1) * kChunk;
      if (next < n)
        stage(req[b ^ 1], ops, luns, chans, valid, base, next,
              min(kChunk, n - next), n_luns, n_channels, err, tid - 32,
              kStagers);
      if (k > 0)
        flush(out[b ^ 1], done, base, (k - 1) * kChunk, kChunk, tid - 32,
              kStagers);
    }
    __syncthreads();
  }
  if (n_chunks > 0) {
    const int last = n_chunks - 1;
    flush(out[last & 1], done, base, last * kChunk, n - last * kChunk, tid,
          kThreads);
  }
  if (tid == 0) {
    float m = lun_free[0];
    for (int i = 1; i < n_luns; ++i) m = fmaxf(m, lun_free[i]);
    makespan[blockIdx.x] = m;
  }
}

}  // namespace

// ints: n_dev, n, n_luns, n_channels.  `err` is a zeroed int32 the kernel
// sets to nonzero when a request's lun, channel or op is out of range.
extern "C" int page_clock_fwd(const void* ops, const void* luns,
                              const void* chans, const void* valid,
                              const void* t_op, const void* t_xfer,
                              void* done, void* makespan, void* err,
                              const int* ints, void* stream) {
  const int n_dev = ints[0], n = ints[1], n_luns = ints[2],
            n_channels = ints[3];
  if (n_dev < 1 || n < 0 || n_luns < 1 || n_luns > kMaxResources ||
      n_channels < 1 || n_channels > kMaxResources)
    return (int)cudaErrorInvalidValue;
  page_clock_kernel<<<n_dev, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ops, (const int32_t*)luns, (const int32_t*)chans,
      (const bool*)valid, (const float*)t_op, (const float*)t_xfer,
      (float*)done, (float*)makespan, (int*)err, n, n_luns, n_channels);
  return (int)cudaGetLastError();
}
