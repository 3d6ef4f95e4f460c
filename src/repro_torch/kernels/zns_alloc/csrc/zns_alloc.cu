// zns_alloc: masked per-LUN-group lowest-wear selection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/zns_alloc/zns_alloc.py (launched by
// `zns_alloc_pallas`), and the `lax.top_k` selection the JAX engine does
// inline in `_take_lowest` / `_cheapest_groups`
// (src/repro/core/engine.py).  The plain PyTorch version of the same
// function is ../ref.py; the two agree bit for bit.
//
// What it computes, per row (lane, group) of a (L, G, W) batch: an
// element (column c) is free when avail is FREE (0) or INVALID (3), the
// row is eligible and c < per_group_eff[lane].  Each column gets a
// unique 64-bit key -- (wear << 32) | c when free and by_wear, c when
// free and not by_wear, (1 << 62) | c when not free -- and the row keeps
// the `take` smallest keys, re-ordered by (wear, c) with non-free filler
// last in ascending column order.  Outputs: cols (L, G, take), ok (the
// free count, L x G), cost (f32 wear over the first take_eff picks, +inf
// if one is not free) and optionally the 0/1 mask sel (L, G, W).
//
// What bounds it on an H100: nothing but launch latency and the bytes
// read.  The work is integer compares, 2 * 4 * L * G * W bytes in (wear
// and avail) and a few bytes per row out; at the main path's shapes
// (4 x 1056 per lane) that is ~34 KB per lane, far below what the card
// moves in a microsecond.  So tensor cores, TMA and wgmma are of no use.
//
// Design: one CTA of 256 threads per row.  Each thread keeps its
// ceil(W / 256) keys in registers, so the row is read from device memory
// once.  The Pallas kernel's `take` rounds of masked row-argmin with a
// second min for the tie become `take` rounds of one block-wide min over
// the unique 64-bit key (warp shuffles, then one shared-memory word per
// warp); the owner of the minimum retires it.  The <= 64 picks are then
// re-sorted by (wear, col) by one thread in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 8;              // width <= 2048
constexpr int kMaxTake = 64;
constexpr unsigned long long kNonFree = 1ull << 62;
constexpr unsigned long long kGone = ~0ull;

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
zns_alloc_rows_kernel(const int32_t* __restrict__ wear,
                      const int32_t* __restrict__ avail,
                      const int32_t* __restrict__ eligible,
                      const int32_t* __restrict__ by_wear,
                      const int32_t* __restrict__ take_eff,
                      const int32_t* __restrict__ per_group_eff,
                      int32_t* __restrict__ cols, int32_t* __restrict__ ok,
                      float* __restrict__ cost, int32_t* __restrict__ sel,
                      int n_groups, int width, int take) {
  __shared__ unsigned long long warp_min[kWarps];
  __shared__ int warp_cnt[kWarps];
  __shared__ unsigned long long picks[kMaxTake];

  const int row = blockIdx.x;
  const int lane = row / n_groups;
  const long long base = (long long)row * width;
  const bool elig = eligible[row] != 0;
  const bool bw = by_wear[lane] != 0;
  const int pge = per_group_eff[lane];
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;

  unsigned long long key[kMaxItems];
  int nfree = 0;
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int c = tid + i * kThreads;
    unsigned long long k = kGone;
    if (c < width) {
      const int a = avail[base + c];
      const bool f = elig && (a == 0 || a == 3) && c < pge;
      const unsigned long long w = (unsigned)wear[base + c];
      const unsigned long long cc = (unsigned)c;
      k = f ? (bw ? ((w << 32) | cc) : cc) : (kNonFree | cc);
      nfree += f;
    }
    key[i] = k;
  }

  // free count: warp sum, then one word per warp
#pragma unroll
  for (int off = 16; off; off >>= 1)
    nfree += __shfl_xor_sync(0xffffffffu, nfree, off);
  if (lid == 0) warp_cnt[wid] = nfree;

  for (int r = 0; r < take; ++r) {
    unsigned long long m = kGone;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) m = umin64(m, key[i]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      m = umin64(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lid == 0) warp_min[wid] = m;
    __syncthreads();
    m = warp_min[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = umin64(m, warp_min[w]);
    __syncthreads();  // warp_min is rewritten by the next round
    if (tid == 0) picks[r] = m;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i)
      if (key[i] == m) key[i] = kGone;  // keys are unique: one owner
  }
  __syncthreads();

  if (sel != nullptr) {
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int c = tid + i * kThreads;
      if (c < width) sel[base + c] = 0;
    }
    __syncthreads();
    if (tid < take && picks[tid] < kNonFree)
      sel[base + (int)(picks[tid] & 0xffffffffu)] = 1;
  }

  if (tid == 0) {
    // re-key the picks by (wear, col), non-free last, and insertion-sort
    unsigned long long sk[kMaxTake];
    for (int r = 0; r < take; ++r) {
      const unsigned long long c = picks[r] & 0xffffffffu;
      sk[r] = picks[r] < kNonFree
                  ? (((unsigned long long)(unsigned)wear[base + c] << 32) | c)
                  : (kNonFree | c);
    }
    for (int r = 1; r < take; ++r) {
      const unsigned long long v = sk[r];
      int j = r - 1;
      while (j >= 0 && sk[j] > v) {
        sk[j + 1] = sk[j];
        --j;
      }
      sk[j + 1] = v;
    }
    const int te = take_eff[lane];
    const float inf = __int_as_float(0x7f800000);
    float total = 0.0f;
    for (int r = 0; r < take; ++r) {
      const bool f = sk[r] < kNonFree;
      cols[(long long)row * take + r] = (int32_t)(sk[r] & 0xffffffffu);
      if (r < te) total += f ? (float)(uint32_t)(sk[r] >> 32) : inf;
    }
    cost[row] = total;
    int cnt = 0;
    for (int w = 0; w < kWarps; ++w) cnt += warp_cnt[w];
    ok[row] = cnt;
  }
}

}  // namespace

extern "C" int zns_alloc_rows(const void* wear, const void* avail,
                              const void* eligible, const void* by_wear,
                              const void* take_eff, const void* per_group_eff,
                              void* cols, void* ok, void* cost, void* sel,
                              int n_lanes, int n_groups, int width, int take,
                              void* stream) {
  if (width < 1 || width > kThreads * kMaxItems || take < 1 ||
      take > kMaxTake || take > width || n_groups < 1 || n_lanes < 1)
    return (int)cudaErrorInvalidValue;
  zns_alloc_rows_kernel<<<n_lanes * n_groups, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)wear, (const int32_t*)avail, (const int32_t*)eligible,
      (const int32_t*)by_wear, (const int32_t*)take_eff,
      (const int32_t*)per_group_eff, (int32_t*)cols, (int32_t*)ok,
      (float*)cost, (int32_t*)sel, n_groups, width, take);
  return (int)cudaGetLastError();
}
