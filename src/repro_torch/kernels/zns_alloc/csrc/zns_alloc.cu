// zns_alloc: masked per-LUN-group lowest-wear selection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/zns_alloc/zns_alloc.py (launched by
// `zns_alloc_pallas`), and the `lax.top_k` selection the JAX engine does
// inline in `_take_lowest` / `_cheapest_groups`, with the round-robin
// window, the wear bound and the claim around them
// (src/repro/core/engine.py).  The plain PyTorch versions of the same
// functions are ../ref.py; they agree bit for bit.
//
// The row selection: in a row (lane, group) of a wear / availability
// grid, column c is free when its availability is FREE (0) or INVALID
// (3), the row is eligible, c < the lane's own group width and -- under
// a wear bound -- its wear lies at most `bound` above the lane's least
// worn free element.  The row keeps the `take` smallest keys, (wear, c)
// for a free column under the wear-aware key, c for a free column under
// first fit, and after every free column the non-free ones by column; the
// picks come out ordered by (wear, c), non-free filler last.  Its cost is
// the f32 wear summed left to right over the first take_eff picks, +inf
// if one of them is not free.  Wear lies in [0, 2^30).
//
// Three entry points:
//   zns_alloc_rows   the row selection over a (L, G, W) batch, with the
//                    0/1 mask of the free picks (the Pallas contract);
//   zns_alloc_select the engine's whole ALLOC for every lane: traditional
//                    lanes take their round-robin window, or when a window
//                    group lacks take_eff free elements the zone_groups
//                    cheapest groups; silent lanes take the cheapest groups
//                    of the wear-bounded grid for the ranks the size hint
//                    needs; then the winning groups (the first zone_groups
//                    eligible, ascending, 0-filled) and their element ids;
//   zns_grow_select  the silent grow: the cheapest wear-bounded elements of
//                    one zone's own groups.
//
// What bounds it on an H100: launch latency and the chain of dependent
// steps inside one row, not bytes or operations.  At the engine's zn540
// shapes a lane's grid is 4 x 1056 int32 of wear and of availability (34
// KB), read in well under a microsecond; the work is a few compares per
// column.  So the design avoids everything that serialises: the engine's
// three selections and the masks around them (~110 small launches an op
// step) are one launch, each row is one warp with no block barrier per
// pick, and the picks are ordered by parallel rank counting.
//
// Design: one warp per row.  The warp first copies its row's wear and
// availability into shared memory with 4-byte cp.async, every copy in
// flight at once (a lane's rows start at any 4-byte offset), so the row
// costs one device-memory latency; every later pass reads shared memory
// 16 bytes (four columns) a lane at a time.  It stages each column's
// selection value -- the wear (or 0 under first fit) of a free column,
// 0xffffffff for a non-free one -- beside it, then finds the take-th
// smallest value by a binary search over the row's value span (one
// warp-wide count, `__reduce_add_sync`, per halving; no pass at all when
// at most `take` columns are free, and a few at the engine's narrow wear
// spans), then compacts the picks in column order (every column below
// the threshold, then the lowest columns at it; a lane's place is the
// prefix of the four-column counts below it, three ballots), orders them
// by rank counting over the <= 64 picks, and sums the cost as one
// integer where that is exact.  The fused kernels run one CTA per lane
// with one warp per group (n_groups <= 32): the lane-wide least wear and
// the cheapest-groups rank (cost ascending, ties to the lower group) are
// reductions over the CTA's warps in shared memory, a traditional lane
// ranks the cheapest groups only when its window fails, a silent lane
// never runs the round-robin selection, and the cheapest groups' one
// selection is also their claim.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTake = 64;
constexpr int kMaxGroups = 32;
constexpr int kRowWarps = 4;               // zns_alloc_rows: rows per CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNonFreeVal = 0xffffffffu;
constexpr unsigned long long kNonFree = 1ull << 62;
constexpr int kBig = 1 << 30;              // the engine's sentinel wear
constexpr int kSmemLimit = 232448;

// the lane table's columns (ref.LANE_FIELDS)
enum {
  kPerGroup, kNGroups, kZoneGroups, kTakeEff, kWearAware, kSilent,
  kWearBound, kPerRank, kTake, kLpg, kLaneFields
};

// (column tests combine with & and |, not && and ||: one warp runs a
// row alone on its scheduler, so every branch the short-circuit forms
// compile to lies on the critical path)
__device__ __forceinline__ bool avail_free(int a) {
  return (a == 0) | (a == 3);
}

// Python's floor division and remainder for a positive divisor
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int py_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// The row's columns in shared memory, padded to whole 16-byte vectors.
__host__ __device__ constexpr int padded(int width) {
  return (width + 3) & ~3;
}

// Per-warp scratch in shared memory: two keys per pick, and the row's
// wear, availability and selection values.
struct WarpScratch {
  unsigned long long* pick;    // [take] the picks' keys, column order
  unsigned long long* sorted;  // [take] the same, in (wear, col) order
  int32_t* wear;               // [padded(width)], 16-byte aligned
  int32_t* avail;              // [padded(width)]
  unsigned* val;               // [padded(width)] each column's value
};

// The scratch of warp `w` of `n_warps` in a CTA's dynamic shared memory:
// the keys of every warp, then each warp's rows.
__device__ __forceinline__ WarpScratch warp_scratch(unsigned long long* smem,
                                                    int w, int n_warps,
                                                    int width, int take) {
  const int wp = padded(width);
  WarpScratch ws;
  ws.pick = smem + w * take;
  ws.sorted = smem + (n_warps + w) * take;
  ws.wear = (int32_t*)(smem + 2 * n_warps * take) + 3 * w * wp;
  ws.avail = ws.wear + wp;
  ws.val = (unsigned*)(ws.avail + wp);
  return ws;
}

__host__ __device__ constexpr int scratch_bytes(int n_warps, int width,
                                                int take) {
  return n_warps * (16 * take + 12 * padded(width));
}

// Copies a row's wear and availability into the warp's scratch, every
// 4-byte copy in flight at once (a lane's rows start at any 4-byte
// offset).
__device__ __forceinline__ void stage_row(const int32_t* wear,
                                          const int32_t* avail, int width,
                                          const WarpScratch& ws) {
  for (int c = threadIdx.x & 31; c < width; c += 32) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(ws.wear + c)),
                 "l"(wear + c)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(ws.avail + c)),
                 "l"(avail + c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Where `n` (0..4) of this lane's four columns are counted, the exclusive
// prefix over the lanes below it: three ballots of the count's bits.
struct Prefix {
  int before, total;
};
__device__ __forceinline__ Prefix lane_prefix(int n, unsigned lt) {
  const unsigned b0 = __ballot_sync(kFull, n & 1);
  const unsigned b1 = __ballot_sync(kFull, n & 2);
  const unsigned b2 = __ballot_sync(kFull, n & 4);
  return {__popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt),
          __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2)};
}

// One warp selects the row's `take` smallest keys (see the header) from
// the row staged in `ws`, four columns a lane at a time (16-byte shared
// loads; lane l of step s holds columns 128 s + 4 l .. + 3, so the
// column order is the lane order).  `free_at(c, w, a)` says whether
// column c, of wear w and availability a, is free.  Writes the ordered
// columns to cols[0, take), the cost to *cost (if not null) and the 0/1
// mask of the free picks to sel[0, width) (if not null); returns the
// row's free count in every lane.
template <class Free>
__device__ int warp_select(Free free_at, int width, bool by_wear, int take,
                           int take_eff, const WarpScratch& ws,
                           int32_t* cols, float* cost, int32_t* sel) {
  const int l = threadIdx.x & 31;
  const unsigned lt = (1u << l) - 1u;
  const int n4 = padded(width) / 4;
  const int4* w4 = (const int4*)ws.wear;
  const int4* a4 = (const int4*)ws.avail;
  uint4* v4 = (uint4*)ws.val;

  // 1. stage the values (padding columns are not free); count the free
  // columns and their value span
  int nfree = 0;
  unsigned lo = kNonFreeVal, hi = 0;
  for (int i = l; i < n4; i += 32) {
    const int4 w = w4[i], a = a4[i];
    const int wv[4] = {w.x, w.y, w.z, w.w};
    const int av[4] = {a.x, a.y, a.z, a.w};
    unsigned v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * i + k;
      const bool f = (c < width) & free_at(c, wv[k], av[k]);
      v[k] = f ? (by_wear ? (unsigned)wv[k] : 0u) : kNonFreeVal;
      nfree += f;
      lo = min(lo, v[k]);
      hi = max(hi, f ? v[k] : 0u);
    }
    v4[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  nfree = __reduce_add_sync(kFull, nfree);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  __syncwarp();

  // 2. the threshold: the take-th smallest value, and how many lie below
  unsigned thr;
  int below = 0;
  if (nfree <= take) {
    thr = kNonFreeVal;                 // every free column, then filler
    below = nfree;
  } else {
    while (lo < hi) {
      const unsigned mid = lo + ((hi - lo) >> 1);
      int cnt = 0;
      for (int i = l; i < n4; i += 32) {
        const uint4 v = v4[i];
        cnt += (v.x <= mid) + (v.y <= mid) + (v.z <= mid) + (v.w <= mid);
      }
      cnt = __reduce_add_sync(kFull, cnt);
      if (cnt >= take) {
        hi = mid;
      } else {
        lo = mid + 1;
        below = cnt;
      }
    }
    thr = lo;
  }
  const int need_eq = take - below;

  // 3. compact the picks in column order: every value below the
  // threshold, then the lowest columns at it
  int n_eq = 0, n_pick = 0;
  for (int s0 = 0; s0 < n4; s0 += 32) {
    const int i = s0 + l;
    const bool in = i < n4;
    const uint4 vv = in ? v4[i] : make_uint4(kNonFreeVal, kNonFreeVal,
                                             kNonFreeVal, kNonFreeVal);
    const int4 ww = in ? w4[i] : make_int4(0, 0, 0, 0);
    const unsigned v[4] = {vv.x, vv.y, vv.z, vv.w};
    const int wv[4] = {ww.x, ww.y, ww.z, ww.w};
    bool eq[4];
    int n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      eq[k] = in & (4 * i + k < width) & (v[k] == thr);
      n += eq[k];
    }
    const Prefix e = lane_prefix(n, lt);
    int r = n_eq + e.before;
    bool pick[4];
    n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pick[k] = in & (4 * i + k < width) &
                ((v[k] < thr) | (eq[k] & (r < need_eq)));
      r += eq[k];
      n += pick[k];
    }
    const Prefix p = lane_prefix(n, lt);
    int pos = n_pick + p.before;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned long long c = (unsigned)(4 * i + k);
      if (pick[k])
        ws.pick[pos++] =
            v[k] != kNonFreeVal
                ? (((unsigned long long)(unsigned)wv[k] << 32) | c)
                : (kNonFree | c);
      if (sel != nullptr && in && 4 * i + k < width)
        sel[4 * i + k] = pick[k] && v[k] != kNonFreeVal;
    }
    n_eq += e.total;
    n_pick += p.total;
    if (sel == nullptr && n_pick >= take) break;   // warp-uniform
  }
  __syncwarp();

  // 4. order the picks by (wear, col), non-free last: each pick's place
  // is the count of smaller keys (the keys are unique)
  for (int j = l; j < take; j += 32) {
    const unsigned long long k = ws.pick[j];
    int r = 0;
#pragma unroll 8
    for (int q = 0; q < take; ++q) r += ws.pick[q] < k;
    ws.sorted[r] = k;
    cols[r] = (int32_t)(k & 0xffffffffu);
  }
  __syncwarp();

  // 5. the cost, summed left to right in f32 over the first take_eff
  // picks.  Where no pick is filler and their wears (each capped at
  // 2^24) sum below 2^24, every partial sum is an exact f32 integer, so
  // the sum is the integer sum; filler makes it +inf; otherwise one lane
  // adds them in order.
  if (cost != nullptr) {
    const int te = min(take, take_eff);
    unsigned sum = 0;
    bool nonfree = false;
    for (int r = l; r < te; r += 32) {
      const unsigned long long k = ws.sorted[r];
      nonfree |= k >= kNonFree;
      sum += min((unsigned)(k >> 32), 1u << 24);
    }
    nonfree = __any_sync(kFull, nonfree);
    sum = __reduce_add_sync(kFull, sum);
    if (l == 0) {
      float total = 0.0f;
      if (te > 0 && nonfree) {
        total = __int_as_float(0x7f800000);
      } else if (sum < (1u << 24)) {
        total = (float)sum;
      } else {
        for (int r = 0; r < te; ++r)
          total += (float)(unsigned)(ws.sorted[r] >> 32);
      }
      *cost = total;
    }
  }
  __syncwarp();
  return nfree;
}

// A row that is not eligible selects its first `take` columns, as a
// selection with no free column does.
__device__ __forceinline__ void filler(int32_t* cols, int take) {
  for (int r = threadIdx.x & 31; r < take; r += 32) cols[r] = r;
  __syncwarp();
}

// ---------------------------------------------------------------------- //
// zns_alloc_rows: one warp per row of a (L, G, W) batch
// ---------------------------------------------------------------------- //
__global__ void __launch_bounds__(kRowWarps * 32)
rows_kernel(const int32_t* __restrict__ wear,
            const int32_t* __restrict__ avail,
            const int32_t* __restrict__ eligible,
            const int32_t* __restrict__ by_wear,
            const int32_t* __restrict__ take_eff,
            const int32_t* __restrict__ per_group_eff,
            int32_t* __restrict__ cols, int32_t* __restrict__ ok,
            float* __restrict__ cost, int32_t* __restrict__ sel, int n_rows,
            int n_groups, int width, int take) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowWarps + wid;
  if (row >= n_rows) return;                      // whole warps only
  const int lane = row / n_groups;
  const WarpScratch ws = warp_scratch(smem, wid, kRowWarps, width, take);
  const long long base = (long long)row * width;
  stage_row(wear + base, avail + base, width, ws);
  const bool elig = eligible[row] != 0;
  const int pge = per_group_eff[lane];
  auto free_at = [=](int c, int, int a) {
    return elig & (c < pge) & avail_free(a);
  };
  const int n = warp_select(free_at, width, by_wear[lane] != 0, take,
                            take_eff[lane], ws, cols + (long long)row * take,
                            cost + row, sel != nullptr ? sel + base : nullptr);
  if ((threadIdx.x & 31) == 0) ok[row] = n;
}

// ---------------------------------------------------------------------- //
// the fused kernels: one CTA per lane, one warp per group
// ---------------------------------------------------------------------- //
struct LaneCta {
  int g, l, n_groups, width, take;
  WarpScratch ws;
  int32_t* cols_all;           // [n_groups][take] each group's picks
  int32_t* cols;               // this warp's row of it
};

// The warps' scratch, then each group's picks.
__device__ __forceinline__ LaneCta lane_cta(unsigned long long* smem,
                                            int n_groups, int width,
                                            int take) {
  LaneCta t;
  t.g = threadIdx.x >> 5;
  t.l = threadIdx.x & 31;
  t.n_groups = n_groups;
  t.width = width;
  t.take = take;
  t.ws = warp_scratch(smem, t.g, n_groups, width, take);
  t.cols_all = (int32_t*)((char*)smem +
                          scratch_bytes(n_groups, width, take));
  t.cols = t.cols_all + t.g * take;
  return t;
}

// The least wear of a free element of the lane's own grid (groups below
// n_groups_eff, columns below its group width), kBig if none.  Every
// thread of the CTA must call it.
__device__ int lane_min_wear(const LaneCta& t, int ng, int pge,
                             int* s_min) {
  int m = kBig;
  if (t.g < ng) {
    const int end = min(t.width, pge);
    const int4* w4 = (const int4*)t.ws.wear;
    const int4* a4 = (const int4*)t.ws.avail;
    for (int i = t.l; 4 * i < end; i += 32) {
      const int4 w = w4[i], a = a4[i];
      m = min(m, (4 * i < end) & avail_free(a.x) ? w.x : kBig);
      m = min(m, (4 * i + 1 < end) & avail_free(a.y) ? w.y : kBig);
      m = min(m, (4 * i + 2 < end) & avail_free(a.z) ? w.z : kBig);
      m = min(m, (4 * i + 3 < end) & avail_free(a.w) ? w.w : kBig);
    }
  }
  m = __reduce_min_sync(kFull, m);
  if (t.l == 0) s_min[t.g] = m;
  __syncthreads();
  int out = kBig;
  for (int gg = 0; gg < t.n_groups; ++gg) out = min(out, s_min[gg]);
  return out;
}

// The winners -- the first zone_groups eligible groups, ascending,
// 0-filled -- and their element ids, eids[p][r] = win[p] * width +
// cols[win[p]][r].  Rows that are not eligible must hold the filler.
__device__ void claim(const LaneCta& t, bool elig, int zone_groups,
                      int* s_elig, int* s_win, int32_t* win_out,
                      int32_t* eids_out) {
  if (t.l == 0) s_elig[t.g] = elig;
  __syncthreads();
  if ((int)threadIdx.x < zone_groups) {
    const int p = threadIdx.x;
    int w = 0, seen = 0;
    for (int gg = 0; gg < t.n_groups; ++gg) {
      if (s_elig[gg]) {
        if (seen == p) w = gg;
        ++seen;
      }
    }
    s_win[p] = w;
    if (win_out != nullptr) win_out[p] = w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < zone_groups * t.take; i += blockDim.x) {
    const int p = i / t.take;
    const int w = s_win[p];
    eids_out[i] = w * t.width + t.cols_all[w * t.take + (i - p * t.take)];
  }
}

// win (L, zone_groups), eids (L, zone_groups, take), feasible (L,) and
// lane_out (2, L): rr_next, then rank_lim.
__global__ void __launch_bounds__(kMaxGroups * 32)
alloc_select_kernel(const int32_t* __restrict__ wear,
                    const int32_t* __restrict__ avail,
                    const int32_t* __restrict__ lanes,
                    const int32_t* __restrict__ rr_next,
                    const int32_t* __restrict__ hint, long long hint_stride,
                    int32_t* __restrict__ win, int32_t* __restrict__ eids,
                    bool* __restrict__ feasible,
                    int32_t* __restrict__ lane_out, int n_groups, int width,
                    int take, int zone_groups, long long estride) {
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ int s_min[kMaxGroups], s_elig[kMaxGroups], s_win[kMaxGroups];
  __shared__ float s_cost[kMaxGroups];
  const LaneCta t = lane_cta(smem, n_groups, width, take);
  const int lane = blockIdx.x;
  const int32_t* lc = lanes + lane * kLaneFields;
  const int pge = lc[kPerGroup], ng = lc[kNGroups], zg = lc[kZoneGroups];
  const int take_eff = lc[kTakeEff], per_rank = lc[kPerRank];
  const bool sil = lc[kSilent] != 0;
  const int bound = lc[kWearBound];
  stage_row(wear + lane * estride + t.g * width,
            avail + lane * estride + t.g * width, width, t.ws);
  const int rr = rr_next[lane];
  const int hv = hint[lane * hint_stride];
  // the ranks a silent claim needs: ceil(hint / pages per rank) for a
  // positive hint, else the whole claim; at least one
  const int take_s =
      min(max(hv > 0 ? (hv - 1) / per_rank + 1 : take_eff, 1), take_eff);

  // traditional: the round-robin window, zg groups from rr mod ng
  bool f1 = false, elig1 = false;
  if (!sil) {
    for (int p = 0; p < min(zg, zone_groups); ++p)
      elig1 |= py_mod(rr + p, ng) == t.g;
    int ok1 = 0;
    if (elig1) {
      auto free_at = [=](int c, int, int a) {
        return (c < pge) & avail_free(a);
      };
      ok1 = warp_select(free_at, width, lc[kWearAware] != 0, take,
                        take_eff, t.ws, t.cols, nullptr, nullptr);
    } else {
      filler(t.cols, take);
    }
    f1 = __syncthreads_and(!elig1 || ok1 >= take_eff);
  }
  const bool use_rr = !sil && f1;

  // the cheapest groups: traditional's fallback, silent's claim on the
  // wear-bounded grid
  bool elig2 = false, f2 = false;
  if (!use_rr) {
    const int min_wear =
        sil ? lane_min_wear(t, ng, pge, s_min) : kBig;
    const int take_p = sil ? take_s : take_eff;
    int ok2 = 0;
    if (t.g < ng && pge > 0) {
      auto free_at = [=](int c, int w, int a) {
        return (c < pge) & avail_free(a) & (!sil | (w - min_wear <= bound));
      };
      ok2 = warp_select(free_at, width, true, take, take_p, t.ws,
                        t.cols, &s_cost[t.g], nullptr);
    } else if (t.l == 0) {
      s_cost[t.g] = min(take, take_p) > 0 ? __int_as_float(0x7f800000)
                                          : 0.0f;
    }
    __syncthreads();
    const float mine = s_cost[t.g];
    int rank = 0;
    for (int gg = 0; gg < n_groups; ++gg) {
      const float other = s_cost[gg];
      rank += other < mine || (other == mine && gg < t.g);
    }
    elig2 = rank < zg;
    f2 = __syncthreads_and(!elig2 || ok2 >= take_p);
  }

  const bool elig = use_rr ? elig1 : elig2;
  if (!elig) filler(t.cols, take);
  claim(t, elig, zone_groups, s_elig, s_win, win + lane * zone_groups,
        eids + (long long)lane * zone_groups * take);
  if (threadIdx.x == 0) {
    feasible[lane] = sil ? f2 : (f1 || f2);
    // the window advances even when the allocation then fails
    lane_out[lane] = sil ? rr : py_mod(rr + zg, ng);
    lane_out[gridDim.x + lane] = sil ? take_s : lc[kTake];
  }
}

// ints: lanes, n_groups, width, take, zone_groups, lane stride of
// wear/avail, n_zones, parallelism.
__global__ void __launch_bounds__(kMaxGroups * 32)
grow_select_kernel(const int32_t* __restrict__ wear,
                   const int32_t* __restrict__ avail,
                   const int32_t* __restrict__ lanes,
                   const int32_t* __restrict__ zone_cols,
                   const int32_t* __restrict__ zone,
                   const int32_t* __restrict__ kk, int32_t* __restrict__ eids,
                   bool* __restrict__ feasible, int n_groups, int width,
                   int take, int zone_groups, long long estride, int n_zones,
                   int parallelism) {
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ int s_min[kMaxGroups], s_elig[kMaxGroups], s_win[kMaxGroups];
  const LaneCta t = lane_cta(smem, n_groups, width, take);
  const int lane = blockIdx.x;
  const int32_t* lc = lanes + lane * kLaneFields;
  const int pge = lc[kPerGroup], ng = lc[kNGroups], zg = lc[kZoneGroups];
  const int bound = lc[kWearBound], lpg = lc[kLpg];
  stage_row(wear + lane * estride + t.g * width,
            avail + lane * estride + t.g * width, width, t.ws);
  const int min_wear = lane_min_wear(t, ng, pge, s_min);

  // the zone's winning groups, recovered from its column map
  const int z = min(max(zone[lane], 0), n_zones - 1);
  const int32_t* zc =
      zone_cols + ((long long)lane * n_zones + z) * parallelism;
  bool elig = false;
  if (lpg > 0)
    for (int p = 0; p < min(zg, zone_groups); ++p)
      elig |= floor_div(zc[min(max(p * lpg, 0), parallelism - 1)], lpg) ==
              t.g;
  const int k = kk[lane];
  int ok = 0;
  if (elig) {
    auto free_at = [=](int c, int w, int a) {
      return (c < pge) & avail_free(a) & (w - min_wear <= bound);
    };
    ok = warp_select(free_at, width, true, take, k, t.ws, t.cols,
                     nullptr, nullptr);
  } else {
    filler(t.cols, take);
  }
  const bool fg = __syncthreads_and(!elig || ok >= k);
  claim(t, elig, zone_groups, s_elig, s_win, nullptr,
        eids + (long long)lane * zone_groups * take);
  if (threadIdx.x == 0) feasible[lane] = fg;
}

__global__ void empty_kernel() {}

int fused_smem(int n_groups, int width, int take) {
  return scratch_bytes(n_groups, width, take) + n_groups * take * 4;
}

// Lets `kernel` use `bytes` of dynamic shared memory past the default
// 48 KB on the current device.  The attribute is the device's, so
// `granted` keeps the size set so far per device (kMaxDevices of them)
// and the attribute is set again only when a launch needs more.
constexpr int kMaxDevices = 64;

template <class K>
int allow_smem(K kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && bytes <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return (int)err;
}

}  // namespace

// ints: lanes, n_groups, width, take.
extern "C" int zns_alloc_rows(const void* wear, const void* avail,
                              const void* eligible, const void* by_wear,
                              const void* take_eff, const void* per_group_eff,
                              void* cols, void* ok, void* cost, void* sel,
                              const int* ints, void* stream) {
  const int n_lanes = ints[0], n_groups = ints[1], width = ints[2],
            take = ints[3];
  static int granted[kMaxDevices] = {};
  const int smem = scratch_bytes(kRowWarps, width, take);
  if (width < 1 || take < 1 || take > kMaxTake || take > width ||
      n_groups < 1 || n_lanes < 1 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(rows_kernel, smem, granted);
  if (err != 0) return err;
  const int n_rows = n_lanes * n_groups;
  rows_kernel<<<(n_rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, smem,
                (cudaStream_t)stream>>>(
      (const int32_t*)wear, (const int32_t*)avail, (const int32_t*)eligible,
      (const int32_t*)by_wear, (const int32_t*)take_eff,
      (const int32_t*)per_group_eff, (int32_t*)cols, (int32_t*)ok,
      (float*)cost, (int32_t*)sel, n_rows, n_groups, width, take);
  return (int)cudaGetLastError();
}

// ints: lanes, n_groups, width, take, zone_groups, lane stride.
extern "C" int zns_alloc_select(const void* wear, const void* avail,
                                const void* lanes, const void* rr_next,
                                const void* hint, long long hint_stride,
                                void* win, void* eids, void* feasible,
                                void* lane_out, const int* ints,
                                void* stream) {
  static int granted[kMaxDevices] = {};
  const int n_lanes = ints[0], n_groups = ints[1], width = ints[2],
            take = ints[3], zone_groups = ints[4];
  const int smem = fused_smem(n_groups, width, take);
  if (n_lanes < 1 || n_groups < 1 || n_groups > kMaxGroups || take < 1 ||
      take > kMaxTake || take > width || zone_groups < 1 ||
      zone_groups > n_groups || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(alloc_select_kernel, smem, granted);
  if (err != 0) return err;
  alloc_select_kernel<<<n_lanes, n_groups * 32, smem,
                        (cudaStream_t)stream>>>(
      (const int32_t*)wear, (const int32_t*)avail, (const int32_t*)lanes,
      (const int32_t*)rr_next, (const int32_t*)hint, hint_stride,
      (int32_t*)win, (int32_t*)eids, (bool*)feasible, (int32_t*)lane_out,
      n_groups, width, take, zone_groups, (long long)ints[5]);
  return (int)cudaGetLastError();
}

// ints: lanes, n_groups, width, take, zone_groups, lane stride, n_zones,
// parallelism.
extern "C" int zns_grow_select(const void* wear, const void* avail,
                               const void* lanes, const void* zone_cols,
                               const void* zone, const void* k, void* eids,
                               void* feasible, const int* ints,
                               void* stream) {
  static int granted[kMaxDevices] = {};
  const int n_lanes = ints[0], n_groups = ints[1], width = ints[2],
            take = ints[3], zone_groups = ints[4];
  const int smem = fused_smem(n_groups, width, take);
  if (n_lanes < 1 || n_groups < 1 || n_groups > kMaxGroups || take < 1 ||
      take > kMaxTake || take > width || zone_groups < 1 ||
      zone_groups > n_groups || smem > kSmemLimit || ints[6] < 1 ||
      ints[7] < 1)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(grow_select_kernel, smem, granted);
  if (err != 0) return err;
  grow_select_kernel<<<n_lanes, n_groups * 32, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)wear, (const int32_t*)avail, (const int32_t*)lanes,
      (const int32_t*)zone_cols, (const int32_t*)zone, (const int32_t*)k,
      (int32_t*)eids, (bool*)feasible, n_groups, width, take, zone_groups,
      (long long)ints[5], ints[6], ints[7]);
  return (int)cudaGetLastError();
}

// An empty kernel, one warp: what any launch through this route costs.
extern "C" int zns_alloc_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
