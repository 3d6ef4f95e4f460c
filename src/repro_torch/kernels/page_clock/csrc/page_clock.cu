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
// __fadd_rn, which the compiler may not fuse or reorder.  A parallel
// max-plus scan over the requests would reassociate the f32 additions and
// no longer equal the reference, so there is none.  What this kernel does
// use is the recurrence's own independence: a valid request reads and
// writes only its LUN's clock and its channel's clock.  Where no LUN of a
// row meets two channels (every geometry the repo has puts a LUN on one
// fixed channel, `lun % n_channels`), the requests of different channels
// share no clock, so each channel's requests form a chain of their own.
// Stepping each chain in stream order, on a thread of its own, performs
// the very same f32 operations on the very same values as stepping the
// whole row in order: every clock sees the same reads and writes in the
// same order.  An invalid request writes no clock and completes at 0, so
// it belongs to no chain.
//
// What bounds it on an H100: the dependent chain of one request (a max and
// two adds) times the requests of the longest channel chain, and around
// it the instructions a request costs its stepping thread; the 13 bytes a
// request moves through device memory are far below that.  A stepping
// thread that loads its next request from shared memory just before it
// needs it waits out that load every request, and a few warps of scalar
// loads from device memory deliver requests slower than the chains take
// them, so both are hidden.
//
// Design: one CTA of 512 threads per device row, in one launch.
//  * Pre-pass: every thread reads the row's requests once, 16-byte loads
//    (four requests an array a load, eight loads in flight), checks each
//    index (a bad one raises the error word, which the wrapper turns into
//    IndexError, and the row is not stepped) and records each LUN's
//    channel in a shared per-LUN slot (atomicCAS from -1, only on a LUN's
//    first sight).  A valid request whose channel differs from its LUN's
//    slot marks the row "whole".
//  * Partitioned rows (no LUN meets two channels, at most 32 channels):
//    lane c of warp 0 steps channel c's chain, with the channel's clock
//    and its LUNs' clocks in registers where the channel has at most 2
//    LUNs (an unrolled select on the LUN's index within its channel;
//    zn540 has 1, custom16 2), else with the LUN clocks in shared memory
//    (each owned by one lane).  Warps 1-8 stage the next chunk of 2048
//    requests meanwhile: 16-byte loads into packed words in shared
//    memory, then an order-preserving split into per-channel lists
//    (__match_any_sync ranks within a warp's 32 requests, per-warp counts,
//    one exclusive scan over channels), one 8-byte entry per valid
//    request: its t_op, its position in the chunk and its LUN.  A
//    stepping lane reads its entries eight at a time, a group ahead, and
//    writes each completion into the chunk's words at the request's
//    position (the stagers put the invalid requests' 0 there); the
//    stagers copy a chunk's completions to device memory, 16 bytes a
//    store, before they stage the chunk after next into its buffer.
//  * Whole rows: lane 0 of warp 0 steps every request in order with the
//    clocks in shared memory, its words read a group ahead too, each
//    completion in place of its word; warps 1-8 stage the packed words.
// One barrier a chunk; the stagers' own steps use a named barrier of
// their 256 threads; warps 9-15 only read in the pre-pass and copy out
// the last two chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageWarps = 8;
constexpr int kStageThreads = 32 * kStageWarps;
constexpr int kThreads = 512;   // warp 0 steps, 1-8 stage, all read
constexpr int kChunk = 2048;                   // requests staged at a time
constexpr int kSeg = kChunk / kStageWarps;     // a staging warp's share
constexpr int kRounds = kSeg / 32;
constexpr int kGroups = kChunk / 4 / kStageThreads;   // 16-byte groups
constexpr int kMaxResources = 1024;            // LUNs, and channels
constexpr int kMaxChains = 32;                 // channels, partitioned
constexpr int kMaxRegLuns = 2;                 // LUN clocks in registers
constexpr int kWhole = -1;                     // mode: one stepping thread
constexpr int kScanGroups = 8;                 // pre-pass loads in flight
constexpr int kRowChains = 1, kRowWhole = 2;   // a row's path, reported

static_assert(kChunk % (4 * kStageThreads) == 0, "chunk of 16-byte groups");
static_assert(kChunk <= 2048, "a list entry keeps 11 bits of position");

// A packed request word: lun in bits 0-9, channel in 10-19, op in 20-21,
// valid in 22.  A list entry: the request's t_op (f32 bits), then its
// position in the chunk in bits 0-10 and its LUN (its index within its
// channel where the clocks are registers) in bits 11-20.
__device__ __forceinline__ uint32_t pack(int op, int lun, int ch, bool ok) {
  return ((uint32_t)lun & 0x3ffu) | (((uint32_t)ch & 0x3ffu) << 10) |
         (((uint32_t)op & 3u) << 20) | ((uint32_t)ok << 22);
}

struct Row {
  const int32_t* ops;
  const int32_t* luns;
  const int32_t* chans;
  const bool* valid;
  float* done;
  long long f0, f1, a;   // the row's flat [f0, f1), its window start a
  int n_chunks;
};

// The requests of flat [f, f + 4) that lie in the row, as one 16-byte
// load of each array where all four do, else element by element; returns
// the mask of those present.
__device__ __forceinline__ unsigned load4(const Row& r, long long f,
                                          int4& o, int4& l, int4& c,
                                          uint32_t& v) {
  if (f >= r.f0 && f + 4 <= r.f1) {
    o = *(const int4*)(r.ops + f);
    l = *(const int4*)(r.luns + f);
    c = *(const int4*)(r.chans + f);
    v = *(const uint32_t*)(r.valid + f);
    return 0xfu;
  }
  int oo[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0}, cc[4] = {0, 0, 0, 0};
  uint32_t vv = 0;
  unsigned present = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long i = f + e;
    if (i >= r.f0 && i < r.f1) {
      oo[e] = r.ops[i];
      ll[e] = r.luns[i];
      cc[e] = r.chans[i];
      vv |= (uint32_t)(r.valid[i] ? 1 : 0) << (8 * e);
      present |= 1u << e;
    }
  }
  o = make_int4(oo[0], oo[1], oo[2], oo[3]);
  l = make_int4(ll[0], ll[1], ll[2], ll[3]);
  c = make_int4(cc[0], cc[1], cc[2], cc[3]);
  v = vv;
  return present;
}

__device__ __forceinline__ int lane_of(const int4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}

__device__ __forceinline__ void stager_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStageThreads) : "memory");
}

struct __align__(16) Shared {
  uint32_t req[2][kChunk];         // a chunk's words, then completions
  uint2 list[2][kChunk];           // per-channel lists, back to back
  float t_op[3];
  float lun_free[kMaxResources];
  float ch_free[kMaxResources];
  int slot[kMaxResources];         // LUN -> channel | index << 16, or -1
  int cnt[kStageWarps][kMaxChains];
  int base[kStageWarps][kMaxChains];
  int off[2][kMaxChains];
  int len[2][kMaxChains];
  int rev[kMaxChains][kMaxRegLuns];  // a channel's LUNs by index
  int n_own[kMaxChains];             // LUNs a channel
};

// Group q (four requests) of chunk k's completions, which the stepping
// threads left in place of the chunk's words, to device memory.
__device__ __forceinline__ void flush(const Shared& s, const Row& r, int k,
                                      int q) {
  const long long f = r.a + (long long)k * kChunk + 4 * q;
  const float4 v = *(const float4*)&s.req[k & 1][4 * q];
  if (f >= r.f0 && f + 4 <= r.f1) {
    *(float4*)(r.done + f) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (f + i >= r.f0 && f + i < r.f1) r.done[f + i] = e[i];
  }
}

// Warps 1-8: chunk k of the row into buffer b, after chunk k - 2's
// completions have left it (each thread flushes and packs the same
// groups).  Mode kWhole packs the words only; the partitioned modes also
// build the per-channel lists and put the invalid requests' 0 completions
// in place.
template <int M>
__device__ void stage(Shared& s, const Row& r, int k, int b, int st) {
  const long long cb = r.a + (long long)k * kChunk;
  const int j_lo = (int)max(r.f0 - cb, 0LL);
  const int j_hi = (int)min(r.f1 - cb, (long long)kChunk);
  int4 o[kGroups], l[kGroups], c[kGroups];
  uint32_t v[kGroups];
  unsigned present[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)   // every load in flight first
    present[g] = load4(r, cb + 4 * (st + g * kStageThreads), o[g], l[g],
                       c[g], v[g]);
  if (k >= 2) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      flush(s, r, k - 2, st + g * kStageThreads);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int j = 4 * (st + g * kStageThreads);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((present[g] >> e) & 1u)
        s.req[b][j + e] = pack(lane_of(o[g], e), lane_of(l[g], e),
                               lane_of(c[g], e), (v[g] >> (8 * e)) & 0xffu);
  }
  if constexpr (M != kWhole) {
    const int w = st >> 5, lane = st & 31;
    s.cnt[w][lane] = 0;
    stager_sync();
    // each warp ranks its 256 requests by channel, in order
    int key[kRounds], ofs[kRounds];
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int j = w * kSeg + i * 32 + lane;
      const uint32_t word = s.req[b][j];
      const bool ok = j >= j_lo && j < j_hi && ((word >> 22) & 1u);
      key[i] = ok ? (int)((word >> 10) & 0x3ffu) : -1;
      const unsigned m = __match_any_sync(kFull, key[i]);
      const int rank = __popc(m & ((1u << lane) - 1u));
      const int before = ok ? s.cnt[w][key[i]] : 0;
      ofs[i] = before + rank;
      __syncwarp();
      if (ok && rank == 0) s.cnt[w][key[i]] = before + __popc(m);
      __syncwarp();
    }
    stager_sync();
    if (w == 0) {   // each channel's list: after the channels before it
      int tot = 0;
#pragma unroll
      for (int ww = 0; ww < kStageWarps; ++ww) tot += s.cnt[ww][lane];
      int x = tot;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      int acc = x - tot;
      s.off[b][lane] = acc;
      s.len[b][lane] = tot;
#pragma unroll
      for (int ww = 0; ww < kStageWarps; ++ww) {
        s.base[ww][lane] = acc;
        acc += s.cnt[ww][lane];
      }
    }
    stager_sync();
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int j = w * kSeg + i * 32 + lane;
      if (key[i] >= 0) {
        const uint32_t word = s.req[b][j];
        const int lun = word & 0x3ffu;
        const uint32_t id = M > 0 ? (uint32_t)(s.slot[lun] >> 16)
                                  : (uint32_t)lun;
        s.list[b][s.base[w][key[i]] + ofs[i]] =
            make_uint2(__float_as_uint(s.t_op[(word >> 20) & 3u]),
                       (uint32_t)j | (id << 11));
      } else if (j >= j_lo && j < j_hi) {
        s.req[b][j] = 0u;      // f32 0
      }
    }
  }
}

// The stepping threads read their words kAhead at a time, one group ahead
// of the group they step: the compiler keeps a shared-memory load after
// an earlier store it cannot prove apart, so the loads are written first.
constexpr int kAhead = 8;

// Lane c of warp 0: channel c's requests of one chunk, in order, each
// completion to its position in `out`.  R LUN clocks in registers (R >
// 0), or the LUN clocks in shared memory (R 0).
template <int R>
struct Chain {
  float* out;
  float* lun_free;
  float ch;
  float lc[R > 0 ? R : 1];
  float tx;

  __device__ __forceinline__ void step(uint2 w) {
    const int id = (w.y >> 11) & 0x3ffu;
    float lv;
    if constexpr (R > 0) {
      lv = lc[0];
#pragma unroll
      for (int k = 1; k < R; ++k) lv = id == k ? lc[k] : lv;
    } else {
      lv = lun_free[id];
    }
    const float start = fmaxf(lv, ch);
    const float dx = __fadd_rn(start, tx);
    const float d = __fadd_rn(dx, __uint_as_float(w.x));
    ch = dx;
    if constexpr (R > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) lc[k] = id == k ? d : lc[k];
    } else {
      lun_free[id] = d;
    }
    out[w.y & 0x7ffu] = d;
  }

  __device__ __forceinline__ void run(const uint2* e, int count) {
    const int full = count - count % kAhead;
    uint2 w[kAhead];
    if (full > 0) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) w[i] = e[i];
    }
    int q = 0;
    for (; q < full; q += kAhead) {
      const int nq = q + kAhead < full ? q + kAhead : q;
      uint2 x[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) x[i] = e[nq + i];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) step(w[i]);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) w[i] = x[i];
    }
    for (; q < count; ++q) step(e[q]);
  }
};

// Lane 0 of warp 0: every request of one chunk, in order, the clocks in
// shared memory; each completion replaces its request's word.
struct Whole {
  uint32_t* req;
  float* lun_free;
  float* ch_free;
  float tx, t0, t1, t2;

  __device__ __forceinline__ void step(uint32_t w, int j) {
    const int lun = w & 0x3ffu, ch = (w >> 10) & 0x3ffu;
    const int op = (w >> 20) & 3u;
    const float top = op == 0 ? t0 : (op == 1 ? t1 : t2);
    const float start = fmaxf(lun_free[lun], ch_free[ch]);
    const float dx = __fadd_rn(start, tx);
    const float d = __fadd_rn(dx, top);
    const bool ok = (w >> 22) & 1u;
    if (ok) {
      lun_free[lun] = d;
      ch_free[ch] = dx;
    }
    req[j] = __float_as_uint(ok ? d : 0.0f);
  }

  __device__ __forceinline__ void run(int j_lo, int j_hi) {
    const int full = j_lo + (j_hi - j_lo) - (j_hi - j_lo) % kAhead;
    uint32_t w[kAhead];
    if (full > j_lo) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) w[i] = req[j_lo + i];
    }
    int j = j_lo;
    for (; j < full; j += kAhead) {
      const int nj = j + kAhead < full ? j + kAhead : j;
      uint32_t x[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) x[i] = req[nj + i];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) step(w[i], j + i);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) w[i] = x[i];
    }
    for (; j < j_hi; ++j) step(req[j], j);
  }
};

template <int M>
__device__ void run(Shared& s, const Row& r, int n_channels, float tx,
                    float t0, float t1, float t2) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int R = M > 0 ? M : 1;
  Chain<M> chain{nullptr, s.lun_free, 0.0f, {}, tx};
#pragma unroll
  for (int i = 0; i < R; ++i) chain.lc[i] = 0.0f;
  if (warp > 0 && warp <= kStageWarps && r.n_chunks > 0)
    stage<M>(s, r, 0, 0, tid - 32);
  __syncthreads();
  for (int k = 0; k < r.n_chunks; ++k) {
    const int b = k & 1;
    if (warp == 0) {
      const long long cb = r.a + (long long)k * kChunk;
      if constexpr (M == kWhole) {
        if (lane == 0) {
          Whole whole{s.req[b], s.lun_free, s.ch_free, tx, t0, t1, t2};
          whole.run((int)max(r.f0 - cb, 0LL),
                    (int)min(r.f1 - cb, (long long)kChunk));
        }
      } else if (lane < n_channels) {
        chain.out = (float*)s.req[b];
        chain.run(s.list[b] + s.off[b][lane], s.len[b][lane]);
      }
    } else if (warp <= kStageWarps && k + 1 < r.n_chunks) {
      stage<M>(s, r, k + 1, b ^ 1, tid - 32);
    }
    __syncthreads();
  }
  // the last two chunks' completions, which no later staging flushed
  for (int k = max(r.n_chunks - 2, 0); k < r.n_chunks; ++k)
    for (int q = tid; q < kChunk / 4; q += kThreads) flush(s, r, k, q);
  if constexpr (M > 0) {   // the register clocks back to their LUNs
    if (warp == 0 && lane < n_channels) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < s.n_own[lane]) s.lun_free[s.rev[lane][i]] = chain.lc[i];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) page_clock_kernel(
    const int32_t* __restrict__ ops, const int32_t* __restrict__ luns,
    const int32_t* __restrict__ chans, const bool* __restrict__ valid,
    const float* __restrict__ t_op, const float* __restrict__ t_xfer,
    float* __restrict__ done, float* __restrict__ makespan,
    int* __restrict__ err, int n, int n_luns, int n_channels) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Row r{ops, luns, chans, valid, done, 0, 0, 0, 0};
  r.f0 = (long long)blockIdx.x * n;
  r.f1 = r.f0 + n;
  r.a = r.f0 & ~3LL;      // 16-byte groups start on multiples of 4
  r.n_chunks = n > 0 ? (int)((r.f1 - r.a + kChunk - 1) / kChunk) : 0;
  for (int i = tid; i < n_luns; i += kThreads) {
    s.lun_free[i] = 0.0f;
    s.slot[i] = -1;
  }
  for (int i = tid; i < n_channels; i += kThreads) s.ch_free[i] = 0.0f;
  if (tid < 3) s.t_op[tid] = t_op[tid];
  __syncthreads();

  // the pre-pass: indices, and each LUN's channel
  const bool track = n_channels <= kMaxChains;
  bool bad = false, mixed = false;
  const long long n_groups = (r.f1 - r.a + 3) / 4;
  for (long long g0 = tid; g0 < n_groups; g0 += kScanGroups * kThreads) {
    int4 o[kScanGroups], l[kScanGroups], c[kScanGroups];
    uint32_t v[kScanGroups];
    unsigned present[kScanGroups];
#pragma unroll
    for (int u = 0; u < kScanGroups; ++u) {
      const long long g = g0 + (long long)u * kThreads;
      present[u] = g < n_groups ? load4(r, r.a + 4 * g, o[u], l[u], c[u],
                                        v[u])
                                : 0u;
    }
#pragma unroll
    for (int u = 0; u < kScanGroups; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((present[u] >> e) & 1u)) continue;
        const int op = lane_of(o[u], e), lun = lane_of(l[u], e);
        const int ch = lane_of(c[u], e);
        if ((unsigned)lun >= (unsigned)n_luns ||
            (unsigned)ch >= (unsigned)n_channels || (unsigned)op > 2u) {
          bad = true;
        } else if (track && ((v[u] >> (8 * e)) & 0xffu)) {
          int seen = s.slot[lun];   // a stale -1 only costs a CAS
          if (seen == -1) seen = atomicCAS(&s.slot[lun], -1, ch);
          if (seen != -1 && seen != ch) mixed = true;
        }
      }
  }
  if (__syncthreads_or(bad)) {
    if (tid == 0) atomicOr(err, 1);
    return;
  }
  mixed = __syncthreads_or(mixed);
  if (tid == 0)
    err[1 + blockIdx.x] = (!track || mixed) ? kRowWhole : kRowChains;
  const float tx = *t_xfer, t0 = t_op[0], t1 = t_op[1], t2 = t_op[2];
  if (!track || mixed) {
    run<kWhole>(s, r, n_channels, tx, t0, t1, t2);
  } else {
    if (warp == 0) {   // lane c numbers channel c's LUNs
      int k = 0;
      for (int i = 0; i < n_luns; ++i)
        if (s.slot[i] == lane) {
          s.slot[i] = lane | (k << 16);
          if (k < kMaxRegLuns) s.rev[lane][k] = i;
          ++k;
        }
      s.n_own[lane] = k;
      int most = k;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        most = max(most, __shfl_xor_sync(kFull, most, d));
      if (lane == 0) s.cnt[0][0] = most;
    }
    __syncthreads();
    const int most = s.cnt[0][0];
    __syncthreads();     // read before the stagers reuse cnt
    if (most <= 1)
      run<1>(s, r, n_channels, tx, t0, t1, t2);
    else if (most <= kMaxRegLuns)
      run<kMaxRegLuns>(s, r, n_channels, tx, t0, t1, t2);
    else
      run<0>(s, r, n_channels, tx, t0, t1, t2);
  }
  if (tid == 0) {
    float m = s.lun_free[0];
    for (int i = 1; i < n_luns; ++i) m = fmaxf(m, s.lun_free[i]);
    makespan[blockIdx.x] = m;
  }
}

}  // namespace

// ints: n_dev, n, n_luns, n_channels.  ops, luns, chans and valid are
// contiguous (n_dev, n) and 16-byte aligned.  `err` is 1 + n_dev zeroed
// int32: the kernel sets err[0] to nonzero when a request's lun, channel
// or op is out of range (that row is then not stepped), and err[1 + d] to
// the path row d took (1 one chain a channel, 2 whole).
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
  const void* inputs[4] = {ops, luns, chans, valid};
  for (const void* p : inputs)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  static bool sized = false;      // the Shared block is above 48 KB
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        page_clock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Shared));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  page_clock_kernel<<<n_dev, kThreads, sizeof(Shared),
                      (cudaStream_t)stream>>>(
      (const int32_t*)ops, (const int32_t*)luns, (const int32_t*)chans,
      (const bool*)valid, (const float*)t_op, (const float*)t_xfer,
      (float*)done, (float*)makespan, (int*)err, n, n_luns, n_channels);
  return (int)cudaGetLastError();
}
