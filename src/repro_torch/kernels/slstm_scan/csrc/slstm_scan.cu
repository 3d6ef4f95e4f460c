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
// floor is the chain of S dependent steps, each a 4 d x ph product and
// two exchanges between CTAs: the stabiliser's maxima, then h.
//
// Two designs, one launch a call; ops.launch_plan picks one per shape.
//
// The cluster kernel (slstm_cluster_kernel), bf16 only: one thread-block
// cluster of c CTAs (8, or 16 where 8 would give a CTA more than 96
// units) steps one sequence.  CTA k owns units [k U, (k + 1) U), U = d /
// c, and the four gate columns of each of them in the flat (B, 4d)
// reading of rec: column q d + u is head (q d + u) / 4ph's column
// (q d + u) % 4ph, the reference's gate layout kept exactly.  Those
// columns of r_rec (ph rows each) are loaded once, before step 0, into
// registers as tensor-core fragments: 147 KB a CTA at the served shape
// (96 units, 96 registers a thread over 384 threads).  A step:
//   1. the recurrent sums of the CTA's 4U columns from the whole h_prev in
//      its shared memory, on the tensor cores (mma.sync m16n8k16 with f32
//      accumulate, the slice's transpose as A, h_prev as B's column 0);
//      each sum is rounded to the activation dtype and added to
//      f32(pre_x_t), and each unit's thread forms its gates;
//   2. the per-head maxima of lf and i over each warp's units (a
//      segmented max scan) go into every CTA of the cluster;
//   3. each unit's thread takes its head's maxima (the same values, so the
//      same m', in every CTA), updates c and n in registers, computes h,
//      writes it out and into every CTA's h_prev.
// The sums are f32, but in another order than the L2 kernel's, and the
// mma instruction's own f32 accumulation is not IEEE round-to-nearest
// add by add, so the two kernels' h differ by a few bf16 units (both
// well inside the plain version's tolerance).
// The exchanges of steps 2 and 3 are distributed-shared-memory stores
// that count their bytes on the receiving CTA's mbarrier (st.async with
// complete_tx); a CTA waits on its own mbarrier for the bytes of the
// step (try_wait.acquire.cluster), so no step holds a cluster barrier,
// which would cost more than the exchanges themselves.  h_prev is
// double-buffered (a CTA may write step t's h while another still reads
// step t - 1's); the maxima need no second buffer, since their next write
// follows the reader's h.
// A cluster barrier before step 0 makes sure every CTA's mbarriers are
// set up before the first remote store; after the last step a CTA waits
// for every byte sent into it, then a cluster barrier keeps every CTA
// until no store into it is left.  At B 8 and c 8 the served prefill
// uses 64 of the 132 SMs.
//
// The L2 kernel (slstm_scan_kernel), for f32 and for the bf16 shapes the
// cluster kernel does not take (a head's ph not 64, 128 or 192, a CTA's
// units not a multiple of 16, or more than 96 of them in 16 CTAs): one
// CTA a sequence, so the whole h_prev is exchanged through shared memory
// and a step is four barriers.  Each thread owns a group of 16 bytes of
// consecutive output columns of one head and sums its product over a
// range of r_rec's rows (the ph rows cut in `split` ranges, so 2 x 384
// threads at d 768 in bf16), kBatch 16-byte loads in flight at a time,
// straight from device memory (r_rec stays in the 50 MB L2 across steps);
// the gates, the per-head stabiliser (one warp a head, shuffles) and the
// state update run on shared-memory rows of d and 4d, and each thread's
// pre_x of the next step is loaded while this one runs.  The time a step
// is the SM's L2 read of r_rec (12.8 us at the served shape).

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------
// The cluster kernel
// ---------------------------------------------------------------------
constexpr int kMmaThreads = 384;       // 4U, 96 fragment registers each

struct ClusterArgs {
  const void* pre;
  const void* r;
  void* h;
  int s_len, d, n_heads, units;
  long long sp0, sp1;
};

// Dynamic shared memory a CTA: three mbarriers (32 bytes), then f32
// h_prev twice (2d: one step's h is written while the last one may still
// be read), the CTA's 4U recurrent sums, and the cluster's per-head
// maxima of lf and of i, one slot per (CTA, warp of unit threads, head):
// 2 x c x ceil(U / 32) x H.  ops.cluster_smem computes the same sum.
__host__ __device__ inline size_t cluster_smem(int d, int n_heads, int c) {
  const int units = d / c, wu = (units + 31) / 32;
  return 32 + sizeof(float) * (2 * (size_t)d + 4 * (size_t)units) +
         sizeof(float2) * (size_t)c * wu * n_heads;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `addr` (this CTA's shared memory) in CTA `rank`'s, as a shared::cluster
// address.
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A 4-byte store into another CTA's shared memory whose arrival counts
// its bytes on that CTA's mbarrier `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async2(uint32_t addr, float x, float y,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr), "r"(__float_as_uint(x)),
      "r"(__float_as_uint(y)), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t addr, float x, float y,
                                          float z, float w, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "r"(__float_as_uint(x)),
      "r"(__float_as_uint(y)), "r"(__float_as_uint(z)),
      "r"(__float_as_uint(w)), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n@!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product on the tensor cores: the slice held in registers as
// mma.m16n8k16 A fragments (its transpose: 16 columns x 16 rows of r_rec
// a fragment), two column tiles a warp and KB = ph / 16 row blocks; B is
// h_prev's 16 rows of a block in column 0, zeros elsewhere.  Within a
// block, the fragment's rows 2j, 2j + 1, 2j + 8, 2j + 9 are h's rows 4j
// to 4j + 3 (the same order for A and B, so the sum is the same sum), so
// that a lane's B is one 16-byte load.
template <int KB>
__global__ void __launch_bounds__(kMmaThreads) slstm_cluster_kernel(
    ClusterArgs g) {
  using T = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int seq = blockIdx.x / c;
  const int d = g.d, H = g.n_heads, ph = d / H, w4 = 4 * ph;
  const int U = g.units, nc = 4 * U, u0 = rank * U;
  const int WU = (U + 31) / 32;             // warps of unit threads
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = (uint64_t*)smem;   // maxima; h of even and odd steps
  float* hs = (float*)(smem + 32);
  float* rec = hs + 2 * d;                            // [nc]
  float2* pm = (float2*)(rec + nc);                   // [c][WU][H]
  const uint32_t bar_m = smem_addr(bars), bar_h0 = smem_addr(bars + 1);

  // the column of this CTA's local column lc
  auto column = [&](int lc) { return (lc / U) * d + u0 + lc % U; };

  // this warp's two column tiles of the slice, once
  uint32_t a[2][KB][4];
  int hb[2];
  {
    const unsigned short* rb = (const unsigned short*)g.r;
    const int grp8 = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int col_t = column(16 * (2 * warp + tt));
      hb[tt] = (col_t / w4) * ph;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col_t + grp8 + 8 * (j & 1);
          const int k = 16 * kb + 4 * tig + 2 * (j >> 1);
          const int hh = col / w4;
          const long long at = ((long long)hh * ph + k) * w4 + (col - hh * w4);
          a[tt][kb][j] = (uint32_t)rb[at] | ((uint32_t)rb[at + w4] << 16);
        }
    }
  }
  for (int u = tid; u < 2 * d; u += nt) hs[u] = 0.f;
  // bytes that reach this CTA a step: every (CTA, warp, head) run's two
  // maxima, and all d of h
  int runs = 0;
  for (int k = 0; k < c; ++k)
    for (int w = 0; w < WU; ++w)
      runs += (k * U + min(32 * w + 32, U) - 1) / ph - (k * U + 32 * w) / ph
              + 1;
  const uint32_t bytes_m = 8u * runs, bytes_h = 4u * d;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this thread's unit (tid < U): its state, its head, pre_x ahead; the
  // run of lanes of its warp on the same head
  const bool own = tid < U;
  const int u = u0 + tid, uh = own ? u / ph : -1 - lane;
  const unsigned same = warp < WU ? __match_any_sync(kFull, uh) : 0u;
  const int seg_lo = __ffs(same) - 1, seg_hi = 31 - __clz(same);
  const T* px = (const T*)g.pre + seq * g.sp0;
  T* out = (T*)g.h + (long long)seq * g.s_len * d;
  float cst = 0.f, nst = 0.f, m = -1e30f, nx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) nx[q] = own ? to_f32(px[q * d + u]) : 0.f;
  cluster_barrier();     // every CTA's mbarriers ready before a remote write

  for (int t = 0; t < g.s_len; ++t) {
    const int b = t & 1;                  // h(t) goes to buffer b
    if (t > 0) wait_phase(bar_h0 + 8 * (b ^ 1), ((t - 1) >> 1) & 1);
    if (tid == 0) {
      expect_bytes(bar_m, bytes_m);
      expect_bytes(bar_h0 + 8 * b, bytes_h);
    }
    float xs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xs[q] = nx[q];
      nx[q] = (own && t + 1 < g.s_len)
                  ? to_f32(px[(t + 1) * g.sp1 + q * d + u]) : 0.f;
    }
    // 1. the recurrent sums
    {
      const float* hprev = hs + (b ^ 1) * d;
      const int tig = lane & 3;
      float acc[2][2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[tt][j >> 2][j & 3] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const float4 hk =
              *(const float4*)(hprev + hb[tt] + 16 * kb + 4 * tig);
          const bool col0 = lane < 4;     // B's column 0: h; else zeros
          mma_bf16(acc[tt][kb & 1], a[tt][kb],
                   col0 ? pack_bf16(hk.x, hk.y) : 0u,
                   col0 ? pack_bf16(hk.z, hk.w) : 0u);
        }
      if (tig == 0) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const int lc = 16 * (2 * warp + tt) + (lane >> 2);
          rec[lc] = acc[tt][0][0] + acc[tt][1][0];
          rec[lc + 8] = acc[tt][0][2] + acc[tt][1][2];
        }
      }
    }
    __syncthreads();
    // 2. rec rounded to the activation dtype, plus pre_x; f made
    // log_sigmoid; each head's maxima of lf and i over this warp's units
    // (a segmented max scan) into every CTA of the cluster
    float v[4];
    if (warp < WU) {
      float mf = -INFINITY, mi = -INFINITY;
      if (own) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = rounded<T>(rec[q * U + tid]) + xs[q];
        const float nf = -v[2];
        v[2] = -(fmaxf(nf, 0.f) + log1pf(expf(-fabsf(nf))));
        mf = v[2];
        mi = v[1];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float yf = __shfl_up_sync(kFull, mf, off);
        const float yi = __shfl_up_sync(kFull, mi, off);
        if (lane - off >= seg_lo) {
          mf = fmaxf(mf, yf);
          mi = fmaxf(mi, yi);
        }
      }
      if (own && lane == seg_hi) {
        const uint32_t at = smem_addr(pm + (rank * WU + warp) * H + uh);
        for (int k = 0; k < c; ++k)
          st_async2(remote(at, k), mf, mi, remote(bar_m, k));
      }
    }
    // 3. the state and the output, and h into every CTA, 16 bytes a store
    // (U is a multiple of 16)
    if (warp < WU) {
      float hf = 0.f;
      if (own) {
        const float zt = tanhf(v[0]);           // before the wait: off the
        const float sig = 1.f / (1.f + expf(-v[3]));   // exchange's path
        wait_phase(bar_m, t & 1);
        float mf = -INFINITY, mi = -INFINITY;
        const int h_lo = uh * ph, h_hi = h_lo + ph;
        for (int k = h_lo / U; k <= (h_hi - 1) / U; ++k)
          for (int w = 0; w < WU; ++w) {
            const int lo = max(k * U + 32 * w, h_lo);
            const int hi = min(k * U + min(32 * w + 32, U), h_hi);
            if (lo < hi) {
              const float2 x = pm[(k * WU + w) * H + uh];
              mf = fmaxf(mf, x.x);
              mi = fmaxf(mi, x.y);
            }
          }
        const float m_new = fmaxf(mf + m, mi);
        const float fp = expf(v[2] + m - m_new);
        const float ip = expf(v[1] - m_new);
        cst = cst * fp + ip * zt;
        nst = nst * fp + ip;
        m = m_new;
        const T hv = from_f32<T>(sig * (cst / fmaxf(nst, 1e-6f)));
        out[(long long)t * d + u] = hv;
        hf = to_f32(hv);
      }
      const uint32_t ah = smem_addr(hs + b * d + u), bh = bar_h0 + 8 * b;
      const float h1 = __shfl_down_sync(kFull, hf, 1);
      const float h2 = __shfl_down_sync(kFull, hf, 2);
      const float h3 = __shfl_down_sync(kFull, hf, 3);
      if (own && (lane & 3) == 0)
        for (int k = 0; k < c; ++k)
          st_async4(remote(ah, k), hf, h1, h2, h3, remote(bh, k));
    }
  }
  // every byte sent into this CTA has arrived; then no CTA leaves before
  // the others are done writing into it
  const int last = g.s_len - 1;
  wait_phase(bar_h0 + 8 * (last & 1), (last >> 1) & 1);
  cluster_barrier();
}

template <int KB>
int launch_cluster(ClusterArgs g, int b, int c, int* active,
                   cudaStream_t stream) {
  auto kern = slstm_cluster_kernel<KB>;
  const size_t bytes = cluster_smem(g.d, g.n_heads, c);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (c > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * c, 1, 1);
  cfg.blockDim = dim3(4 * g.units, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(active, (void*)kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (*active < 1) return -1;          // the cluster cannot be scheduled
  err = cudaLaunchKernelEx(&cfg, kern, g);
  if (err != cudaSuccess) return (int)err;
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

// The cluster kernel.  Arguments as slstm_scan_fwd's (bf16 only), and
// the launch plan's cluster size (8 or 16, dividing d) and row blocks kb = d / H / 16 (4, 8 or 12), with d / cluster a
// multiple of 16 and at most 96 (4 d / cluster threads); `active`
// receives cudaOccupancyMaxActiveClusters.  Returns -1 where no cluster
// of that shape can be scheduled, else the CUDA error of the launch (0
// on success).
extern "C" int slstm_scan_cluster_fwd(const void* pre, const void* r,
                                      void* h, int dtype, int b, int s_len,
                                      int d, int n_heads, long long sp0,
                                      long long sp1, int cluster, int kb,
                                      int* active, void* stream) {
  *active = 0;
  if (dtype != 1 || b < 1 || s_len < 1 || n_heads < 1 || d < 1 ||
      d % n_heads || (cluster != 8 && cluster != 16) || d % cluster)
    return (int)cudaErrorInvalidValue;
  const int units = d / cluster, ph = d / n_heads;
  if (units % 16 || 4 * units > kMmaThreads || ph != 16 * kb)
    return (int)cudaErrorInvalidValue;
  ClusterArgs g{pre, r, h, s_len, d, n_heads, units, sp0, sp1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kb) {
    case 4: return launch_cluster<4>(g, b, cluster, active, st);
    case 8: return launch_cluster<8>(g, b, cluster, active, st);
    case 12: return launch_cluster<12>(g, b, cluster, active, st);
  }
  return (int)cudaErrorInvalidValue;
}
