// mlstm_chunkwise: the mLSTM's matrix-memory recurrence over a whole
// sequence in chunkwise form on the tensor cores, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// `lax.scan` (src/repro/models/xlstm.py, `mlstm_forward`'s `step`).  It
// computes the function of mlstm_scan.cu (the recurrent design, which the
// launch plan in ../ops.py keeps for f32 and the shapes this kernel does
// not take): q, k, v (B, S, H, P) bf16 read through their strides (the
// last dimension contiguous), the log gates li, lf (B, S, H) f32, and per
// (b, h) the state C (P x P), n (P), m from 0, 0, -1e30, each step
//     m'  = max(lf + m, li);  fp = exp(lf + m - m');  ip = exp(li - m')
//     C   = fp C + (ip v) k^T;  n = fp n + ip k;  h = C q / max(|n . q|, 1)
// writing h (B, S, H, P) contiguous in bf16.  The plain version of this
// algorithm is ../ref.py `mlstm_chunkwise_ref`; the stepped one,
// `mlstm_scan_ref`, is the yardstick of both designs.
//
// The algebra.  The stabiliser m is stepped exactly as the reference
// steps it (warp 10, every lane alike: the same f32 adds and maxes), so m
// and the per-step log factors a_s = (lf_s + m_{s-1}) - m_s and b_j = li_j
// - m_j are the reference's bit for bit.  Within a chunk of kL steps the
// update of step j weighs D[t][j] = exp(b_j + a_{j+1} + ... + a_t) at
// step t and the carried state cw_t = exp(a_0 + ... + a_t); each segment
// sum is added in that order, every term <= 0, so nothing cancels (a
// difference of two running sums would lose digits when the forget gates
// are near 0).  The clamp's 1 is on the stabilised scale, so this keeps
// it where the reference has it.  With S = Q K^T over the chunk,
//     den_t = cw_t (n . q_t) + sum_j S[t][j] D[t][j]
//     h_t   = (cw_t C q_t + sum_j S[t][j] D[t][j] v_j) / max(|den_t|, 1)
//     C     = cw_{L-1} C + sum_j (D[L-1][j] v_j) k_j^T   (n alike)
// so C q, (S D) V and the update are three tensor-core products.
//
// The design.  Each row of C (a v index) evolves alone, so a CTA owns
// kRows = 96 rows of one (b, h) -- 4 CTAs a head at P 384, 128 CTAs on
// 132 SMs at the served shape -- and keeps them in registers for the whole
// sequence as mma.m16n8k16 accumulators: 12 warps, a warp 16 rows by P / 2
// columns (96 f32 registers a thread at P 384), two warps a row group.  An
// accumulator pair is the A fragment of C q as it stands, so C never moves.
// The scores S and n . q need all P columns; each CTA recomputes them
// (S's causal tiles are 4 % of a chunk's MMAs) rather than writing
// per-chunk states: a two-pass form would write and read back a P^2 f32
// state a chunk and head, 2.4 GB at the served shape, 0.72 ms of HBM.
//
// The precision.  Three operands are f32: S D, C, and D v in the update.
// Each goes to the tensor cores as three bf16 parts hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), three products summed in f32,
// which carry x to 2^-24 of |x|; q, k and v are bf16 and exact.  A pair
// (2^-16) kept every kernel check, but it moved 0.2 % of h's bf16 values
// off the stepped plain version's, and xlstm-125m's prefill logits past
// their bar (src/repro_torch/tools/mlstm_operands.py measures each
// choice; PERF.md has the numbers).  The tensor cores' f32 sums truncate,
// so C q and S sum each k16 step's products apart and add them in f32;
// the state update adds into C directly (summing it apart lowered the
// flips no further).
//
// A chunk, between three barriers: (A) its q, k, v and gates are in; (C)
// six warps S's causal tiles, four n . q, warp 10 steps the stabiliser
// and the last row's weights -- beside them every warp finishes the
// previous chunk's h (its two halves' sums over max(|den|, 1), straight
// to device memory) and the previous chunk's state update, C = cw C +
// (D v)^T K with D v formed in registers from V's fragment, the tensor
// cores' longest phase; (D) the next chunk's rows go out by 16-byte
// cp.async into the stage the update has left; (E) eight warps the rows
// of D, S D (three parts), den and cw, four n's update; (F) every warp C
// q, the cw scaling and (S D) V over half the chunk, its sums to shared
// memory for (C) to finish.  Shared rows are padded by 16 bytes, so
// ldmatrix reads no bank twice.  155 KB a CTA at P 384, 114 KB of it the
// two stages.
//
// What bounds it on an H100.  At the served prefill (B 8, S 2048, H 4, P
// 384) the bytes (q, k, v, h bf16 and the gates, 0.2 GB) take 0.060 ms
// at 3.35 TB/s, its bound; the chunkwise form's products, each counted
// once (the causal Q K^T and (S D) V, C q, the update), are 40.1 GFLOP,
// 0.041 ms at 989 TFLOP/s.  This design issues 124.7 GFLOP of bf16 MMA
// (the three parts count thrice, and each of a head's CTAs computes S),
// 0.126 ms.  It runs at about a tenth of its bound: with C in 96 of a
// thread's 168 registers, three warps a scheduler hide little of the
// latency between a split, its MMAs and their sums, and the stabiliser's
// chain and the rows of D stand between the MMA phases (PERF.md).
//
// Limits (ops.py checks): bf16 only, P a multiple of 32 up to 384.  The
// kernel is instantiated for P tiles of 32, 128 and 384 columns; a P
// between them runs on the next wider one, the extra columns zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kL = 32;                  // steps a chunk
constexpr int kGroups = 6;              // row groups of 16 a CTA
constexpr int kRows = 16 * kGroups;     // rows of C a CTA
constexpr int kWarps = 2 * kGroups;     // two column halves a row group
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16 *q, *k, *v;
  const float *li, *lf;
  bf16* h;
  int s_len, n_heads, p_len;
  long long sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2;
  long long si0, si1, si2, sf0, sf1, sf2;
  int vec;                       // 16-byte copies allowed
};

// Shared memory of the instantiation for PT columns, in bytes.  Two
// stages, each Q and K (kL x PT) and the CTA's V rows (kL x kRows) in
// bf16 and the gates li, lf (2 x kL) f32; then S (f32), S D as three
// bf16 parts, the two column halves' sums of h (f32, kL x kRows each), n
// (PT f32) and the chunk's vectors a, b, w (two), cw, den, n . q and
// cw_{L-1} (two).
template <int PT>
struct Smem {
  static constexpr int kQS = PT + 8;          // Q, K row (elements)
  static constexpr int kVS = kRows + 8;       // V row
  static constexpr int kSS = kL + 8;          // S, S D row
  static constexpr int kHS = kRows + 4;       // a half's sums of h, row
  static constexpr int kQ = kL * kQS * 2;
  static constexpr int kV = kL * kVS * 2;
  static constexpr int kStage = 2 * kQ + kV + 2 * kL * 4;
  static constexpr int kSD = kL * kSS * 2;
  static constexpr int oS = 2 * kStage;
  static constexpr int oSD = oS + kL * kSS * 4;         // hi, mid, lo
  static constexpr int oHalf = oSD + 3 * kSD;
  static constexpr int oN = oHalf + 2 * kL * kHS * 4;
  static constexpr int oVec = oN + PT * 4;
  static constexpr int kBytes = oVec + (7 * kL + 4) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1,
                                      const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b on the tensor cores, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// the two halves of a bf16 pair as f32
__device__ __forceinline__ float low_f32(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float high_f32(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// (x0, x1) as three bf16 pairs, x0 in the low halves: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even;
// both differences are exact, so hi + mid + lo is x to 2^-24 of |x|
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack(__floats2bfloat162_rn(x0, x1));
  const float r0 = x0 - low_f32(hi), r1 = x1 - high_f32(hi);
  mid = pack(__floats2bfloat162_rn(r0, r1));
  lo = pack(__floats2bfloat162_rn(r0 - low_f32(mid), r1 - high_f32(mid)));
}

// Rows [t0, t0 + kL) of one (S, width) operand -- COLS elements from
// column `col0` of a row -- into smem rows of stride `ld`, zero past S
// and past column `limit`: by 16-byte cp.async where rows and strides are
// 16-byte aligned (a thread keeps one 16-byte column piece and steps its
// rows), else by plain loads.
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long srow, int t0, int s_len,
                                           int col0, int limit, int ld,
                                           bool vec) {
  if (vec) {
    constexpr int kPer = COLS / 8;             // 16-byte pieces a row
    constexpr int kStep = kThreads / kPer;     // rows a pass
    static_assert(kThreads % kPer == 0, "a row's pieces divide the CTA");
    const int c = (threadIdx.x % kPer) * 8;
    int s = threadIdx.x / kPer;
    const bool col_live = col0 + c < limit;
    const bf16* from = src + (t0 + s) * srow + col0 + c;
    for (; s < kL; s += kStep, from += kStep * srow) {
      const bool live = col_live && t0 + s < s_len;
      cp16(dst + s * ld + c, live ? from : src, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kL * COLS; i += kThreads) {
      const int s = i / COLS;
      const int c = i - s * COLS;
      const int t = t0 + s;
      dst[s * ld + c] = (t < s_len && col0 + c < limit)
                            ? src[t * srow + col0 + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// The chunk at t0 into stage `buf`: q, k, the CTA's v columns and the
// gates (threads 0-63, 4-byte cp.async)
template <int PT>
__device__ __forceinline__ void stage(const Args& g, char* sm, int buf,
                                      int t0, const bf16* q, const bf16* k,
                                      const bf16* v, const float* li,
                                      const float* lf, int r0) {
  using Sm = Smem<PT>;
  char* base = sm + buf * Sm::kStage;
  stage_rows<PT>((bf16*)base, q, g.sq1, t0, g.s_len, 0, g.p_len, Sm::kQS,
                 g.vec);
  stage_rows<PT>((bf16*)(base + Sm::kQ), k, g.sk1, t0, g.s_len, 0, g.p_len,
                 Sm::kQS, g.vec);
  stage_rows<kRows>((bf16*)(base + 2 * Sm::kQ), v, g.sv1, t0, g.s_len, r0,
                    g.p_len, Sm::kVS, g.vec);
  float* gs = (float*)(base + 2 * Sm::kQ + Sm::kV);
  const int i = threadIdx.x;
  if (i < 2 * kL) {
    const int t = t0 + (i < kL ? i : i - kL);
    const float* src = i < kL ? li + t * g.si1 : lf + t * g.sf1;
    cp4(gs + i, t < g.s_len ? src : li, t < g.s_len ? 4 : 0);
  }
}

template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_chunkwise_kernel(Args g) {
  using Sm = Smem<PT>;
  constexpr int KH = PT / 2;    // columns of C a warp holds
  constexpr int NT = KH / 8;    // its accumulator tiles
  constexpr int KS = KH / 16;   // its k16 steps of C q
  constexpr int QS = Sm::kQS, VS = Sm::kVS, SS = Sm::kSS, HS = Sm::kHS;
  extern __shared__ __align__(16) char sm[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp's index, from lane 0 so the compiler knows it is uniform
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int g8 = lane >> 2;
  const int c4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / g.n_heads;
  const int hh = bh - b * g.n_heads;
  const int r0 = blockIdx.x * kRows;
  const int v0 = (warp % kGroups) * 16;   // the warp's rows in the CTA
  const int kh = warp / kGroups;           // its column half
  const int k0 = kh * KH;
  const bool live = r0 + v0 < g.p_len;
  const int S = g.s_len;
  const int n_chunks = (S + kL - 1) / kL;
  // ldmatrix lane offsets: the row within an 8 x 8 matrix, and which
  // matrix of four (bit 3: second, bit 4: third and fourth)
  const int lr = lane & 7;
  const int m1 = ((lane >> 3) & 1) * 8;
  const int m2 = (lane >> 4) * 8;

  const bf16* q = g.q + b * g.sq0 + hh * g.sq2;
  const bf16* k = g.k + b * g.sk0 + hh * g.sk2;
  const bf16* v = g.v + b * g.sv0 + hh * g.sv2;
  const float* li = g.li + b * g.si0 + hh * g.si2;
  const float* lf = g.lf + b * g.sf0 + hh * g.sf2;

  float* s_s = (float*)(sm + Sm::oS);
  bf16* sdh = (bf16*)(sm + Sm::oSD);
  bf16* sdm = sdh + Sm::kSD / 2;
  bf16* sdl = sdm + Sm::kSD / 2;
  float* halves = (float*)(sm + Sm::oHalf);
  float* n_s = (float*)(sm + Sm::oN);
  float* a_s = (float*)(sm + Sm::oVec);
  float* b_s = a_s + kL;
  float* w_s = b_s + kL;            // two, by chunk parity
  float* cw_s = w_s + 2 * kL;
  float* den_s = cw_s + kL;
  float* nq_s = den_s + kL;
  float* cwl_s = nq_s + kL;         // two, by chunk parity

  // h of the chunk at t0 = (its halves' sums) / max(|den|, 1), 8 columns
  // a thread, to device memory
  auto finish = [&](int t0, int steps) {
    for (int i = tid; i < steps * (kRows / 8); i += kThreads) {
      const int t = i / (kRows / 8);
      const int col = (i - t * (kRows / 8)) * 8;
      if (r0 + col < g.p_len) {
        const float4* h0 = (const float4*)(halves + t * HS + col);
        const float4* h1 = (const float4*)(halves + (kL + t) * HS + col);
        const float d = den_s[t];
        uint4 out;
        uint32_t* po = (uint32_t*)&out;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 x = h0[e], y = h1[e];
          po[2 * e] = pack(__floats2bfloat162_rn((x.x + y.x) / d,
                                                 (x.y + y.y) / d));
          po[2 * e + 1] = pack(__floats2bfloat162_rn((x.z + y.z) / d,
                                                     (x.w + y.w) / d));
        }
        *(uint4*)(g.h + ((b * (long long)S + t0 + t) * g.n_heads + hh) *
                            g.p_len + r0 + col) = out;
      }
    }
  };

  float c[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  for (int i = tid; i < PT; i += kThreads) n_s[i] = 0.f;
  float m = -1e30f;      // the stabiliser, stepped by warp 10

  // A chunk's phases: (A) its data in; (C) its scores, n . q and
  // stabiliser beside the previous chunk's h and state update; (D) the
  // next chunk's staging into the previous one's stage, then (E) D, S D
  // and den; (F) its h sums.
  stage<PT>(g, sm, 0, 0, q, k, v, li, lf, r0);
  cp_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    const int par = ch & 1;
    const int t0 = ch * kL;
    const int steps = min(kL, S - t0);
    const bool more = ch + 1 < n_chunks;
    const char* base = sm + buf * Sm::kStage;
    const char* prev = sm + (buf ^ 1) * Sm::kStage;
    const bf16* qs = (const bf16*)base;
    const bf16* ks = (const bf16*)(base + Sm::kQ);
    const bf16* vs = (const bf16*)(base + 2 * Sm::kQ);
    const float* gli = (const float*)(base + 2 * Sm::kQ + Sm::kV);
    const float* glf = gli + kL;
    cp_wait_all();
    __syncthreads();     // (A) chunk ch is in, chunk ch - 1's h sums out
    // (C) S's causal tiles, n . q, the stabiliser and the last row
    if (warp < 6) {
      // tiles of 16 t by 8 j: (0, 0), (0, 1), (1, 0) ... (1, 3); each
      // k16 step's product summed apart, then added in f32
      const int tt = warp < 2 ? 0 : 16;
      const int jt = (warp < 2 ? warp : warp - 2) * 8;
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* qa = qs + (tt + lr + m1) * QS + m2;
      const bf16* kb = ks + (jt + lr) * QS + m1;
#pragma unroll
      for (int kk = 0; kk < PT; kk += 32) {
        uint32_t a[4], b0, b1;
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        ldsm4(a, qa + kk);
        ldsm2(b0, b1, kb + kk);
        mma(d0, a, b0, b1);
        ldsm4(a, qa + kk + 16);
        ldsm2(b0, b1, kb + kk + 16);
        mma(d1, a, b0, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s0[e] += d0[e];
          s1[e] += d1[e];
        }
      }
      float* row = s_s + (tt + g8) * SS + jt + 2 * c4;
      *(float2*)row = make_float2(s0[0] + s1[0], s0[1] + s1[1]);
      *(float2*)(row + 8 * SS) = make_float2(s0[2] + s1[2], s0[3] + s1[3]);
    } else if (warp < 10) {
      const int tb = (warp - 6) * 8;
      float part[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) part[r] = 0.f;
      for (int kk = 2 * lane; kk < PT; kk += 64) {
        const float2 nn = *(const float2*)(n_s + kk);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t qq = *(const uint32_t*)(qs + (tb + r) * QS + kk);
          part[r] = fmaf(nn.x, low_f32(qq), part[r]);
          part[r] = fmaf(nn.y, high_f32(qq), part[r]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          part[r] += __shfl_xor_sync(kFull, part[r], off);
      if (lane < 8) {
        float x = part[0];
#pragma unroll
        for (int r = 1; r < 8; ++r) x = lane == r ? part[r] : x;
        nq_s[tb + lane] = x;
      }
    } else if (warp == 10) {
      // the reference's step of m, the same f32 operations in order: lane
      // s holds step s's gates, every lane steps m alike and keeps its own
      // step's factors
      const float gi = gli[lane], gf = glf[lane];
      float a = 0.f, bb = -INFINITY;
#pragma unroll
      for (int s = 0; s < kL; ++s) {
        const float lfs = __shfl_sync(kFull, gf, s);
        const float lis = __shfl_sync(kFull, gi, s);
        if (s < steps) {
          const float x = lfs + m;
          const float mn = fmaxf(x, lis);
          if (lane == s) {
            a = x - mn;
            bb = lis - mn;
          }
          m = mn;
        }
      }
      a_s[lane] = a;
      b_s[lane] = bb;
      // the last row's weights w_j = D[steps - 1][j] and cw_{steps - 1}
      float seg = 0.f, segc = 0.f;
#pragma unroll
      for (int s = 0; s < kL; ++s) {
        const float x = __shfl_sync(kFull, a, s);
        if (s < steps) {
          if (s > lane) seg += x;
          segc += x;
        }
      }
      w_s[par * kL + lane] = lane < steps ? expf(bb + seg) : 0.f;
      if (lane == 0) cwl_s[par] = expf(segc);
    }
    if (ch > 0) finish(t0 - kL, kL);
    // chunk ch - 1's update: C = cw_{L-1} C + (D v)^T K, D v formed in
    // registers from V's fragment and w, in three bf16 parts
    if (ch > 0 && live) {
      const bf16* ks = (const bf16*)(prev + Sm::kQ);
      const bf16* vs = (const bf16*)(prev + 2 * Sm::kQ);
      const float* wp = w_s + (par ^ 1) * kL;
      const float cl = cwl_s[par ^ 1];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][e] *= cl;
#pragma unroll
      for (int js = 0; js < kL; js += 16) {
        uint32_t av[4], awh[4], awm[4], awl[4];
        ldsm4t(av, vs + (js + lr + m2) * VS + v0 + m1);
        // a fragment's columns: j = js + 2 c4 (+1) in av[0..1], + 8 in
        // av[2..3]
        const float2 w0 = *(const float2*)(wp + js + 2 * c4);
        const float2 w1 = *(const float2*)(wp + js + 8 + 2 * c4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 wv = i < 2 ? w0 : w1;
          split3(__fmul_rn(low_f32(av[i]), wv.x),
                 __fmul_rn(high_f32(av[i]), wv.y), awh[i], awm[i], awl[i]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm4t(bk, ks + (js + lr + m1) * QS + k0 + np * 16 + m2);
          mma(c[2 * np], awh, bk[0], bk[1]);
          mma(c[2 * np], awm, bk[0], bk[1]);
          mma(c[2 * np], awl, bk[0], bk[1]);
          mma(c[2 * np + 1], awh, bk[2], bk[3]);
          mma(c[2 * np + 1], awm, bk[2], bk[3]);
          mma(c[2 * np + 1], awl, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();     // (D)
    if (more) {
      stage<PT>(g, sm, buf ^ 1, t0 + kL, q, k, v, li, lf, r0);
      cp_commit();
    }

    // (E) D, S D (three bf16 parts), den, cw by rows; n's update
    if (warp < 8) {
      // rows tb .. tb + 3; lane j's column, lane s holding a_s
      const int j = lane;
      const float aj = a_s[j];
      const float bj = b_s[j];
      const int tb = warp * 4;
      float seg = 0.f, segc = 0.f;
#pragma unroll
      for (int s = 0; s < kL - 4; ++s) {
        const float x = __shfl_sync(kFull, aj, s);
        if (s < tb) {
          if (s > j) seg += x;
          segc += x;
        }
      }
      float sd[4], cw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = tb + r;
        const float x = __shfl_sync(kFull, aj, t);
        if (t > j) seg += x;
        segc += x;
        cw[r] = segc;
        sd[r] = j <= t ? __fmul_rn(s_s[t * SS + j], expf(bj + seg)) : 0.f;
        const bf16 hi = __float2bfloat16(sd[r]);
        const float rr = sd[r] - __bfloat162float(hi);
        const bf16 mi = __float2bfloat16(rr);
        sdh[t * SS + j] = hi;
        sdm[t * SS + j] = mi;
        sdl[t * SS + j] = __float2bfloat16(rr - __bfloat162float(mi));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sd[r] += __shfl_xor_sync(kFull, sd[r], off);
      if (lane < 4) {
        const int t = tb + lane;
        const float rs = lane == 0 ? sd[0] : lane == 1 ? sd[1]
                         : lane == 2 ? sd[2] : sd[3];
        const float c_ = expf(lane == 0 ? cw[0] : lane == 1 ? cw[1]
                              : lane == 2 ? cw[2] : cw[3]);
        cw_s[t] = c_;
        den_s[t] = fmaxf(fabsf(c_ * nq_s[t] + rs), 1.f);
      }
    } else if (more) {
      const int u = tid - 256;
      const float cl = cwl_s[par];
      for (int kk = 2 * u; kk < PT; kk += 2 * (kThreads - 256)) {
        float2 acc = *(const float2*)(n_s + kk);
        acc.x *= cl;
        acc.y *= cl;
#pragma unroll 8
        for (int j = 0; j < kL; ++j) {
          const uint32_t kv = *(const uint32_t*)(ks + j * QS + kk);
          acc.x = fmaf(w_s[par * kL + j], low_f32(kv), acc.x);
          acc.y = fmaf(w_s[par * kL + j], high_f32(kv), acc.y);
        }
        *(float2*)(n_s + kk) = acc;
      }
    }
    __syncthreads();     // (F)

    // (G) h's sums: C q (C in three bf16 parts, each k16 step summed
    // apart), scaled by cw, plus (S D) V over half the chunk
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    if (live) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t ah[4], am[4], al[4];
        split3(c[2 * s][0], c[2 * s][1], ah[0], am[0], al[0]);
        split3(c[2 * s][2], c[2 * s][3], ah[1], am[1], al[1]);
        split3(c[2 * s + 1][0], c[2 * s + 1][1], ah[2], am[2], al[2]);
        split3(c[2 * s + 1][2], c[2 * s + 1][3], ah[3], am[3], al[3]);
#pragma unroll
        for (int tp = 0; tp < 2; ++tp) {
          uint32_t bq[4];
          ldsm4(bq, qs + (tp * 16 + lr + m2) * QS + k0 + s * 16 + m1);
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
          mma(d0, ah, bq[0], bq[1]);
          mma(d0, am, bq[0], bq[1]);
          mma(d0, al, bq[0], bq[1]);
          mma(d1, ah, bq[2], bq[3]);
          mma(d1, am, bq[2], bq[3]);
          mma(d1, al, bq[2], bq[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[2 * tp][e] += d0[e];
            acc[2 * tp + 1][e] += d1[e];
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 cw = *(const float2*)(cw_s + nt * 8 + 2 * c4);
        acc[nt][0] *= cw.x;
        acc[nt][1] *= cw.y;
        acc[nt][2] *= cw.x;
        acc[nt][3] *= cw.y;
      }
      {
        const int j0 = kh * 16;
        uint32_t av[4];
        ldsm4t(av, vs + (j0 + lr + m2) * VS + v0 + m1);
#pragma unroll
        for (int tp = 0; tp < 2; ++tp) {
          const int off = (tp * 16 + lr + m2) * SS + j0 + m1;
          uint32_t bh_[4], bm_[4], bl_[4];
          ldsm4(bh_, sdh + off);
          ldsm4(bm_, sdm + off);
          ldsm4(bl_, sdl + off);
          mma(acc[2 * tp], av, bh_[0], bh_[1]);
          mma(acc[2 * tp], av, bm_[0], bm_[1]);
          mma(acc[2 * tp], av, bl_[0], bl_[1]);
          mma(acc[2 * tp + 1], av, bh_[2], bh_[3]);
          mma(acc[2 * tp + 1], av, bm_[2], bm_[3]);
          mma(acc[2 * tp + 1], av, bl_[2], bl_[3]);
        }
      }
      // the half's sums, as h[t][v]
      float* hp = halves + kh * kL * HS + v0 + g8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int t = nt * 8 + 2 * c4;
        hp[t * HS] = acc[nt][0];
        hp[(t + 1) * HS] = acc[nt][1];
        hp[t * HS + 8] = acc[nt][2];
        hp[(t + 1) * HS + 8] = acc[nt][3];
      }
    }
  }
  __syncthreads();
  finish((n_chunks - 1) * kL, S - (n_chunks - 1) * kL);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The shared-memory attribute past 48 KB is the device's: it is set once
// per device and instantiation (of the first kMaxDevices; on every launch
// past them).
template <int PT>
int launch_pt(const Args& g, int bh, cudaStream_t stream) {
  static bool granted[kMaxDevices] = {};
  const int bytes = Smem<PT>::kBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(mlstm_chunkwise_kernel<PT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) granted[dev] = true;
  }
  dim3 grid((g.p_len + kRows - 1) / kRows, bh);
  mlstm_chunkwise_kernel<PT><<<grid, kThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

int p_tile(int p_len) { return p_len <= 32 ? 32 : p_len <= 128 ? 128 : 384; }

}  // namespace

// The P tile a head size runs on (ops.py `launch_plan` mirrors it).
extern "C" int mlstm_chunkwise_tile(int p_len) { return p_tile(p_len); }

// bf16 q, k, v (B, S, H, P) with the given batch, time and head strides
// (elements) and a contiguous last dimension; li, lf (B, S, H) f32 with
// theirs; h (B, S, H, P) bf16 contiguous.  P a multiple of 32 up to 384.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mlstm_chunkwise_fwd(
    const void* q, const void* k, const void* v, const void* li,
    const void* lf, void* h, int b, int s_len, int n_heads, int p_len,
    long long sq0, long long sq1, long long sq2, long long sk0,
    long long sk1, long long sk2, long long sv0, long long sv1,
    long long sv2, long long si0, long long si1, long long si2,
    long long sf0, long long sf1, long long sf2, void* stream) {
  if (b < 1 || n_heads < 1 || (long long)b * n_heads > 65535 || s_len < 1 ||
      p_len < 32 || p_len > 384 || p_len % 32)
    return (int)cudaErrorInvalidValue;
  Args g{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)li,
         (const float*)lf, (bf16*)h, s_len, n_heads, p_len, sq0, sq1, sq2,
         sk0, sk1, sk2, sv0, sv1, sv2, si0, si1, si2, sf0, sf1, sf2, 0};
  g.vec = aligned16(q) && aligned16(k) && aligned16(v);
  for (long long st : {sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2})
    g.vec = g.vec && (st * 2) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int bh = b * n_heads;
  switch (p_tile(p_len)) {
    case 32: return launch_pt<32>(g, bh, st);
    case 128: return launch_pt<128>(g, bh, st);
    default: return launch_pt<384>(g, bh, st);
  }
}
