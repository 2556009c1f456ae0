// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention/kernel.py (`_attn_kernel`, called by
// `flash_attention_bhsd`): online-softmax attention with a causal mask, a
// sliding window, tanh soft-capping of the logits (`cap`) and grouped-query
// attention by index (kv head = h / (H / KH), never materialised per query
// head).  Running max, denominator and accumulator are float32; the output
// is acc / max(l, 1e-30) cast to q's dtype.
//
// Semantics kept from the TPU kernel, by both paths below:
//  * masked logits take the FINITE value -1e30, not -inf.  A row that is
//    fully masked inside a live tile (a window shorter than the tile) then
//    gets p = exp(0) = 1 on zero-filled or masked columns, and the next
//    tile that holds a live column wipes that out with alpha = exp(-1e30 -
//    m) = 0.  With -inf the same row would give exp(-inf + inf) = NaN.
//  * positions are row and column indices; the cap is applied before the
//    mask.
//  * fully masked key tiles are skipped structurally: a query tile walks
//    key tiles from the first one the window reaches to the one holding its
//    last row (causal), and the longest query tiles are scheduled first.
// Differences of layout: q, k, v and o are read and written in the model
// layout (B, S, H, D) through their strides, so the wrapper makes no
// transposed or padded copies; ragged ends of S and T are masked here.  No
// atomics and no split over keys: reruns are bit-identical.
//
// What bounds it: at yi-6b's prefill (B=4, S=T=4000, H=32, KH=4, D=128,
// causal) the live score entries need ~5.2e11 flops against ~295 MB of
// traffic, so attention is bound by operations: 0.53 ms at 989 TFLOP/s on
// the bf16 tensor cores.  The two dtypes take two designs, chosen by
// dtype, never by size; both cover every head dim of HEAD_DIMS.
//
// float32 (`flash_attention_f32`): the CUDA cores' float32 FMA, no TF32,
// so f32 inputs keep the reference's full-f32 scores (the arithmetic check
// of the callers).  One block of 128 threads per (64 query rows, b*h);
// the scaled q tile and 64-row K and V tiles are staged in shared memory
// as float32; each thread owns 4 rows x 8 key columns of the score tile.
//
// bfloat16 (`flash_attention_bf16`): the tensor cores by wgmma, the only
// way to their full rate, fed by TMA.  One block of 3 warpgroups per (128 query
// rows, b*h):
//  * the producer warpgroup (40 registers a thread after setmaxnreg) has
//    one thread keep TMA loads in flight: Q once, then K and V tiles of
//    128 rows into a ring of 3 stages, each completion counted in bytes
//    on an mbarrier ("full"); it refills a stage once the 8 consumer
//    warps have arrived on its "empty" mbarrier.  The tensor maps are
//    built at launch from the model-layout strides (4-D: d, row, head,
//    batch), so ragged rows beyond S and T arrive as zeros; tiles land
//    swizzled (128 B rows; 64 B / 32 B at D = 32 / 16), so wgmma reads
//    them without bank conflicts.
//  * two consumer warpgroups (232 registers) own 64 query rows each.
//    S = Q K^T is a wgmma with both operands in shared memory (m64n128k16,
//    f32 accumulators in registers); the softmax turns S into P in
//    registers, rounded to bf16 in FlashAttention's register layout, which
//    is the A operand of the P.V wgmma (V from shared memory, MN-major).
//    Tile i's P.V is issued together with tile i + 1's Q K^T and runs
//    while tile i + 1's softmax does, and the two consumers take turns at
//    issuing (named barriers), so one's softmax overlaps the other's
//    products.
//  * Shared memory at D = 128: Q 32 KB + 3 x (K 32 KB + V 32 KB) = 224 KB
//    and 7 mbarriers: one block an SM.
//  * Interior tiles skip the mask arithmetic; only diagonal, window-edge
//    and ragged tiles apply it, decided per warpgroup.
//  What bounds it now: ~1.5 ms at yi-6b's prefill on an H100 80GB HBM3
//  (700 W), 2.9x the bound.  ptxas allocates the consumer code within the
//  168 registers of the launch bound (R0-R167 in the SASS, though
//  setmaxnreg gives it 232 at run time), so the 128-key tile just fits
//  without spills; and it serialises the wgmmas (note C7513: every HGMMA
//  waits for the one before, its descriptors rebuilt in the same uniform
//  registers in between), so the tensor cores idle between products.
// Numerics: scores are raw bf16 q.k summed in float32 and then multiplied
// by scale * log2(e) in float32 (q * scale is never rounded to bf16; with
// a cap, tanh(s * scale / cap) * cap * log2(e)); the mask, the running
// max and l stay float32; 2^x is ex2.approx (2 ulp, denormal results
// flushed to zero).  The one new rounding is P to bf16 for P.V.  l sums
// the ROUNDED p: o is then a true weighted mean of V's rows with weights
// that sum to one (a constant V comes back exact), and P's rounding moves
// o by at most 2^-8 * sum_j w_j |v_j - o|, w the softmax weights.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // float32 path: query rows per block
constexpr int BK = 64;        // float32 path: key rows per tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirror: FlashParams in kernels/flash_attention/kernel.py.
struct FlashParams {
  int64_t b, s, t, h, kh, d;
  int64_t q_sb, q_ss, q_sh;   // element strides; the last dim is contiguous
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t causal, window;
  int32_t dtype;              // 0 float32, 1 bfloat16
  int32_t reserved;
  float scale, cap;
};

namespace {

// Key tiles of bk rows a query tile [q0, q0 + bq) visits: [lo, hi].
__device__ __forceinline__ void key_tiles(const FlashParams& p, int64_t q0,
                                          int64_t bq, int64_t bk, int64_t& lo,
                                          int64_t& hi) {
  const int64_t q_last = (q0 + bq < p.s ? q0 + bq : p.s) - 1;
  hi = (p.t + bk - 1) / bk - 1;
  if (p.causal && q_last / bk < hi) hi = q_last / bk;
  lo = 0;
  if (p.window) {
    const int64_t first = q0 - p.window + 1;  // first key the window reaches
    if (first > 0) lo = first / bk;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BK / 8;   // key columns per thread (strided by 8)
static_assert(NTHREADS == (BQ / RPT) * 8, "8 threads per row group");

template <int D>
struct LayoutF32 {
  static constexpr int QS = D + 1;   // padded row stride of Q and K tiles
  static constexpr int PS = BK + 1;  // padded row stride of the P tile
  static constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  static constexpr size_t bytes =
      (size_t)(BQ * QS + KP + BK * D) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_f32(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    const FlashParams p) {
  using L = LayoutF32<D>;
  constexpr int DPT = D / 8;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][QS], q * scale
  float* Ks = Qs + BQ * L::QS;        // [BK][QS]; then P as [BQ][PS]
  float* Vs = Ks + L::KP;             // [BK][D]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;            // row group: rows tr*RPT .. +RPT-1
  const int tc = tid & 7;             // columns tc, tc+8, ...
  const int64_t bi = blockIdx.x / p.h;
  const int64_t hi = blockIdx.x % p.h;
  const int64_t khi = hi / (p.h / p.kh);
  // longest (last) query tiles first: the causal loop is longest there
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;

  const float* qb = q + bi * p.q_sb + hi * p.q_sh;
  const float* kb = k + bi * p.k_sb + khi * p.k_sh;
  const float* vb = v + bi * p.v_sb + khi * p.v_sh;
  float* ob = o + bi * p.o_sb + hi * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int64_t row = q0 + r;
    Qs[r * L::QS + c] = row < p.s ? qb[row * p.q_ss + c] * p.scale : 0.f;
  }

  int64_t kt_lo, kt_hi;
  key_tiles(p, q0, BQ, BK, kt_lo, kt_hi);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int64_t kt = kt_lo; kt <= kt_hi; ++kt) {
    const int64_t k0 = kt * BK;
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const int64_t row = k0 + r;
      const bool in = row < p.t;
      Ks[r * L::QS + c] = in ? kb[row * p.k_st + c] : 0.f;
      Vs[r * D + c] = in ? vb[row * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr * RPT + i) * L::QS + dd];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tc + 8 * j) * L::QS + dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    __syncthreads();  // every thread is done with K: its space takes P

    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr * RPT + i;
      const int64_t qpos = q0 + r;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int64_t kpos = k0 + tc + 8 * j;
        float x = sc[i][j];
        if (p.cap != 0.f) x = tanhf(x / p.cap) * p.cap;
        bool ok = kpos < p.t;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window) ok = ok && qpos - kpos < p.window;
        x = ok ? x : NEG_INF;
        sc[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 4));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(sc[i][j] - mn);
        Ps[r * L::PS + tc + 8 * j] = pj;
        rs += pj;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      rs += __shfl_xor_sync(FULL, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr * RPT + i) * L::PS + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[kk * D + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // before the next tile overwrites P and V
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + tr * RPT + i;
    if (row >= p.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      ob[row * p.o_ss + tc + 8 * c] = acc[i][c] / den;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int WG_BM = 128;         // query rows a block: 2 consumers x 64
constexpr int WG_BN = 128;         // key rows a tile
constexpr int WG_STAGES = 3;       // K/V ring
constexpr int WG_THREADS = 384;    // producer warpgroup + 2 consumers
// registers a thread: the producer gives up what the consumers take
// (40 * 128 + 2 * 232 * 128 = 64,512 of the SM's 65,536)
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;

template <int D>
struct LayoutWg {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // swizzle row, bytes
  static constexpr int NCB = D * 2 / RB;                 // column blocks
  static constexpr uint32_t SWZ = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = WG_BM * D * 2;
  static constexpr int KV_BYTES = WG_BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + WG_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + WG_STAGES * KV_BYTES;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr size_t bytes = BAR_OFF + 8 * (1 + 3 * WG_STAGES) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (d, row, head, batch) into shared memory;
// completion is reported to `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(row),
         "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor of wgmma: start, leading and stride byte
// offsets, swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}

// named barriers 1, 2: the consumers' turns at the tensor cores
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// 2^x, approximate (2 ulp), denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keep the compiler from touching accumulators while wgmma owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A B, A and B in shared memory by descriptor, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (P) in registers, B (V) in shared memory, MN-major

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// registers a wgmma reads (A fragments) stay untouched until its wait
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// One tile of scores (a warp's wgmma accumulator layout: row qrow (+8 for
// odd pairs), column kcol + 8 * (i / 4) + (i & 1)) to the log2 domain,
// capped and masked as the template says; mt takes the row maxima.
template <bool CAP, bool MASK>
__device__ __forceinline__ void log2_scores(float (&sc)[WG_BN / 2],
                                            float (&mt)[2], float sc_mul,
                                            float cap_mul,
                                            const FlashParams& p,
                                            int64_t qrow, int64_t kcol) {
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) {
    const int e = i & 3;
    float x = sc[i] * sc_mul;
    if (CAP) x = tanhf(x) * cap_mul;
    if (MASK) {
      const int64_t qpos = qrow + (e >> 1) * 8;
      const int64_t kpos = kcol + (i >> 2) * 8 + (e & 1);
      bool ok = kpos < p.t;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.window) ok = ok && qpos - kpos < p.window;
      x = ok ? x : NEG_INF;
    }
    sc[i] = x;
    mt[e >> 1] = fmaxf(mt[e >> 1], x);
  }
}

// One tile's scores (a thread's part of a consumer's wgmma accumulator:
// rows qrow and qrow + 8, columns k0 + 2 * t4 + 8n + {0, 1}) to P: log2
// domain, cap, mask on edge tiles, the running max m, the rescale factors
// alpha of the tiles before, l, and P rounded to bf16 in registers as the
// A operand of P.V (k-step j is S's n8 blocks 2j and 2j + 1).  l sums the
// rounded p.  Whether the tile is an edge tile is decided for the whole
// warpgroup (rows r0 .. r0 + 63): a branch that differs between its warps
// while a wgmma runs would serialise the wgmmas.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[WG_BN / 2], uint32_t (&pout)[WG_BN / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], const FlashParams& p, int64_t r0,
    int64_t qrow, int64_t k0, int t4, float sc_mul, float cap_mul) {
  const int64_t kcol = k0 + 2 * t4;
  const bool interior =
      k0 + WG_BN <= p.t && (!p.causal || r0 >= k0 + WG_BN - 1) &&
      (!p.window || r0 + 63 - k0 < p.window);
  float mt[2] = {NEG_INF, NEG_INF};
  if (p.cap != 0.f) {
    if (interior)
      log2_scores<true, false>(sc, mt, sc_mul, cap_mul, p, qrow, kcol);
    else
      log2_scores<true, true>(sc, mt, sc_mul, cap_mul, p, qrow, kcol);
  } else {
    if (interior)
      log2_scores<false, false>(sc, mt, sc_mul, cap_mul, p, qrow, kcol);
    else
      log2_scores<false, true>(sc, mt, sc_mul, cap_mul, p, qrow, kcol);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r]);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < WG_BN / 16; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = h & 1;
      const int i = 8 * j + 2 * h;
      pout[j][h] = pack_bf16(ex2(sc[i] - m[r]), ex2(sc[i + 1] - m[r]));
      const float2 pr = __bfloat1622float2(
          *reinterpret_cast<__nv_bfloat162*>(&pout[j][h]));
      l[r] += pr.x + pr.y;
    }
}

// sc = Q K^T for one consumer's 64 rows and a key tile; both K-major in
// shared memory (qbuf: the consumer's first Q row, kbuf: the K stage)
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[WG_BN / 2], uint32_t qbuf,
                                         uint32_t kbuf) {
  using L = LayoutWg<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int cb = ks * 32 / L::RB, off = ks * 32 % L::RB;
    wgmma_ss(sc,
             gmma_desc(qbuf + cb * WG_BM * L::RB + off, 16, 8 * L::RB, L::SWZ),
             gmma_desc(kbuf + cb * WG_BN * L::RB + off, 16, 8 * L::RB, L::SWZ),
             ks > 0);
  }
  wgmma_commit();
}

// acc += P V for one key tile: P from registers, V (MN-major) from `vbuf`
template <int D>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2],
                                         const uint32_t (&pa)[WG_BN / 16][4],
                                         uint32_t vbuf) {
  using L = LayoutWg<D>;
#pragma unroll
  for (int j = 0; j < WG_BN / 16; ++j)
    wgmma_rs(acc, pa[j],
             gmma_desc(vbuf + j * 16 * L::RB, WG_BN * L::RB, 8 * L::RB,
                       L::SWZ));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, const FlashParams p) {
  using L = LayoutWg<D>;
  constexpr int RB = L::RB;
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;   // then K full, V full, empty
  const auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  const auto bar_v = [&](int s) { return bar_q + 8 * (1 + WG_STAGES + s); };
  const auto bar_e = [&](int s) { return bar_q + 8 * (1 + 2 * WG_STAGES + s); };

  const int64_t bi = blockIdx.x / p.h;
  const int64_t hi = blockIdx.x % p.h;
  const int64_t khi = hi / (p.h / p.kh);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * WG_BM;
  int64_t kt_lo, kt_hi;
  key_tiles(p, q0, WG_BM, WG_BN, kt_lo, kt_hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup and warp indices through a shuffle: the compiler then knows
  // them warp-uniform, so the role branches are not divergent paths (which
  // would serialise the wgmma and drop the setmaxnreg budgets)
  const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(WG_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int cb = 0; cb < L::NCB; ++cb)
        tma_load(sQ + cb * WG_BM * RB, &tq, bar_q, cb * RB / 2, (int)q0,
                 (int)hi, (int)bi);
      for (int64_t kt = kt_lo; kt <= kt_hi; ++kt) {
        const int it = (int)(kt - kt_lo);
        const int s = it % WG_STAGES;
        mbar_wait(bar_e(s), ((it / WG_STAGES) & 1) ^ 1);
        const int row = (int)(kt * WG_BN);
        mbar_expect_tx(bar_k(s), L::KV_BYTES);
        for (int cb = 0; cb < L::NCB; ++cb)
          tma_load(sK + s * L::KV_BYTES + cb * WG_BN * RB, &tk, bar_k(s),
                   cb * RB / 2, row, (int)khi, (int)bi);
        mbar_expect_tx(bar_v(s), L::KV_BYTES);
        for (int cb = 0; cb < L::NCB; ++cb)
          tma_load(sV + s * L::KV_BYTES + cb * WG_BN * RB, &tv, bar_v(s),
                   cb * RB / 2, row, (int)khi, (int)bi);
      }
    }
  } else {
    // consumers: warpgroup c owns query rows q0 + 64c .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(WG_CONSUMER_REGS));
    const int c = wg - 1;
    const int warp = __shfl_sync(FULL, (int)(threadIdx.x / 32) % 4, 0);
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int64_t r0 = q0 + 64 * c;          // this warpgroup's first row
    const int64_t rw = r0 + 16 * warp;       // this warp's first row
    bf16* ob = o + bi * p.o_sb + hi * p.o_sh;

    // scores to the log2 domain: x = (q.k) * scale * log2(e), or with the
    // cap tanh((q.k) * scale / cap) * cap * log2(e)
    const float sc_mul = p.cap != 0.f ? p.scale / p.cap : p.scale * LOG2E;
    const float cap_mul = p.cap * LOG2E;
    float m[2] = {NEG_INF, NEG_INF};         // rows g, g + 8; log2 domain
    float l[2] = {0.f, 0.f};                 // this thread's share
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e(s));
    };

    // Tile i's P.V is issued together with tile i + 1's Q.K^T and runs
    // while tile i + 1's softmax does; pa holds tile i's P, pn the next.
    // The two consumers take turns at issuing (named barriers 1 and 2),
    // so one's softmax overlaps the other's products.  Every stage is
    // released after its round's loads were seen, so no arrival runs
    // ahead into another round.
    const int n = (int)(kt_hi - kt_lo + 1);
    uint32_t pa[WG_BN / 16][4], pn[WG_BN / 16][4];
    float sc[WG_BN / 2], alpha[2];
    if (c == 1) named_arrive(1, 256);  // consumer 0 takes the first turn
    mbar_wait(bar_q, 0);
    if (n > 0) {
      mbar_wait(bar_k(0), 0);
      named_sync(1 + c, 256);
      fence_regs(sc);
      wgmma_fence();
      qk_issue<D>(sc, sQ + c * 64 * RB, sK);
      named_arrive(2 - c, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, pa, m, l, alpha, p, r0, rw + g, kt_lo * WG_BN, t4,
                   sc_mul, cap_mul);
    }
    for (int it = 1; it < n; ++it) {
      const int s = it % WG_STAGES, sp = (it - 1) % WG_STAGES;
      mbar_wait(bar_k(s), (it / WG_STAGES) & 1);
      mbar_wait(bar_v(sp), ((it - 1) / WG_STAGES) & 1);
      named_sync(1 + c, 256);           // this consumer's turn
      // the registers the wgmmas read are written before the fence
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      qk_issue<D>(sc, sQ + c * 64 * RB, sK + s * L::KV_BYTES);
      pv_issue<D>(acc, pa, sV + sp * L::KV_BYTES);
      named_arrive(2 - c, 256);         // the other consumer's turn
      wgmma_wait<1>();                  // Q.K^T done, P.V still runs
      fence_regs(sc);
      softmax_tile(sc, pn, m, l, alpha, p, r0, rw + g, (kt_lo + it) * WG_BN,
                   t4, sc_mul, cap_mul);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(sp);
      // acc holds every tile before this one: to this tile's max
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < WG_BN / 16; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) pa[j][h] = pn[j][h];
    }
    if (n > 0) {
      const int sp = (n - 1) % WG_STAGES;
      mbar_wait(bar_v(sp), ((n - 1) / WG_STAGES) & 1);
      named_sync(1 + c, 256);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      pv_issue<D>(acc, pa, sV + sp * L::KV_BYTES);
      if (c == 0) named_arrive(2, 256);  // consumer 1 issues last
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(sp);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      const int64_t row = rw + g + 8 * r;
      if (row >= p.s) continue;
      const float den = fmaxf(lr, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + 8 * j +
                                           2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / den,
                                  acc[4 * j + 2 * r + 1] / den);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point query, so the library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// TMA map of a model-layout bf16 tensor as (d, row, head, batch) with the
// given element strides; a box is one swizzle row of d by `box_rows` rows,
// zero-filled beyond `rows`
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int64_t rows,
                int64_t heads, int64_t batch, int64_t s_row, int64_t s_head,
                int64_t s_batch, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  constexpr int RB = LayoutWg<D>::RB;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {RB / 2, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, p.s, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, WG_BM) ||
      !encode_map<D>(&tk, k, p.t, p.kh, p.b, p.k_st, p.k_sh, p.k_sb, WG_BN) ||
      !encode_map<D>(&tv, v, p.t, p.kh, p.b, p.v_st, p.v_sh, p.v_sb, WG_BN))
    return cudaErrorInvalidValue;
  const size_t bytes = LayoutWg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.b * p.h),
                  (unsigned)((p.s + WG_BM - 1) / WG_BM));
  flash_attention_bf16<D><<<grid, WG_THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const FlashParams& p, cudaStream_t stream) {
  const size_t bytes = LayoutF32<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_attention_f32<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return cudaGetLastError();
}

cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const FlashParams& p, cudaStream_t stream) {
  const bool f32 = p.dtype == 0;
  switch (p.d) {
    case 16:
      return (f32 ? launch_f32<16> : launch_wg<16>)(q, k, v, o, p, stream);
    case 32:
      return (f32 ? launch_f32<32> : launch_wg<32>)(q, k, v, o, p, stream);
    case 64:
      return (f32 ? launch_f32<64> : launch_wg<64>)(q, k, v, o, p, stream);
    case 128:
      return (f32 ? launch_f32<128> : launch_wg<128>)(q, k, v, o, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_params_size() { return sizeof(FlashParams); }

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  Does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const FlashParams* p, void* stream) {
  if (p->b * p->h == 0 || p->s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = p->dtype == 0 || p->dtype == 1
                              ? launch_d(q, k, v, o, *p, st)
                              : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
