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
// Semantics kept from the TPU kernel:
//  * masked logits take the FINITE value -1e30, not -inf.  A row that is
//    fully masked inside a live tile (a window shorter than the tile) then
//    gets p = exp(0) = 1 on zero-filled or masked columns, and the next
//    tile that holds a live column wipes that out with alpha = exp(-1e30 -
//    m) = 0.  With -inf the same row would give exp(-inf + inf) = NaN.
//  * positions are row and column indices; the cap is applied before the
//    mask.
//  * fully masked key tiles are skipped structurally: a query tile walks
//    key tiles from the first one the window reaches to the one holding its
//    last row (causal).
// Differences of layout: q, k, v and o are read and written in the model
// layout (B, S, H, D) through their strides, so the wrapper makes no
// transposed or padded copies; ragged ends of S and T are masked here.
//
// Design: one block of 128 threads per (query tile of 64 rows, b*h), 2
// blocks per SM at D = 128.  The scaled q tile stays in shared memory; K
// and V tiles of 64 rows are staged in shared memory as float32 (the P
// tile reuses K's space once the scores are in registers).  Each thread
// owns 4 query rows x 8 key columns of the score tile and 4 rows x D/8
// columns of the accumulator; row max and row sum go across the 8 threads
// of a row by warp shuffles.  Every product is a float32 FMA on the CUDA
// cores, for bfloat16 inputs too, so f32 inputs run in full f32 (no TF32)
// and p is never rounded to bfloat16.  No atomics: reruns are bit-identical.
//
// What bounds it: at yi-6b's prefill (B=4, S=T=4000, H=32, KH=4, D=128,
// causal) the live score entries need ~5.2e11 flops against ~278 MB of
// traffic, so it is bound by operations (0.53 ms at 989 TFLOP/s bf16 on
// the tensor cores).  This kernel runs on the CUDA cores' float32 FMA
// (67 TFLOP/s peak) and does nothing yet about that bound: wgmma on bf16
// tiles, TMA loads and warp specialisation are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 128;
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BK / 8;   // key columns per thread (strided by 8)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(NTHREADS == (BQ / RPT) * 8, "8 threads per row group");

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

template <int D>
struct Layout {
  static constexpr int QS = D + 1;   // padded row stride of Q and K tiles
  static constexpr int PS = BK + 1;  // padded row stride of the P tile
  static constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  static constexpr size_t bytes =
      (size_t)(BQ * QS + KP + BK * D) * sizeof(float);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const FlashParams p) {
  using L = Layout<D>;
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

  const T* qb = q + bi * p.q_sb + hi * p.q_sh;
  const T* kb = k + bi * p.k_sb + khi * p.k_sh;
  const T* vb = v + bi * p.v_sb + khi * p.v_sh;
  T* ob = o + bi * p.o_sb + hi * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int64_t row = q0 + r;
    Qs[r * L::QS + c] = row < p.s ? to_f32(qb[row * p.q_ss + c]) * p.scale
                                  : 0.f;
  }

  const int64_t q_last = (q0 + BQ < p.s ? q0 + BQ : p.s) - 1;
  int64_t kt_hi = (p.t + BK - 1) / BK - 1;
  if (p.causal && q_last / BK < kt_hi) kt_hi = q_last / BK;
  int64_t kt_lo = 0;
  if (p.window) {
    const int64_t first = q0 - p.window + 1;  // first key the window reaches
    if (first > 0) kt_lo = first / BK;
  }

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
      Ks[r * L::QS + c] = in ? to_f32(kb[row * p.k_st + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[row * p.v_st + c]) : 0.f;
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
      store(&ob[row * p.o_ss + tc + 8 * c], acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const FlashParams& p, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_attention_fwd<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const FlashParams& p, cudaStream_t stream) {
  switch (p.d) {
    case 16: return launch<T, 16>(q, k, v, o, p, stream);
    case 32: return launch<T, 32>(q, k, v, o, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, p, stream);
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
  const cudaError_t err =
      p->dtype == 1 ? launch_d<__nv_bfloat16>(q, k, v, o, *p, st)
      : p->dtype == 0 ? launch_d<float>(q, k, v, o, *p, st)
                      : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
