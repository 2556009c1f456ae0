// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ssd/kernel.py (`_ssd_kernel`, called by `ssd_scan`),
// together with the layout work of its wrapper (ops.py `ssd`).  Per (b, h)
// row and per chunk of steps, with s the running sum of a = dt * A_h
// inside the chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) (dt_j x_j)
//        + exp(s_i) (C_i @ S)
//   S   <- exp(s_last) S + sum_j exp(s_last - s_j) B_j^T (dt_j x_j)
// The state S (N x P) is float32 and never leaves the chip; dt_j is folded
// into the scores and the state weights, as the reference's chunked
// ssd_reference does, so the x tile is staged as it is read.  The chunk
// length changes only the order of the sums; each path uses its own
// (float32 32 steps, bfloat16 64), whatever chunk the caller validated.
//
// Layout: x (B, L, H, P), dt (B, L, H), B and C (B, L, N) shared by every
// head, y (B, L, H, P), all read and written through their strides (the
// last dim contiguous), so x, B and C may be column slices of one conv
// output.  The kernel applies dt and forms dt * A itself, in float32: the
// wrapper makes no transposed, premultiplied or per-head broadcast copy
// (at mamba2-2.7b's prefill a broadcast B and C would be two 671 MB
// tensors a layer).  exp(s_i - s_j) is evaluated only for j <= i: above
// the diagonal it overflows, and inf * 0 would be NaN.  Steps beyond L in
// the last chunk are zero (a = 0, so they neither decay nor add).  Nothing
// is carried between blocks, so there are no atomics and reruns are
// bit-identical.
//
// What bounds it: at mamba2-2.7b's prefill (B=4, L=4096, H=80, P=64,
// N=128, bf16) the call must move 349,176,128 bytes (x and y 168 MB each)
// — 0.104 ms at 3.35 TB/s.  The chunked form's products fit under that
// time on the bf16 tensor cores, not on the CUDA cores (~0.8 ms at their
// float32 peak).  The two dtypes take two designs, chosen by dtype, never
// by size; both take every P of HEAD_DIMS and N a multiple of 4 up to 128.
//
// float32 (`ssd_chunked_scan<float, P>`): the CUDA cores' float32 FMA, the
// arithmetic check of the callers.  One block of 256 threads per (b, h)
// row walks chunks of 32 steps in order.  A chunk's B, C and x tiles are
// staged in shared memory as float32, the (32 x 32) decayed score tile
// too; each thread keeps 4 state rows x P/8 columns in registers and
// publishes them to shared memory at the start of the next chunk.  79 KB
// of shared memory at N = 128, P = 64: two blocks per SM.  At
// mamba2-2.7b's shape the 320 blocks are 1.2 waves of 264, each ~4 ms.
//
// bfloat16 (`ssd_chunked_scan_bf16_mma<PS, NS>`): the tensor cores by
// mma.sync m16n8k16 (bf16 in, float32 accumulators), against the four
// faults of the float32 design:
//  1. Too few blocks: a block owns one (b, h) row and PS = 32 of its P
//     columns (16 when P = 16) — y[:, p] and S[:, p] need only x[:, p] —
//     so mamba2-2.7b's shape has 640 blocks; h runs fastest in the grid,
//     so the blocks resident together share one batch row's B and C in
//     L2.  128 threads and 109 KB of shared memory (N > 64; 65 KB for
//     N <= 64): two blocks an SM (three at N <= 64).
//  2. Loads overlapped with compute: a ring of two stages holds a chunk's
//     x, B, C and dt tiles, filled by cp.async (16, 8 or 4 bytes a copy,
//     chosen at launch by the tensors' alignment) while the previous chunk
//     is computed; chunks of 64 steps halve the barriers a step (two a
//     chunk).  Tiles are XOR-swizzled by 16-byte chunks, so ldmatrix reads
//     them without bank conflicts; rows beyond L are zero-filled by the
//     copy and B, C columns from N to the padded width are zeroed once.
//  3. Every product on the tensor cores, accumulating in float32: warp w
//     owns chunk rows 16w..16w+15 and computes C.B^T for the column tiles
//     j <= i only; its accumulators become the decayed scores G, whose
//     accumulator layout is the A-fragment layout of G.x, so G never
//     passes through shared memory; C.S; and S += B^T (w o x) for the
//     m16 tiles of state rows it owns (3, 2, 2, 1 of 8 for warps 0-3:
//     warp 3 has 4 of the 10 score tiles), with S itself as the float32
//     accumulator in registers.  Operands that are float32 intermediates
//     (G, S, w o x) are split into three bf16 parts, hi + mid + lo, which
//     hold float32's 24 significand bits exactly (except where lo
//     underflows), and each of their products is three MMAs: x, B and C
//     are bf16, so every product is exact in float32 and only the order
//     of the sums differs from the float32 kernel.  S's parts and those
//     of w o x are written to shared memory once a chunk.  Below the
//     diagonal tiles exp(s_i - s_j) is taken as exp(s_i - s_e) exp(s_e -
//     s_j), e the last step of j's 16-step tile (both factors at most 1;
//     the second, times dt_j, shared by the block): 14 exps a lane for
//     the last warp instead of 32.
//  4. C.B^T is still formed per block (~15 % of its MMAs), and B and C are
//     staged per block, from L2, shared by the 160 blocks of a batch row.
// The warp index is masked to [0, 4) after its shuffle, so the compiler
// knows the range the score-tile branches test: 17 % less time.
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, tools/probe_ssd.py):
// 1.22-1.26 ms at mamba2-2.7b's prefill, 12x the byte bound.  Leaving
// out one part at a time (timing only, before the mask) points at the
// scores and G.x, C.B^T and the loads, per-block costs that do not
// shrink with PS (B and C are 32 KB a chunk a block from L2: 1.3 GB a
// call); loads, barriers and the y store alone take 0.53 ms.  The 640
// blocks are 2.42 waves of 264, so the last of three rounds runs 42 %
// full.  Eight warps a block (row / state roles) ran 1.52 ms at two
// blocks an SM (128 registers: spills) and 1.55 at one; two 32-column
// groups a block (one block an SM) 1.26-1.32, 1.29-1.32 with the scores
// formed once for both groups and shared through shared memory.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a): 182 / 184 / 225 / 227 registers
// for <PS, NS> = <16, 64> / <16, 128> / <32, 64> / <32, 128>, 0 spills;
// no wgmma is used, so no wgmma-serialisation note (C7513 / C7518).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int QT = 32;          // steps per chunk: one warp scans a chunk
constexpr int NTHREADS = 256;   // 8 warps = QT rows x 8 column groups
constexpr int NMAX = 128;       // largest state size (N) the block holds
constexpr int RPT = NMAX / 32;  // state rows per thread: row + 32 r
constexpr int GS = QT + 1;      // padded row stride of the score tile
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirror: SsdParams in kernels/ssd/kernel.py.
struct SsdParams {
  int64_t b, l, h, p, n;
  int64_t x_sb, x_sl, x_sh;     // element strides; the last dim is contiguous
  int64_t dt_sb, dt_sl, dt_sh;  // dt: float32, any strides
  int64_t b_sb, b_sl;
  int64_t c_sb, c_sl;
  int64_t y_sb, y_sl, y_sh;
  int32_t dtype;                // 0 float32, 1 bfloat16 (x, B, C and y)
  int32_t reserved;
};

namespace {

// floats of shared memory for state size n (a multiple of 4) and head dim P
template <int P>
__host__ __device__ constexpr size_t smem_floats(int64_t n) {
  return (size_t)(2 * QT * (n + 4) + QT * P + n * P + QT * GS + 4 * QT);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K consecutive floats of shared memory, 16 or 8 bytes at a time
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float* src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else {
    static_assert(K % 2 == 0, "column groups are float2-aligned");
#pragma unroll
    for (int i = 0; i < K; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  }
}

template <int K>
__device__ __forceinline__ void sts(float* dst, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < K; i += 2)
      *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
  }
}

// K consecutive outputs (round to nearest even for bfloat16, as astype)
template <int K>
__device__ __forceinline__ void store(float* dst, const float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) dst[i] = v[i];
}
template <int K>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&v)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + i) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = __float2bfloat16(v[i]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, P <= 64 ? 2 : 1)
ssd_chunked_scan(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 const SsdParams p) {
  constexpr int CPT = P / 8;    // contiguous columns per thread
  extern __shared__ float4 smem4[];
  const int n = (int)p.n;
  const int NS = n + 4;         // row stride of the B and C tiles
  float* Bs = reinterpret_cast<float*>(smem4);  // [QT][NS]
  float* Cs = Bs + QT * NS;                     // [QT][NS]
  float* Xs = Cs + QT * NS;                     // [QT][P], x
  float* Ss = Xs + QT * P;                      // [n][P], state entering
  float* Gs = Ss + n * P;                       // [QT][GS], scores
  float* sc = Gs + QT * GS;                     // [QT] running sum of a
  float* es = sc + QT;                          // [QT] exp(s_i)
  float* wv = es + QT;                          // [QT] exp(s_last - s_j) dt_j
  float* dts = wv + QT;                         // [QT] dt_j

  const int tid = threadIdx.x;
  const int row = tid >> 3;     // chunk row (scores, y) or state row group
  const int cg = tid & 7;       // column group
  const int64_t bi = blockIdx.x / p.h;
  const int64_t hi = blockIdx.x % p.h;
  const float a_h = A[hi];

  const T* xb = x + bi * p.x_sb + hi * p.x_sh;
  const float* dtb = dt + bi * p.dt_sb + hi * p.dt_sh;
  const T* Bb = Bm + bi * p.b_sb;
  const T* Cb = Cm + bi * p.c_sb;
  T* yb = y + bi * p.y_sb + hi * p.y_sh;

  float sreg[RPT][CPT];         // state rows row + 32 r, cols cg*CPT + c
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) sreg[r][c] = 0.f;

  const int64_t nchunks = (p.l + QT - 1) / QT;
  for (int64_t ck = 0; ck < nchunks; ++ck) {
    const int64_t t0 = ck * QT;

    // (1) publish the state entering the chunk; stage the chunk's inputs
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row + 32 * r;
      if (k < n) sts<CPT>(&Ss[k * P + cg * CPT], sreg[r]);
    }
    // B and C four columns at a time; all loads of a thread unrolled so
    // that they are in flight together
    const int nq = n >> 2;
#pragma unroll
    for (int it = 0; it < QT * NMAX / 4 / NTHREADS; ++it) {
      const int q = tid + it * NTHREADS;
      if (q < QT * nq) {
        const int t = q / nq, k = (q - t * nq) * 4;
        const int64_t ts = t0 + t;
        float bv[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
        if (ts < p.l) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            bv[u] = to_f32(Bb[ts * p.b_sl + k + u]);
            cv[u] = to_f32(Cb[ts * p.c_sl + k + u]);
          }
        }
        sts<4>(&Bs[t * NS + k], bv);
        sts<4>(&Cs[t * NS + k], cv);
      }
    }
    {  // x: row `row`, this thread's columns (dt is folded in later)
      const int64_t ts = t0 + row;
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        v[c] = ts < p.l ? to_f32(xb[ts * p.x_sl + cg * CPT + c]) : 0.f;
      sts<CPT>(&Xs[row * P + cg * CPT], v);
    }
    if (tid < 32) {             // warp 0: inclusive scan of a over the chunk
      const int64_t ts = t0 + tid;
      const float d = ts < p.l ? dtb[ts * p.dt_sl] : 0.f;
      float s = d * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, s, off);
        if (tid >= off) s += v;
      }
      const float last = __shfl_sync(FULL, s, QT - 1);
      sc[tid] = s;
      es[tid] = expf(s);
      wv[tid] = expf(last - s) * d;
      dts[tid] = d;
    }
    __syncthreads();

    // (2) scores G[i][j] = (C_i . B_j) exp(s_i - s_j) dt_j, j <= i
    {
      const int i = row;
      const int imax = row | 3;           // last row of this warp
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; k += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(&Cs[i * NS + k]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (8 * c <= imax) {            // warp-uniform: live columns only
            const float4 bv = *reinterpret_cast<const float4*>(
                &Bs[(cg + 8 * c) * NS + k]);
            acc[c] = fmaf(cv.x, bv.x, acc[c]);
            acc[c] = fmaf(cv.y, bv.y, acc[c]);
            acc[c] = fmaf(cv.z, bv.z, acc[c]);
            acc[c] = fmaf(cv.w, bv.w, acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cg + 8 * c;
        Gs[i * GS + j] =
            j <= i ? acc[c] * expf(sc[i] - sc[j]) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    // (3) y_i = sum_{j<=i} G[i][j] x_j + exp(s_i) (C_i @ S)
    {
      const int i = row;
      float acc[CPT], inter[CPT], v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = inter[c] = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float g = Gs[i * GS + j];
        lds<CPT>(v, &Xs[j * P + cg * CPT]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = fmaf(g, v[c], acc[c]);
      }
      for (int k = 0; k < n; k += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(&Cs[i * NS + k]);
        const float cvk[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          lds<CPT>(v, &Ss[(k + u) * P + cg * CPT]);
#pragma unroll
          for (int c = 0; c < CPT; ++c) inter[c] = fmaf(cvk[u], v[c], inter[c]);
        }
      }
      const int64_t ts = t0 + i;
      if (ts < p.l) {
        const float e = es[i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = fmaf(e, inter[c], acc[c]);
        store<CPT>(yb + ts * p.y_sl + cg * CPT, acc);
      }
    }

    // (4) S <- exp(s_last) S + sum_j exp(s_last - s_j) dt_j B_j^T x_j, in
    // registers: the shared copy is still being read by (3)
    {
      const float dq = es[QT - 1];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sreg[r][c] *= dq;
      float v[CPT];
      for (int j = 0; j < QT; ++j) {
        lds<CPT>(v, &Xs[j * P + cg * CPT]);
        const float w = wv[j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int k = row + 32 * r;
          if (k < n) {
            const float bw = Bs[j * NS + k] * w;
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              sreg[r][c] = fmaf(bw, v[c], sreg[r][c]);
          }
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites every tile
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, const SsdParams& p,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<P>(p.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunked_scan<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_chunked_scan<T, P><<<(unsigned)(p.b * p.h), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y,
                     const SsdParams& p, cudaStream_t stream) {
  switch (p.p) {
    case 16: return launch<T, 16>(x, dt, A, B, C, y, p, stream);
    case 32: return launch<T, 32>(x, dt, A, B, C, y, p, stream);
    case 64: return launch<T, 64>(x, dt, A, B, C, y, p, stream);
    case 128: return launch<T, 128>(x, dt, A, B, C, y, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor cores by mma.sync
// ---------------------------------------------------------------------------

constexpr int TQ = 64;          // steps per chunk of the bfloat16 path
constexpr int TWARPS = 4;       // warp w owns chunk rows 16w..16w+15
constexpr int TTHREADS = 32 * TWARPS;
constexpr int TSTAGES = 2;      // ring of chunk tiles

// Byte offset of (row r, byte o) in a tile of RB-byte rows whose 16-byte
// chunks are XOR-swizzled, so that the 8 rows an ldmatrix reads at one
// column fall in 8 different bank groups.
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int o) {
  constexpr int R = RB / 16;                  // chunks a row
  constexpr int REP = R >= 8 ? 1 : 8 / R;     // rows sharing 128 bytes
  constexpr int MASK = (R >= 8 ? 8 : R) - 1;
  return (uint32_t)(r * RB + (((o >> 4) ^ ((r / REP) & MASK)) << 4) +
                    (o & 15));
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// W bytes global -> shared; zero-filled when !valid (nothing is read)
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? W : 0;
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(W), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + mid + lo, each part a bf16 pair (v0 in the low half):
// 3 x 8 significand bits hold float32's 24, so the sum is exact unless lo
// underflows.  Both differences are exact in float32.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// Rows [0, TQ) of a tile of `row_bytes` bytes a row, read from global rows
// `stride` bytes apart, into a swizzled shared tile of RB-byte rows, W
// bytes a copy; rows at or beyond `valid` become zeros.  A thread keeps
// one piece of a row and walks the rows, TTHREADS / (RB / W) at a pass.
template <int RB, int W>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const unsigned char* src,
                                           int64_t stride, int row_bytes,
                                           int valid, int tid) {
  constexpr int PPR = RB / W;             // pieces a row, at most
  constexpr int RPP = TTHREADS / PPR;     // rows a pass
  static_assert(PPR <= TTHREADS, "a pass covers a row");
  const int o = (tid % PPR) * W;
  if (o >= row_bytes) return;
  for (int r = tid / PPR; r < TQ; r += RPP) {
    const bool ok = r < valid;
    const unsigned char* s = ok ? src + r * stride + o : src;
    const uint32_t d = dst + swz<RB>(r, o);
    if constexpr (W == 2) {   // 2-byte aligned views: plain loads
      const unsigned short v =
          ok ? *reinterpret_cast<const unsigned short*>(s) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(d), "h"(v)
                   : "memory");
    } else {
      cp_async<W>(d, s, ok);
    }
  }
}

template <int RB>
__device__ __forceinline__ void stage_tile(int width, uint32_t dst,
                                           const unsigned char* src,
                                           int64_t stride, int row_bytes,
                                           int valid, int tid) {
  switch (width) {
    case 16: stage_rows<RB, 16>(dst, src, stride, row_bytes, valid, tid);
             break;
    case 8: stage_rows<RB, 8>(dst, src, stride, row_bytes, valid, tid);
            break;
    case 4: stage_rows<RB, 4>(dst, src, stride, row_bytes, valid, tid);
            break;
    default: stage_rows<RB, 2>(dst, src, stride, row_bytes, valid, tid);
  }
}

// Shared memory of one block: TSTAGES x (x | B | C | dt), then S's three
// parts (NS rows), w o x's three parts (TQ rows), s, exp(s) and the
// scores' column factors.
template <int PS, int NS>
__host__ __device__ constexpr size_t bf16_stage_bytes() {
  return (size_t)TQ * (PS * 2 + 2 * NS * 2 + 4);
}
template <int PS, int NS>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return TSTAGES * bf16_stage_bytes<PS, NS>() + 3 * (size_t)NS * PS * 2 +
         3 * (size_t)TQ * PS * 2 + 3 * TQ * 4;
}

// PS: columns of P a block owns; NS: padded state width (64 or 128).
// xw, bw: bytes a copy for x and for B / C (16, 8, 4 or 2).
template <int PS, int NS>
__global__ void __launch_bounds__(TTHREADS, 2)
ssd_chunked_scan_bf16_mma(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const __nv_bfloat16* __restrict__ Bm,
                          const __nv_bfloat16* __restrict__ Cm,
                          __nv_bfloat16* __restrict__ y, const SsdParams p,
                          const int xw, const int bw) {
  constexpr int XB = PS * 2;        // bytes a row of the x, S and W tiles
  constexpr int NB = NS * 2;        // bytes a row of the B and C tiles
  constexpr int NT = PS / 8;        // n8 tiles of a y or S row block
  constexpr int X_BYTES = TQ * XB, BC_BYTES = TQ * NB;
  constexpr int STAGE = (int)bf16_stage_bytes<PS, NS>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Ssp = smem + TSTAGES * STAGE;   // [3][NS][PS] bf16
  unsigned char* const Wsp = Ssp + 3 * NS * XB;        // [3][TQ][PS] bf16
  float* const sc = reinterpret_cast<float*>(Wsp + 3 * TQ * XB);  // s_i
  float* const es = sc + TQ;                                      // e^s_i
  float* const cf = es + TQ;            // exp(s_e(j) - s_j) dt_j, see (1)
  const uint32_t ssp = smem_addr(Ssp), wsp = smem_addr(Wsp);

  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform, and known to the compiler to lie in [0, 4)
  const int warp = __shfl_sync(FULL, tid >> 5, 0) & (TWARPS - 1);
  const int g = lane >> 2, t4 = lane & 3;
  const int n = (int)p.n;
  const int nk = (n + 15) >> 4;     // k16 steps over N (zero-padded)
  const int64_t nslices = p.p / PS;
  const int64_t hh = blockIdx.x % p.h;          // h fastest
  const int64_t rest = blockIdx.x / p.h;
  const int64_t p0 = (rest % nslices) * PS;
  const int64_t bi = rest / nslices;
  const float a_h = A[hh];

  const unsigned char* xb = reinterpret_cast<const unsigned char*>(
      x + bi * p.x_sb + hh * p.x_sh + p0);
  const float* dtb = dt + bi * p.dt_sb + hh * p.dt_sh;
  const unsigned char* Bb =
      reinterpret_cast<const unsigned char*>(Bm + bi * p.b_sb);
  const unsigned char* Cb =
      reinterpret_cast<const unsigned char*>(Cm + bi * p.c_sb);
  __nv_bfloat16* yb = y + bi * p.y_sb + hh * p.y_sh + p0;

  // enqueue chunk ck's x, B, C and dt into stage ck % 2
  auto stage_chunk = [&](int64_t ck) {
    const uint32_t sx = smem_addr(smem + (ck & 1) * STAGE);
    const uint32_t sb = sx + X_BYTES, scm = sb + BC_BYTES;
    const uint32_t sd = scm + BC_BYTES;
    const int64_t t0 = ck * TQ;
    const int valid = (int)(p.l - t0 < TQ ? p.l - t0 : TQ);
    stage_tile<XB>(xw, sx, xb + t0 * p.x_sl * 2, p.x_sl * 2, XB, valid, tid);
    stage_tile<NB>(bw, sb, Bb + t0 * p.b_sl * 2, p.b_sl * 2, 2 * n, valid,
                   tid);
    stage_tile<NB>(bw, scm, Cb + t0 * p.c_sl * 2, p.c_sl * 2, 2 * n, valid,
                   tid);
    if (tid < TQ)
      cp_async<4>(sd + 4 * tid, tid < valid ? dtb + (t0 + tid) * p.dt_sl
                                            : dtb, tid < valid);
    cp_async_commit();
  };

  // the B and C columns from n to NS are never loaded: zero them once
  for (int i = tid; i < TSTAGES * STAGE / 16; i += TTHREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // state rows 16 mt + {g, g + 8} of the m16 tiles mt = tile[r] >= 0,
  // columns 8 nt + 2 t4 + {0, 1}.  Tiles 0-3 go to warps 0-3, 4-6 to warps
  // 0-2 and 7 to warp 0: warp 3 has the most score tiles (4 of 10).
  const int tile[3] = {warp, warp < 3 ? warp + 4 : -1, warp == 0 ? 7 : -1};
  float sacc[3][NT][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[r][nt][e] = 0.f;

  const int i0 = 16 * warp;         // this warp's chunk rows
  const int64_t nchunks = (p.l + TQ - 1) / TQ;
  stage_chunk(0);
  for (int64_t ck = 0; ck < nchunks; ++ck) {
    cp_async_wait_all();
    __syncthreads();  // chunk ck has landed; every warp is done with ck - 1
    if (ck + 1 < nchunks) stage_chunk(ck + 1);
    const unsigned char* st = smem + (ck & 1) * STAGE;
    const uint32_t sx = smem_addr(st), sb = sx + X_BYTES;
    const uint32_t scm = sb + BC_BYTES;
    const float* dts = reinterpret_cast<const float*>(st + X_BYTES +
                                                      2 * BC_BYTES);
    const int64_t t0 = ck * TQ;

    // (1) inclusive scan of a = dt * A over the chunk, in every warp: lane
    // holds steps lane and lane + 32
    const float d0 = dts[lane], d1 = dts[lane + 32];
    float s0 = d0 * a_h, s1 = d1 * a_h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v0 = __shfl_up_sync(FULL, s0, off);
      const float v1 = __shfl_up_sync(FULL, s1, off);
      if (lane >= off) {
        s0 += v0;
        s1 += v1;
      }
    }
    s1 += __shfl_sync(FULL, s0, 31);
    const float last = __shfl_sync(FULL, s1, 31);
    if (warp == 0) {
      sc[lane] = s0;
      sc[lane + 32] = s1;
      es[lane] = expf(s0);
      es[lane + 32] = expf(s1);
      // column factors of the scores below the diagonal tiles: step j
      // decays to the last step of its 16-step tile, e_j = 16 (j / 16) + 15
      cf[lane] = expf(__shfl_sync(FULL, s0, lane | 15) - s0) * d0;
      cf[lane + 32] = expf(__shfl_sync(FULL, s1, lane | 15) - s1) * d1;
    }

    // (2) w o x for this warp's rows, w_j = exp(s_last - s_j) dt_j, in
    // three parts; lane: row i0 + lane / 2, half the columns
    {
      const float wv = warp < 2 ? expf(last - s0) * d0 : expf(last - s1) * d1;
      const int r = i0 + (lane >> 1);
      const float wr = __shfl_sync(FULL, wv, r & 31);
      constexpr int CH = PS / 16;   // 16-byte chunks a lane
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int o = ((lane & 1) * CH + c) * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(st + swz<XB>(r, o));
        const uint32_t in[4] = {v.x, v.y, v.z, v.w};
        uint32_t part[3][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in[u]));
          split3(wr * f.x, wr * f.y, part[0][u], part[1][u], part[2][u]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint4*>(Wsp + k * TQ * XB + swz<XB>(r, o)) =
              make_uint4(part[k][0], part[k][1], part[k][2], part[k][3]);
      }
    }
    // (3) the state entering the chunk, in three parts
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int mt = tile[r];
      if (mt >= 0 && mt < nk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t q[3];
            split3(sacc[r][nt][2 * hf], sacc[r][nt][2 * hf + 1], q[0], q[1],
                   q[2]);
            const uint32_t off =
                swz<XB>(16 * mt + g + 8 * hf, (8 * nt + 2 * t4) * 2);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              *reinterpret_cast<uint32_t*>(Ssp + k * NS * XB + off) = q[k];
          }
      }
    }
    __syncthreads();  // s, e^s, the parts of S and of w o x are published

    // (4) C.B^T for column tiles jt <= warp, and C.S, over N
    float cb[4][2][4], yi[NT][4];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[jt][0][e] = cb[jt][1][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[nt][e] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      const int ko = (kk * 16 + (lane >> 4) * 8) * 2;
      uint32_t a[4];
      ldsm(a, scm + swz<NB>(i0 + (lane & 15), ko));
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        if (jt <= warp) {
          uint32_t b[4];
          ldsm(b, sb + swz<NB>(16 * jt + (lane & 15), ko));
          mma(cb[jt][0], a, b[0], b[2]);
          mma(cb[jt][1], a, b[1], b[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_t(b, ssp + k * NS * XB +
                        swz<XB>(kk * 16 + (lane & 15),
                                (np * 16 + (lane >> 4) * 8) * 2));
          mma(yi[2 * np], a, b[0], b[1]);
          mma(yi[2 * np + 1], a, b[2], b[3]);
        }
    }

    // (5) G = (C.B^T) exp(s_i - s_j) dt_j for j <= i, in registers as the
    // A fragments of G.x, three parts each
    float ya[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] = 0.f;
    const float s_lo = sc[i0 + g], s_hi = sc[i0 + g + 8];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      if (jt <= warp) {
        if (jt < warp) {
          // below the diagonal tile every j < e = 16 jt + 15 < i:
          // exp(s_i - s_j) dt_j = exp(s_i - s_e) (exp(s_e - s_j) dt_j),
          // both factors at most 1
          const float se = sc[16 * jt + 15];
          const float rf[2] = {expf(s_lo - se), expf(s_hi - se)};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cb[jt][hf][e] *=
                  rf[e >> 1] * cf[16 * jt + 8 * hf + 2 * t4 + (e & 1)];
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + g + 8 * (e >> 1);
              const int j = 16 * jt + 8 * hf + 2 * t4 + (e & 1);
              const float si = e >> 1 ? s_hi : s_lo;
              cb[jt][hf][e] =
                  j <= i ? cb[jt][hf][e] * expf(si - sc[j]) * dts[j] : 0.f;
            }
        }
        uint32_t ga[3][4];
        split3(cb[jt][0][0], cb[jt][0][1], ga[0][0], ga[1][0], ga[2][0]);
        split3(cb[jt][0][2], cb[jt][0][3], ga[0][1], ga[1][1], ga[2][1]);
        split3(cb[jt][1][0], cb[jt][1][1], ga[0][2], ga[1][2], ga[2][2]);
        split3(cb[jt][1][2], cb[jt][1][3], ga[0][3], ga[1][3], ga[2][3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_t(b, sx + swz<XB>(16 * jt + (lane & 15),
                                 (np * 16 + (lane >> 4) * 8) * 2));
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            mma(ya[2 * np], ga[k], b[0], b[1]);
            mma(ya[2 * np + 1], ga[k], b[2], b[3]);
          }
        }
      }
    }

    // (6) y_i = G.x + exp(s_i) (C_i . S), rows inside L
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf;
      if (t0 + i < p.l) {
        const float e = es[i];
        __nv_bfloat16* yr = yb + (t0 + i) * p.y_sl + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(yr + 8 * nt) =
              __floats2bfloat162_rn(fmaf(e, yi[nt][2 * hf], ya[nt][2 * hf]),
                                    fmaf(e, yi[nt][2 * hf + 1],
                                         ya[nt][2 * hf + 1]));
      }
    }

    // (7) S <- exp(s_last) S + B^T (w o x) for this warp's state rows;
    // the w o x fragments of a k16 step serve every tile of the warp
    const float dq = es[TQ - 1];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      if (tile[r] >= 0 && tile[r] < nk)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[r][nt][e] *= dq;
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      uint32_t wf[3][NT / 2][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldsm_t(wf[k][np], wsp + k * TQ * XB +
                                swz<XB>(16 * kk + (lane & 15),
                                        (np * 16 + (lane >> 4) * 8) * 2));
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int mt = tile[r];
        if (mt >= 0 && mt < nk) {
          uint32_t a[4];
          ldsm_t(a, sb + swz<NB>(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                 (16 * mt + ((lane >> 3) & 1) * 8) * 2));
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              mma(sacc[r][2 * np], a, wf[k][np][0], wf[k][np][1]);
              mma(sacc[r][2 * np + 1], a, wf[k][np][2], wf[k][np][3]);
            }
        }
      }
    }
  }
}

// Bytes a copy (16, 8, 4 or 2) that the base address, every byte stride
// and the row length allow.
int copy_width(const void* ptr, std::initializer_list<int64_t> strides,
               int64_t row_bytes) {
  int w = 16;
  for (; w > 2; w /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(ptr) % w == 0 && row_bytes % w == 0;
    for (const int64_t s : strides) ok = ok && s % w == 0;
    if (ok) break;
  }
  return w;
}

template <int PS, int NS>
cudaError_t launch_bf16_t(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y,
                          const SsdParams& p, cudaStream_t stream) {
  constexpr size_t bytes = bf16_smem_bytes<PS, NS>();
  const int xw = copy_width(x, {p.x_sb * 2, p.x_sl * 2, p.x_sh * 2, PS * 2},
                            PS * 2);
  const int bw = std::min(copy_width(B, {p.b_sb * 2, p.b_sl * 2}, p.n * 2),
                          copy_width(C, {p.c_sb * 2, p.c_sl * 2}, p.n * 2));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunked_scan_bf16_mma<PS, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunked_scan_bf16_mma<PS, NS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int64_t blocks = p.b * p.h * (p.p / PS);
  ssd_chunked_scan_bf16_mma<PS, NS><<<(unsigned)blocks, TTHREADS, bytes,
                                      stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y),
      p, xw, bw);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y,
                        const SsdParams& p, cudaStream_t stream) {
  const int ps = p.p >= 32 ? 32 : 16;
  if (p.p % ps != 0) return cudaErrorInvalidValue;
  const bool wide = p.n > 64;
  if (ps == 32)
    return wide ? launch_bf16_t<32, 128>(x, dt, A, B, C, y, p, stream)
                : launch_bf16_t<32, 64>(x, dt, A, B, C, y, p, stream);
  return wide ? launch_bf16_t<16, 128>(x, dt, A, B, C, y, p, stream)
              : launch_bf16_t<16, 64>(x, dt, A, B, C, y, p, stream);
}

}  // namespace

extern "C" int ssd_params_size() { return sizeof(SsdParams); }

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  Does not synchronise.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y,
                          const SsdParams* p, void* stream) {
  if (p->b * p->h == 0 || p->l == 0) return 0;
  if (p->n <= 0 || p->n > NMAX || p->n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p->dtype == 1 ? launch_bf16(x, dt, A, B, C, y, *p, st)
      : p->dtype == 0 ? launch_p<float>(x, dt, A, B, C, y, *p, st)
                      : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
