// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ssd/kernel.py (`_ssd_kernel`, called by `ssd_scan`),
// together with the layout work of its wrapper (ops.py `ssd`).  Per (b, h)
// row and per chunk of QT steps, with s the running sum of a = dt * A_h
// inside the chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) (dt_j x_j)
//        + exp(s_i) (C_i @ S)
//   S   <- exp(s_last) S + sum_j exp(s_last - s_j) B_j^T (dt_j x_j)
// The state S (N x P) is float32 and never leaves the chip; dt_j is folded
// into the scores and the state weights, as the reference's chunked
// ssd_reference does, so the x tile is staged as it is read.  The chunk
// length changes only the order of the sums; this kernel uses its own,
// QT = 32 (one warp scans it), whatever chunk the caller validated.
//
// Layout: x (B, L, H, P), dt (B, L, H), B and C (B, L, N) shared by every
// head, y (B, L, H, P), all read and written through their strides (the
// last dim contiguous), so x, B and C may be column slices of one conv
// output.  The kernel applies dt and forms dt * A itself, in float32: the
// wrapper makes no transposed, premultiplied or per-head broadcast copy
// (at mamba2-2.7b's prefill a broadcast B and C would be two 671 MB
// tensors a layer).  exp(s_i - s_j) is evaluated only for j <= i: above
// the diagonal it overflows, and inf * 0 would be NaN.  Steps beyond L in
// the last chunk are zero (a = 0, so they neither decay nor add).
//
// Design: one block of 256 threads per (b, h) row walks the chunks in
// order; nothing is carried between blocks, so there are no atomics and
// reruns are bit-identical.  A chunk's B, C and x tiles are staged in
// shared memory as float32, the (QT x QT) decayed score tile too; each
// thread keeps 4 state rows x P/8 columns in registers and publishes them
// to shared memory at the start of the next chunk.  Every product is a
// float32 FMA on the CUDA cores, for bfloat16 inputs too.  Shared memory
// at N = 128, P = 64: 79 KB, two blocks per SM.
//
// What bounds it: at mamba2-2.7b's prefill (B=4, L=4096, H=80, P=64,
// N=128, bf16) the call must move ~349 MB (x and y 168 MB each) — 0.10 ms
// at 3.35 TB/s — and the chunked form needs ~5e10 flops, under the byte
// time on the tensor cores but ~0.8 ms at the CUDA cores' float32 peak,
// which is where this kernel runs.  Tensor-core tiles (mma.sync, then
// wgmma with TMA) and sharing C.B^T across the heads of a batch row are
// for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
      p->dtype == 1 ? launch_p<__nv_bfloat16>(x, dt, A, B, C, y, *p, st)
      : p->dtype == 0 ? launch_p<float>(x, dt, A, B, C, y, *p, st)
                      : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
