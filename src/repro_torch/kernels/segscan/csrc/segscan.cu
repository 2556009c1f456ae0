// segscan: float64 inclusive prefix sums within segments, left to right.
//
// No Pallas counterpart.  The reference's device partitioner
// (src/repro/core/partition_jax.py, `_sweep` and `_hilbert_sweep`) takes
// its weighted prefix sums with a sequential `lax.scan`, which adds in the
// order np.cumsum does: c = w[start], then c = c + w[j] for j = start+1 ..
// start+size-1.  A parallel scan (torch.cumsum on the GPU) re-associates
// those adds and moves a weighted cut by one ulp, so the port's partitioner
// (repro_torch/core/partition_torch.py) runs this kernel instead.
//
// Layout: every position i of the (n,) inputs carries its segment's first
// position seg_start[i] and length seg_size[i] (int64), as the
// partitioner's state does; segments are contiguous and cover [0, n).
//
// What bounds it: not the bytes (w and seg_start read once, seg_size at
// each segment's first position, the sums written once: 24 bytes a
// position, 19 MB, 5.6 us at 3.35 TB/s, for three candidates of 2^18
// points) but the chain of dependent float64 adds of the longest segment,
// which no order-preserving scheme can shorten: at the first level of a
// sweep, 2^18 adds one after another.  Design:
//
//   * segments of at most LONG values: one thread per segment start walks
//     its segment, loading BATCH values into registers before it adds them
//     in order, so the loads of a batch are in flight together;
//   * longer segments: one block each (a window of LONG positions holds at
//     most one such start).  Warps 1.. stage the next TILE values in shared
//     memory while thread 0 adds the current tile in order, in place; then
//     the block stores the tile.  The walk then waits on shared memory, not
//     on device memory, and the chain of adds is what is left.
//
// Every add is __dadd_rn: no contraction with anything, round to nearest;
// a segment's first sum is its first value itself (as in np.cumsum).  A
// segment that claims to run past n is cut at n (the wrapper cannot check
// the lengths without reading them back to the host).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BATCH = 32;
constexpr int THREADS = 256;
constexpr int64_t LONG = 4096;
constexpr int TILE = 2048;

__device__ __forceinline__ int64_t seg_len(const int64_t* seg_size,
                                           int64_t i, int64_t n) {
  const int64_t len = seg_size[i];
  return len > n - i ? n - i : len;
}

__global__ void __launch_bounds__(THREADS)
segscan_short(const double* __restrict__ w,
              const int64_t* __restrict__ seg_start,
              const int64_t* __restrict__ seg_size,
              double* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n || seg_start[i] != i) return;
  const int64_t len = seg_len(seg_size, i, n);
  if (len <= 0 || len > LONG) return;
  const double* src = w + i;
  double* dst = out + i;
  double c = __ldg(src);
  dst[0] = c;
  int64_t j = 1;
  for (; j + BATCH <= len; j += BATCH) {
    double v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = __ldg(src + j + u);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      c = __dadd_rn(c, v[u]);
      v[u] = c;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) dst[j + u] = v[u];
  }
  for (; j < len; ++j) {
    c = __dadd_rn(c, __ldg(src + j));
    dst[j] = c;
  }
}

__global__ void __launch_bounds__(THREADS)
segscan_long(const double* __restrict__ w,
             const int64_t* __restrict__ seg_start,
             const int64_t* __restrict__ seg_size,
             double* __restrict__ out, int64_t n) {
  __shared__ double buf[2][TILE];
  __shared__ int64_t head;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * LONG;
  const int64_t w1 = w0 + LONG < n ? w0 + LONG : n;
  if (threadIdx.x == 0) head = -1;
  __syncthreads();
  for (int64_t p = w0 + threadIdx.x; p < w1; p += THREADS)
    if (seg_start[p] == p && seg_len(seg_size, p, n) > LONG) head = p;
  __syncthreads();
  const int64_t h = head;
  if (h < 0) return;
  const int64_t len = seg_len(seg_size, h, n);
  const double* src = w + h;
  double* dst = out + h;
  const int64_t ntiles = (len + TILE - 1) / TILE;
  for (int j = threadIdx.x; j < TILE && j < len; j += THREADS)
    buf[0][j] = __ldg(src + j);
  __syncthreads();
  double c = 0.0;
  for (int64_t t = 0; t < ntiles; ++t) {
    double* cur = buf[t & 1];
    const int64_t base = t * TILE;
    const int cnt = static_cast<int>(len - base < TILE ? len - base : TILE);
    if (threadIdx.x >= 32) {
      // stage the next tile beside the walk
      const int64_t nb = base + TILE;
      double* nxt = buf[(t + 1) & 1];
      for (int j = threadIdx.x - 32; j < TILE && nb + j < len;
           j += THREADS - 32)
        nxt[j] = __ldg(src + nb + j);
    } else if (threadIdx.x == 0) {
      int j = 0;
      if (t == 0) {
        c = cur[0];
        j = 1;
      }
      for (; j + BATCH <= cnt; j += BATCH) {
        double v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) v[u] = cur[j + u];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          c = __dadd_rn(c, v[u]);
          v[u] = c;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) cur[j + u] = v[u];
      }
      for (; j < cnt; ++j) {
        c = __dadd_rn(c, cur[j]);
        cur[j] = c;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += THREADS) dst[base + j] = cur[j];
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* segscan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue the two kernels on `stream` (they write disjoint positions);
// returns cudaGetLastError() after the launches (0 on success).  Does not
// synchronise.
extern "C" int segscan_launch(const void* w, const void* seg_start,
                              const void* seg_size, void* out, int64_t n,
                              void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const double*>(w);
  const auto* sp = static_cast<const int64_t*>(seg_start);
  const auto* zp = static_cast<const int64_t*>(seg_size);
  auto* op = static_cast<double*>(out);
  segscan_short<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      wp, sp, zp, op, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > LONG) {
    const int64_t windows = (n + LONG - 1) / LONG;
    segscan_long<<<static_cast<unsigned>(windows), THREADS, 0, st>>>(
        wp, sp, zp, op, n);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
