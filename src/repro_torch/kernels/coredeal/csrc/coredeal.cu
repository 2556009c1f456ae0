// coredeal: the expansion of a cluster -> router assignment to task -> core,
// in two launches around stable device sorts.
//
// No Pallas counterpart.  It replaces the host half of the hierarchy's last
// step, `assign_cores` (repro_torch/hier/refine.py; src/repro/hier/refine.py
// in the reference, plain numpy there too): Skilling's Hilbert transform as
// ~250 whole-array int64 passes over the tasks, an `np.lexsort` by
// (Hilbert key, cluster, router), then each router's tasks dealt round robin
// onto its cores.  On the host that is ~90 ms for 131,072 tasks.
//
//   * key launch, one thread a task: the task's coordinates quantised onto
//     the 2^bits-per-side grid exactly as `_hilbert_quantise` does (every
//     float64 step a __d*_rn intrinsic, `rint` rounding half to even like
//     `np.round`, so nothing is contracted into a fused multiply-add), the
//     transform in registers, and the task's Hilbert index and router.
//   * between them the caller's three stable sorts (by Hilbert index, then
//     cluster, then router: lexsort's order), and the stable sort of the
//     cores' router ids (`core_order`, `core_sorted`).
//   * deal launch, one thread a sorted position: its rank within its
//     router's tasks is its distance to the first position of that router,
//     and its router's cores the run of that id in `core_sorted`, both by
//     binary search (no per-router tables, so no launch to build them).  A
//     task within the budget of `q` tasks a core gets
//     core_order[start + rank % cores]; one beyond it gets -1 and is counted,
//     for the caller's spill pass.
//
// What bounds it: not the bytes (coordinates, cluster, router of a core and
// the answer: 8 d + 24 B a task, 6.3 MB, 1.9 us at 3.35 TB/s for 131,072
// three-dimensional tasks) but the sorts between the launches and the three
// binary searches a position, ~50 dependent L2 reads; all are microseconds.
// A cluster id outside [0, nclusters) or a router id outside [0, nrouters)
// is counted (its task takes router 0), and the caller raises on the count.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 62;  // 62 / d bits a side, at least one

// counts[]: what the caller reads back, in one copy
constexpr int SPILLED = 0, BAD_CLUSTER = 1, BAD_ROUTER = 2;

// The Hilbert index of a point on the 2^bits grid (Skilling's transpose
// algorithm, the loops of `hilbert_index` for one point).
__device__ __forceinline__ int64_t hilbert(int64_t* X, int d, int bits) {
  if (d == 1) return X[0];
  const int64_t M = int64_t{1} << (bits - 1);
  for (int64_t Q = M; Q > 1; Q >>= 1) {  // inverse undo excess work
    const int64_t P = Q - 1;
    for (int i = 0; i < d; ++i) {
      if (X[i] & Q) {
        X[0] ^= P;
      } else {
        const int64_t t = (X[0] ^ X[i]) & P;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  for (int i = 1; i < d; ++i) X[i] ^= X[i - 1];  // Gray encode
  int64_t t = 0;
  for (int64_t Q = M; Q > 1; Q >>= 1)
    if (X[d - 1] & Q) t ^= Q - 1;
  int64_t out = 0;
  for (int i = 0; i < d; ++i) {
    const int64_t x = X[i] ^ t;
    for (int b = 0; b < bits; ++b)
      out |= ((x >> b) & 1) << (b * d + (d - 1 - i));
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
keys_kernel(const double* __restrict__ coords, const double* __restrict__ lo,
            const double* __restrict__ hi, const int64_t* __restrict__ labels,
            const int64_t* __restrict__ c2r, int64_t n, int d,
            int64_t nclusters, int64_t nrouters, int bits,
            int64_t* __restrict__ h, int64_t* __restrict__ router,
            unsigned long long* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const double top = static_cast<double>((int64_t{1} << bits) - 1);
  int64_t X[MAX_D];
  for (int j = 0; j < d; ++j) {
    const double l = lo[j];
    double span = __dsub_rn(hi[j], l);
    if (!(span > 0.0)) span = 1.0;
    const double v = rint(__dmul_rn(
        __ddiv_rn(__dsub_rn(coords[i * d + j], l), span), top));
    // NaN (a NaN coordinate) becomes 0, as numpy's cast and clip make it
    X[j] = static_cast<int64_t>(fmin(fmax(v, 0.0), top));
  }
  h[i] = hilbert(X, d, bits);
  const int64_t c = labels[i];
  int64_t r = 0;
  if (c < 0 || c >= nclusters) {
    atomicAdd(counts + BAD_CLUSTER, 1ull);
  } else {
    r = c2r[c];
    if (r < 0 || r >= nrouters) {
      atomicAdd(counts + BAD_ROUTER, 1ull);
      r = 0;
    }
  }
  router[i] = r;
}

// The first index of `v` in the ascending run a[0, m), or where it would go.
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ a,
                                               int64_t m, int64_t v) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
deal_kernel(const int64_t* __restrict__ srouter,
            const int64_t* __restrict__ order,
            const int64_t* __restrict__ core_sorted,
            const int64_t* __restrict__ core_order, int64_t n, int64_t ncores,
            int64_t q, int64_t* __restrict__ t2p,
            unsigned long long* __restrict__ counts) {
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (pos >= n) return;
  const int64_t r = srouter[pos];
  const int64_t rank = pos - lower_bound(srouter, n, r);
  const int64_t cs = lower_bound(core_sorted, ncores, r);
  const int64_t cores = lower_bound(core_sorted, ncores, r + 1) - cs;
  if (rank < cores * q) {
    t2p[order[pos]] = core_order[cs + rank % cores];
  } else {
    t2p[order[pos]] = -1;
    atomicAdd(counts + SPILLED, 1ull);
  }
}

}  // namespace

extern "C" const char* coredeal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue the key launch on `stream`: h (n,) int64 the Hilbert index and
// router (n,) int64 the router of every task, from coords (n, d) float64
// row-major, lo / hi (d,) float64 their column minima and maxima, labels (n,)
// and c2r (nclusters,) int64; adds the out-of-range cluster and router ids
// to counts[1] and counts[2] (int64).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take.  Does not
// synchronise.
extern "C" int coredeal_keys_launch(const void* coords, const void* lo,
                                    const void* hi, const void* labels,
                                    const void* c2r, int64_t n, int d,
                                    int64_t nclusters, int64_t nrouters,
                                    int bits, void* h, void* router,
                                    void* counts, void* stream) {
  if (n <= 0) return 0;
  if (d < 1 || d > MAX_D || bits < 1 || bits * d > 62 || nclusters < 1 ||
      nrouters < 1 || (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  keys_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(coords), static_cast<const double*>(lo),
      static_cast<const double*>(hi), static_cast<const int64_t*>(labels),
      static_cast<const int64_t*>(c2r), n, d, nclusters, nrouters, bits,
      static_cast<int64_t*>(h), static_cast<int64_t*>(router),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the deal launch on `stream`: srouter (n,) the routers in sorted
// order (ascending), order (n,) the task at each sorted position,
// core_sorted (ncores,) the cores' router ids ascending and core_order
// (ncores,) the core at each; writes t2p (n,) int64 and adds the tasks beyond
// their router's budget to counts[0].  Returns as the key launch.
extern "C" int coredeal_deal_launch(const void* srouter, const void* order,
                                    const void* core_sorted,
                                    const void* core_order, int64_t n,
                                    int64_t ncores, int64_t q, void* t2p,
                                    void* counts, void* stream) {
  if (n <= 0) return 0;
  if (ncores < 1 || q < 1 || (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  deal_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(srouter), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(core_sorted),
      static_cast<const int64_t*>(core_order), n, ncores, q,
      static_cast<int64_t*>(t2p), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
