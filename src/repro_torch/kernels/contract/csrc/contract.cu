// contract: the hierarchy's contraction of a task graph onto its clusters,
// in four launches around stable device sorts.
//
// No Pallas counterpart.  It replaces the contraction of
// `aggregate_tasks` (repro_torch/hier/aggregate.py; src/repro/hier/
// aggregate.py in the reference, numpy there too): `np.bincount` for the
// cluster sizes, weights and each centroid column, `labels[edges]` and the
// intra / inter split over every edge, `np.unique` of the inter-cluster
// pair keys and an `np.bincount` of their volumes.  On the host that is
// ~45-55 ms for the node cell's 131,072 tasks and 770,048 edges.  Every
// output keeps numpy's bits:
//
//   * key launch, one thread an edge: both endpoints' labels; an
//     inter-cluster edge gets the key c0 * nclusters + c1, an
//     intra-cluster one the sentinel nclusters^2, which sorts after every
//     pair key.  Endpoints outside [0, n) are counted (and keyed as the
//     sentinel); sentinel keys are counted too, one atomic a warp.
//   * between them the caller's stable sort of the keys: the edges of one
//     pair stay in edge order, the order in which `np.bincount(inv,
//     weights=...)` adds them, and the intra edges, last, stay in edge
//     order too.
//   * head launch, one thread a sorted position: 1 where a pair's run of
//     keys starts; the caller's integer scan of the heads numbers the
//     pairs in key order, which is `np.unique`'s sorted order.
//   * segment launch, one thread a sorted position: the head of a run adds
//     its edges' volumes left to right in float64 from 0.0, each add a
//     __dadd_rn (nothing contracted), as bincount does, and writes the pair
//     (key / nclusters, key % nclusters) and the sum; an intra position
//     copies its volume into the compacted intra list.  The caller sums
//     that list with numpy: `ew[intra].sum()` is numpy's pairwise sum,
//     whose blocking is numpy's own and may change between its versions,
//     so the same values in the same order summed by numpy give its bits
//     by construction (8 bytes an intra edge copied back: 4.2 MB, ~0.2 ms,
//     in the node cell).
//   * cluster launch, one thread a cluster, over the caller's stable sort
//     of the labels (a cluster's tasks in task order): its size, the
//     sequential sums of its task weights and of coords[:, j] * w (one
//     rounded product, __dmul_rn, as numpy forms `tc[:, j] * wv`), each
//     centroid coordinate divided by where(cw > 0, cw, 1) (__ddiv_rn).
//     Labels outside [0, nclusters) sort to either end; thread 0 counts
//     them.
//
// Results are written into one packed int64 buffer (float64 sums as their
// bit patterns): sizes (nc), weights (nc), centroids (nc x d), pairs (m x
// 2), volumes (m), intra volumes (k), with m the pair count and k the
// intra count, both known only on the card: the segment launch places its
// writes from them, and the caller reads them back once with the error
// counts and then copies the packed prefix once.
//
// What bounds it: not the bytes (16 B of endpoints and 8 of volume an edge,
// 8 (d + 2) B a task: ~22 MB in the node cell, 6.7 us at 3.35 TB/s) and not
// the launches' arithmetic, but the two sorts between them and, before
// them, the host-to-card uploads of those ~22 MB, which set the pace.  A
// run's sum is a chain of dependent float64 adds: runs are short (a pair's
// parallel edges, a cluster's tasks), so a thread a run keeps every add in
// order without waiting long.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// counts[]: what the caller reads back, in one copy
constexpr int BAD_ENDPOINT = 0, BAD_LABEL = 1, INTRA = 2, PAIRS = 3;

__global__ void __launch_bounds__(THREADS)
keys_kernel(const int64_t* __restrict__ edges,
            const int64_t* __restrict__ labels, int64_t nedges, int64_t n,
            int64_t nc, int64_t* __restrict__ key,
            unsigned long long* __restrict__ counts) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t sentinel = nc * nc;
  bool bad = false, intra = false;
  if (e < nedges) {
    const int64_t a = edges[2 * e], b = edges[2 * e + 1];
    int64_t k = sentinel;
    if (a < 0 || a >= n || b < 0 || b >= n) {
      bad = true;
    } else {
      const int64_t la = labels[a], lb = labels[b];
      // a label out of range is counted by the cluster launch
      if (la != lb && la >= 0 && la < nc && lb >= 0 && lb < nc)
        k = la * nc + lb;
    }
    key[e] = k;
    intra = k == sentinel;
  }
  // every thread of the warp reaches the votes: none has returned
  const unsigned nintra = __popc(__ballot_sync(0xffffffffu, intra));
  const unsigned nbad = __popc(__ballot_sync(0xffffffffu, bad));
  if ((threadIdx.x & 31) == 0) {
    if (nintra)
      atomicAdd(counts + INTRA, static_cast<unsigned long long>(nintra));
    if (nbad)
      atomicAdd(counts + BAD_ENDPOINT, static_cast<unsigned long long>(nbad));
  }
}

__global__ void __launch_bounds__(THREADS)
heads_kernel(const int64_t* __restrict__ sk, int64_t nedges,
             int64_t sentinel, int32_t* __restrict__ head) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= nedges) return;
  const int64_t k = sk[p];
  head[p] = k != sentinel && (p == 0 || sk[p - 1] != k);
}

__global__ void __launch_bounds__(THREADS)
segments_kernel(const int64_t* __restrict__ sk,
                const int64_t* __restrict__ si, const double* __restrict__ ew,
                const int32_t* __restrict__ scan, int64_t nedges, int64_t nc,
                int64_t base, unsigned long long* __restrict__ counts,
                int64_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= nedges) return;
  const int64_t npairs = scan[nedges - 1];
  const int64_t ninter = nedges - static_cast<int64_t>(counts[INTRA]);
  if (p == 0) counts[PAIRS] = static_cast<unsigned long long>(npairs);
  if (p >= ninter) {  // the intra edges, last, in edge order
    out[base + 3 * npairs + (p - ninter)] = __double_as_longlong(ew[si[p]]);
    return;
  }
  const int64_t k = sk[p];
  if (p > 0 && sk[p - 1] == k) return;
  double acc = 0.0;
  for (int64_t q = p; q < ninter && sk[q] == k; ++q)
    acc = __dadd_rn(acc, ew[si[q]]);
  const int64_t u = scan[p] - 1;
  out[base + 2 * u] = k / nc;
  out[base + 2 * u + 1] = k % nc;
  out[base + 2 * npairs + u] = __double_as_longlong(acc);
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
clusters_kernel(const int64_t* __restrict__ sl,
                const int64_t* __restrict__ order,
                const double* __restrict__ coords,
                const double* __restrict__ w, int64_t n, int d, int64_t nc,
                unsigned long long* __restrict__ counts,
                int64_t* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= nc) return;
  if (c == 0 && n > 0 && (sl[0] < 0 || sl[n - 1] >= nc))
    atomicAdd(counts + BAD_LABEL, 1ull);
  const int64_t start = lower_bound(sl, n, c);
  const int64_t end = lower_bound(sl, n, c + 1);
  out[c] = end - start;
  double cw = 0.0;
  for (int64_t k = start; k < end; ++k)
    cw = __dadd_rn(cw, w ? w[order[k]] : 1.0);
  out[nc + c] = __double_as_longlong(cw);
  const double denom = cw > 0.0 ? cw : 1.0;
  for (int j = 0; j < d; ++j) {
    double s = 0.0;
    for (int64_t k = start; k < end; ++k) {
      const int64_t i = order[k];
      s = __dadd_rn(s, __dmul_rn(coords[i * d + j], w ? w[i] : 1.0));
    }
    out[2 * nc + c * d + j] = __double_as_longlong(__ddiv_rn(s, denom));
  }
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

bool too_many(int64_t n) { return (n + THREADS - 1) / THREADS > 0x7fffffffLL; }

}  // namespace

extern "C" const char* contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue the key launch on `stream`: key (nedges,) int64 from edges
// (nedges, 2) int64 row-major and labels (n,) int64; adds the edges with an
// endpoint outside [0, n) to counts[0] and the sentinel keys (nc * nc) to
// counts[2] (int64).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape it does not take.  Does not
// synchronise.
extern "C" int contract_keys_launch(const void* edges, const void* labels,
                                    int64_t nedges, int64_t n, int64_t nc,
                                    void* key, void* counts, void* stream) {
  if (nedges <= 0) return 0;
  if (nc < 1 || nc > 0x7fffffffLL || too_many(nedges))
    return static_cast<int>(cudaErrorInvalidValue);
  keys_kernel<<<blocks_for(nedges), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(edges), static_cast<const int64_t*>(labels),
      nedges, n, nc, static_cast<int64_t*>(key),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the head launch: head (nedges,) int32, 1 at the first sorted
// position of each pair's run of keys sk (nedges,) int64 ascending, 0 at
// the rest and at the sentinel keys.  Returns as the key launch.
extern "C" int contract_heads_launch(const void* sk, int64_t nedges,
                                     int64_t nc, void* head, void* stream) {
  if (nedges <= 0) return 0;
  if (nc < 1 || nc > 0x7fffffffLL || too_many(nedges))
    return static_cast<int>(cudaErrorInvalidValue);
  heads_kernel<<<blocks_for(nedges), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sk), nedges, nc * nc,
      static_cast<int32_t*>(head));
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the segment launch: from the sorted keys sk and edge indices si
// (nedges,) int64, the volumes ew (nedges,) float64 in edge order and the
// inclusive scan of the heads (nedges,) int32, writes out[base + 2u],
// out[base + 2u + 1] the pair u, out[base + 2m + u] its summed volume and
// out[base + 3m + j] the j-th intra volume (m the pair count, read from the
// scan and written to counts[3]; the intra count read from counts[2]).
// Returns as the key launch.
extern "C" int contract_segments_launch(const void* sk, const void* si,
                                        const void* ew, const void* scan,
                                        int64_t nedges, int64_t nc,
                                        int64_t base, void* counts, void* out,
                                        void* stream) {
  if (nedges <= 0) return 0;
  if (nc < 1 || base < 0 || too_many(nedges))
    return static_cast<int>(cudaErrorInvalidValue);
  segments_kernel<<<blocks_for(nedges), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sk), static_cast<const int64_t*>(si),
      static_cast<const double*>(ew), static_cast<const int32_t*>(scan),
      nedges, nc, base, static_cast<unsigned long long*>(counts),
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the cluster launch: from the stably sorted labels sl (n,) int64
// and the task at each sorted position order (n,) int64, the coordinates
// (n, d) float64 row-major and the task weights w (n,) float64 (null: every
// weight 1), writes out[c] the size, out[nc + c] the summed weight and
// out[2 nc + c d + j] the centroid of cluster c; adds 1 to counts[1] when a
// label lies outside [0, nc).  Returns as the key launch.
extern "C" int contract_clusters_launch(const void* sl, const void* order,
                                        const void* coords, const void* w,
                                        int64_t n, int d, int64_t nc,
                                        void* counts, void* out,
                                        void* stream) {
  if (nc <= 0) return 0;
  if (d < 1 || n < 0 || too_many(nc))
    return static_cast<int>(cudaErrorInvalidValue);
  clusters_kernel<<<blocks_for(nc), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sl), static_cast<const int64_t*>(order),
      static_cast<const double*>(coords), static_cast<const double*>(w), n, d,
      nc, static_cast<unsigned long long*>(counts),
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
