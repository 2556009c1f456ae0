// mjfinish: the lower levels of the device partitioner's Multi-Jagged
// sweep, from a handoff level L0 to the end, in one launch.
//
// No Pallas counterpart.  It replaces the tail of the level `while_loop` of
// the reference's device partitioner (src/repro/core/partition_jax.py,
// `_sweep`), which the port runs as whole-array torch operations
// (repro_torch/core/partition_torch.py, `mj_levels`): about 120 small
// operations a level, each queued by the host.  From some level on every
// segment of an unweighted sweep is small (4,096 points at level 5 of a
// 131,072-part sweep), so one block holds one segment and runs every
// remaining level of it in shared memory: no global sort, no contended
// atomic, and one launch a side instead of ~120 operations a level.
//
// Layout: the positional state at L0 as the torch loop leaves it: pts,
// mu, seg_start, seg_size, seg_np (N,) int64 and cols (d, N) float64, with
// the flips applied so far; candidate b owns slots [b*n, (b+1)*n).  `heads`
// lists the first position, within one candidate, of every segment at L0
// (the host plans them: an unweighted sweep's segment sizes do not depend
// on the points), so block (b, j) owns the segment at b*n + heads[j].
// A finished segment (np <= 1 or size <= 1) writes its part number and
// stops; a live one of at most `cap` points runs the levels:
//
//   * cut dimension: each dimension's max and min over the sub-segment, one
//     warp a sub-segment by shuffles (one thread a sub-segment once they
//     are many), no atomics; the longest by the `> best + 1e-12` rule over
//     the candidate's priority row, or the row's `level % d` entry without
//     longest_dim;
//   * the stable within-segment order of the torch loop, by (sub-segment,
//     key + 0.0, position), -0.0 tying 0.0: a block-wide bitonic sort
//     while some sub-segment holds more than SMALL_SORT points, then each
//     position's rank counted within its sub-segment;
//   * the rank cut in closed form: #{r : (r + 1) < size * (npl / np)} is
//     ceil(size * (npl / np)) - 1 clamped to [0, size], then k's clamps;
//   * the FZ / FZlow / Gray flips as negations, the child segments.
//
// Every float64 product, quotient and sum that feeds a comparison is a
// __d*_rn intrinsic: nothing is contracted into a fused multiply-add.
//
// What bounds it: not the bytes (the state at L0 read once and the part
// numbers written once: 8 * (d + 2) bytes a point, 31 MB, 9.4 us at 3.35
// TB/s, for six candidates of 131,072 3-d points) but the chain of levels,
// each waiting on the previous one: the top levels sort the whole segment
// with a bitonic network (78 barrier stages for 4,096 points), about 80 us
// a level on the card.  The design keeps every level's traffic in shared
// memory, runs the blocks of all candidates side by side, one block an SM
// (up to 225 KB of shared memory at d = 3; dimensions 4-6 take segments of
// up to 2,048 points), and leaves the network once the sub-segments are
// small (counting ranks costs a position its sub-segment's length).
//
// The host's plan and the state must agree: a block whose planned segment
// is not the state's (its first position not a segment head, its length
// not the distance to the next planned head, or a live one longer than
// `cap`) traps, so the launch fails and the next call that waits on the
// stream raises, rather than leave part numbers unwritten.  The checks
// make the blocks tile every candidate's positions exactly once.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 4096;          // the most points a segment may hold
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SMALL_SORT = 64;      // counting beats the network below this
constexpr int DYN_LIMIT = 232448 - 1024;  // dynamic shared memory a block
constexpr int SFC_Z = 0, SFC_GRAY = 1, SFC_FZ = 2, SFC_FZLOW = 3;

// shared bytes a slot: cols 8d, sort key 8, tag 4, np 4, mu 4, local point,
// sub-segment head, size, k and the head lists 2 each, cut dimension 1
__host__ __device__ constexpr int64_t slot_bytes(int d) { return 8 * d + 31; }

// A sort key whose unsigned order is the float64 order of v + 0.0
// (-0.0 and 0.0 become one key).
__device__ __forceinline__ uint64_t order_key(double v) {
  const uint64_t u =
      static_cast<uint64_t>(__double_as_longlong(__dadd_rn(v, 0.0)));
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}

// (sub-segment head, key, position) order; tags hold head << 16 | position
__device__ __forceinline__ bool before(uint64_t ka, uint32_t ta, uint64_t kb,
                                       uint32_t tb) {
  if ((ta >> 16) != (tb >> 16)) return (ta >> 16) < (tb >> 16);
  if (ka != kb) return ka < kb;
  return (ta & 0xffffu) < (tb & 0xffffu);
}

// The cut dimension of the sub-segment [s, s + z): each dimension's max
// and min over the positions this thread reads (from s + lane, every
// `step`), combined across the warp by shuffles when step is 32; then the
// longest by the `> best + 1e-12` rule over the priority row `srow`.
template <int D>
__device__ __forceinline__ int longest_cut(const double* scol, int cap, int s,
                                           int z, int lane, int step,
                                           const int* srow) {
  double hi[D], lo[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    hi[j] = -INFINITY;
    lo[j] = INFINITY;
  }
  for (int p = s + lane; p < s + z; p += step) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const double v = scol[j * cap + p];
      hi[j] = v > hi[j] ? v : hi[j];
      lo[j] = v < lo[j] ? v : lo[j];
    }
  }
  if (step == 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const double h2 = __shfl_xor_sync(0xffffffffu, hi[j], off);
        const double l2 = __shfl_xor_sync(0xffffffffu, lo[j], off);
        hi[j] = h2 > hi[j] ? h2 : hi[j];
        lo[j] = l2 < lo[j] ? l2 : lo[j];
      }
    }
  }
  double ext[D];
#pragma unroll
  for (int j = 0; j < D; ++j) ext[j] = __dsub_rn(hi[j], lo[j]);
  int best_p = 0;
  double best_e = 0.0;
#pragma unroll
  for (int p = 0; p < D; ++p) {
    double e = ext[0];
#pragma unroll
    for (int j = 1; j < D; ++j)
      if (srow[p] == j) e = ext[j];
    if (p == 0) {
      best_e = e;
    } else if (e > __dadd_rn(best_e, 1e-12)) {
      best_p = p;
      best_e = e;
    }
  }
  return srow[best_p];
}

// The left child's size of a live sub-segment of z points and np parts:
// #{r : (r + 1) < z * (npl / np)} in closed form, then the loop's clamps.
__device__ __forceinline__ int rank_cut(int z, int np, int npl) {
  const double x = __dmul_rn(static_cast<double>(z),
                             __ddiv_rn(static_cast<double>(npl),
                                       static_cast<double>(np)));
  const double below = fmin(fmax(ceil(x) - 1.0, 0.0), static_cast<double>(z));
  const int k = static_cast<int>(below) + 1;
  return min(max(k, 1), max(z - 1, 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mjfinish_kernel(const int64_t* __restrict__ pts,
                const double* __restrict__ cols,
                const int64_t* __restrict__ mu,
                const int64_t* __restrict__ seg_start,
                const int64_t* __restrict__ seg_size,
                const int64_t* __restrict__ seg_np,
                const int64_t* __restrict__ sdo,
                const int64_t* __restrict__ tab,
                const int64_t* __restrict__ heads, int64_t nheads, int64_t n,
                int64_t N, int level0, int levels, int cap, int sfc,
                int longest, int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* scol = reinterpret_cast<double*>(smem);            // (D, cap)
  uint64_t* key =
      reinterpret_cast<uint64_t*>(scol + static_cast<int64_t>(D) * cap);
  uint32_t* tag = reinterpret_cast<uint32_t*>(key + cap);
  int32_t* snp = reinterpret_cast<int32_t*>(tag + cap);     // by head
  int32_t* smu = snp + cap;                                 // by head
  uint16_t* lpts = reinterpret_cast<uint16_t*>(smu + cap);  // by position
  uint16_t* sst = lpts + cap;                               // by position
  uint16_t* ssz = sst + cap;                                // by head
  uint16_t* sk = ssz + cap;                                 // by head
  uint16_t* hl = sk + cap;                                  // 2 x cap/2
  uint8_t* scut = reinterpret_cast<uint8_t*>(hl + cap);     // by head
  __shared__ int nh_cur, nh_next, zmax;
  __shared__ int srow[D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x / nheads;
  const int64_t j = blockIdx.x % nheads;
  const int64_t head = heads[j];
  const int64_t end = j + 1 < nheads ? heads[j + 1] : n;
  const int64_t start = b * n + head;
  if ((j == 0 && head != 0) || head < 0 || end <= head || end > n) __trap();
  const int64_t z64 = seg_size[start];
  if (seg_start[start] != start || z64 != end - head) __trap();
  const int64_t np0 = seg_np[start];
  const int64_t mu0 = mu[start];
  if (np0 <= 1 || z64 <= 1) {  // finished: one part number, any size
    for (int64_t i = tid; i < z64; i += THREADS) out[pts[start + i]] = mu0;
    return;
  }
  if (z64 > cap || np0 > 0x7fffffff) __trap();
  const int z0 = static_cast<int>(z64);
  int sortn = 2;
  while (sortn < z0) sortn <<= 1;

  for (int i = tid; i < z0; i += THREADS) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      scol[j * cap + i] = cols[static_cast<int64_t>(j) * N + start + i];
    lpts[i] = static_cast<uint16_t>(i);
    sst[i] = 0;
    sk[i] = 0;
  }
  if (tid < D) srow[tid] = static_cast<int>(sdo[b * D + tid]);
  if (tid == 0) {
    ssz[0] = static_cast<uint16_t>(z0);
    snp[0] = static_cast<int32_t>(np0);
    smu[0] = 0;
    hl[0] = 0;
    nh_cur = 1;
    nh_next = 0;
    zmax = 0;
  }
  __syncthreads();

  uint16_t* cur = hl;
  uint16_t* nxt = hl + cap / 2;
  for (int level = level0; level < levels; ++level) {
    const int nh = nh_cur;
    if (nh == 0) break;

    // --- cut dimension and k of each live sub-segment: one warp each,
    // or one thread each once they are many (and so small) -------------
    int zm = 0;
    const bool many = nh >= THREADS / 2;
    for (int h = many ? tid : warp; h < nh; h += many ? THREADS : WARPS) {
      const int s = cur[h];
      const int z = ssz[s];
      int cut = 0;
      if (D > 1)
        cut = longest ? longest_cut<D>(scol, cap, s, z, many ? 0 : lane,
                                       many ? 1 : 32, srow)
                      : srow[level % D];
      if (many || lane == 0) {
        const int np = snp[s];
        scut[s] = static_cast<uint8_t>(cut);
        sk[s] = static_cast<uint16_t>(rank_cut(z, np,
                                               static_cast<int>(tab[np])));
        zm = max(zm, z);
      }
    }
    zm = __reduce_max_sync(0xffffffffu, zm);
    if (lane == 0 && zm > 0) atomicMax(&zmax, zm);
    __syncthreads();

    // --- sort keys: live sub-segments by their cut coordinate ----------
    const bool bitonic = zmax > SMALL_SORT;
    const int nkeys = bitonic ? sortn : z0;
    for (int i = tid; i < nkeys; i += THREADS) {
      uint64_t kk = ~0ull;
      uint32_t tt = 0xffff0000u | static_cast<uint32_t>(i);
      if (i < z0) {
        const int s = sst[i];
        kk = sk[s] ? order_key(scol[scut[s] * cap + i]) : 0ull;
        tt = (static_cast<uint32_t>(s) << 16) | static_cast<uint32_t>(i);
      }
      key[i] = kk;
      tag[i] = tt;
    }
    __syncthreads();

    if (bitonic) {
      // --- bitonic sort of (head, key, position) -----------------------
      for (int size = 2; size <= sortn; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = tid; t < (sortn >> 1); t += THREADS) {
            const int a = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
            const int c = a + stride;
            const uint64_t ka = key[a], kc = key[c];
            const uint32_t ta = tag[a], tc = tag[c];
            if (before(kc, tc, ka, ta) == ((a & size) == 0)) {
              key[a] = kc;
              key[c] = ka;
              tag[a] = tc;
              tag[c] = ta;
            }
          }
          __syncthreads();
        }
      }
    } else {
      // --- small sub-segments: each position's rank by counting --------
      for (int i = tid; i < z0; i += THREADS) {
        const int s = sst[i];
        if (sk[s] == 0) continue;  // finished: its tag stays in place
        const int z = ssz[s];
        const uint64_t ki = key[i];
        int r = 0;
        for (int j = s; j < s + z; ++j) {
          const uint64_t kj = key[j];
          r += kj < ki || (kj == ki && j < i);
        }
        tag[s + r] =
            (static_cast<uint32_t>(s) << 16) | static_cast<uint32_t>(i);
      }
      __syncthreads();
    }

    // --- permute the columns and the points (key is free now) ----------
    double* tmp = reinterpret_cast<double*>(key);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      for (int i = tid; i < z0; i += THREADS)
        tmp[i] = scol[j * cap + (tag[i] & 0xffffu)];
      __syncthreads();
      for (int i = tid; i < z0; i += THREADS) scol[j * cap + i] = tmp[i];
      __syncthreads();
    }
    uint16_t* tmp16 = reinterpret_cast<uint16_t*>(key);
    for (int i = tid; i < z0; i += THREADS) tmp16[i] = lpts[tag[i] & 0xffffu];
    __syncthreads();
    for (int i = tid; i < z0; i += THREADS) lpts[i] = tmp16[i];

    // --- flips and each position's child --------------------------------
    for (int i = tid; i < z0; i += THREADS) {
      const int s = sst[i];
      const int k = sk[s];
      if (k == 0) continue;
      const bool right = i - s >= k;
      const int cut = scut[s];
      if (sfc == SFC_GRAY) {
        if (right) {
#pragma unroll
          for (int j = 0; j < D; ++j) scol[j * cap + i] = -scol[j * cap + i];
        }
      } else if (sfc == SFC_FZ) {
        if (right) scol[cut * cap + i] = -scol[cut * cap + i];
      } else if (sfc == SFC_FZLOW) {
        if (!right) scol[cut * cap + i] = -scol[cut * cap + i];
      }
      if (right) sst[i] = static_cast<uint16_t>(s + k);
    }
    __syncthreads();

    // --- child segments and the next list of live heads ---------------
    for (int h0 = 0; h0 < nh; h0 += THREADS) {
      const int h = h0 + tid;
      bool left = false, right = false;
      int s = 0, r = 0;
      if (h < nh) {
        s = cur[h];
        const int k = sk[s];
        const int z = ssz[s];
        const int np = snp[s];
        const int npl = static_cast<int>(tab[np]);
        r = s + k;
        ssz[s] = static_cast<uint16_t>(k);
        snp[s] = npl;
        sk[s] = 0;
        ssz[r] = static_cast<uint16_t>(z - k);
        snp[r] = np - npl;
        smu[r] = smu[s] + npl;
        left = npl > 1 && k > 1;
        right = np - npl > 1 && z - k > 1;
      }
      // one append a warp: ballots, then each lane's offset
      const unsigned ml = __ballot_sync(0xffffffffu, left);
      const unsigned mr = __ballot_sync(0xffffffffu, right);
      int base = 0;
      if (lane == 0 && (ml | mr))
        base = atomicAdd(&nh_next, __popc(ml) + __popc(mr));
      base = __shfl_sync(0xffffffffu, base, 0);
      const unsigned below = (1u << lane) - 1u;
      if (left) nxt[base + __popc(ml & below)] = static_cast<uint16_t>(s);
      if (right)
        nxt[base + __popc(ml) + __popc(mr & below)] = static_cast<uint16_t>(r);
    }
    __syncthreads();
    if (tid == 0) {
      nh_cur = nh_next;
      nh_next = 0;
      zmax = 0;
    }
    uint16_t* swap = cur;
    cur = nxt;
    nxt = swap;
    __syncthreads();
  }

  for (int i = tid; i < z0; i += THREADS)
    out[pts[start + lpts[i]]] = mu0 + smu[sst[i]];
}

template <int D>
int launch(const void* pts, const void* cols, const void* mu,
           const void* seg_start, const void* seg_size, const void* seg_np,
           const void* sdo, const void* tab, const void* heads,
           int64_t nheads, int64_t blocks, int64_t n, int64_t N, int level0,
           int levels, int cap, int sfc, int longest, void* out,
           cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mjfinish_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DYN_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const size_t smem = static_cast<size_t>(cap) * slot_bytes(D);
  mjfinish_kernel<D><<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      static_cast<const int64_t*>(pts), static_cast<const double*>(cols),
      static_cast<const int64_t*>(mu), static_cast<const int64_t*>(seg_start),
      static_cast<const int64_t*>(seg_size),
      static_cast<const int64_t*>(seg_np), static_cast<const int64_t*>(sdo),
      static_cast<const int64_t*>(tab), static_cast<const int64_t*>(heads),
      nheads, n, N, level0, levels, cap, sfc, longest,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* mjfinish_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueue one block a segment of every candidate on `stream`; returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.  Does not
// synchronise.
extern "C" int mjfinish_launch(const void* pts, const void* cols,
                               const void* mu, const void* seg_start,
                               const void* seg_size, const void* seg_np,
                               const void* sdo, const void* tab,
                               const void* heads, int64_t nheads, int64_t nb,
                               int64_t n, int d, int level0, int levels,
                               int cap, int sfc, int longest, void* out,
                               void* stream) {
  if (nb <= 0 || n <= 0 || level0 >= levels) return 0;
  const int64_t blocks = nb * nheads;
  if (nheads <= 0 || nheads > n || cap < 2 || (cap & (cap - 1)) != 0 || cap > TILE ||
      cap * slot_bytes(d) > DYN_LIMIT || sfc < SFC_Z || sfc > SFC_FZLOW || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t N = nb * n;
#define MJ_LAUNCH(D)                                                      \
  case D:                                                                 \
    return launch<D>(pts, cols, mu, seg_start, seg_size, seg_np, sdo, tab, \
                     heads, nheads, blocks, n, N, level0, levels, cap, sfc, \
                     longest, out, st);
  switch (d) {
    MJ_LAUNCH(1)
    MJ_LAUNCH(2)
    MJ_LAUNCH(3)
    MJ_LAUNCH(4)
    MJ_LAUNCH(5)
    MJ_LAUNCH(6)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MJ_LAUNCH
}
