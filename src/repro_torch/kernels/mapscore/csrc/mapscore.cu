// mapscore: score a stack of candidate task->processor mappings on the GPU.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mapscore/kernel.py
// (_mapscore_kernel, launched by mapscore_call).  Per candidate, over all
// messages of the task graph:
//
//   * sum of w * hops and sum of hops (shortest per-dimension distance,
//     torus wrap-around, core dimensions free);
//   * with `traffic`: dimension-ordered routing of every message; the
//     circular interval of links it crosses along each network dimension is
//     added to a per-(dimension, direction) difference array, the prefix sum
//     along the dimension gives the link loads, and the kernel returns the
//     largest load (data_max) and the largest load / bandwidth (latency_max).
//
// What bounds it on an H100.  Not the bytes the function must move (the
// edges, weights and coordinate tables, ~65 MB at 2^18 tasks and 8
// candidates: 19 us at the memory rate), but the work per (message,
// candidate) pair: two gathers from the candidate's coordinate table, the
// hop arithmetic, and for every message that leaves its node 2-4 64-bit
// atomic adds per network dimension it crosses into link accumulators of
// 2 x (machine size) entries per candidate and dimension (8.4 MB on a
// (32,32,32,16) Gemini torus), which no shared memory holds.  Measured
// (tools/probe_mapscore.py): the accumulate pass scales with the SMs it
// gets and barely with where the accumulators live on a stencil, while on
// a random graph over a 512 x 512 torus it is bound by the L2's atomics
// and slows 2x once a group's accumulators outgrow the L2; the reduce
// pass streams the accumulators once more.
//
// What the design does about it:
//
//   * No host sync before the launch.  A first pass reads the int64 edge
//     list once, checks it against the task count and narrows it to int32;
//     checks every coordinate against its dimension and packs each task's
//     coordinates into one 32-bit word (64 where the machine needs more
//     bits), so a gather is one 4-byte load and all tables fit the L2; and
//     sums |w| in a fixed order (per-block partial sums, then the last
//     block to finish adds them) for the fixed-point scale.  A fault sets a
//     bit of a status word that comes back with the results, and the later
//     passes then route nothing.
//   * Candidates go in groups, at least four a stack, whose accumulators
//     fit the L2 (on a random graph a group twice that size runs 2x
//     slower), through two workspaces in a scratch buffer the caller keeps
//     per device and stream (all zero between launches): step i
//     accumulates group i into one workspace while 6/16 of its blocks
//     reduce group i - 1 from the other, so the reduce's streaming overlaps
//     the accumulate, and no separate reduce launch waits.  The
//     reduce zeroes every non-zero entry behind its read (most stay zero,
//     and their sectors are never written), so no memset runs.  The
//     difference array has no dump column: an interval that ends at the
//     last link needs no closing entry.
//   * Each message's edge pair and weight is read once a group: a thread
//     holds four messages in registers (the next tile's load while this one
//     is scored) and walks the group's candidates over them.
//   * Results must not depend on the order the atomics land in (the service
//     caches by content and promises the same winner for the same request).
//     Every weight is converted to 64-bit fixed point with the power-of-two
//     scale, chosen so that no sum can overflow; integer addition is
//     associative, so two launches on equal inputs agree bit for bit.  The
//     maxima are taken with an integer atomicMax on the bit pattern of a
//     non-negative double, which is order-free too.
//
// One compiled kernel serves every machine and message count: sizes, dims,
// wrap flags, offsets and the packed word's layout arrive in a small struct
// at run time.  The per-dimension loops run to MAPSCORE_MAX_DIMS; the dims
// past the machine's have zero masks and strides and add nothing (a kernel
// per dimension count and word size was no faster on all three full-size
// stacks: tools/probe_mapscore.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define MAPSCORE_MAX_DIMS 8
#define GROUP_MAX 8                  // candidates a thread walks per message
constexpr int kThreads = 256;        // threads a block, every pass
constexpr int kMsgsPerThread = 4;    // messages a thread holds in registers
constexpr unsigned kBlocksPerSm = 8; // blocks a step launches per SM
constexpr int kReduceBatch = 8;      // columns a reduce thread loads at once
constexpr unsigned kRedShare16 = 6;  // sixteenths of a step's blocks that
                                     // reduce beside an accumulate

// status bits (scratch[S_STATUS], returned in res[0])
#define ST_EDGE 1u             // an edge index outside [0, ntasks)
#define ST_COL0 2u             // << j: a coordinate of column j outside [0, dims[j])
#define ST_WEIGHT (1u << 9)    // the |w| sum is not finite

// scratch header (int64 entries); per-candidate slots and the workspace
// follow at params.cand_off and params.ws_off
#define S_STATUS 0
#define S_TICKET 1
#define S_SHIFT 2
#define SHIFT_NONE (-2000)     // weights not finite: scale 0, no atomics

struct MapscoreParams {
    int32_t ndim;        // machine dimensions (network + core)
    int32_t nd;          // network dimensions (the first nd of ndim)
    int32_t ncols;       // columns of coord_stack (>= nd; == ndim if traffic)
    int32_t traffic;     // 0: hop sums only; 1: also route
    int32_t group;       // candidates per launch group (1..GROUP_MAX)
    int32_t packed64;    // packed coordinate words are 64-bit (else 32)
    int64_t nb;          // candidates in this launch
    int64_t ntasks;      // rows of one candidate's coordinate table
    int64_t ne;          // messages
    int64_t unit;        // workspace entries of one (candidate, dim):
                         // 2 directions x s_k x rows_k = 2 x machine size
    int64_t rows_max;    // largest rows_k
    int64_t cand_off;    // scratch offset of the per-candidate slots
    int64_t ws_off;      // scratch offset of the two group workspaces
    int64_t prep_blocks; // blocks of the first pass (partial |w| sums)
    double span;         // max(2, sum of network extents): hop bound
    int32_t dims[MAPSCORE_MAX_DIMS];
    int32_t wrap[MAPSCORE_MAX_DIMS];
    int32_t rows[MAPSCORE_MAX_DIMS];     // rows_k: product of the other dims
    int32_t bw_off[MAPSCORE_MAX_DIMS];   // start of dim k in inv_bw
    int32_t pshift[MAPSCORE_MAX_DIMS];   // bit offset of coordinate j in a
    uint32_t pmask[MAPSCORE_MAX_DIMS];   // packed word, and its mask
    // row key of dim k: sum over j of coordinate j times stride[k][j]
    // (mixed radix over the other dims; stride[k][k] = 0)
    int32_t stride[MAPSCORE_MAX_DIMS][MAPSCORE_MAX_DIMS];
};

typedef unsigned long long u64;

// per-candidate slots in scratch: fixed-point sum of w*hops, sum of hops,
// bits of data_max, bits of latency_max
#define SLOT_WH 0
#define SLOT_TH 1
#define SLOT_DATA 2
#define SLOT_LAT 3
#define SLOTS 4

__device__ __forceinline__ void atomic_add_i64(int64_t* p, int64_t v) {
    // two's complement: an unsigned add of the bit pattern is a signed add
    atomicAdd(reinterpret_cast<u64*>(p), static_cast<u64>(v));
}


__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ double warp_max(double v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Fixed-order sum over the block (the same tree every launch); the result
// is valid in thread 0.
__device__ double block_sum_f64(double v) {
    __shared__ double red[kThreads / 32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    v = warp_sum_f64(v);
    __syncthreads();  // red may still be read by an earlier call
    if (lane == 0) red[wid] = v;
    __syncthreads();
    v = lane < kThreads / 32 && wid == 0 ? red[lane] : 0.0;
    return wid == 0 ? warp_sum_f64(v) : 0.0;
}

// Pass 1: grid (prep_blocks).  Block b narrows and checks its share of the
// edge list, sums its |w|, and checks and packs its share of the candidates'
// coordinate rows; the last block to finish adds the partial sums in block
// order and stores the fixed-point exponent.
__global__ void __launch_bounds__(kThreads)
mapscore_prep(const int64_t* __restrict__ edges, const float* __restrict__ w,
              const int32_t* __restrict__ coords, int2* __restrict__ e32,
              void* __restrict__ table, double* __restrict__ parts,
              int64_t* __restrict__ scratch, const MapscoreParams p) {
    const int64_t per = (p.ne + gridDim.x - 1) / gridDim.x;
    const int64_t lo = (int64_t)blockIdx.x * per;
    const int64_t hi = min(lo + per, p.ne);
    double s = 0.0;
    unsigned bad = 0;
#pragma unroll 4
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
        const int64_t a = __ldcs(reinterpret_cast<const long long*>(edges) + 2 * e);
        const int64_t b = __ldcs(reinterpret_cast<const long long*>(edges) + 2 * e + 1);
        s += fabs((double)__ldcs(w + e));
        if (a < 0 || a >= p.ntasks || b < 0 || b >= p.ntasks) bad |= ST_EDGE;
        e32[e] = make_int2((int32_t)a, (int32_t)b);
    }
    const int64_t nrows = p.nb * p.ntasks;
    const int64_t rper = (nrows + gridDim.x - 1) / gridDim.x;
    const int64_t rlo = (int64_t)blockIdx.x * rper;
    const int64_t rhi = min(rlo + rper, nrows);
#pragma unroll 4
    for (int64_t r = rlo + threadIdx.x; r < rhi; r += kThreads) {
        int32_t v[MAPSCORE_MAX_DIMS];
        if (p.ncols == 4) {
            const int4 q = __ldcs(reinterpret_cast<const int4*>(coords) + r);
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
            for (int j = 0; j < p.ncols; ++j)
                v[j] = __ldcs(coords + r * p.ncols + j);
        }
        u64 word = 0;
#pragma unroll
        for (int j = 0; j < MAPSCORE_MAX_DIMS; ++j) {
            if (j >= p.ncols) break;
            if ((unsigned)v[j] >= (unsigned)p.dims[j]) bad |= ST_COL0 << j;
            else word |= (u64)v[j] << p.pshift[j];
        }
        if (p.packed64) static_cast<u64*>(table)[r] = word;
        else static_cast<uint32_t*>(table)[r] = (uint32_t)word;
    }
    bad = __reduce_or_sync(0xffffffffu, bad);
    if (bad && (threadIdx.x & 31) == 0)
        atomicOr(reinterpret_cast<u64*>(scratch + S_STATUS), (u64)bad);
    s = block_sum_f64(s);
    __shared__ int last;
    if (threadIdx.x == 0) {
        parts[blockIdx.x] = s;
        __threadfence();
        const u64 t = atomicAdd(reinterpret_cast<u64*>(scratch + S_TICKET), 1ull);
        last = t == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    double t = 0.0;
    for (int64_t i = threadIdx.x; i < gridDim.x; i += kThreads)
        t += __ldcg(parts + i);
    t = block_sum_f64(t);
    if (threadIdx.x == 0) {
        // fixed_point_shift of kernel.py: bound * 2^shift < 2^62
        const double bound = t * p.span;
        int64_t shift = 0;
        if (!isfinite(bound)) {
            shift = SHIFT_NONE;
            atomicOr(reinterpret_cast<u64*>(scratch + S_STATUS), (u64)ST_WEIGHT);
        } else if (bound > 0.0) {
            int ex;
            frexp(bound, &ex);
            shift = 62 - ex;
        }
        scratch[S_SHIFT] = shift;
        scratch[S_TICKET] = 0;  // ready for the next launch
    }
}

// One endpoint's coordinates from a candidate's table of packed words
// (64-bit words where the machine needs them, else 32-bit).  Columns past
// ncols have a zero mask: their coordinate is 0.
#define MAXD MAPSCORE_MAX_DIMS
template <typename Word>
__device__ __forceinline__ void unpack(Word word, int32_t (&v)[MAXD],
                                       const MapscoreParams& p) {
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
        v[j] = (int32_t)((word >> p.pshift[j]) & p.pmask[j]);
}

__device__ __forceinline__ void gather(const void* __restrict__ tab, int32_t t,
                                       int32_t (&v)[MAXD],
                                       const MapscoreParams& p) {
    if (p.packed64)
        unpack(__ldg(static_cast<const unsigned long long*>(tab) + t), v, p);
    else
        unpack(__ldg(static_cast<const unsigned int*>(tab) + t), v, p);
}

// The difference-array entries of one message's route along network dim
// k: its circular interval of links, in the direction it takes, on the row
// of the other dims' coordinates (dims before k at the destination
// already, dims after k and the core dims still at the source).
__device__ __forceinline__ void route(int k, const int32_t (&src)[MAXD],
                                      const int32_t (&dst)[MAXD], int64_t wq,
                                      int64_t* __restrict__ wsc,
                                      const MapscoreParams& p) {
    const int32_t s = p.dims[k];
    int32_t a = 0, b = 0;
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
        if (j == k) { a = src[j]; b = dst[j]; }
    int32_t start, len, dir;
    if (p.wrap[k]) {
        int32_t fwd = b - a; if (fwd < 0) fwd += s;
        const int32_t bwd = s - fwd;  // a != b: both in [1, s-1]
        if (fwd <= bwd) { dir = 0; start = a; len = fwd; }
        else { dir = 1; len = bwd; start = a - bwd; if (start < 0) start += s; }
    } else if (b > a) { dir = 0; start = a; len = b - a; }
    else { dir = 1; start = b; len = a - b; }
    // int32: the host checked that a candidate's workspace has < 2^31
    // entries
    const int32_t rows = p.rows[k];
    int32_t off = (int32_t)(k * p.unit) + (dir ? s * rows : 0);
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
        off += (j < k ? dst[j] : src[j]) * p.stride[k][j];
    const int32_t end = start + len;
    atomic_add_i64(wsc + off + start * rows, wq);
    // an interval that ends at the last link needs no closing entry: the
    // prefix sum stops there
    if (end < s) atomic_add_i64(wsc + off + end * rows, -wq);
    if (end > s) {  // wrapped tail [0, end - s)
        atomic_add_i64(wsc + off, wq);
        atomic_add_i64(wsc + off + (end - s) * rows, -wq);
    }
}

// Accumulate part of a step: candidates [c0, c0 + g) into workspace `ws`,
// by block `blk` of `nblk`, each walking tiles of kThreads * kMsgsPerThread
// messages.  A thread holds its messages in registers (the next tile's
// load while this one is scored) and walks the group's candidates over
// them: hop sums, and (traffic) the difference-array entries of each
// message's route.  Sums go to the candidates' slots once per block.
__device__ void accumulate(const void* __restrict__ table,
                           const int2* __restrict__ e32,
                           const float* __restrict__ w,
                           int64_t* __restrict__ scratch,
                           int64_t* __restrict__ ws, int64_t c0, int g,
                           int blk, int nblk, const MapscoreParams& p) {
    const double scale = ldexp(1.0, (int)scratch[S_SHIFT]);
    const int word_bytes = p.packed64 ? 8 : 4;
    int64_t whs[GROUP_MAX], ths[GROUP_MAX];
#pragma unroll
    for (int c = 0; c < GROUP_MAX; ++c) whs[c] = ths[c] = 0;

    const int64_t tile = (int64_t)kThreads * kMsgsPerThread;
    const int64_t stride = (int64_t)nblk * tile;
    int2 ed_next[kMsgsPerThread];
    float w_next[kMsgsPerThread];
    auto load_tile = [&](int64_t t0) {
#pragma unroll
        for (int i = 0; i < kMsgsPerThread; ++i) {
            const int64_t e = t0 + i * kThreads + threadIdx.x;
            ed_next[i] = make_int2(-1, -1);
            w_next[i] = 0.0f;
            if (e < p.ne) {
                ed_next[i] = __ldcs(e32 + e);
                w_next[i] = __ldcs(w + e);
            }
        }
    };
    load_tile((int64_t)blk * tile);
    for (int64_t t0 = (int64_t)blk * tile; t0 < p.ne; t0 += stride) {
        int2 ed[kMsgsPerThread];
        int64_t wq[kMsgsPerThread];
#pragma unroll
        for (int i = 0; i < kMsgsPerThread; ++i) {
            ed[i] = ed_next[i];
            wq[i] = llrint((double)w_next[i] * scale);
        }
        if (t0 + stride < p.ne) load_tile(t0 + stride);
        for (int c = 0; c < g; ++c) {
            const void* tab = static_cast<const char*>(table)
                + (c0 + c) * p.ntasks * word_bytes;
            int64_t* wsc = ws + (int64_t)c * p.nd * p.unit;
            int64_t wh = 0, th = 0;
#pragma unroll
            for (int i = 0; i < kMsgsPerThread; ++i) {
                if (ed[i].x < 0) continue;
                int32_t src[MAXD], dst[MAXD];
                gather(tab, ed[i].x, src, p);
                gather(tab, ed[i].y, dst, p);
                int32_t hops = 0;
#pragma unroll
                for (int k = 0; k < MAXD; ++k) {
                    if (k < p.nd) {
                        int32_t d = abs(src[k] - dst[k]);
                        if (p.wrap[k]) d = min(d, p.dims[k] - d);
                        hops += d;
                    }
                }
                wh += (int64_t)hops * wq[i];
                th += hops;
                if (!p.traffic || hops == 0 || wq[i] == 0) continue;
#pragma unroll
                for (int k = 0; k < MAXD; ++k)
                    if (k < p.nd && src[k] != dst[k])
                        route(k, src, dst, wq[i], wsc, p);
            }
            whs[c] += wh;
            ths[c] += th;
        }
    }

    __shared__ int64_t red[2][kThreads / 32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    for (int c = 0; c < g; ++c) {
        const int64_t wh = warp_sum(whs[c]), th = warp_sum(ths[c]);
        __syncthreads();
        if (lane == 0) { red[0][wid] = wh; red[1][wid] = th; }
        __syncthreads();
        if (wid == 0) {
            const int64_t a = warp_sum(lane < kThreads / 32 ? red[0][lane] : 0);
            const int64_t b = warp_sum(lane < kThreads / 32 ? red[1][lane] : 0);
            if (lane == 0) {
                int64_t* slot = scratch + p.cand_off + (c0 + c) * SLOTS;
                atomic_add_i64(slot + SLOT_WH, a);
                atomic_add_i64(slot + SLOT_TH, b);
            }
        }
    }
}

// Reduce part of a step: candidates [c0, c0 + g) from workspace `ws`, by
// block `blk` of `nblk`.  One thread per (candidate, dim, direction, row),
// grid-stride: running sum over the s_k columns, maxima of load and load /
// bandwidth; every non-zero entry is zeroed behind its read (most entries
// of a difference array stay zero, and their sectors are never written).
// Maxima gather in shared memory, then one atomicMax per candidate and
// block.
__device__ void reduce(int64_t* __restrict__ scratch,
                       int64_t* __restrict__ ws,
                       const float* __restrict__ inv_bw, int64_t c0, int g,
                       int blk, int nblk, const MapscoreParams& p) {
    __shared__ unsigned long long bmax[GROUP_MAX][2];
    if (threadIdx.x < 2 * GROUP_MAX) (&bmax[0][0])[threadIdx.x] = 0;
    __syncthreads();
    const int shift = (int)scratch[S_SHIFT];
    const double inv_scale = shift == SHIFT_NONE ? 0.0 : ldexp(1.0, -shift);
    int64_t per_cand = 0;
    for (int k = 0; k < p.nd; ++k) per_cand += 2 * (int64_t)p.rows[k];
    const int64_t total = per_cand * g;
    const int64_t nthreads = (int64_t)nblk * kThreads;
    for (int64_t t0 = (int64_t)blk * kThreads; t0 < total; t0 += nthreads) {
        const int64_t t = t0 + threadIdx.x;
        double data = 0.0, lat = 0.0;
        const int cl = t < total ? (int)(t / per_cand) : -1;
        const int c = __shfl_sync(0xffffffffu, cl, 0);  // lane 0's
        if (cl >= 0) {
            int64_t r = t - cl * per_cand;
            int k = 0;
            while (k < p.nd - 1 && r >= 2 * p.rows[k]) { r -= 2 * p.rows[k]; ++k; }
            const int64_t rows = p.rows[k];
            const int32_t s = p.dims[k];
            const int64_t dir = r / rows;
            r -= dir * rows;
            long long* col = reinterpret_cast<long long*>(
                ws + (int64_t)cl * p.nd * p.unit + k * p.unit
                + dir * s * rows + r);
            const float* ib = inv_bw + p.bw_off[k];
            int64_t cum = 0;
            for (int32_t cb = 0; cb < s; cb += kReduceBatch) {
                long long v[kReduceBatch];
#pragma unroll
                for (int j = 0; j < kReduceBatch; ++j)
                    v[j] = cb + j < s ? __ldcg(col + (int64_t)(cb + j) * rows) : 0;
#pragma unroll
                for (int j = 0; j < kReduceBatch; ++j) {
                    if (cb + j >= s) break;
                    if (v[j] != 0) col[(int64_t)(cb + j) * rows] = 0;
                    cum += v[j];
                    const double x = (double)cum * inv_scale;
                    data = fmax(data, x);
                    lat = fmax(lat, x * (double)__ldg(ib + cb + j));
                }
            }
        }
        // both maxima are >= 0: the bit pattern orders like the value
        if (c < 0) continue;  // the whole warp lies past the end
        if (__all_sync(0xffffffffu, cl == c || cl < 0)) {
            data = warp_max(data);
            lat = warp_max(lat);
            if ((threadIdx.x & 31) == 0) {
                atomicMax(&bmax[c][0], (u64)__double_as_longlong(data));
                atomicMax(&bmax[c][1], (u64)__double_as_longlong(lat));
            }
        } else if (cl >= 0) {  // the warp spans two candidates
            atomicMax(&bmax[cl][0], (u64)__double_as_longlong(data));
            atomicMax(&bmax[cl][1], (u64)__double_as_longlong(lat));
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * g) {
        const int c = threadIdx.x >> 1, m = threadIdx.x & 1;
        if (bmax[c][m] != 0)
            atomicMax(reinterpret_cast<u64*>(scratch + p.cand_off
                                             + (c0 + c) * SLOTS + SLOT_DATA + m),
                      bmax[c][m]);
    }
}

// One step of the pipeline over candidate groups: the first `nacc` blocks
// accumulate group [acc_c0, ..) into workspace `acc_buf`, the rest reduce
// group [red_c0, ..) from the other workspace (a negative c0: no such
// part).  A group's reduce so runs beside the next group's accumulate, in
// one launch: the reduce streams the workspace from memory while the
// accumulate waits on the L2's atomics.  Nothing is accumulated when the
// first pass found a fault, so no index can leave the tables or the
// workspace.
__global__ void __launch_bounds__(kThreads)
mapscore_step(const void* __restrict__ table, const int2* __restrict__ e32,
              const float* __restrict__ w, const float* __restrict__ inv_bw,
              int64_t* __restrict__ scratch, const int64_t acc_c0,
              const int64_t red_c0, const int acc_buf, const int nacc,
              const MapscoreParams p) {
    const int64_t buf = (int64_t)p.group * p.nd * p.unit;
    int64_t* ws = scratch + p.ws_off;
    if ((int)blockIdx.x < nacc) {
        if (scratch[S_STATUS] != 0) return;
        accumulate(table, e32, w, scratch, ws + acc_buf * buf,
                               acc_c0, (int)min((int64_t)p.group,
                                                p.nb - acc_c0),
                               blockIdx.x, nacc, p);
    } else {
        reduce(scratch, ws + (1 - acc_buf) * buf, inv_bw, red_c0,
               (int)min((int64_t)p.group, p.nb - red_c0), blockIdx.x - nacc,
               gridDim.x - nacc, p);
    }
}

// Pass 4: one block.  Writes every entry of res and returns the scratch
// slots and the status word to zero.
//   res (2 + 4 nb) int64: [status, shift, total_hops (nb),
//   then as float64: weighted_hops (nb), data_max (nb), latency_max (nb)]
__global__ void __launch_bounds__(kThreads)
mapscore_finish(int64_t* __restrict__ scratch, int64_t* __restrict__ res,
                const MapscoreParams p) {
    const int shift = (int)scratch[S_SHIFT];
    const double inv_scale = shift == SHIFT_NONE ? 0.0 : ldexp(1.0, -shift);
    double* resf = reinterpret_cast<double*>(res + 2 + p.nb);
    for (int64_t c = threadIdx.x; c < p.nb; c += kThreads) {
        int64_t* slot = scratch + p.cand_off + c * SLOTS;
        res[2 + c] = slot[SLOT_TH];
        resf[c] = (double)slot[SLOT_WH] * inv_scale;
        resf[p.nb + c] = __longlong_as_double(slot[SLOT_DATA]);
        resf[2 * p.nb + c] = __longlong_as_double(slot[SLOT_LAT]);
        for (int j = 0; j < SLOTS; ++j) slot[j] = 0;
    }
    if (threadIdx.x == 0) {
        res[0] = scratch[S_STATUS];
        res[1] = shift;
        scratch[S_STATUS] = 0;
    }
}

static int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess || n <= 0)
            n = 132;
    }
    return n;
}

// Step (acc, red) on `st` (see mapscore_step; a negative group: none):
// `nred` of the `blocks` reduce when both parts run.
static cudaError_t launch_step(unsigned blocks, unsigned nred,
                               cudaStream_t st, const void* table,
                               const void* e32, const void* w,
                               const void* inv_bw, int64_t* scr, int64_t acc,
                               int64_t red, int buf, const MapscoreParams& p) {
    if (acc < 0 && red < 0) return cudaSuccess;
    const int nacc = acc < 0 ? 0 : red < 0 ? (int)blocks
                                           : (int)(blocks - nred);
    mapscore_step<<<blocks, kThreads, 0, st>>>(
        table, static_cast<const int2*>(e32), static_cast<const float*>(w),
        static_cast<const float*>(inv_bw), scr, acc * p.group,
        red * p.group, buf, nacc, p);
    return cudaGetLastError();
}

// Launch the passes on `stream`.  Buffers:
//   coords (nb, ntasks, ncols) int32, 16-byte aligned when ncols == 4;
//   edges (ne, 2) int64; w (ne) float32; inv_bw (sum of network extents)
//   float32, or null when !traffic;
//   e32 (ne) int2, table (nb * ntasks) 32- or 64-bit words and parts
//   (prep_blocks) float64: scratch of this launch;
//   scratch: the caller's persistent int64 buffer, all zero between
//   launches (ws_off + 2 * group * nd * unit entries);
//   res (2 + 4 nb) int64, written whole.
// Steps: step i accumulates group i and reduces group i - 1 (groups of
// `group` candidates, alternating between the two workspaces).
// Returns the first CUDA error code met (0 = every launch was accepted).
extern "C" int mapscore_launch(const void* coords, const void* edges,
                               const void* w, const void* inv_bw, void* e32,
                               void* table, void* parts, void* scratch,
                               void* res, const MapscoreParams* params,
                               void* stream) {
    const MapscoreParams p = *params;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.nb <= 0 || p.ne <= 0) return (int)cudaErrorInvalidValue;
    if (p.group < 1 || p.group > GROUP_MAX || p.ndim < 1 ||
        p.ndim > MAPSCORE_MAX_DIMS)
        return (int)cudaErrorInvalidValue;
    if (p.prep_blocks < 1 || p.prep_blocks > 65535)
        return (int)cudaErrorInvalidValue;
    if (p.ncols == 4 && (reinterpret_cast<uintptr_t>(coords) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    int64_t* scr = static_cast<int64_t*>(scratch);

    mapscore_prep<<<(unsigned)p.prep_blocks, kThreads, 0, st>>>(
        static_cast<const int64_t*>(edges), static_cast<const float*>(w),
        static_cast<const int32_t*>(coords), static_cast<int2*>(e32), table,
        static_cast<double*>(parts), scr, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const unsigned blocks = (unsigned)sm_count() * kBlocksPerSm;
    const unsigned nred = p.traffic ? std::max(1u, blocks * kRedShare16 / 16)
                                    : 0;
    const int64_t ngroups = (p.nb + p.group - 1) / p.group;
    for (int64_t i = 0; i <= ngroups; ++i) {
        const int64_t acc = i < ngroups ? i : -1;
        const int64_t red = p.traffic && i > 0 ? i - 1 : -1;
        const int buf = (int)(i & 1);
        err = launch_step(blocks, nred, st, table, e32, w, inv_bw, scr, acc,
                          red, buf, p);
        if (err != cudaSuccess) return (int)err;
    }

    mapscore_finish<<<1, kThreads, 0, st>>>(scr, static_cast<int64_t*>(res), p);
    return (int)cudaGetLastError();
}

extern "C" const char* mapscore_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int mapscore_params_size() { return (int)sizeof(MapscoreParams); }

extern "C" int mapscore_group_max() { return GROUP_MAX; }
