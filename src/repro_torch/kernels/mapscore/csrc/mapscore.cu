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
// What bounds it on an H100: bytes, not arithmetic.  Per candidate the
// endpoints of every message are gathered (2 * ncols * 4 bytes a message),
// the edge list and the weights are read once (20 bytes a message), routing
// makes at most 4 atomic adds per network dimension a message moves in, and
// the link accumulators are read once.  The index arithmetic is a few dozen
// integer operations a message.
//
// What the design does about it:
//
//   * A GPU has a scatter, so the range-add is four atomic adds, not a
//     one-hot matrix product.  The accumulators of one candidate
//     (sum_k 2 * (s_k + 1) * rows_k entries) run to tens of megabytes on a
//     real machine, far past one block's shared memory, so they live in a
//     device-memory workspace that the caller zeroes; one candidate's share
//     mostly stays in the L2 cache while that candidate's blocks run.
//   * Blocks run in no order, so nothing is carried from one message tile to
//     the next: the message axis is parallel, and the prefix sum and the
//     maxima are a second kernel over the workspace.
//   * Results must not depend on the order the atomics land in (the service
//     caches by content and promises the same winner for the same request).
//     Every weight is therefore converted once to 64-bit fixed point with a
//     power-of-two scale chosen by the caller so that no sum can overflow;
//     integer addition is associative, so +w and -w cancel exactly outside
//     an interval and two launches on equal inputs agree bit for bit.  The
//     maxima are taken with an integer atomicMax on the bit pattern of a
//     non-negative double, which is order-free too.
//   * Layout (s_k + 1, rows_k) with rows contiguous: in the second kernel a
//     thread owns one row and walks the s_k columns, so a warp reads 32
//     neighbouring entries at every step.
//
// One compiled kernel serves every machine and message count: sizes, dims,
// wrap flags and offsets arrive in a small struct at run time.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAPSCORE_MAX_DIMS 8
#define ACC_THREADS 256
#define RED_THREADS 256

struct MapscoreParams {
    int32_t ndim;        // machine dimensions (network + core)
    int32_t nd;          // network dimensions (the first nd of ndim)
    int32_t ncols;       // columns of coord_stack (>= nd; == ndim if traffic)
    int32_t traffic;     // 0: hop sums only; 1: also route
    int64_t nb;          // candidates in this launch
    int64_t ntasks;      // rows of one candidate's coordinate table
    int64_t ne;          // messages
    int64_t ws_per_cand; // workspace entries per candidate
    int64_t nthreads_red;  // sum_k 2 * rows_k: threads of the reduce pass
    double scale;        // fixed point = value * scale (a power of two)
    double inv_scale;
    int32_t dims[MAPSCORE_MAX_DIMS];
    int32_t wrap[MAPSCORE_MAX_DIMS];
    int64_t rows[MAPSCORE_MAX_DIMS];     // product of the other dims
    int64_t acc_off[MAPSCORE_MAX_DIMS];  // start of dim k's + accumulator;
                                         // the - accumulator follows it
    int32_t bw_off[MAPSCORE_MAX_DIMS];   // start of dim k in inv_bw
};

typedef unsigned long long u64;

__device__ __forceinline__ void atomic_add_i64(int64_t* p, int64_t v) {
    // two's complement: an unsigned add of the bit pattern is a signed add
    atomicAdd(reinterpret_cast<u64*>(p), static_cast<u64>(v));
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ double warp_max(double v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Pass 1: grid (message tiles, candidates).  Each thread walks messages with
// a grid stride, gathers both endpoints, adds the hop sums and (traffic) the
// difference-array entries of the message's route.
// acc: (nb, 2) int64 [sum w*hops in fixed point, sum hops].
__global__ void __launch_bounds__(ACC_THREADS)
mapscore_accumulate(const int32_t* __restrict__ coords,
                    const int64_t* __restrict__ edges,
                    const float* __restrict__ w,
                    int64_t* __restrict__ ws,
                    int64_t* __restrict__ acc,
                    const MapscoreParams p) {
    const int64_t cand = blockIdx.y;
    const int32_t* ctab = coords + cand * p.ntasks * p.ncols;
    int64_t* wsc = p.traffic ? ws + cand * p.ws_per_cand : nullptr;

    int64_t wh = 0, th = 0;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < p.ne; e += stride) {
        const int32_t* sp = ctab + edges[2 * e] * p.ncols;
        const int32_t* dp = ctab + edges[2 * e + 1] * p.ncols;
        int32_t src[MAPSCORE_MAX_DIMS], dst[MAPSCORE_MAX_DIMS];
#pragma unroll
        for (int j = 0; j < MAPSCORE_MAX_DIMS; ++j) {
            if (j < p.ncols) { src[j] = sp[j]; dst[j] = dp[j]; }
            else { src[j] = 0; dst[j] = 0; }
        }
        const int64_t wq = llrint((double)w[e] * p.scale);

        int32_t hops = 0;
#pragma unroll
        for (int k = 0; k < MAPSCORE_MAX_DIMS; ++k) {
            if (k < p.nd) {
                int32_t d = abs(src[k] - dst[k]);
                if (p.wrap[k]) d = min(d, p.dims[k] - d);
                hops += d;
            }
        }
        wh += (int64_t)hops * wq;
        th += hops;

        if (!p.traffic || hops == 0 || wq == 0) continue;
#pragma unroll
        for (int k = 0; k < MAPSCORE_MAX_DIMS; ++k) {
            if (k >= p.nd) continue;
            const int32_t s = p.dims[k];
            const int32_t a = src[k], b = dst[k];
            if (a == b) continue;
            int32_t start, len, dir;
            if (p.wrap[k]) {
                int32_t fwd = b - a; if (fwd < 0) fwd += s;
                int32_t bwd = s - fwd;  // a != b, so both lie in [1, s-1]
                if (fwd <= bwd) { dir = 0; start = a; len = fwd; }
                else { dir = 1; len = bwd; start = a - bwd;
                       if (start < 0) start += s; }
            } else if (b > a) { dir = 0; start = a; len = b - a; }
            else { dir = 1; start = b; len = a - b; }
            // row key: dims before k sit at the destination already, dims
            // after k and the core dims still at the source
            int64_t rkey = 0;
#pragma unroll
            for (int j = 0; j < MAPSCORE_MAX_DIMS; ++j) {
                if (j < p.ndim && j != k)
                    rkey = rkey * p.dims[j] + (j < k ? dst[j] : src[j]);
            }
            const int64_t rows = p.rows[k];
            int64_t* base = wsc + p.acc_off[k]
                + (int64_t)dir * (s + 1) * rows + rkey;
            const int32_t end = start + len;
            atomic_add_i64(base + (int64_t)start * rows, wq);
            atomic_add_i64(base + (int64_t)min(end, s) * rows, -wq);
            if (end > s) {  // wrapped tail [0, end - s)
                atomic_add_i64(base, wq);
                atomic_add_i64(base + (int64_t)(end - s) * rows, -wq);
            }
        }
    }

    __shared__ int64_t red[2][ACC_THREADS / 32];
    wh = warp_sum(wh);
    th = warp_sum(th);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) { red[0][wid] = wh; red[1][wid] = th; }
    __syncthreads();
    if (wid == 0) {
        wh = lane < ACC_THREADS / 32 ? red[0][lane] : 0;
        th = lane < ACC_THREADS / 32 ? red[1][lane] : 0;
        wh = warp_sum(wh);
        th = warp_sum(th);
        if (lane == 0) {
            atomic_add_i64(acc + 2 * cand, wh);
            atomic_add_i64(acc + 2 * cand + 1, th);
        }
    }
}

// Pass 2 (traffic): grid (row tiles, candidates).  One thread per
// (dimension, direction, row): running sum over the s_k real columns (the
// dump column s_k stays out), maxima of load and load / bandwidth.
// outf: (nb, 3) double [weighted_hops, data_max, latency_max], zeroed.
__global__ void __launch_bounds__(RED_THREADS)
mapscore_reduce(const int64_t* __restrict__ ws,
                const float* __restrict__ inv_bw,
                double* __restrict__ outf,
                const MapscoreParams p) {
    const int64_t cand = blockIdx.y;
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    double data = 0.0, lat = 0.0;
    if (t < p.nthreads_red) {
        int k = 0;
        while (k < p.nd - 1 && t >= 2 * p.rows[k]) { t -= 2 * p.rows[k]; ++k; }
        const int64_t rows = p.rows[k];
        const int32_t s = p.dims[k];
        const int64_t dir = t / rows, r = t - dir * rows;
        const int64_t* col = ws + cand * p.ws_per_cand + p.acc_off[k]
            + dir * (s + 1) * rows + r;
        const float* ib = inv_bw + p.bw_off[k];
        int64_t cum = 0;
        for (int32_t c = 0; c < s; ++c) {
            cum += col[(int64_t)c * rows];
            const double v = (double)cum * p.inv_scale;
            data = fmax(data, v);
            lat = fmax(lat, v * (double)ib[c]);
        }
    }
    __shared__ double red[2][RED_THREADS / 32];
    data = warp_max(data);
    lat = warp_max(lat);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) { red[0][wid] = data; red[1][wid] = lat; }
    __syncthreads();
    if (wid == 0) {
        data = lane < RED_THREADS / 32 ? red[0][lane] : 0.0;
        lat = lane < RED_THREADS / 32 ? red[1][lane] : 0.0;
        data = warp_max(data);
        lat = warp_max(lat);
        if (lane == 0) {
            // both are >= 0: the bit pattern orders like the value
            atomicMax(reinterpret_cast<long long*>(outf + 3 * cand + 1),
                      __double_as_longlong(data));
            atomicMax(reinterpret_cast<long long*>(outf + 3 * cand + 2),
                      __double_as_longlong(lat));
        }
    }
}

// Pass 3: fixed point -> double for the weighted hop sum.
__global__ void mapscore_finish(const int64_t* __restrict__ acc,
                                double* __restrict__ outf,
                                const MapscoreParams p) {
    const int64_t cand = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (cand < p.nb) outf[3 * cand] = (double)acc[2 * cand] * p.inv_scale;
}

// Launch the passes on `stream`.  All buffers are the caller's:
//   coords (nb, ntasks, ncols) int32; edges (ne, 2) int64; w (ne) float32;
//   inv_bw (sum of network extents) float32 or null when !traffic;
//   ws (nb, ws_per_cand) int64 zeroed, or null when !traffic;
//   acc (nb, 2) int64 zeroed; outf (nb, 3) double zeroed.
// Returns the first CUDA error code met (0 = every launch was accepted).
extern "C" int mapscore_launch(const void* coords, const void* edges,
                               const void* w, const void* inv_bw, void* ws,
                               void* acc, void* outf,
                               const MapscoreParams* params, void* stream) {
    const MapscoreParams p = *params;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.nb <= 0 || p.ne <= 0) return 0;
    if (p.nb > 65535) return (int)cudaErrorInvalidValue;

    int64_t tiles = (p.ne + ACC_THREADS - 1) / ACC_THREADS;
    // a few messages per thread once the card is full: 132 SMs x 8 blocks
    const int64_t cap = 132 * 8 * 4;
    if (tiles * p.nb > cap) {
        tiles = (cap + p.nb - 1) / p.nb;
        if (tiles < 1) tiles = 1;
    }
    dim3 g1((unsigned)tiles, (unsigned)p.nb);
    mapscore_accumulate<<<g1, ACC_THREADS, 0, st>>>(
        static_cast<const int32_t*>(coords),
        static_cast<const int64_t*>(edges), static_cast<const float*>(w),
        static_cast<int64_t*>(ws), static_cast<int64_t*>(acc), p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if (p.traffic && p.nthreads_red > 0) {
        const int64_t rt = (p.nthreads_red + RED_THREADS - 1) / RED_THREADS;
        if (rt > 2147483647LL) return (int)cudaErrorInvalidValue;
        dim3 g2((unsigned)rt, (unsigned)p.nb);
        mapscore_reduce<<<g2, RED_THREADS, 0, st>>>(
            static_cast<const int64_t*>(ws),
            static_cast<const float*>(inv_bw), static_cast<double*>(outf), p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }

    const unsigned fb = (unsigned)((p.nb + 127) / 128);
    mapscore_finish<<<fb, 128, 0, st>>>(static_cast<const int64_t*>(acc),
                                        static_cast<double*>(outf), p);
    return (int)cudaGetLastError();
}

extern "C" const char* mapscore_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int mapscore_params_size() { return (int)sizeof(MapscoreParams); }
