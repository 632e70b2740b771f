// Stable stream compaction of a whole table under one boolean mask.
//
// Replaces: src/repro/kernels/filter_compact.py, filter_compact /
// _compact_kernel (Pallas, TPU): a sequential grid with a running output
// offset in SMEM that packs each 512-row block with a one-hot permutation
// matmul on the MXU, one column per call, values cast to f32.
//
// Bound on the card: bytes.  The work is one read of the mask, one read of
// every column and one write of every survivor; there is no arithmetic to
// speak of.
//
// Design: blocks run in parallel and in no order, so the running offset of
// the TPU grid becomes a count pass.  The caller needs the survivor count
// on the host to size its outputs, so the mask is read twice: once by the
// count (a twentieth of the bytes on a table of 8-byte columns), once by
// the scatter, which is the only launch after the host sync.
//
// (1) fc_tile_counts counts the survivors of each 4096-row tile, 16 mask
//     bytes a thread in one 16-byte load; (2) fc_scan turns the tile counts
//     into exclusive tile offsets in one block (warp-shuffle scans), and its
//     last slot holds the total; (3) fc_scatter takes one tile per thread
//     block.  Each thread loads its 16 mask bytes again; each warp owns 512
//     consecutive rows, and the 16 bits of lanes 2s and 2s+1 (two shuffles)
//     make the survivor word of its s-th run of 32 rows, so a lane finds its
//     row's flag and rank in the tile with one popc, with no barrier per
//     step.  Column by column, each lane loads its 16 rows (coalesced, all
//     16 loads in flight), writes its survivors into shared memory at their
//     rank, and the block then copies the tile's survivors out as one
//     contiguous run with 16-byte stores (the staging is shifted so that
//     shared and global addresses share their alignment; a scalar head and
//     tail take the rest).  The copy is a template on the element size (1,
//     2, 4 or 8 bytes), chosen once per column and tile, not per row.
//     Values move as raw words: no cast, so NaN and int64 need no special
//     case.  Up to FC_MAX_COLS columns share one launch and one read of the
//     mask.
//
// On the main path (12.7 M rows, three columns) the scatter moves its bytes
// at about 2.9 TB/s; the count and scan take about 7 % of the time
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#define FC_THREADS 256
#define FC_WARPS (FC_THREADS / 32)
#define FC_LANE_ROWS 16                       // mask bytes per thread
#define FC_WARP_ROWS (32 * FC_LANE_ROWS)      // 512
#define FC_STEPS (FC_WARP_ROWS / 32)          // runs of 32 rows per warp
#define FC_TILE (FC_WARPS * FC_WARP_ROWS)     // 4096
#define FC_SCAN_THREADS 1024
#define FC_MAX_COLS 16

struct FcColumns {
    const void* src[FC_MAX_COLS];
    void* dst[FC_MAX_COLS];
    int esize[FC_MAX_COLS];
    int ncols;
};

// Bit j set when mask[r0 + j] != 0, for the 16 rows from r0; rows at or
// past n read as 0.  `vec`: the mask is 16-byte aligned (r0 is a multiple
// of 16), so whole groups load as one int4.
__device__ __forceinline__ unsigned fc_bits16(const uint8_t* __restrict__ mask,
                                              int64_t r0, int64_t n, bool vec) {
    unsigned b = 0;
    if (vec && r0 + FC_LANE_ROWS <= n) {
        int4 q = __ldg(reinterpret_cast<const int4*>(mask + r0));
        unsigned w[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                b |= (((w[k] >> (8 * j)) & 0xffu) != 0u ? 1u : 0u) << (4 * k + j);
    } else {
#pragma unroll
        for (int j = 0; j < FC_LANE_ROWS; ++j)
            if (r0 + j < n && mask[r0 + j] != 0) b |= 1u << j;
    }
    return b;
}

__global__ void __launch_bounds__(FC_THREADS)
fc_tile_counts(const uint8_t* __restrict__ mask, int64_t n,
               int64_t* __restrict__ tile_counts) {
    __shared__ int warp_tot[FC_WARPS];
    const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
    const int64_t r0 = (int64_t)blockIdx.x * FC_TILE + (int64_t)threadIdx.x * FC_LANE_ROWS;
    int c = __popc(fc_bits16(mask, r0, n, vec));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t t = 0;
        for (int w = 0; w < FC_WARPS; ++w) t += warp_tot[w];
        tile_counts[blockIdx.x] = t;
    }
}

// One block: offsets[t] = sum(counts[:t]) for t in [0, T], offsets[T] = total.
// Each thread sums a run of counts; warp shuffles scan the runs.
__global__ void __launch_bounds__(FC_SCAN_THREADS)
fc_scan(const int64_t* __restrict__ counts, int64_t T, int64_t* __restrict__ offsets) {
    __shared__ int64_t warp_sums[FC_SCAN_THREADS / 32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t per = (T + FC_SCAN_THREADS - 1) / FC_SCAN_THREADS;
    const int64_t lo = (int64_t)t * per;
    const int64_t hi = lo + per < T ? lo + per : T;
    int64_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += counts[i];
    int64_t x = s;                                    // inclusive scan in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        int64_t y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int64_t v = warp_sums[lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            int64_t y = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += y;
        }
        warp_sums[lane] = v;
    }
    __syncthreads();
    int64_t run = x - s + (warp ? warp_sums[warp - 1] : 0);
    for (int64_t i = lo; i < hi; ++i) {
        offsets[i] = run;
        run += counts[i];
    }
    if (t == FC_SCAN_THREADS - 1) offsets[T] = run;
}

// One column of one tile: stage this tile's survivors in shared memory at
// their rank, then copy them to dst[out0, out0 + tile_cnt) as one run.
// words[s]: the survivor bits of this warp's s-th run of 32 rows.
template <typename E>
__device__ __forceinline__ void fc_column(const E* __restrict__ src, E* __restrict__ dst,
                                          int64_t base, int64_t n,
                                          const unsigned (&words)[FC_STEPS],
                                          int warp_base, int tile_cnt, int64_t out0,
                                          int64_t total, int zero_tail,
                                          unsigned char* stage_bytes) {
    constexpr int V = 16 / sizeof(E);
    E* stage = reinterpret_cast<E*>(stage_bytes);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int shift = (int)((reinterpret_cast<uintptr_t>(dst + out0) & 15) / sizeof(E));
    const int64_t row = base + (int64_t)warp * FC_WARP_ROWS + lane;
    E v[FC_STEPS];
#pragma unroll
    for (int s = 0; s < FC_STEPS; ++s) {
        int64_t r = row + 32 * s;
        v[s] = r < n ? src[r] : E(0);
    }
    const unsigned below = (1u << lane) - 1u;
    int pre = warp_base;
#pragma unroll
    for (int s = 0; s < FC_STEPS; ++s) {
        const unsigned w = words[s];
        if ((w >> lane) & 1u) stage[shift + pre + __popc(w & below)] = v[s];
        pre += __popc(w);
    }
    __syncthreads();
    E* d = dst + out0;
    int head = shift ? V - shift : 0;
    if (head > tile_cnt) head = tile_cnt;
    if ((int)threadIdx.x < head) d[threadIdx.x] = stage[shift + threadIdx.x];
    const int nvec = (tile_cnt - head) / V;
    const int4* sv = reinterpret_cast<const int4*>(stage + shift + head);
    int4* dv = reinterpret_cast<int4*>(d + head);
    for (int i = threadIdx.x; i < nvec; i += FC_THREADS) dv[i] = sv[i];
    const int tail = head + nvec * V;
    if ((int)threadIdx.x < tile_cnt - tail) d[tail + threadIdx.x] = stage[shift + tail + threadIdx.x];
    if (zero_tail) {
        int64_t z0 = base > total ? base : total;
        int64_t z1 = base + FC_TILE < n ? base + FC_TILE : n;
        for (int64_t i = z0 + threadIdx.x; i < z1; i += FC_THREADS) dst[i] = E(0);
    }
    __syncthreads();
}

// zero_tail: dst columns hold n rows and rows [total, n) are set to zero
// (the one-column (packed, count) contract of ops.filter_compact).
__global__ void __launch_bounds__(FC_THREADS)
fc_scatter(const uint8_t* __restrict__ mask, int64_t n,
           const int64_t* __restrict__ offsets, int64_t T, FcColumns cols,
           int zero_tail) {
    __shared__ __align__(16) unsigned char stage[FC_TILE * 8 + 16];
    __shared__ int warp_tot[FC_WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * FC_TILE;
    const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
    const unsigned bits = fc_bits16(mask, base + (int64_t)threadIdx.x * FC_LANE_ROWS, n, vec);
    unsigned words[FC_STEPS];
    int wcnt = 0;
#pragma unroll
    for (int s = 0; s < FC_STEPS; ++s) {
        unsigned lo = __shfl_sync(0xffffffffu, bits, 2 * s);
        unsigned hi = __shfl_sync(0xffffffffu, bits, 2 * s + 1);
        words[s] = lo | (hi << 16);
        wcnt += __popc(words[s]);
    }
    if (lane == 0) warp_tot[warp] = wcnt;
    __syncthreads();
    int warp_base = 0, tile_cnt = 0;
#pragma unroll
    for (int w = 0; w < FC_WARPS; ++w) {
        int c = warp_tot[w];
        warp_base += w < warp ? c : 0;
        tile_cnt += c;
    }
    const int64_t out0 = offsets[blockIdx.x];
    const int64_t total = offsets[T];
    for (int c = 0; c < cols.ncols; ++c) {
        switch (cols.esize[c]) {
            case 1:
                fc_column(static_cast<const uint8_t*>(cols.src[c]),
                          static_cast<uint8_t*>(cols.dst[c]), base, n, words,
                          warp_base, tile_cnt, out0, total, zero_tail, stage);
                break;
            case 2:
                fc_column(static_cast<const uint16_t*>(cols.src[c]),
                          static_cast<uint16_t*>(cols.dst[c]), base, n, words,
                          warp_base, tile_cnt, out0, total, zero_tail, stage);
                break;
            case 4:
                fc_column(static_cast<const uint32_t*>(cols.src[c]),
                          static_cast<uint32_t*>(cols.dst[c]), base, n, words,
                          warp_base, tile_cnt, out0, total, zero_tail, stage);
                break;
            default:
                fc_column(static_cast<const uint64_t*>(cols.src[c]),
                          static_cast<uint64_t*>(cols.dst[c]), base, n, words,
                          warp_base, tile_cnt, out0, total, zero_tail, stage);
                break;
        }
    }
}

extern "C" {

int fc_tile_rows() { return FC_TILE; }
int fc_max_cols() { return FC_MAX_COLS; }

// Survivor offsets: tile_counts (T,) scratch, offsets (T + 1,) int64 with
// T = ceil(n / fc_tile_rows()); offsets[T] is the survivor count.
int fc_count(const void* mask, int64_t n, void* tile_counts, void* offsets,
             void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int64_t T = (n + FC_TILE - 1) / FC_TILE;
    if (T > 0)
        fc_tile_counts<<<(unsigned)T, FC_THREADS, 0, s>>>(
            static_cast<const uint8_t*>(mask), n,
            static_cast<int64_t*>(tile_counts));
    fc_scan<<<1, FC_SCAN_THREADS, 0, s>>>(
        static_cast<const int64_t*>(tile_counts), T,
        static_cast<int64_t*>(offsets));
    return (int)cudaGetLastError();
}

// Copy the survivors of up to fc_max_cols() columns, element sizes 1/2/4/8.
int fc_scatter_cols(const void* mask, int64_t n, const void* offsets,
                    const void* const* srcs, void* const* dsts,
                    const int* esizes, int ncols, int zero_tail, void* stream) {
    if (ncols < 0 || ncols > FC_MAX_COLS) return (int)cudaErrorInvalidValue;
    FcColumns cols;
    cols.ncols = ncols;
    for (int c = 0; c < FC_MAX_COLS; ++c) {
        cols.src[c] = c < ncols ? srcs[c] : nullptr;
        cols.dst[c] = c < ncols ? dsts[c] : nullptr;
        cols.esize[c] = c < ncols ? esizes[c] : 0;
        if (c < ncols && esizes[c] != 1 && esizes[c] != 2 && esizes[c] != 4
            && esizes[c] != 8)
            return (int)cudaErrorInvalidValue;
    }
    int64_t T = (n + FC_TILE - 1) / FC_TILE;
    if (T > 0 && ncols > 0)
        fc_scatter<<<(unsigned)T, FC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(mask), n,
            static_cast<const int64_t*>(offsets), T, cols, zero_tail);
    return (int)cudaGetLastError();
}

}  // extern "C"
