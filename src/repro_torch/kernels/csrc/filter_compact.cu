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
// the TPU grid becomes a second pass.  (1) fc_tile_counts counts the
// survivors of each 2048-row tile (__syncthreads_count over eight 256-row
// steps); (2) fc_scan turns the tile counts into exclusive tile offsets in
// one block, and its last slot holds the total; (3) fc_scatter walks each
// tile again, ranks every survivor inside its tile with a warp ballot plus
// popc and a per-warp prefix in shared memory, and copies the row of every
// column to its slot.  Positions are computed once per tile for all columns
// (up to FC_MAX_COLS per launch), and values move as raw 1-, 2-, 4- or
// 8-byte words: no cast, no multiply, so NaN and int64 need no special case.
// A decoupled look-back would save the mask's second read; the scan pass is
// kept because it is simple and the mask is the smallest array read.
#include <cuda_runtime.h>
#include <stdint.h>

#define FC_THREADS 256
#define FC_ITEMS 8
#define FC_TILE (FC_THREADS * FC_ITEMS)
#define FC_WARPS (FC_THREADS / 32)
#define FC_SCAN_THREADS 1024
#define FC_MAX_COLS 16

struct FcColumns {
    const void* src[FC_MAX_COLS];
    void* dst[FC_MAX_COLS];
    int esize[FC_MAX_COLS];
    int ncols;
};

__global__ void fc_tile_counts(const uint8_t* __restrict__ mask, int64_t n,
                               int64_t* __restrict__ tile_counts) {
    int64_t base = (int64_t)blockIdx.x * FC_TILE;
    int total = 0;
    for (int k = 0; k < FC_ITEMS; ++k) {
        int64_t i = base + (int64_t)k * FC_THREADS + threadIdx.x;
        int m = (i < n) ? (mask[i] != 0) : 0;
        total += __syncthreads_count(m);
    }
    if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: offsets[t] = sum(counts[:t]) for t in [0, T], offsets[T] = total.
__global__ void fc_scan(const int64_t* __restrict__ counts, int64_t T,
                        int64_t* __restrict__ offsets) {
    __shared__ int64_t sums[FC_SCAN_THREADS];
    int t = threadIdx.x;
    int64_t per = (T + FC_SCAN_THREADS - 1) / FC_SCAN_THREADS;
    int64_t lo = (int64_t)t * per;
    int64_t hi = lo + per < T ? lo + per : T;
    int64_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += counts[i];
    sums[t] = s;
    __syncthreads();
    for (int off = 1; off < FC_SCAN_THREADS; off <<= 1) {
        int64_t v = (t >= off) ? sums[t - off] : 0;
        __syncthreads();
        sums[t] += v;
        __syncthreads();
    }
    int64_t run = (t == 0) ? 0 : sums[t - 1];
    for (int64_t i = lo; i < hi; ++i) {
        offsets[i] = run;
        run += counts[i];
    }
    if (t == FC_SCAN_THREADS - 1) offsets[T] = sums[t];
}

__device__ __forceinline__ void fc_copy(const void* src, void* dst, int es,
                                        int64_t i, int64_t o) {
    switch (es) {
        case 1: static_cast<uint8_t*>(dst)[o] = static_cast<const uint8_t*>(src)[i]; break;
        case 2: static_cast<uint16_t*>(dst)[o] = static_cast<const uint16_t*>(src)[i]; break;
        case 4: static_cast<uint32_t*>(dst)[o] = static_cast<const uint32_t*>(src)[i]; break;
        default: static_cast<uint64_t*>(dst)[o] = static_cast<const uint64_t*>(src)[i]; break;
    }
}

__device__ __forceinline__ void fc_zero(void* dst, int es, int64_t o) {
    switch (es) {
        case 1: static_cast<uint8_t*>(dst)[o] = 0; break;
        case 2: static_cast<uint16_t*>(dst)[o] = 0; break;
        case 4: static_cast<uint32_t*>(dst)[o] = 0; break;
        default: static_cast<uint64_t*>(dst)[o] = 0; break;
    }
}

// zero_tail: dst columns hold n rows and rows [total, n) are set to zero
// (the one-column (packed, count) contract of ops.filter_compact).
__global__ void fc_scatter(const uint8_t* __restrict__ mask, int64_t n,
                           const int64_t* __restrict__ offsets, int64_t T,
                           FcColumns cols, int zero_tail) {
    __shared__ int warp_tot[FC_WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * FC_TILE;
    const int64_t total = offsets[T];
    int64_t out = offsets[blockIdx.x];
    for (int k = 0; k < FC_ITEMS; ++k) {
        int64_t i = base + (int64_t)k * FC_THREADS + threadIdx.x;
        bool m = (i < n) && (mask[i] != 0);
        unsigned bal = __ballot_sync(0xffffffffu, m);
        int lane_pre = __popc(bal & ((1u << lane) - 1u));
        if (lane == 0) warp_tot[warp] = __popc(bal);
        __syncthreads();
        int warp_pre = 0, step = 0;
        for (int w = 0; w < FC_WARPS; ++w) {
            int c = warp_tot[w];
            if (w < warp) warp_pre += c;
            step += c;
        }
        if (m) {
            int64_t o = out + warp_pre + lane_pre;
            for (int c = 0; c < cols.ncols; ++c)
                fc_copy(cols.src[c], cols.dst[c], cols.esize[c], i, o);
        }
        if (zero_tail && i < n && i >= total) {
            for (int c = 0; c < cols.ncols; ++c)
                fc_zero(cols.dst[c], cols.esize[c], i);
        }
        out += step;
        __syncthreads();
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
    }
    int64_t T = (n + FC_TILE - 1) / FC_TILE;
    if (T > 0 && ncols > 0)
        fc_scatter<<<(unsigned)T, FC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(mask), n,
            static_cast<const int64_t*>(offsets), T, cols, zero_tail);
    return (int)cudaGetLastError();
}

}  // extern "C"
