// Deterministic segment sum (and row count) by int64 group codes.
//
// Replaces: src/repro/kernels/groupby_sum.py, groupby_sum / _groupby_kernel
// (Pallas, TPU): per 256-row block a one-hot (Gp, B) x (B, Vp) matmul on the
// MXU accumulated into an output block resident across a sequential grid,
// everything in f32.
//
// Bound on the card: bytes.  Each row reads one code and V values and adds
// them into one of G*V sums: about one add per byte read, far below the
// card's ratio of operations to bandwidth.
//
// Design: the result must be bit-identical run to run, so no float atomics;
// every sum is taken in a fixed order (fixed row sets, fixed trees, fixed
// warp shuffles).  Small G*V (the group-bys of the main path): gb_partial
// gives every thread private accumulators in shared memory ([slot][thread],
// conflict-free), strides a fixed row set (row += gridDim * blockDim,
// coalesced), reduces each slot across the block in a fixed tree and writes
// one partial per block; gb_merge sums each slot's partials with one warp.
// Counts are int64 accumulators in the same launch, so mean costs one
// launch and a count stays exact past 2^24 rows.  Large G*V: the caller
// orders rows by code (torch.sort); gb_bounds finds each group's run,
// gb_pieces cuts every run into pieces of GB_PIECE rows and scans their
// counts, gb_piece_sum sums each piece with one warp, and gb_piece_merge
// sums each group's pieces with one warp.  The work per warp is bounded
// whatever the skew of the groups.  Integer sums accumulate in int64 and
// float sums in the column's own type.  Codes outside [0, G) add nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#define GB_THREADS 128
#define GB_MAX_SLOTS 32      // G*V + G(count) slots of 8 bytes: 32 KB of shared memory
#define GB_MAX_BLOCKS 1024
#define GB_WARP_THREADS 256  // blocks of the one-warp-per-item kernels
#define GB_PIECE 2048        // sorted rows per piece
#define GB_SCAN_THREADS 1024

template <typename T>
__device__ __forceinline__ T gb_warp_sum(T acc) {
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
    return acc;
}

template <typename T>
__global__ void gb_partial(const int64_t* __restrict__ codes,
                           const T* __restrict__ vals, int64_t n, int V,
                           int G, int sv, int with_count,
                           T* __restrict__ part, int64_t* __restrict__ cpart) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int B = GB_THREADS;
    const int tid = threadIdx.x;
    int64_t* cacc = reinterpret_cast<int64_t*>(smem);           // [G][B]
    T* acc = reinterpret_cast<T*>(smem + (with_count ? (size_t)G * B * sizeof(int64_t) : 0));
    for (int s = 0; s < sv; ++s) acc[s * B + tid] = T(0);
    if (with_count)
        for (int g = 0; g < G; ++g) cacc[g * B + tid] = 0;
    const int64_t stride = (int64_t)gridDim.x * B;
    for (int64_t row = (int64_t)blockIdx.x * B + tid; row < n; row += stride) {
        int64_t c = codes[row];
        if (c < 0 || c >= G) continue;
        for (int v = 0; v < V; ++v)
            acc[((int)c * V + v) * B + tid] += vals[row * V + v];
        if (with_count) cacc[(int)c * B + tid] += 1;
    }
    __syncthreads();
    for (int h = B / 2; h > 0; h >>= 1) {
        if (tid < h) {
            for (int s = 0; s < sv; ++s) acc[s * B + tid] += acc[s * B + tid + h];
            if (with_count)
                for (int g = 0; g < G; ++g) cacc[g * B + tid] += cacc[g * B + tid + h];
        }
        __syncthreads();
    }
    if (tid < sv) part[(int64_t)blockIdx.x * sv + tid] = acc[tid * B];
    if (with_count && tid < G) cpart[(int64_t)blockIdx.x * G + tid] = cacc[tid * B];
}

// One warp per slot: out[s] = sum over blocks b of part[b][s].
template <typename T>
__global__ void gb_merge(const T* __restrict__ part, int nb, int slots,
                         T* __restrict__ out) {
    int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (s >= slots) return;             // whole warps leave together
    T acc = T(0);
    for (int b = lane; b < nb; b += 32) acc += part[(int64_t)b * slots + s];
    acc = gb_warp_sum(acc);
    if (lane == 0) out[s] = acc;
}

__global__ void gb_bounds_init(int64_t* start, int64_t* end, int64_t G) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < G) { start[g] = 0; end[g] = 0; }
}

// sc: codes in ascending order; writes each in-range group's [start, end).
__global__ void gb_bounds(const int64_t* __restrict__ sc, int64_t n, int64_t G,
                          int64_t* __restrict__ start, int64_t* __restrict__ end) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int64_t c = sc[i];
    if (c < 0 || c >= G) return;
    if (i == 0 || sc[i - 1] != c) start[c] = i;
    if (i == n - 1 || sc[i + 1] != c) end[c] = i + 1;
}

// One block: poff[g] = number of pieces of groups before g, poff[G] = total.
__global__ void gb_pieces(const int64_t* __restrict__ start,
                          const int64_t* __restrict__ end, int64_t G,
                          int64_t* __restrict__ poff) {
    __shared__ int64_t sums[GB_SCAN_THREADS];
    int t = threadIdx.x;
    int64_t per = (G + GB_SCAN_THREADS - 1) / GB_SCAN_THREADS;
    int64_t lo = (int64_t)t * per;
    int64_t hi = lo + per < G ? lo + per : G;
    int64_t s = 0;
    for (int64_t g = lo; g < hi; ++g) s += (end[g] - start[g] + GB_PIECE - 1) / GB_PIECE;
    sums[t] = s;
    __syncthreads();
    for (int off = 1; off < GB_SCAN_THREADS; off <<= 1) {
        int64_t v = (t >= off) ? sums[t - off] : 0;
        __syncthreads();
        sums[t] += v;
        __syncthreads();
    }
    int64_t run = (t == 0) ? 0 : sums[t - 1];
    for (int64_t g = lo; g < hi; ++g) {
        poff[g] = run;
        run += (end[g] - start[g] + GB_PIECE - 1) / GB_PIECE;
    }
    if (t == GB_SCAN_THREADS - 1) poff[G] = sums[t];
}

// One warp per piece w < poff[G]: part[w][v] = sum of the piece's rows.
template <typename T>
__global__ void gb_piece_sum(const int64_t* __restrict__ perm,
                             const T* __restrict__ vals, int V, int64_t G,
                             const int64_t* __restrict__ start,
                             const int64_t* __restrict__ end,
                             const int64_t* __restrict__ poff,
                             T* __restrict__ part) {
    int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (w >= poff[G]) return;           // whole warps leave together
    // the group owning piece w: the last g with poff[g] <= w
    int64_t lo = 0, hi = G;             // poff[lo] <= w < poff[hi]
    while (hi - lo > 1) {
        int64_t mid = (lo + hi) >> 1;
        if (poff[mid] <= w) lo = mid; else hi = mid;
    }
    int64_t r0 = start[lo] + (w - poff[lo]) * GB_PIECE;
    int64_t r1 = r0 + GB_PIECE < end[lo] ? r0 + GB_PIECE : end[lo];
    for (int v = 0; v < V; ++v) {
        T acc = T(0);
        for (int64_t r = r0 + lane; r < r1; r += 32) acc += vals[perm[r] * V + v];
        acc = gb_warp_sum(acc);
        if (lane == 0) part[w * V + v] = acc;
    }
}

// One warp per group: out[g][v] = sum of its pieces in piece order.
template <typename T>
__global__ void gb_piece_merge(const T* __restrict__ part, int V, int64_t G,
                               const int64_t* __restrict__ start,
                               const int64_t* __restrict__ end,
                               const int64_t* __restrict__ poff,
                               T* __restrict__ out, int64_t* __restrict__ counts) {
    int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (g >= G) return;                 // whole warps leave together
    for (int v = 0; v < V; ++v) {
        T acc = T(0);
        for (int64_t p = poff[g] + lane; p < poff[g + 1]; p += 32) acc += part[p * V + v];
        acc = gb_warp_sum(acc);
        if (lane == 0) out[g * V + v] = acc;
    }
    if (counts && lane == 0) counts[g] = end[g] - start[g];
}

static unsigned gb_warp_grid(int64_t items) {
    int64_t warps_per_block = GB_WARP_THREADS / 32;
    return (unsigned)((items + warps_per_block - 1) / warps_per_block);
}

template <typename T>
static int gb_small(const void* codes, const void* vals, int64_t n, int V,
                    int G, void* part, void* cpart, int nb, void* out,
                    void* counts, cudaStream_t s) {
    int sv = G * V;
    int with_count = counts != nullptr;
    size_t smem = (size_t)GB_THREADS * ((size_t)sv * sizeof(T) +
                                        (with_count ? (size_t)G * sizeof(int64_t) : 0));
    gb_partial<T><<<nb, GB_THREADS, smem, s>>>(
        static_cast<const int64_t*>(codes), static_cast<const T*>(vals), n, V,
        G, sv, with_count, static_cast<T*>(part), static_cast<int64_t*>(cpart));
    if (sv)
        gb_merge<T><<<gb_warp_grid(sv), GB_WARP_THREADS, 0, s>>>(
            static_cast<const T*>(part), nb, sv, static_cast<T*>(out));
    if (with_count)
        gb_merge<int64_t><<<gb_warp_grid(G), GB_WARP_THREADS, 0, s>>>(
            static_cast<const int64_t*>(cpart), nb, G, static_cast<int64_t*>(counts));
    return (int)cudaGetLastError();
}

template <typename T>
static int gb_sorted(const void* sorted_codes, const void* perm,
                     const void* vals, int64_t n, int V, int64_t G,
                     void* start, void* end, void* poff, void* part,
                     int64_t max_pieces, void* out, void* counts,
                     cudaStream_t s) {
    int64_t* st = static_cast<int64_t*>(start);
    int64_t* en = static_cast<int64_t*>(end);
    int64_t* po = static_cast<int64_t*>(poff);
    gb_bounds_init<<<(unsigned)((G + 255) / 256), 256, 0, s>>>(st, en, G);
    if (n > 0)
        gb_bounds<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
            static_cast<const int64_t*>(sorted_codes), n, G, st, en);
    gb_pieces<<<1, GB_SCAN_THREADS, 0, s>>>(st, en, G, po);
    if (V > 0 && max_pieces > 0)
        gb_piece_sum<T><<<gb_warp_grid(max_pieces), GB_WARP_THREADS, 0, s>>>(
            static_cast<const int64_t*>(perm), static_cast<const T*>(vals), V, G,
            st, en, po, static_cast<T*>(part));
    gb_piece_merge<T><<<gb_warp_grid(G), GB_WARP_THREADS, 0, s>>>(
        static_cast<const T*>(part), V, G, st, en, po, static_cast<T*>(out),
        static_cast<int64_t*>(counts));
    return (int)cudaGetLastError();
}

extern "C" {

int gb_max_slots() { return GB_MAX_SLOTS; }
int gb_max_blocks() { return GB_MAX_BLOCKS; }
int gb_threads() { return GB_THREADS; }
int gb_piece_rows() { return GB_PIECE; }

// dtype: 0 = float32, 1 = float64, 2 = int64.  vals (n, V) row-major, with
// V = 0 for a count only (vals and out unused); counts (G,) int64 or null.
// (An empty tensor's data pointer is null, so V, not the pointer, says
// whether there are values.)
// part (nb * G * V) of the value type and cpart (nb * G) int64 are scratch.
int gb_sum_small(int dtype, const void* codes, const void* vals, int64_t n,
                 int V, int G, void* part, void* cpart, int nb, void* out,
                 void* counts, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int slots = G * V + (counts ? G : 0);
    if (G <= 0 || slots > GB_MAX_SLOTS || nb <= 0 || nb > GB_MAX_BLOCKS)
        return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return gb_small<float>(codes, vals, n, V, G, part, cpart, nb, out, counts, s);
        case 1: return gb_small<double>(codes, vals, n, V, G, part, cpart, nb, out, counts, s);
        case 2: return gb_small<long long>(codes, vals, n, V, G, part, cpart, nb, out, counts, s);
    }
    return (int)cudaErrorInvalidValue;
}

// Rows ordered by code: sorted_codes (n,) ascending and perm (n,) the row of
// each sorted position; V = 0 for a count only.  Scratch: start/end (G,)
// and poff (G + 1,) int64, part (max_pieces * V) of the value type with
// max_pieces >= ceil(n / gb_piece_rows()) + G.
int gb_sum_sorted(int dtype, const void* sorted_codes, const void* perm,
                  const void* vals, int64_t n, int V, int64_t G, void* start,
                  void* end, void* poff, void* part, int64_t max_pieces,
                  void* out, void* counts, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (G <= 0 || max_pieces < (n + GB_PIECE - 1) / GB_PIECE + G)
        return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return gb_sorted<float>(sorted_codes, perm, vals, n, V, G, start, end, poff, part, max_pieces, out, counts, s);
        case 1: return gb_sorted<double>(sorted_codes, perm, vals, n, V, G, start, end, poff, part, max_pieces, out, counts, s);
        case 2: return gb_sorted<long long>(sorted_codes, perm, vals, n, V, G, start, end, poff, part, max_pieces, out, counts, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
