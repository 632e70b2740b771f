// Per-block (min, max) of one column: zone maps for partition pruning and
// dtype narrowing.
//
// Replaces: src/repro/kernels/zonemap.py, zonemap / _zonemap_kernel
// (Pallas, TPU): one grid step per 4096-row block, values cast to f32, the
// tail masked with +-inf.
//
// Bound on the card: bytes.  One read of the column and two values written
// per zone block; two comparisons per element.
//
// Design: a zone block is the caller's partition (block_rows), so one call
// covers every partition of a column.  Zone blocks can be few and large:
// one block covering a whole column for a single partition put the whole
// column on one SM (2.22 ms for 12.7 M f64 rows on an H100).  So a zone
// block is cut into `split` pieces of `piece_rows` rows, chosen by the
// caller (kernels/zonemap.py, plan_split) so that there are about two
// pieces per SM, all resident at once; with more zone blocks than that
// (194 on the main path) each stays whole.  zm_pieces reduces one piece
// per thread block: each thread keeps ZM_UNROLL 16-byte loads in flight, a
// scalar path takes the rows before the first 16-byte boundary (a view
// such as x[1:]) and the ragged tail, and a warp-shuffle tree reduces the
// block.  With split > 1 the pieces' bounds go to a scratch array and
// zm_merge, one thread block per zone block, reduces them in a fixed
// order.  No atomics.  On the main path it reads at about 3.0 TB/s, 89 %
// of the data-sheet rate (PERF.md).
//
// Bounds stay in the column's own type (integer identities from the type's
// limits, so bounds above 2^24 are exact, unlike the f32 cast of the TPU
// kernel).  A piece holding a NaN reports NaN for both bounds, and so does
// its zone block, as numpy's min and max do.  No row at or past n is read.
#include <cuda_runtime.h>
#include <stdint.h>

#define ZM_THREADS 256
#define ZM_MIN_BLOCKS 4       // resident blocks per SM; plan_split plans fewer
#define ZM_UNROLL 4
#define ZM_MERGE_THREADS 256

template <typename T> struct ZmLim;
template <> struct ZmLim<float> {
    __device__ static float lo() { return -__int_as_float(0x7f800000); }
    __device__ static float hi() { return __int_as_float(0x7f800000); }
};
template <> struct ZmLim<double> {
    __device__ static double lo() { return -__longlong_as_double(0x7ff0000000000000LL); }
    __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000LL); }
};
template <> struct ZmLim<int8_t> {
    __device__ static int8_t lo() { return INT8_MIN; }
    __device__ static int8_t hi() { return INT8_MAX; }
};
template <> struct ZmLim<uint8_t> {
    __device__ static uint8_t lo() { return 0; }
    __device__ static uint8_t hi() { return UINT8_MAX; }
};
template <> struct ZmLim<int16_t> {
    __device__ static int16_t lo() { return INT16_MIN; }
    __device__ static int16_t hi() { return INT16_MAX; }
};
template <> struct ZmLim<int32_t> {
    __device__ static int32_t lo() { return INT32_MIN; }
    __device__ static int32_t hi() { return INT32_MAX; }
};
template <> struct ZmLim<int64_t> {
    __device__ static int64_t lo() { return INT64_MIN; }
    __device__ static int64_t hi() { return INT64_MAX; }
};

// The type a warp shuffle carries for T (shuffles take no 1- or 2-byte types).
template <typename T> struct ZmWide { typedef T type; };
template <> struct ZmWide<int8_t> { typedef int type; };
template <> struct ZmWide<uint8_t> { typedef unsigned type; };
template <> struct ZmWide<int16_t> { typedef int type; };

template <typename T> __device__ __forceinline__ bool zm_isnan(T) { return false; }
template <> __device__ __forceinline__ bool zm_isnan<float>(float v) { return v != v; }
template <> __device__ __forceinline__ bool zm_isnan<double>(double v) { return v != v; }

template <typename T> __device__ __forceinline__ T zm_nan() { return T(0); }
template <> __device__ __forceinline__ float zm_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double zm_nan<double>() {
    return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T> struct ZmAcc {
    T mn, mx;
    int nan;
    __device__ __forceinline__ ZmAcc() : mn(ZmLim<T>::hi()), mx(ZmLim<T>::lo()), nan(0) {}
    __device__ __forceinline__ void add(T v) {
        if (zm_isnan(v)) {
            nan = 1;
        } else {
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
        }
    }
};

template <typename T> union ZmVec {
    int4 raw;
    T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void zm_add_vec(ZmAcc<T>& a, int4 raw) {
    ZmVec<T> u;
    u.raw = raw;
#pragma unroll
    for (int j = 0; j < (int)(16 / sizeof(T)); ++j) a.add(u.e[j]);
}

// Fold rows [lo, hi) of x into this thread's accumulator (the whole thread
// block takes part).
template <typename T>
__device__ __forceinline__ void zm_range(const T* __restrict__ x, int64_t lo,
                                         int64_t hi, ZmAcc<T>& a) {
    constexpr int V = 16 / sizeof(T);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x + lo);
    int64_t head = (int64_t)(((16 - (addr & 15)) & 15) / sizeof(T));
    if (head > hi - lo) head = hi - lo;
    if (threadIdx.x < head) a.add(x[lo + threadIdx.x]);
    const int64_t vlo = lo + head;
    const int64_t nvec = (hi - vlo) / V;
    const int4* __restrict__ xv = reinterpret_cast<const int4*>(x + vlo);
    int64_t i = threadIdx.x;
    for (; i + (ZM_UNROLL - 1) * ZM_THREADS < nvec; i += ZM_UNROLL * ZM_THREADS) {
        int4 q[ZM_UNROLL];
#pragma unroll
        for (int u = 0; u < ZM_UNROLL; ++u) q[u] = __ldg(xv + i + u * ZM_THREADS);
#pragma unroll
        for (int u = 0; u < ZM_UNROLL; ++u) zm_add_vec(a, q[u]);
    }
    for (; i < nvec; i += ZM_THREADS) zm_add_vec(a, __ldg(xv + i));
    const int64_t tlo = vlo + nvec * V;
    if (threadIdx.x < hi - tlo) a.add(x[tlo + threadIdx.x]);
}

// Reduce the thread block's accumulators; the result is valid in thread 0.
// blockDim.x is a multiple of 32.
template <typename T>
__device__ __forceinline__ void zm_block_reduce(ZmAcc<T>& a) {
    typedef typename ZmWide<T>::type W;
    __shared__ W smn[32], smx[32];
    W mn = a.mn, mx = a.mx;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        W o = __shfl_down_sync(0xffffffffu, mn, off);
        W p = __shfl_down_sync(0xffffffffu, mx, off);
        mn = o < mn ? o : mn;
        mx = p > mx ? p : mx;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        smn[warp] = mn;
        smx[warp] = mx;
    }
    a.nan = __syncthreads_or(a.nan);
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        mn = lane < nw ? smn[lane] : (W)ZmLim<T>::hi();
        mx = lane < nw ? smx[lane] : (W)ZmLim<T>::lo();
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            W o = __shfl_down_sync(0xffffffffu, mn, off);
            W p = __shfl_down_sync(0xffffffffu, mx, off);
            mn = o < mn ? o : mn;
            mx = p > mx ? p : mx;
        }
        a.mn = (T)mn;
        a.mx = (T)mx;
    }
}

// One thread block per piece: blockIdx.x = zone * split + piece.  Writes
// the piece's bounds (NaN if it holds one) to mins/maxs[blockIdx.x]; with
// split == 1 those are the zone blocks' bounds.
template <typename T>
__global__ void __launch_bounds__(ZM_THREADS, ZM_MIN_BLOCKS)
zm_pieces(const T* __restrict__ x, int64_t n, int64_t block_rows, int split,
          int64_t piece_rows, T* __restrict__ mins, T* __restrict__ maxs) {
    const int64_t zone = blockIdx.x / split;
    const int64_t piece = blockIdx.x % split;
    const int64_t zlo = zone * block_rows;
    const int64_t zhi = zlo + block_rows < n ? zlo + block_rows : n;
    const int64_t lo = zlo + piece * piece_rows;
    const int64_t hi = lo + piece_rows < zhi ? lo + piece_rows : zhi;
    ZmAcc<T> a;
    if (lo < hi) zm_range(x, lo, hi, a);
    zm_block_reduce(a);
    if (threadIdx.x == 0) {
        mins[blockIdx.x] = a.nan ? zm_nan<T>() : a.mn;
        maxs[blockIdx.x] = a.nan ? zm_nan<T>() : a.mx;
    }
}

// One thread block per zone block: the bounds of its `split` pieces.
template <typename T>
__global__ void zm_merge(const T* __restrict__ pmins, const T* __restrict__ pmaxs,
                         int split, T* __restrict__ mins, T* __restrict__ maxs) {
    const int64_t base = (int64_t)blockIdx.x * split;
    ZmAcc<T> a;
    for (int s = threadIdx.x; s < split; s += blockDim.x) {
        T lo = pmins[base + s], hi = pmaxs[base + s];
        if (zm_isnan(lo)) {
            a.nan = 1;
        } else {
            a.mn = lo < a.mn ? lo : a.mn;
            a.mx = hi > a.mx ? hi : a.mx;
        }
    }
    zm_block_reduce(a);
    if (threadIdx.x == 0) {
        mins[blockIdx.x] = a.nan ? zm_nan<T>() : a.mn;
        maxs[blockIdx.x] = a.nan ? zm_nan<T>() : a.mx;
    }
}

template <typename T>
static int zm_launch(const void* x, int64_t n, int64_t block_rows, int split,
                     int64_t piece_rows, void* partials, void* mins, void* maxs,
                     cudaStream_t s) {
    const int64_t nb = (n + block_rows - 1) / block_rows;
    if (nb <= 0) return (int)cudaGetLastError();
    const int64_t grid = nb * split;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    T* pmins = split > 1 ? static_cast<T*>(partials) : static_cast<T*>(mins);
    T* pmaxs = split > 1 ? static_cast<T*>(partials) + grid : static_cast<T*>(maxs);
    zm_pieces<T><<<(unsigned)grid, ZM_THREADS, 0, s>>>(
        static_cast<const T*>(x), n, block_rows, split, piece_rows, pmins, pmaxs);
    if (split > 1) {
        int threads = split >= ZM_MERGE_THREADS ? ZM_MERGE_THREADS : ((split + 31) / 32) * 32;
        zm_merge<T><<<(unsigned)nb, threads, 0, s>>>(pmins, pmaxs, split,
                                                    static_cast<T*>(mins),
                                                    static_cast<T*>(maxs));
    }
    return (int)cudaGetLastError();
}

extern "C" {

int zm_threads() { return ZM_THREADS; }
int zm_min_blocks() { return ZM_MIN_BLOCKS; }

// dtype: 0 float32, 1 float64, 2 int8, 3 uint8, 4 int16, 5 int32, 6 int64.
// mins/maxs hold ceil(n / block_rows) values of the column's type.  Every
// zone block is cut into `split` pieces of `piece_rows` rows
// (split * piece_rows >= min(block_rows, n)); with split > 1, `partials` is scratch
// for 2 * ceil(n / block_rows) * split values of the column's type.
int zm_minmax(int dtype, const void* x, int64_t n, int64_t block_rows, int split,
              int64_t piece_rows, void* partials, void* mins, void* maxs,
              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t zone_rows = block_rows < n ? block_rows : n;
    if (block_rows <= 0 || split <= 0 || piece_rows <= 0
        || (int64_t)split * piece_rows < zone_rows || (split > 1 && !partials))
        return (int)cudaErrorInvalidValue;
    switch (dtype) {
#define ZM_CASE(code, T) \
        case code: return zm_launch<T>(x, n, block_rows, split, piece_rows, partials, mins, maxs, s);
        ZM_CASE(0, float)
        ZM_CASE(1, double)
        ZM_CASE(2, int8_t)
        ZM_CASE(3, uint8_t)
        ZM_CASE(4, int16_t)
        ZM_CASE(5, int32_t)
        ZM_CASE(6, int64_t)
#undef ZM_CASE
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
