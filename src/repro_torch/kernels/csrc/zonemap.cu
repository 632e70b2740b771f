// Per-block (min, max) of one column: zone maps for partition pruning and
// dtype narrowing.
//
// Replaces: src/repro/kernels/zonemap.py, zonemap / _zonemap_kernel
// (Pallas, TPU): one grid step per 4096-row block, values cast to f32, the
// tail masked with +-inf.
//
// Bound on the card: bytes.  One read of the column and two values written
// per block; two comparisons per element.
//
// Design: one thread block per zone block (block_rows is the caller's
// partition size, so one launch covers every partition of a column).  Each
// thread strides its block's rows (coalesced), keeps a running min and max
// in the column's own type (integer identities from the type's limits, so
// bounds above 2^24 are exact, unlike the f32 cast of the TPU kernel), and
// records whether it saw a NaN; a shared-memory tree then reduces the block.
// A block with a NaN reports NaN for both bounds, as numpy's min and max do.
// The tail needs no identity padding: a block only reads rows below n.
#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>

#define ZM_THREADS 512

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

template <typename T> __device__ __forceinline__ bool zm_isnan(T) { return false; }
template <> __device__ __forceinline__ bool zm_isnan<float>(float v) { return v != v; }
template <> __device__ __forceinline__ bool zm_isnan<double>(double v) { return v != v; }

template <typename T> __device__ __forceinline__ T zm_nan() { return T(0); }
template <> __device__ __forceinline__ float zm_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double zm_nan<double>() {
    return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__global__ void zm_kernel(const T* __restrict__ x, int64_t n, int64_t block_rows,
                          T* __restrict__ mins, T* __restrict__ maxs) {
    __shared__ T smin[ZM_THREADS];
    __shared__ T smax[ZM_THREADS];
    const int tid = threadIdx.x;
    const int64_t lo = (int64_t)blockIdx.x * block_rows;
    const int64_t hi = lo + block_rows < n ? lo + block_rows : n;
    T mn = ZmLim<T>::hi(), mx = ZmLim<T>::lo();
    int nan = 0;
    for (int64_t i = lo + tid; i < hi; i += ZM_THREADS) {
        T v = x[i];
        if (zm_isnan(v)) {
            nan = 1;
        } else {
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
        }
    }
    smin[tid] = mn;
    smax[tid] = mx;
    int any_nan = __syncthreads_or(nan);
    for (int h = ZM_THREADS / 2; h > 0; h >>= 1) {
        if (tid < h) {
            T a = smin[tid + h], b = smax[tid + h];
            if (a < smin[tid]) smin[tid] = a;
            if (b > smax[tid]) smax[tid] = b;
        }
        __syncthreads();
    }
    if (tid == 0) {
        mins[blockIdx.x] = any_nan ? zm_nan<T>() : smin[0];
        maxs[blockIdx.x] = any_nan ? zm_nan<T>() : smax[0];
    }
}

template <typename T>
static int zm_launch(const void* x, int64_t n, int64_t block_rows, void* mins,
                     void* maxs, cudaStream_t s) {
    int64_t nb = (n + block_rows - 1) / block_rows;
    if (nb > 0)
        zm_kernel<T><<<(unsigned)nb, ZM_THREADS, 0, s>>>(
            static_cast<const T*>(x), n, block_rows, static_cast<T*>(mins),
            static_cast<T*>(maxs));
    return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 float32, 1 float64, 2 int8, 3 uint8, 4 int16, 5 int32, 6 int64.
// mins/maxs hold ceil(n / block_rows) values of the column's type.
int zm_minmax(int dtype, const void* x, int64_t n, int64_t block_rows,
              void* mins, void* maxs, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (block_rows <= 0) return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return zm_launch<float>(x, n, block_rows, mins, maxs, s);
        case 1: return zm_launch<double>(x, n, block_rows, mins, maxs, s);
        case 2: return zm_launch<int8_t>(x, n, block_rows, mins, maxs, s);
        case 3: return zm_launch<uint8_t>(x, n, block_rows, mins, maxs, s);
        case 4: return zm_launch<int16_t>(x, n, block_rows, mins, maxs, s);
        case 5: return zm_launch<int32_t>(x, n, block_rows, mins, maxs, s);
        case 6: return zm_launch<int64_t>(x, n, block_rows, mins, maxs, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
