// Shared helpers of the round kernels: constants, block reductions, and the
// f32 arithmetic whose association must match the plain PyTorch versions
// (and through them the JAX reference) bit for bit.
//
// Built with -fmad=false, so the compiler contracts nothing; every fused
// multiply-add below is written out with __fmaf_rn on purpose, and every
// division is IEEE (__fdiv_rn).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ARMADA_LAUNCH
#define ARMADA_LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif

#define ARMADA_INF 3.0e38f
#define ARMADA_BIGI 2147483647
#define ARMADA_BLOCK 1024
#define ARMADA_WARPS (ARMADA_BLOCK / 32)

// Return the first launch error of a C entry point.
#define ARMADA_CHECK()                          \
    do {                                        \
        cudaError_t e_ = cudaGetLastError();    \
        if (e_ != cudaSuccess) return (int)e_;  \
    } while (0)

typedef unsigned char u8;

// (value, index) pair with the argmin order: smaller value first, ties to the
// lower index (torch.argmin and jnp.argmin both return the first minimum).
struct ArgMin {
    float v;
    int i;
    int extra;
};

static __device__ __forceinline__ bool argmin_less(float av, int ai, float bv, int bi) {
    return av < bv || (av == bv && ai < bi);
}

static __device__ __forceinline__ ArgMin argmin_pick(ArgMin a, ArgMin b) {
    return argmin_less(b.v, b.i, a.v, a.i) ? b : a;
}

// Block-wide argmin; every thread gets the result.  `sh` holds ARMADA_WARPS
// entries plus one for the broadcast.
static __device__ ArgMin block_argmin(ArgMin a, ArgMin* sh) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        ArgMin o;
        o.v = __shfl_down_sync(0xffffffffu, a.v, off);
        o.i = __shfl_down_sync(0xffffffffu, a.i, off);
        o.extra = __shfl_down_sync(0xffffffffu, a.extra, off);
        a = argmin_pick(a, o);
    }
    if (lane == 0) sh[warp] = a;
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        ArgMin b = lane < nw ? sh[lane] : ArgMin{ARMADA_INF, ARMADA_BIGI, 0};
        for (int off = 16; off > 0; off >>= 1) {
            ArgMin o;
            o.v = __shfl_down_sync(0xffffffffu, b.v, off);
            o.i = __shfl_down_sync(0xffffffffu, b.i, off);
            o.extra = __shfl_down_sync(0xffffffffu, b.extra, off);
            b = argmin_pick(b, o);
        }
        if (lane == 0) sh[ARMADA_WARPS] = b;
    }
    __syncthreads();
    ArgMin r = sh[ARMADA_WARPS];
    __syncthreads();
    return r;
}

// Block-wide integer sum (exact); every thread gets the result.
static __device__ long long block_sum_ll(long long x, long long* sh) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        long long y = lane < nw ? sh[lane] : 0;
        for (int off = 16; off > 0; off >>= 1) y += __shfl_down_sync(0xffffffffu, y, off);
        if (lane == 0) sh[ARMADA_WARPS] = y;
    }
    __syncthreads();
    long long r = sh[ARMADA_WARPS];
    __syncthreads();
    return r;
}

// Block-wide OR of a flag; every thread gets the result.
static __device__ __forceinline__ bool block_any(bool x) { return __syncthreads_or(x ? 1 : 0) != 0; }

// DRF cost of one allocation row x[R] (ops/fairness.py unweighted_drf_cost):
// max(0, max_r(total_r > 0 ? x_r / total_r : 0) * mult_r).  max is exact in any
// order; each term is one IEEE division and one multiply.
static __device__ __forceinline__ float drf_unweighted(const float* x, const float* total,
                                                const float* mult, int R) {
    float m = -ARMADA_INF;
    bool any = false;
    for (int r = 0; r < R; ++r) {
        float f = total[r] > 0.0f ? __fdiv_rn(x[r], total[r]) : 0.0f;
        f = __fmul_rn(f, mult[r]);
        if (!any || f > m) m = f;
        any = true;
    }
    if (!any) m = -ARMADA_INF;
    return m > 0.0f ? m : 0.0f;
}

static __device__ __forceinline__ float drf_weighted(const float* x, const float* total,
                                              const float* mult, float w, int R) {
    return w > 0.0f ? __fdiv_rn(drf_unweighted(x, total, mult, R), w) : 0.0f;
}

// Packing score of one node row (ops/packing.py node_packing_score): the
// left-to-right chain of fused multiply-adds XLA:CPU emits for the reference's
// sum_r alloc_r * inv_scale_r.
static __device__ __forceinline__ float packing_score(const float* a, const float* inv_scale, int R) {
    float s = __fmul_rn(a[0], inv_scale[0]);
    for (int r = 1; r < R; ++r) s = __fmaf_rn(a[r], inv_scale[r], s);
    return s;
}

// Copies of `req` (node axes only) that fit in allocatable row a[R]
// (ops/packing.py member_capacity): min_r floor(a_r / req_r) over req_r > 0,
// clipped to [0, 2^30].
static __device__ __forceinline__ int member_capacity(const float* a, const float* req, int R) {
    float cap = ARMADA_INF;
    for (int r = 0; r < R; ++r) {
        float per = req[r] > 0.0f ? floorf(__fdiv_rn(a[r], req[r])) : ARMADA_INF;
        cap = fminf(cap, per);
    }
    cap = fminf(fmaxf(cap, 0.0f), 1073741824.0f);
    return (int)cap;
}

// Encode a non-negative float so that unsigned integer order is float order
// (for atomicMin on costs, which are >= 0 or +INF).
static __device__ __forceinline__ unsigned int ordered_bits(float x) {
    if (x == 0.0f) x = 0.0f;  // -0.0 and +0.0 compare equal
    return __float_as_uint(x);
}
