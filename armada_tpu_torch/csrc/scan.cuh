// Order-preserving stream compaction, K-C's design: per-block flag counts,
// one exclusive scan over the block counts, then a pass in which each block
// ranks its flags with warp ballots.  No host synchronisation and no
// torch.nonzero.  The kernels take the flag as a functor `bool f(long long
// i)` (false past the end), so K-C's packed decode (csrc/compact.cu) and
// K-F's lanes share one implementation.  A lane axis (K-F, the stacked
// decode) rides blockIdx.y: the flag functor reads its lane from blockIdx.y,
// and the kernels offset their count, offset and output arrays by the lane
// strides they are given (0 for a single lane).  `block_scan_excl` is the
// block-wide prefix K-H's splice (csrc/slab.cu) and K-J's lists and type
// ranks (csrc/explain.cu) build on.
#pragma once

#include "common.cuh"

#define SCAN_BLOCK 1024

static inline int scan_blocks(long long n) {
    const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
    return nb > 0 ? (int)nb : 1;
}

// counts[b] = number of flagged i in block b (of lane blockIdx.y).
template <class Flag>
static __global__ void __launch_bounds__(SCAN_BLOCK)
    scan_count_kernel(Flag flag, int* counts, long long lane_stride) {
    counts += blockIdx.y * lane_stride;
    const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
    const int c = __syncthreads_count(flag(i) ? 1 : 0);
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Exclusive scan of counts[0..nb) in place (one thread); returns the total.
static __device__ __forceinline__ int scan_serial(int* counts, int nb) {
    int run = 0;
    for (int b = 0; b < nb; ++b) {
        const int c = counts[b];
        counts[b] = run;
        run += c;
    }
    return run;
}

// The rank of this thread's flag among the flagged threads of its block
// (lower threads first).  Every thread of the block must call it.
static __device__ __forceinline__ int block_rank(bool f, int* warp_tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(m);
    __syncthreads();
    if (threadIdx.x == 0) scan_serial(warp_tot, SCAN_BLOCK / 32);
    __syncthreads();
    return warp_tot[warp] + __popc(m & ((1u << lane) - 1u));
}

// Exclusive prefix of v over the block (SCAN_BLOCK threads, every one of
// them calls it); the block's total to *total.  Ends with a barrier, so
// `warp_tot` can be used again.
static __device__ __forceinline__ int block_scan_excl(int v, int* warp_tot, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int t = warp_tot[lane];
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, t, off);
            if (lane >= off) t += y;
        }
        warp_tot[lane] = t;
    }
    __syncthreads();
    const int out = (warp ? warp_tot[warp - 1] : 0) + x - v;
    *total = warp_tot[SCAN_BLOCK / 32 - 1];
    __syncthreads();
    return out;
}

// dst[rank] = i for the flagged i, ranks below cap (the ascending index
// list of jnp.nonzero(size=cap); the caller fills dst with -1 first).
template <class Flag>
static __global__ void __launch_bounds__(SCAN_BLOCK)
    scan_index_kernel(Flag flag, const int* offsets, int* dst, int cap, long long off_stride,
                      long long dst_stride) {
    __shared__ int warp_tot[SCAN_BLOCK / 32];
    offsets += blockIdx.y * off_stride;
    dst += blockIdx.y * dst_stride;
    const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
    const bool f = flag(i);
    const int rank = offsets[blockIdx.x] + block_rank(f, warp_tot);
    if (f && rank < cap) dst[rank] = (int)i;
}
