// The block-wide exclusive prefix that K-H's splice (csrc/slab.cu) and K-J's
// lists and type ranks (csrc/explain.cu) build on.
#pragma once

#include "common.cuh"

#define SCAN_BLOCK 1024

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
