// The batched copy of K-E and K-G (csrc/lanes.cu): a table of (src, dst,
// bytes) descriptors copied by one launch.  K-H's functional copies
// (csrc/slab.cu) go through it too.
#pragma once

#include "common.cuh"

#define LANES_THREADS 256
#define LANES_UNROLL 4
#define LANES_TILE (LANES_THREADS * LANES_UNROLL * 16)  // 16 KB

struct CopyDesc {
    const u8* src;
    u8* dst;
    long long bytes;  // > 0: zero-byte fields get no descriptor
    int tile0;        // tiles of the descriptors before this one
    int wlog;         // src and dst agree modulo 1 << wlog, wlog in 0..4
};

// Copy every descriptor of descs[0..n) (a host array).  Returns 0, a
// cudaError_t, or -1 for a table that breaks its layout.
extern "C" int armada_lanes_copy(const CopyDesc* descs, int n, cudaStream_t stream);

// Fill tile0 and wlog of descs[0..n), whose src, dst and bytes (> 0) are set.
static inline void lanes_table(CopyDesc* d, int n) {
    long long tiles = 0;
    for (int k = 0; k < n; ++k) {
        const unsigned long long src = (unsigned long long)d[k].src;
        const unsigned x = (unsigned)((src ^ (unsigned long long)d[k].dst) & 15);
        d[k].wlog = x == 0 ? 4 : __builtin_ctz(x);
        d[k].tile0 = (int)tiles;
        tiles += (d[k].bytes + LANES_TILE - 1) / LANES_TILE;
    }
}
