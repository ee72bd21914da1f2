// K-E and K-G: stacking pool problems along a lane axis, and slicing one
// lane back out -- one batched copy kernel for both.  K-H (csrc/slab.cu)
// makes its functional copies with it too, through `armada_lanes_copy` and
// lanes.cuh.
//
// Replaces the JAX package's models/__init__.py `_stack_problems._stack`
// (:658, a jitted tree_map of jnp.stack over the ~47 fields of P device
// problems) and models/problem.py `lane_slice._slice` (:1596, a jitted
// tree_map of a[i] over a stacked problem or result).  Plain versions:
// armada_tpu_torch/kernels/lanes.py `stack_plain` (torch.stack per field)
// and `slice_plain` (t[i].clone() per field).
//
// Bound on this card: the bytes moved, each read once and written once over
// HBM (P lanes x ~47 fields to stack, ~47 or ~15 fields to slice): on the
// pools path (7 lanes of N = 6,144) K-E moves ~141 MB, 42 us at 3.35 TB/s,
// and K-G ~20 MB, 6 us.  Nothing is computed, so the design is about bytes
// in flight and an even spread of them:
//  - The host (kernels/lanes.py) lays every output field out in ONE arena
//    and passes a table of (src, dst, bytes, tile0, wlog) descriptors: the
//    descriptors' bytes are cut into LANES_TILE-byte tiles, `tile0` is the
//    prefix sum of the tiles before a descriptor, and `wlog` is log2 of the
//    widest word (up to 16 bytes) at which src and dst agree in alignment.
//  - The grid is flat and sized to the card (LANES_BLOCKS_PER_SM blocks an
//    SM).  Block b takes an equal share of the tiles, finds the descriptor
//    of its first tile by a binary search over `tile0`, and walks on from
//    there: no block waits on the largest field's size, as a row of blocks
//    a descriptor did.
//  - Each thread keeps LANES_UNROLL independent word loads in flight before
//    its stores (a 16 KB tile of 16-byte words is one such round of a
//    256-thread block).  Bytes before the first and after the last aligned
//    word of a tile are copied one at a time: narrow heads and tails, per
//    descriptor, never the whole launch.
//  - The table rides in the kernel's parameter space (__grid_constant__, so
//    the dynamic indexing reads the constant bank and copies nothing into
//    local memory): up to LANES_CAP descriptors a launch, 32 KB, which CUDA
//    12.1 and later allow, so K-E's 7 x 47 descriptors are one launch.
//    Larger tables are cut into chunks, one launch each.  Never a host
//    staging copy, which would wait on the stream.  A table of up to
//    LANES_CAP_SMALL rows (K-G's 47 or 15) launches a 4 KB block instead:
//    the host's enqueue grows with the block: on an H100, K-G's table took
//    ~14 us more to enqueue and ~2.5 us more to run from the 32 KB one
//    (chip_smoke.py times it against a build with -DLANES_CAP_SMALL=1000,
//    which has one form).
// The Hopper bulk copy (cp.async.bulk through shared memory) was not
// needed: this vector copy reaches ~79 % of K-E's bound on the pools path,
// about what torch's own copy_ of the same bytes in one buffer reaches
// (PERF.md §6).  chip_smoke.py's pools path times each kernel's call in
// turns with its library call (torch.stack, t[i].clone() per field) on the
// cycle's own lanes, and the launch alone, cold and hot, against the bound.

#include "lanes.cuh"

#define LANES_BLOCKS_PER_SM 4
#ifndef LANES_CAP
#define LANES_CAP 1000
#endif
#ifndef LANES_CAP_SMALL
#define LANES_CAP_SMALL 120
#endif
#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "lanes.cu passes up to 32 KB of kernel parameters: CUDA 12.1 or later"
#endif

template <int CAP>
struct CopyChunk {
    int n;
    int tiles;
    CopyDesc d[CAP];
};
static_assert(sizeof(CopyChunk<LANES_CAP>) <= 32764, "kernel parameters above 32,764 bytes");
static_assert(LANES_CAP_SMALL <= LANES_CAP, "the small form is the smaller one");

// nw words of W from s to t: LANES_UNROLL loads in flight a thread, then the
// stores.
template <typename W>
static __device__ __forceinline__ void copy_words(const W* __restrict__ s, W* __restrict__ t,
                                                  long long nw) {
    for (long long base = threadIdx.x; base < nw; base += LANES_THREADS * LANES_UNROLL) {
        W v[LANES_UNROLL];
#pragma unroll
        for (int k = 0; k < LANES_UNROLL; ++k) {
            const long long i = base + k * LANES_THREADS;
            if (i < nw) v[k] = s[i];
        }
#pragma unroll
        for (int k = 0; k < LANES_UNROLL; ++k) {
            const long long i = base + k * LANES_THREADS;
            if (i < nw) t[i] = v[k];
        }
    }
}

// Bytes [a, e) of descriptor d: a narrow head up to the first address at
// which both sides are word-aligned, the words, a narrow tail.
static __device__ __forceinline__ void copy_range(const u8* s, u8* t, int wlog, long long a,
                                                  long long e) {
    const unsigned long long mask = (1ull << wlog) - 1;
    long long ab = a + (long long)((0ull - ((unsigned long long)t + a)) & mask);
    long long ae = e - (long long)(((unsigned long long)t + e) & mask);
    if (ae <= ab) ab = ae = e;  // shorter than a word: all narrow
    for (long long i = a + threadIdx.x; i < ab; i += LANES_THREADS) t[i] = s[i];
    const long long nw = (ae - ab) >> wlog;
    switch (wlog) {
        case 4: copy_words((const int4*)(s + ab), (int4*)(t + ab), nw); break;
        case 3: copy_words((const unsigned long long*)(s + ab), (unsigned long long*)(t + ab), nw); break;
        case 2: copy_words((const unsigned*)(s + ab), (unsigned*)(t + ab), nw); break;
        case 1: copy_words((const unsigned short*)(s + ab), (unsigned short*)(t + ab), nw); break;
        default: copy_words(s + ab, t + ab, nw); break;
    }
    for (long long i = ae + threadIdx.x; i < e; i += LANES_THREADS) t[i] = s[i];
}

template <int CAP>
__global__ void __launch_bounds__(LANES_THREADS, LANES_BLOCKS_PER_SM)
batched_copy_kernel(__grid_constant__ const CopyChunk<CAP> c) {
    const int first = (int)((long long)blockIdx.x * c.tiles / gridDim.x);
    const int last = (int)((long long)(blockIdx.x + 1) * c.tiles / gridDim.x);
    if (first >= last) return;
    int lo = 0, hi = c.n - 1;  // the last descriptor with tile0 <= first
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (c.d[mid].tile0 <= first) lo = mid;
        else hi = mid - 1;
    }
    int k = lo;
    int next = k + 1 < c.n ? c.d[k + 1].tile0 : c.tiles;
    for (int tile = first; tile < last; ++tile) {
        while (tile >= next) {
            ++k;
            next = k + 1 < c.n ? c.d[k + 1].tile0 : c.tiles;
        }
        const long long a = (long long)(tile - c.d[k].tile0) * LANES_TILE;
        const long long bytes = c.d[k].bytes;
        copy_range(c.d[k].src, c.d[k].dst, c.d[k].wlog, a, a + LANES_TILE < bytes ? a + LANES_TILE : bytes);
    }
}

static int sm_count(void) {
    static int cached[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (cached[dev] == 0) {
        int v = 0;
        if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v <= 0)
            v = 132;
        cached[dev] = v;
    }
    return cached[dev];
}

// One launch over descs[0..m), m <= CAP: the table checked (positive bytes,
// tile0 the running prefix, src and dst aligned as wlog says) and rebased to
// the chunk's first tile.
template <int CAP>
static int launch_chunk(const CopyDesc* descs, int m, cudaStream_t stream) {
    CopyChunk<CAP> c;
    long long tiles = 0;
    for (int k = 0; k < m; ++k) {
        CopyDesc e = descs[k];
        if (e.bytes <= 0 || e.wlog < 0 || e.wlog > 4) return -1;
        if ((((unsigned long long)e.src ^ (unsigned long long)e.dst) & ((1ull << e.wlog) - 1)) != 0)
            return -1;
        if ((long long)e.tile0 - descs[0].tile0 != tiles) return -1;
        e.tile0 = (int)tiles;
        tiles += (e.bytes + LANES_TILE - 1) / LANES_TILE;
        if (tiles > 2147483647LL) return -1;
        c.d[k] = e;
    }
    c.n = m;
    c.tiles = (int)tiles;
    long long grid = (long long)sm_count() * LANES_BLOCKS_PER_SM;
    if (grid > tiles) grid = tiles;
    ARMADA_LAUNCH(batched_copy_kernel<CAP>, (unsigned)grid, LANES_THREADS, stream)(c);
    ARMADA_CHECK();
    return 0;
}

// Copy every descriptor of descs[0..n) (a host array, read here on the host
// and passed by value to the launches).  Descriptors must not overlap.
// Returns 0, a cudaError_t, or -1 for a table that breaks its layout.
extern "C" int armada_lanes_copy(const CopyDesc* descs, int n, cudaStream_t stream) {
    if (n < 0) return -1;
    for (int lo = 0; lo < n; lo += LANES_CAP) {
        const int m = n - lo < LANES_CAP ? n - lo : LANES_CAP;
        const int rc = m <= LANES_CAP_SMALL ? launch_chunk<LANES_CAP_SMALL>(descs + lo, m, stream)
                                            : launch_chunk<LANES_CAP>(descs + lo, m, stream);
        if (rc != 0) return rc;
    }
    return 0;
}

extern "C" int armada_lanes_desc_size(void) { return (int)sizeof(CopyDesc); }
extern "C" int armada_lanes_tile_bytes(void) { return LANES_TILE; }
