// K-E and K-G: stacking pool problems along a lane axis, and slicing one
// lane back out -- one batched copy kernel for both.
//
// Replaces the JAX package's models/__init__.py `_stack_problems._stack`
// (:658, a jitted tree_map of jnp.stack over the ~47 fields of P device
// problems) and models/problem.py `lane_slice._slice` (:1596, a jitted
// tree_map of a[i] over a stacked problem or result).  Plain versions:
// armada_tpu_torch/kernels/lanes.py `stack_plain` (torch.stack per field)
// and `slice_plain` (t[i].clone() per field).
//
// Bound on this card: the bytes moved, read once and written once (P lanes
// x ~47 fields to stack, ~47 or ~15 fields to slice): at 7 lanes of an
// 8,192-node, 131,072-slot pool ~100 MB, ~60 us of HBM time.  The simple
// design: one launch walks a table of (src, dst, bytes) descriptors, one
// row of blocks (blockIdx.y) per descriptor, each row grid-striding over its
// bytes in 16-byte words where the addresses and length allow it, else
// 4-byte words, else bytes.  The descriptors go in the kernel's parameter
// space by value, in chunks of LANES_CHUNK (3 KB of the 4 KB parameter
// limit): never through a host staging copy, which would wait for the
// stream to drain.

#include "common.cuh"

#define LANES_CHUNK 128

struct CopyDesc {
    const void* src;
    void* dst;
    long long bytes;
};

struct CopyChunk {
    CopyDesc d[LANES_CHUNK];
};

__global__ void batched_copy_kernel(CopyChunk c) {
    const CopyDesc d = c.d[blockIdx.y];
    const unsigned long long s = (unsigned long long)d.src, t = (unsigned long long)d.dst;
    const unsigned long long align = s | t | (unsigned long long)d.bytes;
    const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x;
    if ((align & 15) == 0) {
        const int4* src = (const int4*)d.src;
        int4* dst = (int4*)d.dst;
        for (long long i = start; i < d.bytes / 16; i += step) dst[i] = src[i];
    } else if ((align & 3) == 0) {
        const int* src = (const int*)d.src;
        int* dst = (int*)d.dst;
        for (long long i = start; i < d.bytes / 4; i += step) dst[i] = src[i];
    } else {
        const u8* src = (const u8*)d.src;
        u8* dst = (u8*)d.dst;
        for (long long i = start; i < d.bytes; i += step) dst[i] = src[i];
    }
}

// Copy every descriptor of descs[0..n) (a host array, read here on the host
// and passed by value to the launches).  Descriptors must not overlap.
extern "C" int armada_lanes_copy(const CopyDesc* descs, int n, cudaStream_t stream) {
    if (n < 0) return -1;
    for (int lo = 0; lo < n; lo += LANES_CHUNK) {
        const int m = n - lo < LANES_CHUNK ? n - lo : LANES_CHUNK;
        CopyChunk c;
        long long most = 0;
        for (int k = 0; k < m; ++k) {
            c.d[k] = descs[lo + k];
            if (c.d[k].bytes < 0) return -1;
            if (c.d[k].bytes > most) most = c.d[k].bytes;
        }
        long long gx = (most + 65535) / 65536;  // ~64 KB a block row per sweep
        if (gx < 1) gx = 1;
        if (gx > 1024) gx = 1024;
        ARMADA_LAUNCH(batched_copy_kernel, dim3((unsigned)gx, (unsigned)m), 256, stream)(c);
        ARMADA_CHECK();
    }
    return 0;
}

extern "C" int armada_lanes_desc_size(void) { return (int)sizeof(CopyDesc); }
