// K-C: the packed decode buffer.
//
// Replaces the JAX package's models/fair_scheduler.py `compact_result` (a
// jitted concatenation of a 9-word header, the placement slots and three
// `jnp.nonzero(size=cap, fill_value=-1)` index lists).  Plain version:
// armada_tpu_torch/models/fair_scheduler.py `compact_result_plain`.
//
// Bound on this card: it reads g_state (4 bytes a gang) and two run flags
// (1 byte each) and writes the buffer (4 * (9 + S + 2SW + fcap + 2 ecap)
// bytes): ~4 MB in at a million gangs, a few microseconds of HBM time.  The
// simple design: an order-preserving stream compaction in three passes --
// per-block flag counts, one exclusive scan over the block counts, then a
// scatter in which each block ranks its flags with warp ballots -- with no
// host synchronisation and no torch.nonzero.

#include "common.cuh"

#define CB 1024  // elements per block

struct CompactArgs {
    const int* g_state;         // [G]
    const u8* run_evicted;      // [RJ]
    const u8* run_rescheduled;  // [RJ]
    const int* slot_gang;       // [S]
    const int* slot_nodes;      // [S * W]
    const int* slot_counts;     // [S * W]
    const int* n_slots;         // scalar
    const int* iterations;      // scalar
    const int* termination;     // scalar
    const int* sched_count;     // scalar
    const float* spot_price;    // scalar
    const int* kernel_iters;    // scalar
    int* counts;                // [nbG + 2 * nbR] scratch
    int* out;                   // [9 + S + 2SW + fcap + 2 ecap]
    int G, RJ, real_g, real_r, S, W, fcap, ecap;
};

// mode 0: failed gangs; 1: preempted runs; 2: rescheduled runs.
__device__ __forceinline__ bool flag_of(const CompactArgs& a, int mode, long long i) {
    if (mode == 0) return i < a.G && i < a.real_g && a.g_state[i] == 2;
    if (i >= a.RJ || i >= a.real_r || !a.run_evicted[i]) return false;
    return mode == 1 ? !a.run_rescheduled[i] : a.run_rescheduled[i] != 0;
}

__global__ void __launch_bounds__(CB) count_kernel(CompactArgs a, int mode, int* counts) {
    const long long i = (long long)blockIdx.x * CB + threadIdx.x;
    const int n = __syncthreads_count(flag_of(a, mode, i) ? 1 : 0);
    if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

// Exclusive scan of the three count arrays in place; totals into the header.
__global__ void scan_kernel(CompactArgs a, int nbG, int nbR) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    int* segs[3] = {a.counts, a.counts + nbG, a.counts + nbG + nbR};
    const int lens[3] = {nbG, nbR, nbR};
    for (int m = 0; m < 3; ++m) {
        int run = 0;
        for (int b = 0; b < lens[m]; ++b) {
            const int c = segs[m][b];
            segs[m][b] = run;
            run += c;
        }
        a.out[5 + m] = run;
    }
    a.out[0] = *a.n_slots;
    a.out[1] = *a.iterations;
    a.out[2] = *a.termination;
    a.out[3] = *a.sched_count;
    a.out[4] = __float_as_int(*a.spot_price);
    a.out[8] = *a.kernel_iters;
}

__global__ void __launch_bounds__(CB) scatter_kernel(CompactArgs a, int mode, const int* offsets,
                                                     int* dst, int cap) {
    __shared__ int warp_tot[CB / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long i = (long long)blockIdx.x * CB + threadIdx.x;
    const bool f = flag_of(a, mode, i);
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(m);
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int w = 0; w < CB / 32; ++w) {
            const int c = warp_tot[w];
            warp_tot[w] = run;
            run += c;
        }
    }
    __syncthreads();
    if (f) {
        const int rank = offsets[blockIdx.x] + warp_tot[warp] + __popc(m & ((1u << lane) - 1u));
        if (rank < cap) dst[rank] = (int)i;
    }
}

__global__ void slots_kernel(CompactArgs a) {
    const long long SW = (long long)a.S * a.W;
    const long long n = a.S + 2 * SW;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        int v;
        if (i < a.S) v = a.slot_gang[i];
        else if (i < a.S + SW) v = a.slot_nodes[i - a.S];
        else v = a.slot_counts[i - a.S - SW];
        a.out[9 + i] = v;
    }
}

extern "C" int armada_compact(const CompactArgs* args, cudaStream_t stream) {
    CompactArgs a = *args;
    const int nbG = (a.G + CB - 1) / CB > 0 ? (a.G + CB - 1) / CB : 1;
    const int nbR = (a.RJ + CB - 1) / CB > 0 ? (a.RJ + CB - 1) / CB : 1;
    const long long base = 9 + (long long)a.S + 2LL * a.S * a.W;
    // the index lists start as -1 (all bits set)
    cudaMemsetAsync(a.out + base, 0xff, sizeof(int) * ((size_t)a.fcap + 2 * (size_t)a.ecap), stream);
    ARMADA_CHECK();
    ARMADA_LAUNCH(count_kernel, nbG, CB, stream)(a, 0, a.counts);
    ARMADA_CHECK();
    ARMADA_LAUNCH(count_kernel, nbR, CB, stream)(a, 1, a.counts + nbG);
    ARMADA_CHECK();
    ARMADA_LAUNCH(count_kernel, nbR, CB, stream)(a, 2, a.counts + nbG + nbR);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_kernel, 1, 32, stream)(a, nbG, nbR);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scatter_kernel, nbG, CB, stream)(a, 0, a.counts, a.out + base, a.fcap);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scatter_kernel, nbR, CB, stream)(a, 1, a.counts + nbG, a.out + base + a.fcap,
                                                   a.ecap);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scatter_kernel, nbR, CB, stream)(a, 2, a.counts + nbG + nbR,
                                                   a.out + base + a.fcap + a.ecap, a.ecap);
    ARMADA_CHECK();
    const long long ns = a.S + 2LL * a.S * a.W;
    int grid = (int)((ns + 255) / 256);
    if (grid < 1) grid = 1;
    if (grid > 4096) grid = 4096;
    ARMADA_LAUNCH(slots_kernel, grid, 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_compact_args_size(void) { return (int)sizeof(CompactArgs); }
