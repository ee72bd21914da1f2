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
// simple design: the order-preserving stream compaction of csrc/scan.cuh
// (per-block flag counts, one exclusive scan over the block counts, then a
// pass in which each block ranks its flags with warp ballots), with no host
// synchronisation and no torch.nonzero.

#include "scan.cuh"

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

// The flag of element i -- mode 0: a failed gang; 1: a preempted run;
// 2: a rescheduled run.
struct CompactFlag {
    const int* g_state;
    const u8* run_evicted;
    const u8* run_rescheduled;
    int G, RJ, real_g, real_r, mode;
    __device__ __forceinline__ bool operator()(long long i) const {
        if (mode == 0) return i < G && i < real_g && g_state[i] == 2;
        if (i >= RJ || i >= real_r || !run_evicted[i]) return false;
        return mode == 1 ? !run_rescheduled[i] : run_rescheduled[i] != 0;
    }
};

static CompactFlag flag_of(const CompactArgs& a, int mode) {
    return CompactFlag{a.g_state, a.run_evicted, a.run_rescheduled, a.G, a.RJ, a.real_g,
                       a.real_r, mode};
}

// Exclusive scan of the three count arrays in place; totals into the header.
__global__ void scan_kernel(CompactArgs a, int nbG, int nbR) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    a.out[5] = scan_serial(a.counts, nbG);
    a.out[6] = scan_serial(a.counts + nbG, nbR);
    a.out[7] = scan_serial(a.counts + nbG + nbR, nbR);
    a.out[0] = *a.n_slots;
    a.out[1] = *a.iterations;
    a.out[2] = *a.termination;
    a.out[3] = *a.sched_count;
    a.out[4] = __float_as_int(*a.spot_price);
    a.out[8] = *a.kernel_iters;
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
    const int nbG = scan_blocks(a.G);
    const int nbR = scan_blocks(a.RJ);
    const long long base = 9 + (long long)a.S + 2LL * a.S * a.W;
    // the index lists start as -1 (all bits set)
    cudaMemsetAsync(a.out + base, 0xff, sizeof(int) * ((size_t)a.fcap + 2 * (size_t)a.ecap), stream);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, nbG, SCAN_BLOCK, stream)(flag_of(a, 0), a.counts);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, nbR, SCAN_BLOCK, stream)(flag_of(a, 1), a.counts + nbG);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, nbR, SCAN_BLOCK, stream)(flag_of(a, 2),
                                                              a.counts + nbG + nbR);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_kernel, 1, 32, stream)(a, nbG, nbR);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, nbG, SCAN_BLOCK, stream)(flag_of(a, 0), a.counts,
                                                              a.out + base, a.fcap);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, nbR, SCAN_BLOCK, stream)(
        flag_of(a, 1), a.counts + nbG, a.out + base + a.fcap, a.ecap);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, nbR, SCAN_BLOCK, stream)(
        flag_of(a, 2), a.counts + nbG + nbR, a.out + base + a.fcap + a.ecap, a.ecap);
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
