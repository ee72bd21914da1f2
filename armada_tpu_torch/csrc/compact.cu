// K-C: the packed decode buffer, and K-F, its stacked form.
//
// Replaces the JAX package's models/fair_scheduler.py `compact_result` (a
// jitted concatenation of a 9-word header, the placement slots and three
// `jnp.nonzero(size=cap, fill_value=-1)` index lists) and, with a lane
// axis, models/problem.py `_compact_stacked` (:1489; jax.vmap of it over a
// stacked round's P pool lanes into one [P, L] buffer).  Plain versions:
// armada_tpu_torch/models/fair_scheduler.py `compact_result_plain` and
// armada_tpu_torch/kernels/compact.py `compact_result_stacked_plain`.
//
// Bound on this card: it reads g_state (4 bytes a gang) and two run flags
// (1 byte each) and writes the buffer (4 * (9 + S + 2SW + fcap + 2 ecap)
// bytes) per lane: ~4 MB in at a million gangs, a few microseconds of HBM
// time.  The simple design: the order-preserving stream compaction of
// csrc/scan.cuh (per-block flag counts, one exclusive scan over the block
// counts, then a pass in which each block ranks its flags with warp
// ballots), with no host synchronisation and no torch.nonzero.  Lanes ride
// blockIdx.y: lane l's inputs start l x (per-lane length) past lane 0's,
// its output row at l x L of the contiguous [P, L] buffer, and its real
// gang and run counts come from row l of an i32 [P, 2] table on the card.

#include "scan.cuh"

struct CompactArgs {
    const int* g_state;         // [P, G]
    const u8* run_evicted;      // [P, RJ]
    const u8* run_rescheduled;  // [P, RJ]
    const int* slot_gang;       // [P, S]
    const int* slot_nodes;      // [P, S * W]
    const int* slot_counts;     // [P, S * W]
    const int* n_slots;         // [P]
    const int* iterations;      // [P]
    const int* termination;     // [P]
    const int* sched_count;     // [P]
    const float* spot_price;    // [P]
    const int* kernel_iters;    // [P]
    const int* real;            // [P, 2] (real gangs, real runs), or null: real_g / real_r
    int* counts;                // [P, nbG + 2 * nbR] scratch
    int* out;                   // [P, L], L = 9 + S + 2SW + fcap + 2 ecap
    int G, RJ, real_g, real_r, S, W, fcap, ecap, lanes;
};

static __host__ __device__ __forceinline__ long long compact_len(const CompactArgs& a) {
    return 9 + (long long)a.S + 2LL * a.S * a.W + a.fcap + 2LL * a.ecap;
}

// The flag of element i of lane blockIdx.y -- mode 0: a failed gang;
// 1: a preempted run; 2: a rescheduled run.
struct CompactFlag {
    const int* g_state;
    const u8* run_evicted;
    const u8* run_rescheduled;
    const int* real;
    int G, RJ, real_g, real_r, mode;
    __device__ __forceinline__ bool operator()(long long i) const {
        const long long l = blockIdx.y;
        if (mode == 0) {
            const int rg = real ? real[2 * l] : real_g;
            return i < G && i < rg && g_state[l * G + i] == 2;
        }
        const int rr = real ? real[2 * l + 1] : real_r;
        if (i >= RJ || i >= rr || !run_evicted[l * RJ + i]) return false;
        return mode == 1 ? !run_rescheduled[l * RJ + i] : run_rescheduled[l * RJ + i] != 0;
    }
};

static CompactFlag flag_of(const CompactArgs& a, int mode) {
    return CompactFlag{a.g_state, a.run_evicted, a.run_rescheduled, a.real, a.G, a.RJ,
                       a.real_g, a.real_r, mode};
}

// Exclusive scan of lane blockIdx.y's three count arrays in place; totals
// into its header.
__global__ void scan_kernel(CompactArgs a, int nbG, int nbR) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    const long long l = blockIdx.y;
    int* counts = a.counts + l * (nbG + 2LL * nbR);
    int* out = a.out + l * compact_len(a);
    out[5] = scan_serial(counts, nbG);
    out[6] = scan_serial(counts + nbG, nbR);
    out[7] = scan_serial(counts + nbG + nbR, nbR);
    out[0] = a.n_slots[l];
    out[1] = a.iterations[l];
    out[2] = a.termination[l];
    out[3] = a.sched_count[l];
    out[4] = __float_as_int(a.spot_price[l]);
    out[8] = a.kernel_iters[l];
}

__global__ void slots_kernel(CompactArgs a) {
    const long long l = blockIdx.y;
    const long long SW = (long long)a.S * a.W;
    const long long n = a.S + 2 * SW;
    int* out = a.out + l * compact_len(a);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        int v;
        if (i < a.S) v = a.slot_gang[l * a.S + i];
        else if (i < a.S + SW) v = a.slot_nodes[l * SW + i - a.S];
        else v = a.slot_counts[l * SW + i - a.S - SW];
        out[9 + i] = v;
    }
}

// The index lists of every lane start as -1 (all bits set).
__global__ void lists_fill_kernel(CompactArgs a, long long base) {
    const long long l = blockIdx.y;
    int* out = a.out + l * compact_len(a) + base;
    const long long n = (long long)a.fcap + 2LL * a.ecap;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = -1;
}

static int grid_of(long long n) {
    long long g = (n + 255) / 256;
    if (g < 1) g = 1;
    if (g > 4096) g = 4096;
    return (int)g;
}

extern "C" int armada_compact(const CompactArgs* args, cudaStream_t stream) {
    CompactArgs a = *args;
    if (a.lanes < 1 || a.lanes > 65535) return -1;
    const int P = a.lanes;
    const int nbG = scan_blocks(a.G);
    const int nbR = scan_blocks(a.RJ);
    const long long L = compact_len(a);
    const long long nb = nbG + 2LL * nbR;
    const long long base = 9 + (long long)a.S + 2LL * a.S * a.W;
    if (a.fcap + 2LL * a.ecap > 0) {
        ARMADA_LAUNCH(lists_fill_kernel, dim3(grid_of(a.fcap + 2LL * a.ecap), P), 256, stream)(
            a, base);
        ARMADA_CHECK();
    }
    ARMADA_LAUNCH(scan_count_kernel, dim3(nbG, P), SCAN_BLOCK, stream)(flag_of(a, 0), a.counts,
                                                                       nb);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, dim3(nbR, P), SCAN_BLOCK, stream)(flag_of(a, 1),
                                                                       a.counts + nbG, nb);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, dim3(nbR, P), SCAN_BLOCK, stream)(
        flag_of(a, 2), a.counts + nbG + nbR, nb);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_kernel, dim3(1, P), 32, stream)(a, nbG, nbR);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, dim3(nbG, P), SCAN_BLOCK, stream)(
        flag_of(a, 0), a.counts, a.out + base, a.fcap, nb, L);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, dim3(nbR, P), SCAN_BLOCK, stream)(
        flag_of(a, 1), a.counts + nbG, a.out + base + a.fcap, a.ecap, nb, L);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, dim3(nbR, P), SCAN_BLOCK, stream)(
        flag_of(a, 2), a.counts + nbG + nbR, a.out + base + a.fcap + a.ecap, a.ecap, nb, L);
    ARMADA_CHECK();
    ARMADA_LAUNCH(slots_kernel, dim3(grid_of(a.S + 2LL * a.S * a.W), P), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_compact_args_size(void) { return (int)sizeof(CompactArgs); }
