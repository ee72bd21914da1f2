// K-C: the packed decode buffer, and K-F, its stacked form.
//
// Replaces the JAX package's models/fair_scheduler.py `compact_result` (a
// jitted concatenation of a 9-word header, the placement slots and three
// `jnp.nonzero(size=cap, fill_value=-1)` index lists) and, with a lane
// axis, models/problem.py `_compact_stacked` (:1501; jax.vmap of it over a
// stacked round's P pool lanes into one [P, L] buffer).  Plain versions:
// armada_tpu_torch/models/fair_scheduler.py `compact_result_plain` and
// armada_tpu_torch/kernels/compact.py `compact_result_stacked_plain`.
//
// Bound on this card: it reads g_state (4 bytes a gang) and the two run
// flags (1 byte each) and writes the buffer (4 x (9 + S + 2SW + fcap +
// 2 ecap) bytes) per lane: ~3.7 MB at the main path's 901,120 gangs, about
// 1 us of HBM time, so a call costs what its launches cost.  The design is
// one launch a call, no memset and no host-to-device copy:
//  - One grid per call, lanes on blockIdx.y.  Its blocks tile each lane's
//    gang flags (the failed list), then its run flags (the preempted and
//    the rescheduled lists, from one read of the two flags), then the
//    slots (a copy; the first slot block writes the header's scalars).
//  - A tile of 4,096 flags (16 a thread, loaded before any is used) counts
//    its flags with warp ballots, ranks them inside the tile with one
//    warp's scan of the 128 (row, warp) counts, and takes its list offset
//    by a decoupled look-back over the tiles before it in the same lane
//    (the pattern of csrc/slab.cu `slab_lookback`).  Each list has its own
//    chain of look-back status words; a run tile publishes on two.  The
//    tile writes the indices whose rank is below the cap.
//  - The last tile of a chain knows the list's true count: it writes it to
//    the header (even above the cap) and fills the list's tail with -1 from
//    the count to the cap.
//  - A status word carries the call's tag (1..255, a counter of the
//    workspace kept by kernels/compact.py): every call writes every status
//    word of its lanes, so a word of the previous call never carries the
//    current tag and nothing is cleared between calls.  A tile waits only
//    on tiles of lower blockIdx.x in its own lane, which the card starts
//    first.
//  - The real-gang and real-run counts of each lane ride by value in the
//    argument block (a device table only past CP_INLINE lanes).

#include "common.cuh"

#define CP_THREADS 256
#define CP_WARPS (CP_THREADS / 32)
#define CP_ITEMS 16                          // flags a thread
#define CP_TILE (CP_THREADS * CP_ITEMS)      // flags a tile
#define CP_INLINE 256                        // lanes whose real counts ride in the arguments

typedef unsigned long long u64;
typedef unsigned int u32;

// The argument block: int64 words (kernels/compact.py WORD), passed to the
// kernel by value.
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
    int* out;                   // [P, L], L = 9 + S + 2SW + fcap + 2 ecap
    u64* ws;                    // [P, tiles(G) + 2 tiles(RJ)] look-back status words
    const int* real_table;      // [P, 2] (real gangs, real runs) past CP_INLINE lanes, else null
    long long G, RJ, S, W, fcap, ecap, lanes, tag;
    int real_inline[2 * CP_INLINE];  // (real gangs, real runs) of lanes < CP_INLINE
};

static __host__ __device__ __forceinline__ long long cp_tiles(long long n) {
    return (n + CP_TILE - 1) / CP_TILE;
}

static __host__ __device__ __forceinline__ long long cp_len(const CompactArgs& a) {
    return 9 + a.S + 2 * a.S * a.W + a.fcap + 2 * a.ecap;
}

// A look-back status word: (tag, flag, count) -- 8, 2 and 54 bits.
#define CP_AGG 1ull
#define CP_PRE 2ull
#define CP_CNT_MASK ((1ull << 54) - 1)

static __device__ __forceinline__ void cp_publish(u64* st, u32 tag, u64 flag, long long n) {
    *(volatile u64*)st = ((u64)tag << 56) | (flag << 54) | (u64)n;
}

// The count over the tiles before `tile` of one chain (decoupled look-back),
// read by one whole warp: each lane waits on one of 32 predecessors'
// statuses, and the nearest inclusive prefix among them ends the walk.
static __device__ long long cp_lookback(const u64* st, long long tile, u32 tag) {
    const int lane = threadIdx.x & 31;
    long long sum = 0;
    for (long long hi = tile; hi > 0; hi -= 32) {
        const long long j = hi - 32 + lane;  // lane 31 reads tile hi - 1
        u64 s = 0;
        if (j >= 0) {
            do {
                s = *(const volatile u64*)&st[j];
            } while ((u32)(s >> 56) != tag || ((s >> 54) & 3ull) == 0);
        }
        const unsigned pre = __ballot_sync(0xffffffffu, j >= 0 && ((s >> 54) & 3ull) == CP_PRE);
        const int from = pre ? 31 - __clz((int)pre) : 0;
        long long v = (j >= 0 && lane >= from) ? (long long)(s & CP_CNT_MASK) : 0;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        sum += __shfl_sync(0xffffffffu, v, 0);
        if (pre) break;
    }
    return sum;
}

// The slots (a copy) and the header's scalars; header counts of an empty
// axis (no tile to write them).
static __device__ void cp_slots(const CompactArgs& a, long long l, long long t, int* out,
                                long long tG, long long tR) {
    const long long SW = a.S * a.W;
    const long long n = a.S + 2 * SW;
    const long long p0 = t * CP_TILE + threadIdx.x;
    int v[CP_ITEMS];
#pragma unroll
    for (int j = 0; j < CP_ITEMS; ++j) {
        const long long p = p0 + (long long)j * CP_THREADS;
        if (p < a.S) v[j] = a.slot_gang[l * a.S + p];
        else if (p < a.S + SW) v[j] = a.slot_nodes[l * SW + p - a.S];
        else if (p < n) v[j] = a.slot_counts[l * SW + p - a.S - SW];
    }
#pragma unroll
    for (int j = 0; j < CP_ITEMS; ++j) {
        const long long p = p0 + (long long)j * CP_THREADS;
        if (p < n) out[9 + p] = v[j];
    }
    if (t == 0 && threadIdx.x == 0) {
        out[0] = a.n_slots[l];
        out[1] = a.iterations[l];
        out[2] = a.termination[l];
        out[3] = a.sched_count[l];
        out[4] = __float_as_int(a.spot_price[l]);
        out[8] = a.kernel_iters[l];
        if (tG == 0) out[5] = 0;
        if (tR == 0) out[6] = out[7] = 0;
    }
}

__global__ void __launch_bounds__(CP_THREADS) compact_kernel(const CompactArgs a) {
    __shared__ int cnt[CP_ITEMS * CP_WARPS];  // (row, warp) counts, list 0 | list 1 << 16
    __shared__ long long base[2], total[2];
    const long long l = blockIdx.y;
    const long long tG = cp_tiles(a.G), tR = cp_tiles(a.RJ);
    const long long x = blockIdx.x;
    int* out = a.out + l * cp_len(a);
    if (x >= tG + tR) {
        cp_slots(a, l, x - tG - tR, out, tG, tR);
        return;
    }
    const bool gang = x < tG;
    const long long tile = gang ? x : x - tG;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long i0 = tile * CP_TILE + threadIdx.x;
    const int rg = l < CP_INLINE ? a.real_inline[2 * l] : a.real_table[2 * l];
    const int rr = l < CP_INLINE ? a.real_inline[2 * l + 1] : a.real_table[2 * l + 1];
    unsigned m0[CP_ITEMS], m1[CP_ITEMS];
    if (gang) {
        // list 0: the failed gangs (state 2) below the real-gang count
        const long long lim = min(a.G, (long long)max(rg, 0));
        const int* __restrict__ g = a.g_state + l * a.G;
        int v[CP_ITEMS];
#pragma unroll
        for (int j = 0; j < CP_ITEMS; ++j) {
            const long long i = i0 + (long long)j * CP_THREADS;
            v[j] = i < lim ? g[i] : 0;
        }
#pragma unroll
        for (int j = 0; j < CP_ITEMS; ++j) {
            m0[j] = __ballot_sync(0xffffffffu, v[j] == 2);
            m1[j] = 0u;
        }
    } else {
        // lists 1 and 2: evicted runs, not rescheduled / rescheduled, below
        // the real-run count
        const long long lim = min(a.RJ, (long long)max(rr, 0));
        const u8* __restrict__ ev = a.run_evicted + l * a.RJ;
        const u8* __restrict__ rs = a.run_rescheduled + l * a.RJ;
        u8 e[CP_ITEMS], r[CP_ITEMS];
#pragma unroll
        for (int j = 0; j < CP_ITEMS; ++j) {
            const long long i = i0 + (long long)j * CP_THREADS;
            e[j] = i < lim ? ev[i] : 0;
            r[j] = i < lim ? rs[i] : 0;
        }
#pragma unroll
        for (int j = 0; j < CP_ITEMS; ++j) {
            m0[j] = __ballot_sync(0xffffffffu, e[j] != 0 && r[j] == 0);
            m1[j] = __ballot_sync(0xffffffffu, e[j] != 0 && r[j] != 0);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < CP_ITEMS; ++j)
            cnt[j * CP_WARPS + warp] = __popc(m0[j]) | (__popc(m1[j]) << 16);
    }
    __syncthreads();
    const int nl = gang ? 1 : 2;
    // chain c's status words of this lane: gangs, then preempted, then rescheduled
    u64* st = a.ws + l * (tG + 2 * tR) + (gang ? 0 : tG);
    if (warp == 0) {
        // exclusive scan of the 128 (row, warp) counts in tile order, four a lane
        static_assert(CP_ITEMS * CP_WARPS == 128, "one warp scans four counts a lane");
        int c[4], s = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            c[k] = cnt[4 * lane + k];
            s += c[k];
        }
        int inc = s;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc, off);
            if (lane >= off) inc += y;
        }
        int run = inc - s;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            cnt[4 * lane + k] = run;
            run += c[k];
        }
        const int tot = __shfl_sync(0xffffffffu, inc, 31);
        const u32 tag = (u32)a.tag;
        if (tile > 0 && lane == 0)
            for (int k = 0; k < nl; ++k)
                cp_publish(st + k * tR + tile, tag, CP_AGG, k ? tot >> 16 : tot & 0xffff);
        for (int k = 0; k < nl; ++k) {
            const long long own = k ? tot >> 16 : tot & 0xffff;
            const long long pre = tile > 0 ? cp_lookback(st + k * tR, tile, tag) : 0;
            if (lane == 0) {
                cp_publish(st + k * tR + tile, tag, CP_PRE, pre + own);
                base[k] = pre;
                total[k] = pre + own;
            }
        }
    }
    __syncthreads();
    const long long lists = 9 + a.S + 2 * a.S * a.W;
    int* dst0 = out + lists + (gang ? 0 : a.fcap);
    int* dst1 = out + lists + a.fcap + a.ecap;
    const long long cap0 = gang ? a.fcap : a.ecap, cap1 = a.ecap;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < CP_ITEMS; ++j) {
        const int e = cnt[j * CP_WARPS + warp];
        const int i = (int)(i0 + (long long)j * CP_THREADS);
        if ((m0[j] >> lane) & 1u) {
            const long long r = base[0] + (e & 0xffff) + __popc(m0[j] & below);
            if (r < cap0) dst0[r] = i;
        }
        if ((m1[j] >> lane) & 1u) {
            const long long r = base[1] + (e >> 16) + __popc(m1[j] & below);
            if (r < cap1) dst1[r] = i;
        }
    }
    if (tile == (gang ? tG : tR) - 1) {
        // the last tile of its chains: the true counts, and each list's -1 tail
        for (int k = 0; k < nl; ++k) {
            int* dst = k ? dst1 : dst0;
            const long long cap = k ? cap1 : cap0;
            if (threadIdx.x == 0) out[gang ? 5 : 6 + k] = (int)total[k];
            for (long long p = min(total[k], cap) + threadIdx.x; p < cap; p += CP_THREADS)
                dst[p] = -1;
        }
    }
}

extern "C" int armada_compact(const CompactArgs* args, cudaStream_t stream) {
    const CompactArgs& a = *args;
    const long long tG = cp_tiles(a.G), tR = cp_tiles(a.RJ);
    const long long tS = a.S + 2 * a.S * a.W > 0 ? cp_tiles(a.S + 2 * a.S * a.W) : 1;
    if (a.lanes < 1 || a.lanes > 65535 || a.G < 0 || a.RJ < 0 || a.S < 0 || a.W < 0
        || a.G >= (1ll << 31) || a.RJ >= (1ll << 31) || a.fcap < 0 || a.fcap > a.G
        || a.ecap < 0 || a.ecap > a.RJ || a.tag < 1 || a.tag > 255 || !a.out
        || (tG + tR > 0 && !a.ws) || (a.lanes > CP_INLINE && !a.real_table)
        || tG + tR + tS >= (1ll << 31))
        return -1;
    ARMADA_LAUNCH(compact_kernel, dim3((unsigned)(tG + tR + tS), (unsigned)a.lanes), CP_THREADS,
                  stream)(a);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_compact_args_size(void) { return (int)sizeof(CompactArgs); }

// Status words of one lane's workspace.
extern "C" long long armada_compact_ws_words(long long G, long long RJ) {
    return cp_tiles(G) + 2 * cp_tiles(RJ);
}
