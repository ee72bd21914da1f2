#pragma once

// K-B: the scheduling round.  Shared by round.cu (the grid-wide kernels, the
// launch sequence and the placement loop's narrow instantiations),
// round_wide.cu (its wide instantiations) and round_cluster.cu (K-K, the
// loop as a thread-block cluster).
//
// Replaces the JAX package's models/fair_scheduler.py `_schedule_round_jit`
// (with `_make_place_iteration`, `_phase_b`, `_move_runs_to_evicted`,
// `_fit_row`, and ops/fit.py, ops/packing.py, ops/fairness.py inlined), at
// every loop shape: the node-type bias (TR > 1), prefer-large ordering, the
// multi-commit extension at any commit_k (K10, `_make_place_iteration`
// fair_scheduler.py:773-1016), and K11: the per-key fit cache (:515-600,
// :1017-1079), the certified pick chain at any batch_k (:1081-1480) and
// unroll (:1960).  Plain version:
// armada_tpu_torch/models/fair_scheduler.py `schedule_round_plain`,
// `_extension`, `_FitCache` and `_pick_chain`, which this file follows step
// by step.
//
// What bounds it on this card.  The placement loop is sequential: up to
// 2G + Q + 8 iterations, each deciding one gang (or retiring queue heads).
// Per iteration it reads the Q x 16 cursor window (only queues that hold
// gangs), and for a fit attempt two allocatable rows of every node
// (2 x N x R x 4 bytes: 1.8 MB at N = 57,344, R = 4) plus the static-fit and
// ban rows; a gang of cardinality c adds up to c argmin passes over N.  At
// ~1,000 to ~30,000 iterations per round the loop is bound by that sequence of
// per-iteration passes and block barriers, not by device bandwidth: on an
// H100 80GB HBM3 at 700 W, the main world's step takes ~13.5 us at S = 16
// (the window walk ~5.3, the node pass ~3.9, the commit ~1.6, the cluster
// exchange ~1.3) against a bound of ~0.6 us (PERF.md §5).
//
// The design: the prologue, the DRF gate, the eviction move, the key sweep
// and the unbind are grid-wide kernels (scatter-adds with atomics, exact
// because every value is integral in resolution units); the placement loop
// is ONE persistent kernel a lane -- a thread-block cluster of S CTAs
// (round_cluster.cu; S from the wrapper's owner, kernels/round.py
// `choose_cluster_size`), or one block where S = 1 -- that keeps the carry
// scalars in shared memory and alloc[P1, N, R] in global memory (it fits in
// L2 at the reference scale); phase B's fixed point is a second single-block
// kernel.  No host synchronisation between the launches.
//
// A step of the loop, as it runs on this card (the reference computes each
// part as a whole-array program; here the latency of dependent loads and
// barriers is the cost, so the step keeps both few):
// - the window walk: a half-warp a live queue (two queues at once), lane w
//   on window entry head + w; a ballot gives the leading skippable run (the
//   reference's cumprod); the candidate's lanes then compute its DRF key
//   and its whole gate (caps, burst, floating capacity) in parallel, so the
//   gate costs no loads after the pick;
// - the pick: one reduction of (key, queue) with the step's flags OR'ed;
// - the node pass: a single needs no division (fits_row decides as
//   min(member_capacity, 1) >= 1 does), R = 4 rows load as float4, the
//   key's compat row is a bit mask the walk read; its counts and argmins
//   meet in one reduction (one cluster exchange under CL), to warp 0 only;
// - the commit: warp 0, a lane a (entry, level, resource) element and a
//   resource, on accumulators kept in shared memory for the whole loop (and
//   the per-queue state, where it fits beside the kernel's own).
// Four block barriers a single-commit step at S = 1, and one cluster
// barrier more at S > 1 (20.8 and 22.8 before; PERF.md §5).
//
// The multi-commit extension (commit_k = K > 1) runs inside the same block
// after the head's commit: the K - 1 next queues by order key (successive
// warp argmins over (key, queue), which is the stable top-K), their checks
// (eligibility, caps in commit order, queue order) on one thread each, then
// ONE sweep over the nodes for all picks at once -- each thread keeps a
// running (clean-first, score, index) minimum per pick in registers, packed
// into one 64-bit key, and the block reduces the picks together -- then the
// [E x E] conflict table on E^2 threads and the certified prefix's commit on
// thread 0.  So an iteration costs about one head iteration plus one node
// sweep, whatever K is (up to EXT_CHUNK picks per sweep).  The sweep is
// compute-bound: every pick's static fit, dynamic fit and packing score at
// every node (on an H100 80GB HBM3 at 700 W, K = 8 on chip_smoke.py's 1M-job
// world: ~435 us a trip against ~122 us for a single-commit trip; PERF.md).
//
// K-D, the stacked round: P pools whose problems match in every shape run as
// ONE sequence of launches.  Replaces `_schedule_round_stacked_jit`
// (models/fair_scheduler.py:1788, jax.vmap of the solo round).  Every kernel
// takes the lane from blockIdx.y: the grid-wide kernels launch with grid
// (x, P), and the two persistent kernels with grid (1, P), one block per
// pool lane on its own SM -- the placement loop with grid (S, P), a
// cluster of S CTAs a lane, when its owner picks S > 1.  Lane l's arrays start l x (per-lane element
// count) past lane 0's (`lane_of`), so one RoundArgs by value serves every
// lane and nothing per lane is uploaded.  The lanes never meet and the
// block's arithmetic is the solo round's, so each lane equals the solo
// round on its slice bit for bit (vmap runs the lanes in lockstep and masks
// finished ones; that gives the same per-lane result).  Past 132 lanes the
// persistent blocks queue for a free SM: the round's device time grows by
// the longest lane per extra wave, the results do not change.  A solo
// round is the stacked one at P = 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <type_traits>

// The step profile (-DROUND_STEP_PROFILE; the shipped build compiles none
// of it).  Thread 0 of lane 0's rank-0 CTA reads clock64 where each section
// of a placement-loop step begins and adds the cycles since the last such
// point to the section that ended; it also counts the steps and the block
// and cluster barriers it passes, and the loop's globaltimer nanoseconds
// and cycles, so that cycles convert to time.  The loop's last launch in
// each translation unit leaves its sums in round_prof_out, which
// armada_round_step_profile copies out.
#ifdef ROUND_STEP_PROFILE
enum { PS_WINDOW, PS_KEYS, PS_PICK, PS_GATE, PS_NODE, PS_CLUSTER, PS_COMMIT, PS_AFTER, PS_END,
       PS_STEPS, PS_BARRIERS, PS_LOOP_NS, PS_LOOP_CYCLES, PS_SLOTS };
static __device__ long long round_prof_out[PS_SLOTS];
__shared__ long long prof_acc[PS_SLOTS];
__shared__ long long prof_t;
__shared__ int prof_cur;
static __device__ __forceinline__ bool prof_thread() {
    return threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;
}
static __device__ __forceinline__ long long prof_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
// Section s begins: the cycles since the last mark go to the one that ended.
static __device__ __forceinline__ void prof_begin(int s) {
    if (prof_thread()) {
        const long long t = clock64();
        prof_acc[prof_cur] += t - prof_t;
        prof_t = t;
        prof_cur = s;
    }
}
static __device__ __forceinline__ int prof_section() { return prof_cur; }
#define ARMADA_BAR_HOOK() (prof_thread() ? (void)++prof_acc[PS_BARRIERS] : (void)0)
#define PROF_BEGIN(s) prof_begin(s)
#else
#define PROF_BEGIN(s) ((void)0)
#endif

#include "common.cuh"

// The placement loop's dynamic shared memory (a CPU build of the kernels
// may define it otherwise).
#ifndef ROUND_DYN_SHARED
#define ROUND_DYN_SHARED(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace cg = cooperative_groups;

#define SKIP_WINDOW 16
#define MAX_R 8
// The narrow multi-commit: up to MAX_COMMIT_K, MAX_EXT = MAX_COMMIT_K - 1
// extension picks per iteration, their tables in shared memory.  A wider
// commit_k runs the WIDE instantiations (round_wide.cu), whose tables lie in
// global scratch the wrapper allocates by the width (`wide_need`).  One sweep
// over the nodes serves EXT_CHUNK picks, whatever the width.
#define MAX_COMMIT_K 16
#define MAX_EXT (MAX_COMMIT_K - 1)
#define EXT_CHUNK 8
// Threads of the multi-commit instantiation: 640 leave it 96 registers a
// thread, which its node sweep needs without spilling (768 threads, 80
// registers, spill; ptxas -v, sm_90a).
#ifndef EXT_BLOCK
#define EXT_BLOCK 640
#endif
static_assert(EXT_BLOCK <= ARMADA_BLOCK && EXT_BLOCK % 32 == 0,
              "the per-warp tables are sized for ARMADA_BLOCK threads");
// Threads of the pick-chain instantiation (batch_k > 1): at 1,024 threads
// (64 registers) its replay state spills 84-120 bytes, at 768 (80
// registers) 32-40 bytes (ptxas -v, sm_90a).
#ifndef BK_BLOCK
#define BK_BLOCK 640
#endif
static_assert(BK_BLOCK <= ARMADA_BLOCK && BK_BLOCK % 32 == 0 && BK_BLOCK >= 64,
              "the per-warp tables are sized for ARMADA_BLOCK threads");
// Threads of the other instantiations (single-commit, with or without
// prefer-large or the fit cache): 768 leave 80 registers a thread, which
// the step needs without spilling (at 1,024 threads, 64 registers, it
// spilled; ptxas -v, sm_90a); with the node-type bias 640, 96
// registers (at 80 it spilled 4-12 bytes; ptxas sizes registers for whole
// groups of 128 threads, so 704 threads still leave 80).
#ifndef LOOP_BLOCK
#define LOOP_BLOCK 768
#endif
#ifndef LOOP_BLOCK_HET
#define LOOP_BLOCK_HET 640
#endif
static_assert(LOOP_BLOCK <= ARMADA_BLOCK && LOOP_BLOCK % 32 == 0 && LOOP_BLOCK_HET <= ARMADA_BLOCK &&
                  LOOP_BLOCK_HET % 32 == 0,
              "the per-warp tables are sized for ARMADA_BLOCK threads");
// Prefer-large ordering: the offset that lifts over-budget queues' keys
// (fair_scheduler.py _PL_OVER), added in f32.
#define PL_OVER 1.0e30f

// Everything the round reads and writes.  Mirrors SchedulingProblem plus the
// state buffers the wrapper allocates (armada_tpu_torch/kernels/round.py).
struct RoundArgs {
    // problem (read-only)
    const float* node_total;   // [N, R]
    const int* node_type;      // [N]
    const u8* node_ok;         // [N]
    const float* run_req;      // [RJ, R]
    const int* run_node;       // [RJ]
    const int* run_level;      // [RJ]
    const int* run_queue;      // [RJ]
    const int* run_pc;         // [RJ]
    const u8* run_preemptible; // [RJ]
    const int* run_gang;       // [RJ]
    const u8* run_valid;       // [RJ]
    const float* g_req;        // [G, R]
    const int* g_card;         // [G]
    const int* g_level;        // [G]
    const int* g_key;          // [G]
    const int* g_pc;           // [G]
    const int* g_run;          // [G]
    const u8* g_valid;         // [G]
    const u8* g_absent;        // [G]
    const float* g_price;      // [G]
    const float* g_spot_price; // [G]
    const int* gq_gang;        // [G]
    const int* q_start;        // [Q]
    const int* q_len;          // [Q]
    const float* q_weight;     // [Q]
    const float* q_penalty;    // [Q, R]
    const u8* compat;          // [K, T]
    const float* total_pool;   // [R]
    const float* drf_mult;     // [R]
    const float* inv_scale;    // [R]
    const float* round_cap;    // [R]
    const float* pc_queue_cap; // [C, R]
    const float* protected_fraction;  // scalar
    const int* global_burst;   // scalar
    const int* perq_burst;     // [Q]
    const float* node_axes;    // [R]
    const float* float_total;  // [R]
    const u8* market;          // scalar
    const float* spot_cutoff;  // scalar
    const u8* ban_mask;        // [BR, N]
    const int* g_ban_row;      // [G]
    // fair shares of the prologue (K-A outputs)
    const float* fair_share;   // [Q]
    const float* dcafs;        // [Q]
    // state (written)
    float* used;               // [P1, N, R] scratch
    float* alloc;              // [P1, N, R]
    float* q_alloc;            // [Q, R]
    float* q_alloc_pc;         // [Q, C, R]
    float* float_used;         // [R]
    float* sched_res;          // [R]
    float* spot_res;           // [R]
    float* spot_price;         // scalar
    u8* run_evicted;           // [RJ]
    u8* run_rescheduled;       // [RJ]
    u8* pending;               // [RJ] phase B scratch
    int* g_state;              // [G]
    u8* q_killed;              // [Q]
    int* q_sched;              // [Q]
    int* q_head;               // [Q]
    int* live_q;               // [Q] queues holding gangs, ascending
    u8* key_bad;               // [K]
    int* slot_gang;            // [S]
    int* slot_nodes;           // [S, W]
    int* slot_counts;          // [S, W]
    int* cap_c;                // [N] scratch: capacity at the clean level
    int* cap_l;                // [N] scratch: capacity at the gang's level
    float* score_c;            // [N] scratch
    float* score_l;            // [N] scratch
    unsigned int* nmin;        // [N] phase B scratch (ordered cost bits)
    int* rmin;                 // [N] phase B scratch
    float* cost;               // [RJ] phase B scratch
    int* scal;                 // [8]: n_slots, iterations, termination,
                               //      sched_count, done, kernel_iters,
                               //      the fit cache's hits and misses
    // node-type bias, prefer-large and multi-commit inputs
    const float* type_bias;    // [TR, T]
    const int* key_type_row;   // [K]
    const int* g_queue;        // [G]
    float* okey;               // [Q] scratch: the iteration's order keys
    int* q_nskip;              // [Q] scratch: the iteration's cursor skips
    // the per-key fit cache (CS slots; empty when CS = 0)
    u8* fitc_clean;            // [CS, N] fit rows at the clean level
    u8* fitc_lvl;              // [CS, N] fit rows at the slot's level
    float* cscore;             // [P1, N] packing score of every level's row
    float* bmc_clean;          // [CS, N / CB] block minima of the masked scores
    float* bmc_lvl;            // [CS, N / CB]
    int* cslot_key;            // [CS] the slot's key (-1: empty)
    int* cslot_lvl;            // [CS]
    float* cslot_req;          // [CS, R]
    // the pick chain's scratch (empty when batch_k = 1)
    float* bk_m0;              // [N] masked clean-level scores of the row cache
    float* bk_ml;              // [N] masked own-level scores
    u8* bk_fit0;               // [N]
    u8* bk_fitl;               // [N]
    float* sim_keys;           // [Q] simulated order keys
    int* simpos;               // [Q] simulated window positions
    float* sim_row;            // [Q, R] simulated queue allocations
    // shapes and statics; BR = ban rows, P = lanes, TR = bias rows, CS =
    // cache slots, CB = the cache's block size
    // the wide instantiations' tables (commit_k > MAX_COMMIT_K or batch_k >
    // MAX_BATCH_K; empty otherwise): WI ints, WF floats and WB bytes a lane
    int* wide_i;
    float* wide_f;
    u8* wide_b;
    int N, R, G, Q, RJ, K, T, C, P1, S, W, max_iter, BR, P;
    int TR, prefer_large, commit_k, CS, CB, batch_k, unroll;
    long long WI, WF, WB;
};

// scal is [8, P]: slot k of lane l at scal[k * P + l] (a contiguous [P]
// row per slot for the stacked result).
enum { SC_NSLOTS = 0, SC_ITERS = 1, SC_TERM = 2, SC_SCHED = 3, SC_DONE = 4, SC_KITERS = 5,
       SC_CHITS = 6, SC_CMISSES = 7 };

// Lane l of a stacked round: every lane has lane 0's shapes, so each array
// of lane l starts l x (its per-lane element count) past lane 0's.  The
// problem's arrays and K-A's shares (`inputs_at`), then the state the round
// writes (`state_at`, by the lane's replica in a cluster), in place.
static __device__ __forceinline__ void inputs_at(RoundArgs& a, long long l) {
    const long long N = a.N, R = a.R, G = a.G, Q = a.Q, RJ = a.RJ;
    const long long NR = N * R;
    a.node_total += l * NR;
    a.node_type += l * N;
    a.node_ok += l * N;
    a.run_req += l * RJ * R;
    a.run_node += l * RJ;
    a.run_level += l * RJ;
    a.run_queue += l * RJ;
    a.run_pc += l * RJ;
    a.run_preemptible += l * RJ;
    a.run_gang += l * RJ;
    a.run_valid += l * RJ;
    a.g_req += l * G * R;
    a.g_card += l * G;
    a.g_level += l * G;
    a.g_key += l * G;
    a.g_pc += l * G;
    a.g_run += l * G;
    a.g_valid += l * G;
    a.g_absent += l * G;
    a.g_price += l * G;
    a.g_spot_price += l * G;
    a.gq_gang += l * G;
    a.q_start += l * Q;
    a.q_len += l * Q;
    a.q_weight += l * Q;
    a.q_penalty += l * Q * R;
    a.compat += l * (long long)a.K * a.T;
    a.total_pool += l * R;
    a.drf_mult += l * R;
    a.inv_scale += l * R;
    a.round_cap += l * R;
    a.pc_queue_cap += l * (long long)a.C * R;
    a.protected_fraction += l;
    a.global_burst += l;
    a.perq_burst += l * Q;
    a.node_axes += l * R;
    a.float_total += l * R;
    a.market += l;
    a.spot_cutoff += l;
    a.ban_mask += l * (long long)a.BR * N;
    a.g_ban_row += l * G;
    a.fair_share += l * Q;
    a.dcafs += l * Q;
    a.type_bias += l * (long long)a.TR * a.T;
    a.key_type_row += l * a.K;
    a.g_queue += l * G;
}

static __device__ __forceinline__ void state_at(RoundArgs& a, long long l, long long scal_off) {
    const long long N = a.N, R = a.R, G = a.G, Q = a.Q, RJ = a.RJ;
    const long long P1NR = (long long)a.P1 * N * R;
    a.used += l * P1NR;
    a.alloc += l * P1NR;
    a.q_alloc += l * Q * R;
    a.q_alloc_pc += l * Q * a.C * R;
    a.float_used += l * R;
    a.sched_res += l * R;
    a.spot_res += l * R;
    a.spot_price += l;
    a.run_evicted += l * RJ;
    a.run_rescheduled += l * RJ;
    a.pending += l * RJ;
    a.g_state += l * G;
    a.q_killed += l * Q;
    a.q_sched += l * Q;
    a.q_head += l * Q;
    a.live_q += l * Q;
    a.key_bad += l * a.K;
    a.slot_gang += l * a.S;
    a.slot_nodes += l * (long long)a.S * a.W;
    a.slot_counts += l * (long long)a.S * a.W;
    a.cap_c += l * N;
    a.cap_l += l * N;
    a.score_c += l * N;
    a.score_l += l * N;
    a.nmin += l * N;
    a.rmin += l * N;
    a.cost += l * RJ;
    a.scal += scal_off;
    a.okey += l * Q;
    a.q_nskip += l * Q;
    const long long CSN = (long long)a.CS * N, NBS = (long long)a.CS * (N / a.CB);
    a.fitc_clean += l * CSN;
    a.fitc_lvl += l * CSN;
    a.cscore += l * (long long)a.P1 * N;
    a.bmc_clean += l * NBS;
    a.bmc_lvl += l * NBS;
    a.cslot_key += l * a.CS;
    a.cslot_lvl += l * a.CS;
    a.cslot_req += l * (long long)a.CS * R;
    const long long BN = a.batch_k > 1 ? N : 0, BQ = a.batch_k > 1 ? Q : 0;
    a.bk_m0 += l * BN;
    a.bk_ml += l * BN;
    a.bk_fit0 += l * BN;
    a.bk_fitl += l * BN;
    a.sim_keys += l * BQ;
    a.simpos += l * BQ;
    a.sim_row += l * BQ * R;
    a.wide_i += l * a.WI;
    a.wide_f += l * a.WF;
    a.wide_b += l * a.WB;
}

static __device__ __forceinline__ RoundArgs lane_of(RoundArgs a, long long l) {
    inputs_at(a, l);
    state_at(a, l, l);
    return a;
}


#define LANE_ARGS const RoundArgs a = lane_of(a0, blockIdx.y)

#define GRID_STRIDE(i, n) \
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
         i += (long long)gridDim.x * blockDim.x)

// --- the placement loop ----------------------------------------------------------

// A queue's place in the pick order: the lower key first, then (prefer-large
// only) the larger gang, then the lower queue.  `sz` is 0 for every queue
// outside prefer-large, which leaves the plain (key, queue) argmin.
struct QPick {
    float v, sz;
    int q, g;
    unsigned f;  // the step's flags (QF_*), OR'ed by the placement loop's pick
    int slot;    // the placement loop's half-warp that holds the pick's record
};

// Flags the queue pick's reduction carries: some queue has a candidate, some
// cursor advanced, some window was all skipped with gangs left (EXT).
enum { QF_ANY = 1u, QF_ADV = 2u, QF_HID = 4u };

#define FULL_MASK 0xffffffffu

static __device__ __forceinline__ bool qpick_less(const QPick& a, const QPick& b);

// The warp's least QPick and the OR of its flags, in every lane (a
// butterfly: the order is total over distinct queues).
static __device__ __forceinline__ QPick qpick_warp(QPick a) {
    for (int off = 16; off > 0; off >>= 1) {
        QPick o;
        o.v = __shfl_xor_sync(FULL_MASK, a.v, off);
        o.sz = __shfl_xor_sync(FULL_MASK, a.sz, off);
        o.q = __shfl_xor_sync(FULL_MASK, a.q, off);
        o.g = __shfl_xor_sync(FULL_MASK, a.g, off);
        o.f = __shfl_xor_sync(FULL_MASK, a.f, off);
        o.slot = __shfl_xor_sync(FULL_MASK, a.slot, off);
        const unsigned f = a.f | o.f;
        if (qpick_less(o, a)) a = o;
        a.f = f;
    }
    return a;
}

static __device__ __forceinline__ bool qpick_less(const QPick& a, const QPick& b) {
    if (a.v != b.v) return a.v < b.v;
    if (a.sz != b.sz) return a.sz > b.sz;
    return a.q < b.q;
}

static __device__ __forceinline__ QPick qpick_shfl(QPick a, int off) {
    QPick o;
    o.v = __shfl_down_sync(0xffffffffu, a.v, off);
    o.sz = __shfl_down_sync(0xffffffffu, a.sz, off);
    o.q = __shfl_down_sync(0xffffffffu, a.q, off);
    o.g = __shfl_down_sync(0xffffffffu, a.g, off);
    return o;
}

// Block-wide queue pick; every thread gets the result.  `sh` holds
// ARMADA_WARPS entries plus one for the broadcast.
static __device__ QPick block_qpick(QPick a, QPick* sh) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        const QPick o = qpick_shfl(a, off);
        if (qpick_less(o, a)) a = o;
    }
    if (lane == 0) sh[warp] = a;
    ARMADA_SYNC();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        QPick b = lane < nw ? sh[lane] : QPick{ARMADA_INF, -ARMADA_INF, ARMADA_BIGI, 0};
        for (int off = 16; off > 0; off >>= 1) {
            const QPick o = qpick_shfl(b, off);
            if (qpick_less(o, b)) b = o;
        }
        if (lane == 0) sh[ARMADA_WARPS] = b;
    }
    ARMADA_SYNC();
    const QPick r = sh[ARMADA_WARPS];
    ARMADA_SYNC();
    return r;
}

// The request fits in allocatable row a[R] (fair_scheduler.py _fit_row,
// min_r floor(a_r / req_r) >= 1 over req_r > 0).  For req_r > 0,
// floor(RN(a_r / req_r)) >= 1 exactly when a_r >= req_r: RN(a/r) >= 1 when
// a >= r, and when a < r the quotient is at most 1 - 2^-24, which rounds
// below 1.  So the comparison decides as the division does.
static __device__ __forceinline__ bool fits_row(const float* a, const float* req, int R) {
    bool ok = true;
    for (int r = 0; r < R; ++r) ok &= !(req[r] > 0.0f) || a[r] >= req[r];
    return ok;
}

// One extension pick's node candidate as a 64-bit key whose unsigned order
// is the JAX package's choice: clean-level fits (prio 0) before own-level
// fits (prio 1), then the lower packing score, then the lower node index.
static __device__ __forceinline__ unsigned long long pick_key(unsigned prio, float s, int n) {
    unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);  // -0 ties +0
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)prio << 63) | ((unsigned long long)u << 31) |
           (unsigned long long)(unsigned)n;
}

// One node pass's partial over a warp, a CTA or the cluster: the clean and
// own-level argmins (score, node) and the fitting copies at each level.
struct NodePart {
    ArgMin c, l;
    long long sc, sl;
};

static __device__ __forceinline__ NodePart npart_empty() {
    return NodePart{{ARMADA_INF, ARMADA_BIGI, 0}, {ARMADA_INF, ARMADA_BIGI, 0}, 0, 0};
}

static __device__ __forceinline__ ArgMin argmin_xor(ArgMin a, int off) {
    ArgMin o;
    o.v = __shfl_xor_sync(FULL_MASK, a.v, off);
    o.i = __shfl_xor_sync(FULL_MASK, a.i, off);
    o.extra = __shfl_xor_sync(FULL_MASK, a.extra, off);
    return argmin_pick(a, o);
}

// The warp's NodePart in every lane (argmins tie to the lower node, sums
// exact: the result is the order-free one).
static __device__ __forceinline__ NodePart npart_warp(NodePart p) {
    for (int off = 16; off > 0; off >>= 1) {
        p.c = argmin_xor(p.c, off);
        p.l = argmin_xor(p.l, off);
        p.sc += __shfl_xor_sync(FULL_MASK, p.sc, off);
        p.sl += __shfl_xor_sync(FULL_MASK, p.sl, off);
    }
    return p;
}

// A live queue's candidate of the step with what the gate and the fit read
// of it: its request (and the node, total and floating parts of it), and
// the gate's verdicts.  Each half-warp of the window walk keeps its best.
struct Cand {
    float req[MAX_R], req_node[MAX_R], req_tot[MAX_R], req_float[MAX_R];
    int g, card, level, key, pc, run, ban, trow;
    unsigned cmask;  // the key's compat row (T <= 32)
    int hit_burst, gate_global, gate_queue, float_ok;
};

// A live queue and its window's span, staged in shared memory for the first
// LIVE_STAGE live queues.
struct LiveQ {
    int q, start, len;
};
#ifndef LIVE_STAGE
#define LIVE_STAGE 256
#endif

struct LoopShared {
    int nlive;
    int done, iterations, kiters, termination, cursor, sched_count, new_blocked;
    int advanced, hidden;
    // the iteration's pick
    int any_q, qstar, g, card, level, key, pc, run, is_ev, pinned, trow, ban;
    unsigned cmask;
    int attempt, gate_global, gate_queue, hit_burst, float_ok, placed, n_ext;
    float req[MAX_R], req_node[MAX_R], req_tot[MAX_R], req_float[MAX_R];
    // the fit
    int fit_feasible;
    // the fit cache: the pick is a cacheable single; its slot; a hit; the
    // round's hits and misses
    int cacheable, cslot, chit, nhits, nmisses;
    // the node range this CTA reduces over: [0, N) but in the sharded round
    int n0, n1;
    // the loop's R-sized accumulators, kept here for the whole loop and
    // written back after it (RoundArgs' pointers are redirected to them)
    float h_sched_res[MAX_R], h_float_used[MAX_R], h_spot_res[MAX_R], h_spot_price;
    // where they, and the per-queue state when shared memory holds it
    // (hotq), go back after the loop
    float *out_sched_res, *out_float_used, *out_spot_res, *out_spot_price, *out_q_alloc;
    int *out_q_sched, *out_q_head;
    u8* out_q_killed;
    // the allocatable rows load as one float4 (R = 4, 16-byte aligned)
    int row4;
    // the lane's (and replica's) spread rows, and a market round
    int *nodes_w, *counts_w;
    int market;
    // the problem's R-sized rows the step reads
    float inv_scale[MAX_R], c_total[MAX_R], c_mult[MAX_R], c_rcap[MAX_R], c_ftot[MAX_R],
        c_nax[MAX_R];
    // a gang pass's fitting copies at both levels, for every thread
    long long psc, psl;
};

// The multi-commit extension's tables (fair_scheduler.py:773-1016): pick e
// is the e-th queue after the head in order-key order; k indexes the batch
// queues of the order check (k = 0 the head, k = e + 1 pick e).  The narrow
// form holds them in shared memory (commit_k <= MAX_COMMIT_K); the wide form
// points into the lane's global scratch, laid out by `wide_need`, and is
// itself in shared memory, so `ext.q[e]` reads the same in both.
struct ExtBase {
    int m;     // picks whose order key is below INF
    int m_ok;  // the prefix that passed eligibility, caps and queue order
    unsigned long long red[ARMADA_WARPS][EXT_CHUNK];
    unsigned long long kmin[EXT_CHUNK];  // the sharded sweep's per-pick minima
};

struct ExtShared : ExtBase {
    int q[MAX_EXT], g[MAX_EXT], level[MAX_EXT], key[MAX_EXT], pc[MAX_EXT], elig[MAX_EXT];
    float keyv[MAX_EXT];
    float req[MAX_EXT][MAX_R], reqn[MAX_EXT][MAX_R], flt[MAX_EXT][MAX_R];
    int qk[MAX_COMMIT_K];
    float nk[MAX_COMMIT_K];
    int node[MAX_EXT], lvl_sel[MAX_EXT], found[MAX_EXT];
    u8 flip0[MAX_EXT][MAX_EXT], adj_fit[MAX_EXT][MAX_EXT];
    float adj_score[MAX_EXT][MAX_EXT];
};

// An [E x E] table in global scratch, indexed t[e][j] like the narrow form's.
template <class T>
struct Mat {
    T* p;
    long long ld;
    __device__ __forceinline__ T* operator[](long long e) const { return p + e * ld; }
};

struct ExtWide : ExtBase {
    int *q, *g, *level, *key, *pc, *elig, *qk, *node, *lvl_sel, *found;
    float *keyv, *nk;
    float (*req)[MAX_R], (*reqn)[MAX_R], (*flt)[MAX_R];
    Mat<u8> flip0, adj_fit;
    Mat<float> adj_score;
};

// The pick chain's per-pick tables (batch_k - 1 picks), narrow (shared
// memory, batch_k <= MAX_BATCH_K) and wide (global scratch); the chain's
// scalars are ChainBase, below.
#define MAX_BATCH_K 16
#define MAX_CHAIN (MAX_BATCH_K - 1)

// The wide scratch of one lane, in elements: the extension's tables at
// commit_k > MAX_COMMIT_K, the chain's at batch_k > MAX_BATCH_K (the two
// never run together).  The wrapper sizes its buffers from this
// (armada_round_wide_need).
static __host__ __device__ inline void wide_need(int commit_k, int batch_k, long long* ni,
                                                 long long* nf, long long* nb) {
    *ni = *nf = *nb = 0;
    if (commit_k > MAX_COMMIT_K) {
        const long long E = commit_k - 1;
        *ni = 10 * E + 1;
        *nf = 2 * E + 1 + 3 * E * MAX_R + E * E;
        *nb = 2 * E * E;
    } else if (batch_k > MAX_BATCH_K) {
        const long long E = batch_k - 1;
        *ni = 7 * E;
        *nf = 3 * E * MAX_R;
    }
}

// --- K-K: the cluster exchange ---------------------------------------------------
//
// In the sharded round every CTA of the cluster owns the node range
// [rank * N / S, (rank + 1) * N / S) and reduces its node passes over it; the
// S partials of one pass (up to two (value, index) argmins, two exact sums
// and EXT_CHUNK 64-bit pick keys) meet here.  Thread 0 publishes the block's
// partial in shared memory, a cluster barrier (release/acquire) orders it
// before every other CTA's read, and warp 0 reads the S partials through
// distributed shared memory (lane r reads rank r) and combines them; every
// CTA ends with the same answer, ties to the lowest node index as in the
// single-block argmin.  Two publish buffers alternate, so one barrier a pass
// suffices: a CTA rewrites a buffer only after the next pass's barrier,
// which every CTA reaches after its last read of it.
// The widest cluster: 16 CTAs, a non-portable cluster size on Hopper.
#define MAX_CLUSTER 16

struct ClusterPub {
    ArgMin m[2];
    long long s[2];
    unsigned long long k[EXT_CHUNK];
};

struct ClusterX {
    ClusterPub pub[2];
    ClusterPub comb;
    int phase, S;
};

template <int NM, int NS, int NK>
static __device__ void cluster_combine(ClusterX& cx, ArgMin* m, long long* s,
                                       unsigned long long* k) {
    cg::cluster_group cl = cg::this_cluster();
#ifdef ROUND_STEP_PROFILE
    const int prof_was = prof_section();
#endif
    PROF_BEGIN(PS_CLUSTER);
    const int ph = cx.phase;
    ClusterPub* mine = &cx.pub[ph];
    if (threadIdx.x == 0) {
        for (int i = 0; i < NM; ++i) mine->m[i] = m[i];
        for (int i = 0; i < NS; ++i) mine->s[i] = s[i];
        for (int i = 0; i < NK; ++i) mine->k[i] = k[i];
    }
    ARMADA_BAR_HOOK();
    cl.sync();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        ArgMin mm[NM > 0 ? NM : 1];
        long long ss[NS > 0 ? NS : 1];
        unsigned long long kk[NK > 0 ? NK : 1];
        for (int i = 0; i < NM; ++i) mm[i] = ArgMin{ARMADA_INF, ARMADA_BIGI, 0};
        for (int i = 0; i < NS; ++i) ss[i] = 0;
        for (int i = 0; i < NK; ++i) kk[i] = ~0ull;
        if (lane < cx.S) {
            const ClusterPub* r = cl.map_shared_rank(mine, lane);
            for (int i = 0; i < NM; ++i) mm[i] = r->m[i];
            for (int i = 0; i < NS; ++i) ss[i] = r->s[i];
            for (int i = 0; i < NK; ++i) kk[i] = r->k[i];
        }
        for (int off = 16; off > 0; off >>= 1) {
            for (int i = 0; i < NM; ++i) {
                ArgMin o;
                o.v = __shfl_xor_sync(0xffffffffu, mm[i].v, off);
                o.i = __shfl_xor_sync(0xffffffffu, mm[i].i, off);
                o.extra = __shfl_xor_sync(0xffffffffu, mm[i].extra, off);
                mm[i] = argmin_pick(mm[i], o);
            }
            for (int i = 0; i < NS; ++i) ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
            for (int i = 0; i < NK; ++i) {
                const unsigned long long o = __shfl_xor_sync(0xffffffffu, kk[i], off);
                if (o < kk[i]) kk[i] = o;
            }
        }
        if (lane == 0) {
            for (int i = 0; i < NM; ++i) cx.comb.m[i] = mm[i];
            for (int i = 0; i < NS; ++i) cx.comb.s[i] = ss[i];
            for (int i = 0; i < NK; ++i) cx.comb.k[i] = kk[i];
            cx.phase = ph ^ 1;
        }
    }
    ARMADA_SYNC();
    for (int i = 0; i < NM; ++i) m[i] = cx.comb.m[i];
    for (int i = 0; i < NS; ++i) s[i] = cx.comb.s[i];
    for (int i = 0; i < NK; ++i) k[i] = cx.comb.k[i];
#ifdef ROUND_STEP_PROFILE
    prof_begin(prof_was);
#endif
}

// A node pass's CTA partial (valid in warp 0) combined with the cluster's
// (the single-commit pass's one exchange): thread 0 publishes it, every
// thread of the cluster passes one cluster barrier, and warp 0 reads the S
// partials through distributed shared memory.  Warp 0 ends with the
// cluster's answer; the other warps pass through, since only warp 0
// commits.  The publish buffers alternate as in cluster_combine.
static __device__ void cluster_part(ClusterX& cx, NodePart& t) {
    cg::cluster_group cl = cg::this_cluster();
#ifdef ROUND_STEP_PROFILE
    const int prof_was = prof_section();
#endif
    PROF_BEGIN(PS_CLUSTER);
    int ph = 0;
    if (threadIdx.x < 32) {
        ph = cx.phase;
        if (threadIdx.x == 0) {
            ClusterPub* mine = &cx.pub[ph];
            mine->m[0] = t.c;
            mine->m[1] = t.l;
            mine->s[0] = t.sc;
            mine->s[1] = t.sl;
        }
    }
    ARMADA_BAR_HOOK();
    cl.sync();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        NodePart r = npart_empty();
        if (lane < cx.S) {
            const ClusterPub* o = cl.map_shared_rank(&cx.pub[ph], lane);
            r.c = o->m[0];
            r.l = o->m[1];
            r.sc = o->s[0];
            r.sl = o->s[1];
        }
        t = npart_warp(r);
        if (lane == 0) cx.phase = ph ^ 1;
    }
#ifdef ROUND_STEP_PROFILE
    prof_begin(prof_was);
#endif
}

__device__ __forceinline__ int gq_at(const RoundArgs& a, long long idx) {
    if (idx < 0) idx = 0;
    if (idx > a.G - 1) idx = a.G - 1;
    return a.gq_gang[idx];
}

// The first parked (undecided) window entry of queue q at or after index i,
// SKIP_WINDOW if none; the window starts at the iteration's head before its
// skip (q_head - q_nskip).
static __device__ int next_parked(const RoundArgs& a, int q, int i, int* gang) {
    const int len = a.q_len[q], start = a.q_start[q];
    const int head0 = a.q_head[q] - a.q_nskip[q];
    for (; i < SKIP_WINDOW; ++i) {
        const int off = head0 + i;
        if (off >= len) break;
        const int gg = gq_at(a, (long long)start + off);
        const int kk = a.g_key[gg];
        if (!(a.g_state[gg] != 0 || (kk >= 0 && a.key_bad[kk]))) {
            *gang = gg;
            return i;
        }
    }
    return SKIP_WINDOW;
}

// itemSize of prefer-large: the gang's unweighted DRF cost times its
// queue's weight.
static __device__ __forceinline__ float gang_size(const RoundArgs& a, int g) {
    float x[MAX_R];
    const float cardf = (float)a.g_card[g];
    for (int r = 0; r < a.R; ++r) x[r] = __fmul_rn(a.g_req[(long long)g * a.R + r], cardf);
    return __fmul_rn(drf_unweighted(x, a.total_pool, a.drf_mult, a.R), a.q_weight[a.g_queue[g]]);
}

// The extension: after the head placed in a non-market round with no
// queue's window exhausted, commit the longest prefix of the next
// commit_k - 1 queue heads that provably equals the next sequential steps.
// Every thread of the block calls it.  State is the head's post-commit one.
template <class X, bool CL>
static __device__ void extension(const RoundArgs& a, LoopShared& sh, X& ext, ClusterX& cx) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int R = a.R, N = a.N, W = a.W;
    const long long NR = (long long)N * R;
    const int E = a.commit_k - 1;

    // (1) the next E queues by (order key, queue) after the head: successive
    // warp-wide argmins strictly after the previous pick, which is the
    // stable top-K; a key that is not below INF ends the batch
    if (warp == 0) {
        float pv = a.okey[sh.qstar];
        int pq = sh.qstar, m = 0;
        for (int e = 0; e < E; ++e) {
            float bv = ARMADA_INF;
            int bq = ARMADA_BIGI;
            for (int li = lane; li < sh.nlive; li += 32) {
                const int q = a.live_q[li];
                const float v = a.okey[q];
                if ((v > pv || (v == pv && q > pq)) && argmin_less(v, q, bv, bq)) {
                    bv = v;
                    bq = q;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
                const int oq = __shfl_xor_sync(0xffffffffu, bq, off);
                if (argmin_less(ov, oq, bv, bq)) {
                    bv = ov;
                    bq = oq;
                }
            }
            if (!(bv < ARMADA_INF)) break;
            if (lane == 0) {
                ext.q[e] = bq;
                ext.keyv[e] = bv;
            }
            pv = bv;
            pq = bq;
            m = e + 1;
        }
        if (lane == 0) ext.m = m;
    }
    ARMADA_SYNC();
    const int m = ext.m;

    // (3) each pick's head gang and eligibility: unbanned, non-evictee,
    // type-insensitive singles
    if (tid < m) {
        const int e = tid, q = ext.q[e];
        const int g = gq_at(a, (long long)a.q_start[q] + a.q_head[q]);
        const int card = a.g_card[g], key = a.g_key[g];
        ext.g[e] = g;
        ext.level[e] = a.g_level[g];
        ext.key[e] = key;
        ext.pc[e] = a.g_pc[g];
        bool elig = card == 1 && a.g_run[g] < 0 && a.g_ban_row[g] == 0;
        if (a.TR > 1 && key >= 0 && a.key_type_row[key] != 0) elig = false;
        ext.elig[e] = elig;
        for (int r = 0; r < R; ++r) {
            const float req = a.g_req[(long long)g * R + r];
            ext.req[e][r] = req;
            ext.reqn[e][r] = __fmul_rn(req, a.node_axes[r]);
            ext.flt[e][r] = __fmul_rn(__fmul_rn(req, __fsub_rn(1.0f, a.node_axes[r])), (float)card);
        }
    }
    // (5) the next candidate of batch queue k (the first undecided window
    // entry past its head) and its proposed cost after queue k commits; a
    // window that ends before the queue's tail proves nothing (-INF)
    for (int k = tid; k <= m; k += blockDim.x) {
        const int q = k == 0 ? sh.qstar : ext.q[k - 1];
        const int len = a.q_len[q], start = a.q_start[q];
        const int headn = a.q_head[q], nsk = a.q_nskip[q];
        const int head0 = headn - nsk;
        int gnext = 0;
        const int npos = next_parked(a, q, nsk + 1, &gnext);
        float nkv;
        if (npos < SKIP_WINDOW) {
            const bool next_new = a.g_run[gnext] < 0;
            const bool allowed =
                !(next_new && (sh.new_blocked || a.q_killed[q])) && a.q_weight[q] > 0.0f;
            if (allowed) {
                const int own = gq_at(a, (long long)start + headn);  // queue k's committed gang
                const float cardf = (float)a.g_card[gnext];
                float x[MAX_R];
                for (int r = 0; r < R; ++r) {
                    const float o = k == 0 ? 0.0f : a.g_req[(long long)own * R + r];
                    x[r] = __fadd_rn(__fadd_rn(__fadd_rn(a.q_alloc[q * R + r], o), a.q_penalty[q * R + r]),
                                     __fmul_rn(a.g_req[(long long)gnext * R + r], cardf));
                }
                nkv = drf_weighted(x, a.total_pool, a.drf_mult, a.q_weight[q], R);
            } else {
                nkv = ARMADA_INF;
            }
        } else {
            nkv = head0 + SKIP_WINDOW - 1 >= len ? ARMADA_INF : -ARMADA_INF;
        }
        ext.qk[k] = q;
        ext.nk[k] = nkv;
    }
    ARMADA_SYNC();

    // (4) caps, burst, floating capacity and the iteration bound in commit
    // order, with the sequential f32 accumulation; (5) no earlier batch
    // queue's next candidate precedes the pick
    if (tid == 0) {
        float run_res[MAX_R], run_flt[MAX_R];
        for (int r = 0; r < R; ++r) {
            run_res[r] = a.sched_res[r];
            run_flt[r] = a.float_used[r];
        }
        int mo = 0;
        for (int e = 0; e < m; ++e) {
            const int q = ext.q[e], pc = ext.pc[e];
            bool ok = ext.elig[e] != 0;
            for (int r = 0; r < R; ++r) {
                run_res[r] = __fadd_rn(run_res[r], ext.req[e][r]);
                run_flt[r] = __fadd_rn(run_flt[r], ext.flt[e][r]);
                ok &= run_res[r] <= a.round_cap[r];
                ok &= run_flt[r] <= __fadd_rn(a.float_total[r], 1e-3f);
                ok &= __fadd_rn(a.q_alloc_pc[((long long)q * a.C + pc) * R + r], ext.req[e][r]) <=
                      a.pc_queue_cap[pc * R + r];
            }
            ok &= (long long)sh.sched_count + e + 1 <= *a.global_burst;
            ok &= (long long)sh.iterations + 1 + e < a.max_iter;
            ok &= (long long)a.q_sched[q] + 1 <= a.perq_burst[q];
            const float kv = ext.keyv[e];
            for (int k = 0; k <= e; ++k) ok &= ext.nk[k] > kv || (ext.nk[k] == kv && ext.qk[k] > q);
            if (!ok) break;
            mo = e + 1;
        }
        ext.m_ok = mo;
    }
    ARMADA_SYNC();
    const int mo = ext.m_ok;
    if (mo == 0) return;

    // (6) each pick's node against the post-head state: one sweep over the
    // nodes per EXT_CHUNK picks, a running minimum of pick_key per pick (the
    // CTA's node range in the sharded round, its minima combined across the
    // cluster: the key's low bits are the node index, so the least key is
    // the global choice)
    const int n0 = CL ? sh.n0 : 0, n1 = CL ? sh.n1 : N;
    for (int c0 = 0; c0 < mo; c0 += EXT_CHUNK) {
        const int cn = min(EXT_CHUNK, mo - c0);
        unsigned long long best[EXT_CHUNK];
#pragma unroll
        for (int i = 0; i < EXT_CHUNK; ++i) best[i] = ~0ull;
        for (int n = n0 + tid; n < n1; n += blockDim.x) {
            if (!a.node_ok[n]) continue;
            const int ty = a.node_type[n];
            const float* row0 = a.alloc + (long long)n * R;
            float s0 = 0.0f;
            bool have_s0 = false;
#pragma unroll
            for (int i = 0; i < EXT_CHUNK; ++i) {
                if (i < cn) {
                    const int e = c0 + i;
                    const int key = ext.key[e];
                    if (key < 0 || a.compat[(long long)key * a.T + ty]) {
                        if (fits_row(row0, ext.reqn[e], R)) {
                            if (!have_s0) {
                                s0 = packing_score(row0, a.inv_scale, R);
                                have_s0 = true;
                            }
                            const unsigned long long c = pick_key(0u, s0, n);
                            if (c < best[i]) best[i] = c;
                        } else {
                            const float* rowl = a.alloc + (long long)ext.level[e] * NR + (long long)n * R;
                            if (fits_row(rowl, ext.reqn[e], R)) {
                                const unsigned long long c =
                                    pick_key(1u, packing_score(rowl, a.inv_scale, R), n);
                                if (c < best[i]) best[i] = c;
                            }
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < EXT_CHUNK; ++i) {
            unsigned long long v = best[i];
            for (int off = 16; off > 0; off >>= 1) {
                const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
                if (o < v) v = o;
            }
            if (lane == 0) ext.red[warp][i] = v;
        }
        ARMADA_SYNC();
        if (CL) {
            if (tid < cn) {
                unsigned long long v = ~0ull;
                const int nw = (blockDim.x + 31) >> 5;
                for (int w = 0; w < nw; ++w)
                    if (ext.red[w][tid] < v) v = ext.red[w][tid];
                ext.kmin[tid] = v;
            }
            ARMADA_SYNC();
            unsigned long long kk[EXT_CHUNK];
            for (int i = 0; i < EXT_CHUNK; ++i) kk[i] = i < cn ? ext.kmin[i] : ~0ull;
            cluster_combine<0, 0, EXT_CHUNK>(cx, nullptr, nullptr, kk);
            if (tid < cn) {
                const unsigned long long v = cx.comb.k[tid];
                const int e = c0 + tid;
                const bool found = v != ~0ull;
                ext.found[e] = found;
                ext.node[e] = found ? (int)(v & 0x7fffffffull) : 0;
                ext.lvl_sel[e] = found && (v >> 63) ? ext.level[e] : 0;
            }
        } else if (tid < cn) {
            unsigned long long v = ~0ull;
            const int nw = (blockDim.x + 31) >> 5;
            for (int w = 0; w < nw; ++w)
                if (ext.red[w][tid] < v) v = ext.red[w][tid];
            const int e = c0 + tid;
            const bool found = v != ~0ull;
            ext.found[e] = found;
            ext.node[e] = found ? (int)(v & 0x7fffffffull) : 0;
            ext.lvl_sel[e] = found && (v >> 63) ? ext.level[e] : 0;
        }
        ARMADA_SYNC();
    }

    // (7) pick e against the cumulative deltas of the earlier picks at pick
    // j's node: its clean fit there (flip0), and its fit and packing score
    // at its selection level there (adj_fit, adj_score)
    for (long long t = tid; t < (long long)mo * mo; t += blockDim.x) {
        const int e = (int)(t / mo), j = (int)(t % mo);
        if (j > e) continue;
        const int nj = ext.node[j], key = ext.key[e], ls = ext.lvl_sel[e];
        const bool okn =
            (key < 0 || a.compat[(long long)key * a.T + a.node_type[nj]]) && a.node_ok[nj];
        const float* r0 = a.alloc + (long long)nj * R;
        const float* rs = a.alloc + (long long)ls * NR + (long long)nj * R;
        float c0[MAX_R], cs[MAX_R];
        for (int r = 0; r < R; ++r) c0[r] = cs[r] = 0.0f;
        for (int k = 0; k < e; ++k) {
            if (ext.node[k] != nj) continue;
            for (int r = 0; r < R; ++r) c0[r] = __fadd_rn(c0[r], ext.reqn[k][r]);
            if (ls <= ext.level[k])
                for (int r = 0; r < R; ++r) cs[r] = __fadd_rn(cs[r], ext.reqn[k][r]);
        }
        float adj0[MAX_R], adjs[MAX_R];
        for (int r = 0; r < R; ++r) {
            adj0[r] = __fsub_rn(r0[r], c0[r]);
            adjs[r] = __fsub_rn(rs[r], cs[r]);
        }
        ext.flip0[e][j] = okn && fits_row(r0, ext.reqn[e], R) && !fits_row(adj0, ext.reqn[e], R);
        ext.adj_fit[e][j] = okn && fits_row(adjs, ext.reqn[e], R);
        ext.adj_score[e][j] = packing_score(adjs, a.inv_scale, R);
    }
    ARMADA_SYNC();

    // (8) the certified prefix, and (9) its commit in pick order
    if (tid == 0) {
        int n_ext = 0;
        for (int e = 0; e < mo; ++e) {
            if (!ext.found[e] || !ext.adj_fit[e][e]) break;
            const float ss = ext.adj_score[e][e];
            const int ne = ext.node[e];
            bool ok = true;
            for (int j = 0; j < e && ok; ++j) {
                bool conflict = ext.flip0[e][j] != 0;
                if (ext.node[j] != ne) {
                    const float sj = ext.adj_score[e][j];
                    conflict |= ext.adj_fit[e][j] && (sj < ss || (sj == ss && ext.node[j] < ne));
                }
                ok = !conflict;
            }
            if (!ok) break;
            n_ext = e + 1;
        }
        for (int e = 0; e < n_ext; ++e) {
            const int node = ext.node[e], q = ext.q[e], g = ext.g[e], pc = ext.pc[e];
            for (int l = 0; l <= ext.level[e] && l < a.P1; ++l)
                for (int r = 0; r < R; ++r) {
                    float* p = a.alloc + (long long)l * NR + (long long)node * R + r;
                    *p = __fsub_rn(*p, ext.reqn[e][r]);
                }
            for (int r = 0; r < R; ++r) {
                const float req = ext.req[e][r];
                a.q_alloc[q * R + r] = __fadd_rn(a.q_alloc[q * R + r], req);
                float* pp = a.q_alloc_pc + ((long long)q * a.C + pc) * R + r;
                *pp = __fadd_rn(*pp, req);
                a.sched_res[r] = __fadd_rn(a.sched_res[r], req);
                a.float_used[r] = __fadd_rn(a.float_used[r], ext.flt[e][r]);
                a.spot_res[r] = __fadd_rn(a.spot_res[r], req);
            }
            a.q_sched[q] += 1;
            a.g_state[g] = 1;
            const int cur = sh.cursor + e;
            if (cur < a.S) {
                a.slot_gang[cur] = g;
                for (int w = 0; w < W; ++w) {
                    a.slot_nodes[(long long)cur * W + w] = w == 0 ? node : N;
                    a.slot_counts[(long long)cur * W + w] = w == 0 ? 1 : 0;
                }
            }
        }
        sh.cursor += n_ext;
        sh.sched_count += n_ext;
        sh.n_ext = n_ext;
    }
}

// --- K11: the per-key fit cache ------------------------------------------------
//
// (fair_scheduler.py:515-600, :1017-1079; plain version `_FitCache`.)  Slot
// s = key % CS holds one (key, level, request)'s fit rows at the clean
// level and at its own level, in global memory (L2-resident at the
// reference scale: ~7.8 MB at CS = 64, N = 57,344), and their block minima
// over blocks of CB nodes; cscore holds every level's packing score.  A
// hit reads NB = N / CB block minima and one block of CB nodes instead of
// the node pass.  The tables are exact: a miss refills the slot from one
// node pass, and after every commit the touched nodes' scores, every
// slot's fit bits there and the touched blocks' minima are re-derived.

// A hit's pick over the CTA's blocks [b0, b1) of one slot row: the first
// block attaining the least block minimum, then the first node attaining it
// inside the block; (INF, BIGI) when no block holds a fit.  The sharded round
// combines the CTAs' picks: the blocks tile each CTA's node range, so the
// least (score, node) over the CTAs is the unsharded pick.
static __device__ ArgMin cached_hit_range(const RoundArgs& a, int s, const float* bm, const u8* fitc,
                                          const float* score, int b0, int b1, ArgMin* red) {
    const int tid = threadIdx.x;
    const int CB = a.CB;
    ArgMin b{ARMADA_INF, ARMADA_BIGI, 0};
    for (int i = b0 + tid; i < b1; i += blockDim.x) b = argmin_pick(b, ArgMin{bm[i], i, 0});
    b = block_argmin(b, red);
    const bool found = b.v < ARMADA_INF;
    const int lo = (found ? b.i : b0) * CB;
    ArgMin j{ARMADA_INF, ARMADA_BIGI, 0};
    if (tid < CB) {
        const int n = lo + tid;
        j = ArgMin{fitc[(long long)s * a.N + n] ? score[n] : ARMADA_INF, n, 0};
    }
    j = block_argmin(j, red);
    return found ? ArgMin{j.v, j.i, 0} : ArgMin{ARMADA_INF, ARMADA_BIGI, 0};
}

// The cached pick of a cacheable single; every thread calls it.
template <bool CL>
static __device__ void cached_pick(const RoundArgs& a, LoopShared& sh, int* nodes_w, int* counts_w,
                                   ArgMin* red, ClusterX& cx) {
    const int tid = threadIdx.x;
    const int R = a.R, N = a.N, CB = a.CB, NB = N / CB;
    const long long NR = (long long)N * R;
    const int n0 = CL ? sh.n0 : 0, n1 = CL ? sh.n1 : N;
    if (tid == 0) {
        const int s = sh.key % a.CS;
        bool hit = a.cslot_key[s] == sh.key && a.cslot_lvl[s] == sh.level;
        for (int r = 0; r < R; ++r) hit &= a.cslot_req[s * R + r] == sh.req_node[r];
        sh.cslot = s;
        sh.chit = hit;
        if (hit) ++sh.nhits;
        else ++sh.nmisses;
    }
    ARMADA_SYNC();
    const int s = sh.cslot, level = sh.level;
    const u8* fitc;
    const float* score;
    ArgMin b{ARMADA_INF, ARMADA_BIGI, 0};
    if (CL && sh.chit) {
        // the clean level's pick, and the slot's level's when no node fits
        // clean anywhere in the cluster
        b = cached_hit_range(a, s, a.bmc_clean + (long long)s * NB, a.fitc_clean, a.cscore, n0 / CB,
                             n1 / CB, red);
        cluster_combine<1, 0, 0>(cx, &b, nullptr, nullptr);
        if (!(b.v < ARMADA_INF)) {
            b = cached_hit_range(a, s, a.bmc_lvl + (long long)s * NB, a.fitc_lvl,
                                 a.cscore + (long long)level * N, n0 / CB, n1 / CB, red);
            cluster_combine<1, 0, 0>(cx, &b, nullptr, nullptr);
        }
    } else if (sh.chit) {
        // the first block attaining the least block minimum, clean level
        // first, then the first node attaining it inside the block
        const float* bm0 = a.bmc_clean + (long long)s * NB;
        for (int i = tid; i < NB; i += blockDim.x) b = argmin_pick(b, ArgMin{bm0[i], i, 0});
        b = block_argmin(b, red);
        fitc = a.fitc_clean;
        score = a.cscore;
        if (!(b.v < ARMADA_INF)) {
            const float* bml = a.bmc_lvl + (long long)s * NB;
            b = ArgMin{ARMADA_INF, ARMADA_BIGI, 0};
            for (int i = tid; i < NB; i += blockDim.x) b = argmin_pick(b, ArgMin{bml[i], i, 0});
            b = block_argmin(b, red);
            fitc = a.fitc_lvl;
            score = a.cscore + (long long)level * N;
        }
        const bool found = b.v < ARMADA_INF;
        const int lo = (found ? b.i : 0) * CB;
        ArgMin j{ARMADA_INF, ARMADA_BIGI, 0};
        if (tid < CB) {
            const int n = lo + tid;
            j = ArgMin{fitc[(long long)s * N + n] ? score[n] : ARMADA_INF, n, 0};
        }
        j = block_argmin(j, red);
        b = found ? ArgMin{j.v, j.i, 0} : ArgMin{ARMADA_INF, ARMADA_BIGI, 0};
    } else {
        // a miss: one node pass fills the slot's rows and takes the pick
        const int key = sh.key;
        const float* al0 = a.alloc;
        const float* all = a.alloc + (long long)level * NR;
        u8* fc_row = a.fitc_clean + (long long)s * N;
        u8* fl_row = a.fitc_lvl + (long long)s * N;
        const float* sc0 = a.cscore;
        const float* scl = a.cscore + (long long)level * N;
        ArgMin bc{ARMADA_INF, ARMADA_BIGI, 0}, bl{ARMADA_INF, ARMADA_BIGI, 0};
        for (int n = n0 + tid; n < n1; n += blockDim.x) {
            const bool ok = a.compat[(long long)key * a.T + a.node_type[n]] && a.node_ok[n];
            const bool fc = ok && fits_row(al0 + (long long)n * R, sh.req_node, R);
            const bool fl = ok && fits_row(all + (long long)n * R, sh.req_node, R);
            fc_row[n] = fc;
            fl_row[n] = fl;
            if (fc) bc = argmin_pick(bc, ArgMin{sc0[n], n, 0});
            if (fl) bl = argmin_pick(bl, ArgMin{scl[n], n, 0});
        }
        bc = block_argmin(bc, red);
        bl = block_argmin(bl, red);
        if (CL) {
            ArgMin m2[2] = {bc, bl};
            cluster_combine<2, 0, 0>(cx, m2, nullptr, nullptr);
            bc = m2[0];
            bl = m2[1];
        }
        float* bm0 = a.bmc_clean + (long long)s * NB;
        float* bml = a.bmc_lvl + (long long)s * NB;
        for (int i = n0 / CB + tid; i < n1 / CB; i += blockDim.x) {
            float m0 = ARMADA_INF, ml = ARMADA_INF;
            for (int k = 0; k < CB; ++k) {
                const int n = i * CB + k;
                if (fc_row[n] && sc0[n] < m0) m0 = sc0[n];
                if (fl_row[n] && scl[n] < ml) ml = scl[n];
            }
            bm0[i] = m0;
            bml[i] = ml;
        }
        if (tid == 0) {
            a.cslot_key[s] = key;
            a.cslot_lvl[s] = level;
            for (int r = 0; r < R; ++r) a.cslot_req[s * R + r] = sh.req_node[r];
        }
        b = bc.v < ARMADA_INF ? bc : bl;
    }
    if (tid == 0) {
        const bool found = b.v < ARMADA_INF;
        for (int w = 0; w < a.W; ++w) {
            nodes_w[w] = N;
            counts_w[w] = 0;
        }
        nodes_w[0] = found ? b.i : N;
        counts_w[0] = found ? 1 : 0;
        sh.fit_feasible = found;
    }
    ARMADA_SYNC();
}

// The cache's upkeep after a step's commits: the touched nodes are the
// head's spread (nodes_w, N = unused) and the multi-commit picks
// (ext.node[0, n_ext)).  Every thread calls it.
// The sharded round keeps only its own node range's rows (n0, n1).
static __device__ void cache_upkeep(const RoundArgs& a, const int* nodes_w, const int* ext_node,
                                    int n_ext, int n0, int n1) {
    const int tid = threadIdx.x;
    const int R = a.R, N = a.N, W = a.W, CB = a.CB, NB = N / CB, CS = a.CS;
    const long long NR = (long long)N * R;
    const int T = W + n_ext;
    // (1) every level's score at the touched nodes
    for (int i = tid; i < T * a.P1; i += blockDim.x) {
        const int t = i / a.P1, l = i % a.P1;
        const int n = t < W ? nodes_w[t] : ext_node[t - W];
        if (n >= N || n < n0 || n >= n1) continue;
        a.cscore[(long long)l * N + n] = packing_score(a.alloc + l * NR + (long long)n * R, a.inv_scale, R);
    }
    // (2) every slot's fit bits there
    for (int i = tid; i < CS * T; i += blockDim.x) {
        const int sl = i / T, t = i % T;
        const int n = t < W ? nodes_w[t] : ext_node[t - W];
        if (n >= N || n < n0 || n >= n1) continue;
        const int key = a.cslot_key[sl];
        const float* req = a.cslot_req + sl * R;
        const bool ok = key >= 0 && a.compat[(long long)key * a.T + a.node_type[n]] && a.node_ok[n];
        a.fitc_clean[(long long)sl * N + n] = ok && fits_row(a.alloc + (long long)n * R, req, R);
        a.fitc_lvl[(long long)sl * N + n] =
            ok && fits_row(a.alloc + a.cslot_lvl[sl] * NR + (long long)n * R, req, R);
    }
    ARMADA_SYNC();
    // (3) the touched blocks' minima, from the patched bits and scores: a
    // warp a (slot, touched node), its lanes over the block's CB <= 64
    // nodes (a minimum is exact in any order)
    const int lane = tid & 31;
    for (int i = tid >> 5; i < CS * T; i += blockDim.x >> 5) {
        const int sl = i / T, t = i % T;
        const int n = t < W ? nodes_w[t] : ext_node[t - W];
        if (n >= N || n < n0 || n >= n1) continue;
        const int blk = n / CB;
        const u8* f0 = a.fitc_clean + (long long)sl * N + (long long)blk * CB;
        const u8* fl = a.fitc_lvl + (long long)sl * N + (long long)blk * CB;
        const float* s0 = a.cscore + (long long)blk * CB;
        const float* sl_ = a.cscore + (long long)a.cslot_lvl[sl] * N + (long long)blk * CB;
        float m0 = ARMADA_INF, ml = ARMADA_INF;
        for (int k = lane; k < CB; k += 32) {
            if (f0[k] && s0[k] < m0) m0 = s0[k];
            if (fl[k] && sl_[k] < ml) ml = sl_[k];
        }
        for (int off = 16; off > 0; off >>= 1) {
            m0 = fminf(m0, __shfl_xor_sync(FULL_MASK, m0, off));
            ml = fminf(ml, __shfl_xor_sync(FULL_MASK, ml, off));
        }
        if (lane == 0) {
            a.bmc_clean[(long long)sl * NB + blk] = m0;
            a.bmc_lvl[(long long)sl * NB + blk] = ml;
        }
    }
    ARMADA_SYNC();
}

// --- K11: the certified pick chain (batch_k > 1) ----------------------------------
//
// (fair_scheduler.py:1081-1480; plain version `_pick_chain` and
// `_commit_chain`.)  After the head placed, replay the sequential loop's
// next batch_k - 1 steps on [Q] state -- each live queue's simulated order
// key and window position -- against the post-head state, and commit the
// prefix it can prove.  Each sub-pick is one block argmin over the live
// queues, one node pass (or, for the same key, level, bans and request as
// the previous pick, a pass over the rows that pick stored), and scalar
// checks on thread 0 against the earlier picks' deltas at their nodes.
struct ChainBase {
    int n;  // picks proven so far
    // the running state after the picks
    int r_count, r_iter;
    float r_res[MAX_R], r_float[MAX_R], r_spot_res[MAX_R], r_spot;
    // the current sub-pick
    int stop, qj, ij, cg, ev, lvl, pc_j, key, ban, run_j, trow, match, node_j;
    float cur_req[MAX_R], cur_reqn[MAX_R], cur_flt[MAX_R];
    // the row cache: the rows in bk_* belong to (key, level, ban, request)
    int rc_valid, rc_key, rc_lvl, rc_ban;
    long long rc_n0;
    float rc_req[MAX_R];
};

struct ChainShared : ChainBase {
    int q[MAX_CHAIN], g[MAX_CHAIN], node[MAX_CHAIN], lo[MAX_CHAIN], level[MAX_CHAIN];
    int pc[MAX_CHAIN], run[MAX_CHAIN];
    float req[MAX_CHAIN][MAX_R], reqn[MAX_CHAIN][MAX_R], flt[MAX_CHAIN][MAX_R];
};

struct ChainWide : ChainBase {
    int *q, *g, *node, *lo, *level, *pc, *run;
    float (*req)[MAX_R], (*reqn)[MAX_R], (*flt)[MAX_R];
};

// Point the wide tables at the lane's scratch (one thread, before the loop).
static __device__ void wide_bind(const RoundArgs& a, ExtWide& ext, ChainWide& ch) {
    int* ip = a.wide_i;
    float* fp = a.wide_f;
    u8* bp = a.wide_b;
    if (a.commit_k > MAX_COMMIT_K) {
        const long long E = a.commit_k - 1;
        ext.q = ip; ext.g = ip + E; ext.level = ip + 2 * E; ext.key = ip + 3 * E;
        ext.pc = ip + 4 * E; ext.elig = ip + 5 * E; ext.node = ip + 6 * E;
        ext.lvl_sel = ip + 7 * E; ext.found = ip + 8 * E; ext.qk = ip + 9 * E;
        ext.keyv = fp; ext.nk = fp + E;
        ext.req = (float (*)[MAX_R])(fp + 2 * E + 1);
        ext.reqn = ext.req + E;
        ext.flt = ext.reqn + E;
        ext.adj_score = Mat<float>{fp + 2 * E + 1 + 3 * E * MAX_R, E};
        ext.flip0 = Mat<u8>{bp, E};
        ext.adj_fit = Mat<u8>{bp + E * E, E};
    } else if (a.batch_k > MAX_BATCH_K) {
        const long long E = a.batch_k - 1;
        ch.q = ip; ch.g = ip + E; ch.node = ip + 2 * E; ch.lo = ip + 3 * E;
        ch.level = ip + 4 * E; ch.pc = ip + 5 * E; ch.run = ip + 6 * E;
        ch.req = (float (*)[MAX_R])fp;
        ch.reqn = ch.req + E;
        ch.flt = ch.reqn + E;
    }
}

// Queue q's simulated order key with its next candidate at window index
// npos (gang gn), after sim_row.
static __device__ float sim_key(const RoundArgs& a, const LoopShared& sh, bool market, int q,
                                int npos, int gn) {
    if (npos >= SKIP_WINDOW) {
        const int head0 = a.q_head[q] - a.q_nskip[q];
        return head0 + SKIP_WINDOW - 1 >= a.q_len[q] ? ARMADA_INF : -ARMADA_INF;
    }
    const bool allowed = !(a.g_run[gn] < 0 && (sh.new_blocked || a.q_killed[q])) && a.q_weight[q] > 0.0f;
    if (!allowed) return ARMADA_INF;
    if (market) return -a.g_price[gn];
    const int R = a.R;
    const float cardf = (float)a.g_card[gn];
    float x[MAX_R];
    for (int r = 0; r < R; ++r)
        x[r] = __fadd_rn(__fadd_rn(a.sim_row[q * R + r], a.q_penalty[q * R + r]),
                         __fmul_rn(a.g_req[(long long)gn * R + r], cardf));
    return drf_weighted(x, a.total_pool, a.drf_mult, a.q_weight[q], R);
}

// The earlier picks' requests committed at (lvl, node), summed in pick order.
template <class CH>
static __device__ __forceinline__ void chain_adjusted(const RoundArgs& a, const CH& ch, int node,
                                                     int lvl, float* out) {
    const int R = a.R;
    float d[MAX_R];
    for (int r = 0; r < R; ++r) d[r] = 0.0f;
    for (int k = 0; k < ch.n; ++k)
        if (ch.node[k] == node && ch.lo[k] <= lvl && lvl <= ch.level[k])
            for (int r = 0; r < R; ++r) d[r] = __fadd_rn(d[r], ch.reqn[k][r]);
    const float* row = a.alloc + ((long long)lvl * a.N + node) * R;
    for (int r = 0; r < R; ++r) out[r] = __fsub_rn(row[r], d[r]);
}

// The sub-pick's static and dynamic fit at node nd and level lvl (0: the
// clean level), as its node pass computed them into bk_fit0 / bk_fitl: the
// sharded round holds those rows for its own nodes only, and thread 0 needs
// them at the earlier picks' nodes, wherever they lie.
template <class CH>
static __device__ __forceinline__ bool chain_fit(const RoundArgs& a, const CH& ch, int nd, int lvl) {
    const int key = ch.key;
    const bool okn = (key < 0 || a.compat[(long long)key * a.T + a.node_type[nd]]) && a.node_ok[nd] &&
                     !a.ban_mask[(long long)ch.ban * a.N + nd];
    return okn && fits_row(a.alloc + ((long long)lvl * a.N + nd) * a.R, ch.cur_reqn, a.R);
}

template <bool HET, class CH, bool CL>
static __device__ void pick_chain(const RoundArgs& a, LoopShared& sh, CH& ch, QPick* redq,
                                  NodePart* npart, ClusterX& cx) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int R = a.R, N = a.N, W = a.W;
    const long long NR = (long long)N * R;
    const int E = a.batch_k - 1;
    const bool market = *a.market != 0;

    // the simulation's start: every live queue's next order key
    for (int li = tid; li < sh.nlive; li += blockDim.x) {
        const int q = a.live_q[li];
        for (int r = 0; r < R; ++r) a.sim_row[q * R + r] = a.q_alloc[q * R + r];
        const int pos = min(a.q_nskip[q], SKIP_WINDOW - 1);
        int gn = 0;
        const int sp = next_parked(a, q, q == sh.qstar ? min(pos + 1, SKIP_WINDOW) : pos, &gn);
        a.simpos[q] = sp;
        a.sim_keys[q] = sim_key(a, sh, market, q, sp, gn);
    }
    if (tid == 0) {
        ch.n = 0;
        ch.stop = 0;
        ch.rc_valid = 0;
        ch.r_count = sh.sched_count;
        ch.r_iter = sh.iterations + 1;
        for (int r = 0; r < R; ++r) {
            ch.r_res[r] = a.sched_res[r];
            ch.r_float[r] = a.float_used[r];
            ch.r_spot_res[r] = a.spot_res[r];
        }
        ch.r_spot = *a.spot_price;
    }
    ARMADA_SYNC();

    for (int k = 0; k < E; ++k) {
        // (1) the simulated queue pick: the least key, ties to the lower queue
        QPick best{ARMADA_INF, 0.0f, ARMADA_BIGI, 0};
        for (int li = tid; li < sh.nlive; li += blockDim.x) {
            const int q = a.live_q[li];
            const QPick c{a.sim_keys[q], 0.0f, q, 0};
            if (qpick_less(c, best)) best = c;
        }
        best = block_qpick(best, redq);
        // (2) the pick's gang, its gates, and for an evictee its pinned fit
        if (tid == 0) {
            bool ok = best.q != ARMADA_BIGI && best.v < ARMADA_INF;
            const int qj = ok ? best.q : 0;
            const int ij = ok ? a.simpos[qj] : SKIP_WINDOW;
            ok = ok && ij < SKIP_WINDOW && ch.r_iter < a.max_iter;
            int g = 0;
            if (ok) {
                g = gq_at(a, (long long)a.q_start[qj] + a.q_head[qj] - a.q_nskip[qj] + ij);
                ok = a.g_card[g] == 1;
            }
            if (ok) {
                ch.qj = qj;
                ch.ij = ij;
                ch.cg = g;
                const int run = a.g_run[g];
                ch.ev = run >= 0;
                ch.run_j = run;
                ch.lvl = a.g_level[g];
                ch.pc_j = a.g_pc[g];
                ch.key = a.g_key[g];
                ch.ban = a.g_ban_row[g];
                ch.trow = HET && ch.key >= 0 ? a.key_type_row[ch.key] : 0;
                for (int r = 0; r < R; ++r) {
                    const float req = a.g_req[(long long)g * R + r];
                    ch.cur_req[r] = req;
                    ch.cur_reqn[r] = __fmul_rn(req, a.node_axes[r]);
                    ch.cur_flt[r] = __fmul_rn(__fmul_rn(req, __fsub_rn(1.0f, a.node_axes[r])), 1.0f);
                }
                if (ch.ev) {
                    const int pin = a.run_node[run];
                    float adj[MAX_R];
                    chain_adjusted(a, ch, pin, ch.lvl, adj);
                    ok = fits_row(adj, ch.cur_reqn, R) && a.node_ok[pin];
                    ch.node_j = pin;
                } else {
                    int prev = 0;
                    float prev_pc[MAX_R];
                    for (int r = 0; r < R; ++r) prev_pc[r] = 0.0f;
                    for (int e = 0; e < ch.n; ++e) {
                        if (ch.q[e] != qj || ch.run[e] >= 0) continue;
                        ++prev;
                        if (ch.pc[e] == ch.pc_j)
                            for (int r = 0; r < R; ++r) prev_pc[r] = __fadd_rn(prev_pc[r], ch.req[e][r]);
                    }
                    ok = (long long)ch.r_count + 1 <= *a.global_burst &&
                         (long long)a.q_sched[qj] + prev + 1 <= a.perq_burst[qj];
                    const int pc = ch.pc_j;
                    for (int r = 0; r < R; ++r) {
                        const float req = ch.cur_req[r];
                        ok &= __fadd_rn(ch.r_res[r], req) <= a.round_cap[r];
                        ok &= __fadd_rn(__fadd_rn(a.q_alloc_pc[((long long)qj * a.C + pc) * R + r], prev_pc[r]),
                                        req) <= a.pc_queue_cap[pc * R + r];
                        ok &= __fadd_rn(ch.r_float[r], ch.cur_flt[r]) <= __fadd_rn(a.float_total[r], 1e-3f);
                    }
                    bool match = ch.rc_valid && ch.key >= 0 && ch.key == ch.rc_key && ch.lvl == ch.rc_lvl &&
                                 ch.ban == ch.rc_ban;
                    for (int r = 0; r < R; ++r) match &= ch.rc_req[r] == ch.cur_reqn[r];
                    ch.match = match;
                }
            }
            ch.stop = !ok;
        }
        ARMADA_SYNC();
        if (ch.stop) break;
        if (!ch.ev) {
            // (3) the node pass: the row cache's rows, or fresh ones, with
            // the earlier picks' nodes left out of the argmins
            const int key = ch.key, lvl = ch.lvl;
            const u8* ban = a.ban_mask + (long long)ch.ban * N;
            const float* bias = HET ? a.type_bias + (long long)ch.trow * a.T : nullptr;
            const bool match = ch.match;
            const int nprev = ch.n;
            long long n0 = 0;
            ArgMin b0{ARMADA_INF, ARMADA_BIGI, 0}, bl{ARMADA_INF, ARMADA_BIGI, 0};
            for (int n = (CL ? sh.n0 : 0) + tid; n < (CL ? sh.n1 : N); n += blockDim.x) {
                float m0, ml;
                if (match) {
                    m0 = a.bk_m0[n];
                    ml = a.bk_ml[n];
                } else {
                    const bool okn = (key < 0 || a.compat[(long long)key * a.T + a.node_type[n]]) &&
                                     a.node_ok[n] && !ban[n];
                    const float* r0 = a.alloc + (long long)n * R;
                    const float* rl = a.alloc + lvl * NR + (long long)n * R;
                    const bool f0 = okn && fits_row(r0, ch.cur_reqn, R);
                    const bool fl = okn && fits_row(rl, ch.cur_reqn, R);
                    float s0 = packing_score(r0, a.inv_scale, R);
                    float sl = packing_score(rl, a.inv_scale, R);
                    if (bias) {
                        const float bb = bias[a.node_type[n]];
                        s0 = __fadd_rn(s0, bb);
                        sl = __fadd_rn(sl, bb);
                    }
                    m0 = f0 ? s0 : ARMADA_INF;
                    ml = fl ? sl : ARMADA_INF;
                    a.bk_m0[n] = m0;
                    a.bk_ml[n] = ml;
                    a.bk_fit0[n] = f0;
                    a.bk_fitl[n] = fl;
                    n0 += f0;
                }
                bool touched = false;
                for (int e = 0; e < nprev; ++e) touched |= ch.node[e] == n;
                if (touched) continue;
                b0 = argmin_pick(b0, ArgMin{m0, n, 0});
                bl = argmin_pick(bl, ArgMin{ml, n, 0});
            }
            // the pass's three reductions in one, to warp 0 (which alone
            // reads them): warps, then warp 0 over the warps and the
            // cluster's CTAs (a match counts nothing: n0 stays 0)
            {
                NodePart p{b0, bl, n0, 0};
                p = npart_warp(p);
                if (lane == 0) npart[warp] = p;
                ARMADA_SYNC();
                const int nw = blockDim.x >> 5;
                if (warp == 0) p = npart_warp(lane < nw ? npart[lane] : npart_empty());
                if constexpr (CL) cluster_part(cx, p);
                b0 = p.c;
                bl = p.l;
                n0 = p.sc;
            }
            // (4) the clean count and the touched nodes at their adjusted
            // allocatable; the pick is the least (score, node) of both.
            // Warp 0: lane e takes earlier pick e's node at the clean level
            // and at the pick's own (both, so that neither waits on the
            // count), the lanes' counts and argmins then meet
            if (warp == 0) {
                if (lane == 0 && !match) {
                    ch.rc_valid = 1;
                    ch.rc_key = key;
                    ch.rc_lvl = lvl;
                    ch.rc_ban = ch.ban;
                    ch.rc_n0 = n0;
                    for (int r = 0; r < R; ++r) ch.rc_req[r] = ch.cur_reqn[r];
                }
                int dec = 0;
                ArgMin c0{ARMADA_INF, ARMADA_BIGI, 0}, cl{ARMADA_INF, ARMADA_BIGI, 0};
                for (int e = lane; e < nprev; e += 32) {
                    const int nd = ch.node[e];
                    bool first = true;
                    for (int f = 0; f < e; ++f) first &= ch.node[f] != nd;
                    const bool fit0 = CL ? chain_fit(a, ch, nd, 0) : a.bk_fit0[nd] != 0;
                    const bool fitl = CL ? chain_fit(a, ch, nd, lvl) : a.bk_fitl[nd] != 0;
                    float adj[MAX_R];
                    chain_adjusted(a, ch, nd, 0, adj);
                    const bool a0 = fits_row(adj, ch.cur_reqn, R);
                    dec += first && fit0 && !a0;
                    const float bnd = bias ? bias[a.node_type[nd]] : 0.0f;
                    if (a0 && fit0) {
                        float sc = packing_score(adj, a.inv_scale, R);
                        if (bias) sc = __fadd_rn(sc, bnd);
                        c0 = argmin_pick(c0, ArgMin{sc, nd, 0});
                    }
                    chain_adjusted(a, ch, nd, lvl, adj);
                    if (fits_row(adj, ch.cur_reqn, R) && fitl) {
                        float sc = packing_score(adj, a.inv_scale, R);
                        if (bias) sc = __fadd_rn(sc, bnd);
                        cl = argmin_pick(cl, ArgMin{sc, nd, 0});
                    }
                }
                for (int off = 16; off > 0; off >>= 1) {
                    dec += __shfl_xor_sync(FULL_MASK, dec, off);
                    c0 = argmin_xor(c0, off);
                    cl = argmin_xor(cl, off);
                }
                if (lane == 0) {
                    const bool use_clean = ch.rc_n0 - dec >= 1;
                    const ArgMin bb = use_clean ? argmin_pick(b0, c0) : argmin_pick(bl, cl);
                    if (bb.v < ARMADA_INF) {
                        ch.node_j = bb.i;
                    } else {
                        ch.stop = 1;
                    }
                }
            }
            ARMADA_SYNC();
            if (ch.stop) break;
        }
        // (5) record the pick and advance its queue's simulation
        if (tid == 0) {
            const int e = ch.n, qj = ch.qj, g = ch.cg;
            ch.q[e] = qj;
            ch.g[e] = g;
            ch.node[e] = ch.node_j;
            ch.lo[e] = ch.ev ? 1 : 0;
            ch.level[e] = ch.lvl;
            ch.pc[e] = ch.pc_j;
            ch.run[e] = ch.ev ? ch.run_j : -1;
            for (int r = 0; r < R; ++r) {
                ch.req[e][r] = ch.cur_req[r];
                ch.reqn[e][r] = ch.cur_reqn[r];
                ch.flt[e][r] = ch.cur_flt[r];
            }
            ch.n = e + 1;
            if (!ch.ev) {
                ch.r_count += 1;
                for (int r = 0; r < R; ++r) {
                    ch.r_res[r] = __fadd_rn(ch.r_res[r], ch.cur_req[r]);
                    ch.r_float[r] = __fadd_rn(ch.r_float[r], ch.cur_flt[r]);
                }
            }
            for (int r = 0; r < R; ++r) ch.r_spot_res[r] = __fadd_rn(ch.r_spot_res[r], ch.cur_req[r]);
            if (market && ch.r_spot < 0.0f) {
                float share = -ARMADA_INF;
                for (int r = 0; r < R; ++r) {
                    const float t = a.total_pool[r];
                    float f = t > 0.0f ? __fdiv_rn(ch.r_spot_res[r], fmaxf(t, 1e-9f)) : 0.0f;
                    f = __fmul_rn(f, a.drf_mult[r]);
                    share = fmaxf(share, f);
                }
                if (share > *a.spot_cutoff) ch.r_spot = a.g_spot_price[g];
            }
            ch.r_iter += 1;
            for (int r = 0; r < R; ++r)
                a.sim_row[qj * R + r] = __fadd_rn(a.sim_row[qj * R + r], ch.cur_req[r]);
            int gn = 0;
            const int npos = next_parked(a, qj, min(ch.ij + 1, SKIP_WINDOW), &gn);
            a.sim_keys[qj] = sim_key(a, sh, market, qj, npos, gn);
            a.simpos[qj] = npos;
        }
        ARMADA_SYNC();
    }

    // (6) the commit of the proven picks, in pick order
    if (tid == 0) {
        float add_res[MAX_R], add_flt[MAX_R];
        for (int r = 0; r < R; ++r) add_res[r] = add_flt[r] = 0.0f;
        for (int e = 0; e < ch.n; ++e) {
            const int node = ch.node[e], q = ch.q[e], pc = ch.pc[e];
            for (int l = ch.lo[e]; l <= ch.level[e] && l < a.P1; ++l)
                for (int r = 0; r < R; ++r) {
                    float* p = a.alloc + l * NR + (long long)node * R + r;
                    *p = __fsub_rn(*p, ch.reqn[e][r]);
                }
            for (int r = 0; r < R; ++r) {
                a.q_alloc[q * R + r] = __fadd_rn(a.q_alloc[q * R + r], ch.req[e][r]);
                float* pp = a.q_alloc_pc + ((long long)q * a.C + pc) * R + r;
                *pp = __fadd_rn(*pp, ch.req[e][r]);
            }
            a.g_state[ch.g[e]] = 1;
            if (ch.run[e] >= 0) {
                a.run_rescheduled[ch.run[e]] = 1;
                continue;
            }
            for (int r = 0; r < R; ++r) {
                add_res[r] = __fadd_rn(add_res[r], ch.req[e][r]);
                add_flt[r] = __fadd_rn(add_flt[r], ch.flt[e][r]);
            }
            a.q_sched[q] += 1;
            sh.sched_count += 1;
            const int cur = sh.cursor;
            if (cur < a.S) {
                a.slot_gang[cur] = ch.g[e];
                for (int w = 0; w < W; ++w) {
                    a.slot_nodes[(long long)cur * W + w] = w == 0 ? node : N;
                    a.slot_counts[(long long)cur * W + w] = w == 0 ? 1 : 0;
                }
            }
            sh.cursor = cur + 1;
        }
        for (int r = 0; r < R; ++r) {
            a.sched_res[r] = __fadd_rn(a.sched_res[r], add_res[r]);
            a.float_used[r] = __fadd_rn(a.float_used[r], add_flt[r]);
            a.spot_res[r] = ch.r_spot_res[r];
        }
        *a.spot_price = ch.r_spot;
        sh.n_ext = ch.n;
    }
}

// The static fit's compat row of the step's key: up to 32 node types a
// bit mask in a register of every thread (a ballot a warp), else the row in
// memory; a key of -1 admits every type.
struct CompatRow {
    const u8* row;
    unsigned mask;
    bool bits;
    __device__ __forceinline__ bool admits(int ty) const { return bits ? (mask >> ty) & 1u : row[ty] != 0; }
};

// The step's pick's row: the window walk read its mask (cmask).
static __device__ __forceinline__ CompatRow compat_row(const RoundArgs& a, int key, unsigned cmask) {
    const int T = a.T;
    return CompatRow{a.compat + (long long)max(key, 0) * T, key < 0 ? 0xffffffffu : cmask,
                     key < 0 || T <= 32};
}

// A single's node pass over this thread's nodes of [n0, n1): which nodes
// the request fits at the clean level and at its own, the count of each and
// the least (score, node) of each.  min(member_capacity, 1) >= 1 holds
// exactly when the row fits (fits_row), so a single needs no division, and
// the score only where the row fits.  ROW4: each row is one float4 load.
template <bool HET, bool ROW4>
static __device__ __forceinline__ NodePart single_pass(const RoundArgs& a, const LoopShared& sh,
                                                       const CompatRow& cr, const u8* ban,
                                                       const float* bias, int level, int n0, int n1) {
    const int R = a.R;
    const float* al0 = a.alloc;
    const float* all = a.alloc + (long long)level * a.N * R;
    float cv = ARMADA_INF, lv = ARMADA_INF;
    int ci = ARMADA_BIGI, li = ARMADA_BIGI, cs = 0, ls = 0;
    // the loads of a node do not wait on its static fit, and two nodes'
    // loads are in flight at once: the pass is bound by their latency
#pragma unroll 2
    for (int n = n0 + (int)threadIdx.x; n < n1; n += blockDim.x) {
        const int ty = a.node_type[n];
        const bool sfit = cr.admits(ty) & (a.node_ok[n] != 0) & (ban[n] == 0);
        bool fc, fl;
        float s0 = 0.0f, s1 = 0.0f;
        if constexpr (ROW4) {
            const float4 c = reinterpret_cast<const float4*>(al0)[n];
            const float4 l = reinterpret_cast<const float4*>(all)[n];
            const float* q = sh.req_node;
            const float* w = sh.inv_scale;
            fc = sfit & (!(q[0] > 0.0f) | (c.x >= q[0])) & (!(q[1] > 0.0f) | (c.y >= q[1])) &
                 (!(q[2] > 0.0f) | (c.z >= q[2])) & (!(q[3] > 0.0f) | (c.w >= q[3]));
            fl = sfit & (!(q[0] > 0.0f) | (l.x >= q[0])) & (!(q[1] > 0.0f) | (l.y >= q[1])) &
                 (!(q[2] > 0.0f) | (l.z >= q[2])) & (!(q[3] > 0.0f) | (l.w >= q[3]));
            // packing_score's left-to-right chain at R = 4
            s0 = __fmaf_rn(c.w, w[3], __fmaf_rn(c.z, w[2], __fmaf_rn(c.y, w[1], __fmul_rn(c.x, w[0]))));
            s1 = __fmaf_rn(l.w, w[3], __fmaf_rn(l.z, w[2], __fmaf_rn(l.y, w[1], __fmul_rn(l.x, w[0]))));
        } else {
            if (!sfit) continue;
            const float* rc = al0 + (long long)n * R;
            const float* rl = all + (long long)n * R;
            fc = fits_row(rc, sh.req_node, R);
            fl = fits_row(rl, sh.req_node, R);
            if (fc) s0 = packing_score(rc, sh.inv_scale, R);
            if (fl) s1 = packing_score(rl, sh.inv_scale, R);
        }
        if (HET && (fc || fl)) {
            const float bb = bias[ty];
            s0 = __fadd_rn(s0, bb);
            s1 = __fadd_rn(s1, bb);
        }
        if (fc) {
            ++cs;
            if (argmin_less(s0, n, cv, ci)) {
                cv = s0;
                ci = n;
            }
        }
        if (fl) {
            ++ls;
            if (argmin_less(s1, n, lv, li)) {
                lv = s1;
                li = n;
            }
        }
    }
    return NodePart{{cv, ci, 0}, {lv, li, 0}, cs, ls};
}

// nodes_w / counts_w: i32[P, W] rows holding the (node, count) spread of
// the gang being placed; node N marks an unused entry.  One instantiation
// per loop shape, so that each carries only its own branches' registers:
// EXT the multi-commit extension (commit_k > 1; it runs EXT_BLOCK threads,
// so that the node sweep keeps its running minima in registers without
// spilling), PL prefer-large ordering (never with EXT), HET the node-type
// bias (TR > 1), BK the pick chain (batch_k > 1; never with EXT, PL or the
// cache: its replay state spilled the single-commit instantiations as a
// runtime branch).  The fit cache is a block-uniform runtime branch of
// every instantiation (CS > 0).  WIDE: the extension's or the chain's tables
// in global scratch (commit_k > MAX_COMMIT_K or batch_k > MAX_BATCH_K).
//
// CL: the round over S node shards as one thread-block cluster of S CTAs a
// lane (grid S x P, cluster S x 1; round_cluster.cu): every solo and stacked
// round whose cluster size S the wrapper's owner sets above 1, and K-K, whose
// mesh sets it.  Every CTA runs the whole loop on its own replica of the
// round's state (`state_at`, replica `rank` of lane l at rank x P + l; rank
// 0's are the round's output, the wrapper allocates the others and round.cu
// copies the post-eviction state into them), reduces every node pass over
// its own node range only, and combines the partials across the cluster
// (`cluster_part`, `cluster_combine`).  Every CTA so makes every decision and every
// commit itself, on identical state: no CTA writes an address another reads,
// and distributed shared memory carries the only traffic between them.  The
// replicas cost a copy of the mutable state a CTA (the [P1, N, R] allocatable
// among it); a commit touches a few rows.  The job axis (the gang and run
// arrays) is read in place in global memory by every CTA: job shards only
// pad and lay it out.
template <bool EXT, bool PL, bool HET, bool BK, bool WIDE, bool CL>
__global__ void __launch_bounds__(EXT ? EXT_BLOCK : BK ? BK_BLOCK : HET ? LOOP_BLOCK_HET : LOOP_BLOCK, 1)
    place_loop_kernel(RoundArgs a0, int* nodes_w0, int* counts_w0, int hotq) {
    static_assert(SKIP_WINDOW == 16, "the window walk gives each live queue a half-warp");
    int rank = 0, S_ = 1;
    if constexpr (CL) {
        rank = (int)cg::this_cluster().block_rank();
        S_ = (int)cg::this_cluster().num_blocks();
    }
    // lane blockIdx.y; in the cluster its replica `rank`, state (rank x P +
    // lane), the scalar block's [8, P] rows of replica rank
    const long long lane = blockIdx.y, rep = (long long)rank * a0.P + lane;
    __shared__ LoopShared sh;
    __shared__ typename std::conditional<WIDE, ExtWide, ExtShared>::type ext;
    __shared__ typename std::conditional<WIDE, ChainWide, ChainShared>::type ch;
    __shared__ QPick redq[ARMADA_WARPS + 1];
    __shared__ ArgMin red[ARMADA_WARPS + 1];
    __shared__ NodePart npart[ARMADA_WARPS];
    __shared__ Cand cands[2 * ARMADA_WARPS];
    __shared__ LiveQ live_tab[LIVE_STAGE];
    __shared__ ClusterX cx;
    // the lane's (and replica's) arguments, in shared memory: no thread
    // holds the ~100 pointers in registers
    __shared__ RoundArgs a_sh;
    ROUND_DYN_SHARED(dyn);
    const int tid = threadIdx.x;
    const int wl = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
    if (tid == 0) {
        RoundArgs& b = a_sh;
        b = a0;
        inputs_at(b, lane);
        state_at(b, rep, 8LL * rank * a0.P + lane);
        // the loop's R-sized accumulators live in shared memory until the
        // loop ends, and so does the per-queue state (q_alloc, q_sched,
        // q_head, q_killed) where `hot_bytes` found room for it (hotq);
        // out_* keep where they go back
        sh.out_q_alloc = b.q_alloc;
        sh.out_q_sched = b.q_sched;
        sh.out_q_head = b.q_head;
        sh.out_q_killed = b.q_killed;
        sh.out_sched_res = b.sched_res;
        sh.out_float_used = b.float_used;
        sh.out_spot_res = b.spot_res;
        sh.out_spot_price = b.spot_price;
        b.sched_res = sh.h_sched_res;
        b.float_used = sh.h_float_used;
        b.spot_res = sh.h_spot_res;
        b.spot_price = &sh.h_spot_price;
        if (hotq) {
            float* qa = reinterpret_cast<float*>(dyn);
            int* qs = reinterpret_cast<int*>(qa + (long long)b.Q * b.R);
            b.q_alloc = qa;
            b.q_sched = qs;
            b.q_head = qs + b.Q;
            b.q_killed = reinterpret_cast<u8*>(qs + 2LL * b.Q);
        }
        // R = 4 rows load as one float4 where the allocatable is 16-byte aligned
        sh.row4 = b.R == 4 && ((unsigned long long)b.alloc & 15ull) == 0;
        sh.nodes_w = nodes_w0 + rep * b.W;
        sh.counts_w = counts_w0 + rep * b.W;
        sh.market = *b.market != 0;
        sh.n0 = CL ? rank * (b.N / S_) : 0;
        sh.n1 = CL ? sh.n0 + b.N / S_ : b.N;
    }
    ARMADA_SYNC();
    const RoundArgs& a = a_sh;
    // Kernel-wide values stay in shared memory (sh, a_sh), and each phase
    // below reads what it needs: at 1,024 threads a thread has 64 registers.
    {
    const int R = a.R, N = a.N, n0 = sh.n0, n1 = sh.n1;
    // live queues (those holding gangs), ascending; and the loop state
    if (tid == 0) {
        int n = 0;
        for (int q = 0; q < a.Q; ++q)
            if (a.q_len[q] > 0) a.live_q[n++] = q;
        sh.nlive = n;
        sh.done = 0;
        sh.iterations = 0;
        sh.kiters = 0;
        sh.termination = 0;
        sh.cursor = 0;
        sh.sched_count = 0;
        sh.new_blocked = 0;
        sh.nhits = 0;
        sh.nmisses = 0;
        sh.h_spot_price = -1.0f;
        cx.phase = 0;
        cx.S = S_;
        if constexpr (WIDE) wide_bind(a, ext, ch);
    }
    if (hotq)
        for (long long i = tid; i < (long long)a.Q * R; i += blockDim.x) a.q_alloc[i] = sh.out_q_alloc[i];
    for (int q = tid; q < a.Q; q += blockDim.x) {
        a.q_head[q] = 0;
        a.q_sched[q] = 0;
        a.q_killed[q] = a.q_weight[q] > 0.0f ? 0 : 1;
    }
    for (int r = tid; r < R; r += blockDim.x) {
        sh.h_sched_res[r] = 0.0f;
        sh.h_spot_res[r] = 0.0f;
        sh.h_float_used[r] = sh.out_float_used[r];
        sh.inv_scale[r] = a.inv_scale[r];
        sh.c_total[r] = a.total_pool[r];
        sh.c_mult[r] = a.drf_mult[r];
        sh.c_rcap[r] = a.round_cap[r];
        sh.c_ftot[r] = a.float_total[r];
        sh.c_nax[r] = a.node_axes[r];
    }
    // the fit cache's scores over the post-eviction allocatable
    if (a.CS > 0) {
        const long long span = n1 - n0;
        for (long long i = tid; i < (long long)a.P1 * span; i += blockDim.x) {
            const long long c = (i / span) * N + n0 + i % span;
            a.cscore[c] = packing_score(a.alloc + c * R, a.inv_scale, R);
        }
    }
    }
    ARMADA_SYNC();
    for (int li = tid; li < min(sh.nlive, LIVE_STAGE); li += blockDim.x) {
        const int q = a.live_q[li];
        live_tab[li] = LiveQ{q, a.q_start[q], a.q_len[q]};
    }
    ARMADA_SYNC();
#ifdef ROUND_STEP_PROFILE
    long long prof_ns0 = 0, prof_c0 = 0;
    if (prof_thread()) {
        for (int i = 0; i < PS_SLOTS; ++i) prof_acc[i] = 0;
        prof_cur = PS_END;
        prof_ns0 = prof_ns();
        prof_c0 = clock64();
        prof_t = prof_c0;
    }
#endif

    // unroll: the loop condition is read every `unroll` steps; a step past
    // done or the iteration bound is a no-op (the body's gate)
    int steps_left = 0;
    while (true) {
        if (steps_left == 0) {
            if (sh.done || sh.iterations >= a.max_iter) break;
            steps_left = a.unroll;
        }
        --steps_left;
        if (sh.done || sh.iterations >= a.max_iter) continue;
        PROF_BEGIN(PS_WINDOW);
#ifdef ROUND_STEP_PROFILE
        if (prof_thread()) ++prof_acc[PS_STEPS];
#endif
        // --- the cursor window, the candidates and their gates: a half-warp a
        // live queue, two queues at once ---------------------------------------------
        // Lane w of a half-warp reads entry head + w of its queue's window
        // and, speculatively, what the gate reads of that entry's gang; a
        // ballot over "skippable" gives the leading run (the reference's
        // cumprod, fair_scheduler.py:394-395), whose end is the candidate.
        // Lane r then takes resource r of the candidate's request: its DRF
        // term (the key is their max over the lanes, then one division) and
        // its caps; lanes t and t + 16 read the candidate key's compat row
        // into a bit mask (T <= 32).  So every live queue's candidate arrives
        // with its key and its gate in three dependent global loads after
        // the staged queue table, and the half-warp keeps its best
        // candidate's record (cands[hw]) for warp 0.  A half-warp walks
        // queues li and li + 2 x warps side by side: their loads are in
        // flight together.
        QPick best{ARMADA_INF, -ARMADA_INF, ARMADA_BIGI, 0, 0u, 0};
        {
            const int R = a.R, T = a.T, half = wl >> 4, w16 = wl & 15, hw = tid >> 4;
            const bool market = sh.market;
            const int nlive = sh.nlive;
            const unsigned hmask = 0xffffu << (half << 4);
            for (int li0 = 2 * warp; li0 < nlive; li0 += 4 * nwarps) {
                int q[2], head[2], len[2], gang[2], kk[2], run[2], pc[2];
                bool qv[2], skip[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int li = li0 + half + u * 2 * nwarps;
                    qv[u] = li < nlive;
                    int start;
                    if (li < LIVE_STAGE) {
                        const LiveQ e = live_tab[qv[u] ? li : 0];
                        q[u] = e.q;
                        start = e.start;
                        len[u] = e.len;
                    } else {
                        q[u] = a.live_q[qv[u] ? li : 0];
                        start = a.q_start[q[u]];
                        len[u] = a.q_len[q[u]];
                    }
                    head[u] = a.q_head[q[u]];
                    gang[u] = gq_at(a, (long long)start + head[u] + w16);
                    kk[u] = a.g_key[gang[u]];
                    const int st = a.g_state[gang[u]];
                    run[u] = a.g_run[gang[u]];
                    pc[u] = a.g_pc[gang[u]];
                    const bool bad = kk[u] >= 0 && a.key_bad[kk[u]] != 0;
                    skip[u] = qv[u] && head[u] + w16 < len[u] && (st != 0 || bad);
                }
                // the candidates, and what their half-warp reads of each: lane
                // r the request, the queue's allocation and penalty, its
                // priority class's usage and cap; lanes t and t + 16 the
                // compat row's bytes; every lane the gang's cardinality; lane
                // 0 its level, ban row, type row, queue (prefer-large) and
                // price (market)
                int nskip[2], cand[2], c_key[2], c_card[2], c_run[2], c_pc[2], c_lvl[2], c_ban[2], c_trow[2];
                bool has[2];
                float req[2], qa[2], qp[2], qpc[2], qcap_r[2], cw[2], price[2];
                bool cb0[2], cb1[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const unsigned run16 = (__ballot_sync(FULL_MASK, skip[u]) >> (half << 4)) & 0xffffu;
                    nskip[u] = __ffs(~run16) - 1;
                    const int src = (half << 4) + (nskip[u] < SKIP_WINDOW ? nskip[u] : 0);
                    const int cand_g = __shfl_sync(FULL_MASK, gang[u], src);
                    c_key[u] = __shfl_sync(FULL_MASK, kk[u], src);
                    c_run[u] = __shfl_sync(FULL_MASK, run[u], src);
                    c_pc[u] = __shfl_sync(FULL_MASK, pc[u], src);
                    const int qq = q[u];
                    const bool visible = qv[u] && nskip[u] < SKIP_WINDOW && head[u] + nskip[u] < len[u];
                    cand[u] = visible ? cand_g : 0;
                    has[u] = visible && !(c_run[u] < 0 && (sh.new_blocked || a.q_killed[qq])) &&
                             a.q_weight[qq] > 0.0f;
                    req[u] = qa[u] = qp[u] = qpc[u] = qcap_r[u] = cw[u] = price[u] = 0.0f;
                    c_card[u] = c_lvl[u] = c_ban[u] = c_trow[u] = 0;
                    if (has[u]) {
                        const int g = cand[u];
                        c_card[u] = a.g_card[g];
                        if (w16 < R) {
                            const int r = w16;
                            req[u] = a.g_req[(long long)g * R + r];
                            qa[u] = a.q_alloc[qq * R + r];
                            qp[u] = a.q_penalty[qq * R + r];
                            qpc[u] = a.q_alloc_pc[((long long)qq * a.C + c_pc[u]) * R + r];
                            qcap_r[u] = a.pc_queue_cap[c_pc[u] * R + r];
                        }
                        if (w16 == 0) {
                            c_lvl[u] = a.g_level[g];
                            c_ban[u] = a.g_ban_row[g];
                            if (HET && c_key[u] >= 0) c_trow[u] = a.key_type_row[c_key[u]];
                            if (PL) cw[u] = a.q_weight[a.g_queue[g]];
                            if (market) price[u] = a.g_price[g];
                        }
                    }
                    const u8* crow = a.compat + (long long)max(c_key[u], 0) * T;
                    cb0[u] = has[u] && c_key[u] >= 0 && w16 < T && crow[w16] != 0;
                    cb1[u] = has[u] && c_key[u] >= 0 && w16 + 16 < T && crow[w16 + 16] != 0;
                }
                PROF_BEGIN(PS_KEYS);
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int qq = q[u];
                    // lane r: resource r of the candidate's request, its DRF
                    // terms (with the candidate, without it and of the gang
                    // alone, prefer-large's) and its caps
                    const float cardf = (float)c_card[u];
                    float term = -ARMADA_INF, term0 = -ARMADA_INF, termg = -ARMADA_INF;
                    bool rcap = false, qcap = false, fok = true;
                    if (has[u] && w16 < R) {
                        const int r = w16;
                        const float rt = __fmul_rn(req[u], cardf);
                        const float rf = __fmul_rn(__fmul_rn(req[u], __fsub_rn(1.0f, sh.c_nax[r])), cardf);
                        if (!market) {
                            const float t = sh.c_total[r], mult = sh.c_mult[r];
                            const float x0 = __fadd_rn(qa[u], qp[u]);
                            term = __fmul_rn(t > 0.0f ? __fdiv_rn(__fadd_rn(x0, rt), t) : 0.0f, mult);
                            if (PL) {
                                term0 = __fmul_rn(t > 0.0f ? __fdiv_rn(x0, t) : 0.0f, mult);
                                termg = __fmul_rn(t > 0.0f ? __fdiv_rn(rt, t) : 0.0f, mult);
                            }
                        }
                        rcap = __fadd_rn(a.sched_res[r], rt) > sh.c_rcap[r];
                        qcap = __fadd_rn(qpc[u], rt) > qcap_r[u];
                        fok = __fadd_rn(a.float_used[r], rf) <= __fadd_rn(sh.c_ftot[r], 1e-3f);
                    }
                    // drf_unweighted's max is exact in any order
                    for (int off = 8; off > 0; off >>= 1) {
                        term = fmaxf(term, __shfl_xor_sync(FULL_MASK, term, off));
                        if (PL) {
                            term0 = fmaxf(term0, __shfl_xor_sync(FULL_MASK, term0, off));
                            termg = fmaxf(termg, __shfl_xor_sync(FULL_MASK, termg, off));
                        }
                    }
                    rcap = (__ballot_sync(FULL_MASK, rcap) & hmask) != 0;
                    qcap = (__ballot_sync(FULL_MASK, qcap) & hmask) != 0;
                    fok = (__ballot_sync(FULL_MASK, !fok) & hmask) == 0;
                    const unsigned cm = ((__ballot_sync(FULL_MASK, cb0[u]) >> (half << 4)) & 0xffffu) |
                                        (((__ballot_sync(FULL_MASK, cb1[u]) >> (half << 4)) & 0xffffu) << 16);
                    bool better = false;
                    if (qv[u] && w16 == 0) {
                        const int ns = nskip[u];
                        a.q_head[qq] = head[u] + ns;
                        if (ns > 0) best.f |= QF_ADV;
                        // the extensions read the window from its pre-skip start
                        if (EXT || BK) a.q_nskip[qq] = ns;
                        if (EXT && ns >= SKIP_WINDOW && head[u] + ns < len[u]) best.f |= QF_HID;
                        float key = ARMADA_INF;
                        if (has[u]) {
                            float sz = 0.0f;
                            if (market) {
                                key = -price[u];
                            } else {
                                const float w = a.q_weight[qq];
                                key = w > 0.0f ? __fdiv_rn(term > 0.0f ? term : 0.0f, w) : 0.0f;
                                if (PL) {
                                    // within budget: the current cost; over budget:
                                    // PL_OVER + the proposed cost, rounded in f32
                                    const float budget =
                                        w > 0.0f ? __fdiv_rn(a.dcafs[qq], fmaxf(w, 1e-9f)) : 0.0f;
                                    key = key <= budget
                                              ? (w > 0.0f ? __fdiv_rn(term0 > 0.0f ? term0 : 0.0f, w) : 0.0f)
                                              : __fadd_rn(PL_OVER, key);
                                }
                            }
                            // prefer-large's itemSize (gang_size): the gang's
                            // unweighted DRF cost times its queue's weight
                            if (PL) sz = __fmul_rn(termg > 0.0f ? termg : 0.0f, cw[u]);
                            const QPick c{key, sz, qq, cand[u], best.f | QF_ANY, hw};
                            best.f |= QF_ANY;
                            better = qpick_less(c, best);
                            if (better) best = c;
                        }
                        if (EXT) a.okey[qq] = key;
                    }
                    // the half-warp's best candidate so far: its record for warp 0
                    better = __shfl_sync(FULL_MASK, better, half << 4);
                    if (better) {
                        Cand& cd = cands[hw];
                        if (w16 < R) {
                            const int r = w16;
                            const float nax = sh.c_nax[r];
                            cd.req[r] = req[u];
                            cd.req_node[r] = __fmul_rn(req[u], nax);
                            cd.req_tot[r] = __fmul_rn(req[u], cardf);
                            cd.req_float[r] = __fmul_rn(__fmul_rn(req[u], __fsub_rn(1.0f, nax)), cardf);
                        }
                        if (w16 == 0) {
                            const bool ev = c_run[u] >= 0;
                            const bool hit_burst =
                                !ev && (long long)sh.sched_count + c_card[u] > *a.global_burst;
                            const bool hit_q_burst =
                                !ev && (long long)a.q_sched[qq] + c_card[u] > a.perq_burst[qq];
                            const bool gate_global = hit_burst || (!ev && rcap);
                            cd.g = cand[u];
                            cd.card = c_card[u];
                            cd.level = c_lvl[u];
                            cd.key = c_key[u];
                            cd.pc = c_pc[u];
                            cd.run = c_run[u];
                            cd.ban = c_ban[u];
                            cd.trow = c_trow[u];
                            cd.cmask = cm;
                            cd.hit_burst = hit_burst;
                            cd.gate_global = gate_global;
                            cd.gate_queue = (hit_q_burst || (!ev && qcap)) && !gate_global;
                            cd.float_ok = ev || fok;
                        }
                    }
                }
                PROF_BEGIN(PS_WINDOW);
            }
        }

        // --- the queue pick: one reduction of the keys and the flags ------------------
        best = qpick_warp(best);
        if (wl == 0) redq[warp] = best;
        ARMADA_SYNC();
        PROF_BEGIN(PS_PICK);
        // --- the gate, on warp 0: the winner's record from its half-warp --------------
        if (warp == 0) {
            QPick b = wl < nwarps ? redq[wl] : QPick{ARMADA_INF, -ARMADA_INF, ARMADA_BIGI, 0, 0u, 0};
            b = qpick_warp(b);
            PROF_BEGIN(PS_GATE);
            const bool any_q = (b.f & QF_ANY) != 0;
            if (any_q) {
                const Cand& cd = cands[b.slot];
                if (wl < a.R) {
                    sh.req[wl] = cd.req[wl];
                    sh.req_node[wl] = cd.req_node[wl];
                    sh.req_tot[wl] = cd.req_tot[wl];
                    sh.req_float[wl] = cd.req_float[wl];
                }
                if (wl == 0) {
                    const int run = cd.run;
                    sh.qstar = b.q;
                    sh.g = b.g;
                    sh.card = cd.card;
                    sh.level = cd.level;
                    sh.key = cd.key;
                    sh.trow = cd.trow;
                    sh.pc = cd.pc;
                    sh.run = run;
                    sh.ban = cd.ban;
                    sh.cmask = cd.cmask;
                    sh.is_ev = run >= 0;
                    sh.pinned = run >= 0 ? a.run_node[run] : -1;
                    sh.hit_burst = cd.hit_burst;
                    sh.gate_global = cd.gate_global;
                    sh.gate_queue = cd.gate_queue;
                    sh.attempt = !cd.gate_global && !cd.gate_queue;
                    sh.float_ok = cd.float_ok;
                    // cacheable: an unbanned, keyed, type-insensitive single
                    sh.cacheable = a.CS > 0 && run < 0 && cd.card == 1 && cd.key >= 0 && cd.ban == 0 &&
                                   cd.trow == 0;
                }
            }
            if (wl == 0) {
                sh.any_q = any_q;
                sh.advanced = (b.f & QF_ADV) != 0;
                sh.hidden = EXT && (b.f & QF_HID) != 0;
                if (!any_q) {
                    sh.attempt = 0;
                    sh.gate_global = 0;
                    sh.gate_queue = 0;
                    sh.hit_burst = 0;
                }
                sh.fit_feasible = 0;
            }
        }
        ARMADA_SYNC();
        PROF_BEGIN(PS_NODE);

        // --- fit and node selection -------------------------------------------------
        int s_node = -1;  // a single's node (N: none), in warp 0's registers for its commit
        if (sh.attempt) {
            const int R = a.R, N = a.N, W = a.W, T = a.T;
            const long long NR = (long long)N * R;
            const int n0 = sh.n0, n1 = sh.n1;
            int* const nodes_w = sh.nodes_w;
            int* const counts_w = sh.counts_w;
            const int card = sh.card, level = sh.level;
            if (sh.is_ev) {
                // the evictee's pinned node: warp 0 alone, which commits
                if (tid == 0) {
                    const int pin = min(max(sh.pinned, 0), N - 1);
                    const float* row = a.alloc + (long long)level * NR + (long long)pin * R;
                    // _fit_row: min_r floor(alloc / req) >= 1 (INF where req == 0)
                    float m = ARMADA_INF;
                    for (int r = 0; r < R; ++r) {
                        const float per = sh.req_node[r] > 0.0f
                                              ? floorf(__fdiv_rn(row[r], sh.req_node[r]))
                                              : ARMADA_INF;
                        m = fminf(m, per);
                    }
                    const bool fits = m >= 1.0f && a.node_ok[pin];
                    for (int w = 0; w < W; ++w) {
                        nodes_w[w] = N;
                        counts_w[w] = 0;
                    }
                    nodes_w[0] = fits ? sh.pinned : N;
                    counts_w[0] = fits ? 1 : 0;
                    sh.fit_feasible = fits;
                }
            } else if (sh.cacheable) {
                cached_pick<CL>(a, sh, nodes_w, counts_w, red, cx);
            } else {
                const int key = sh.key;
                const u8* ban = a.ban_mask + (long long)sh.ban * N;
                // the node-type bias row of the gang's key: one f32 add after
                // the packing-score chain (TR > 1 only)
                const float* bias = HET ? a.type_bias + (long long)sh.trow * a.T : nullptr;
                const CompatRow cr = compat_row(a, key, sh.cmask);
                NodePart p = npart_empty();
                if (card == 1) {
                    p = sh.row4 ? single_pass<HET, true>(a, sh, cr, ban, bias, level, n0, n1)
                                : single_pass<HET, false>(a, sh, cr, ban, bias, level, n0, n1);
                } else {
                    const float* al0 = a.alloc;
                    const float* all = a.alloc + (long long)level * NR;
                    for (int n = n0 + tid; n < n1; n += blockDim.x) {
                        const int ty = a.node_type[n];
                        const bool ok = cr.admits(ty) && a.node_ok[n] && !ban[n];
                        int cc = 0, cl = 0;
                        float s0 = ARMADA_INF, s1 = ARMADA_INF;
                        if (ok) {
                            cc = min(member_capacity(al0 + (long long)n * R, sh.req_node, R), card);
                            cl = min(member_capacity(all + (long long)n * R, sh.req_node, R), card);
                            s0 = packing_score(al0 + (long long)n * R, sh.inv_scale, R);
                            s1 = packing_score(all + (long long)n * R, sh.inv_scale, R);
                            if (bias) {
                                const float b = bias[ty];
                                s0 = __fadd_rn(s0, b);
                                s1 = __fadd_rn(s1, b);
                            }
                        }
                        p.sc += cc;
                        p.sl += cl;
                        if (cc >= 1) p.c = argmin_pick(p.c, ArgMin{s0, n, 0});
                        if (cl >= 1) p.l = argmin_pick(p.l, ArgMin{s1, n, 0});
                        a.cap_c[n] = cc;
                        a.cap_l[n] = cl;
                        a.score_c[n] = s0;
                        a.score_l[n] = s1;
                    }
                }
                // the pass's four reductions in one: warps, then warp 0 over
                // the warps (and over the cluster's CTAs)
                p = npart_warp(p);
                if (wl == 0) npart[warp] = p;
                ARMADA_SYNC();
                if (warp == 0) p = npart_warp(wl < nwarps ? npart[wl] : npart_empty());
                if constexpr (CL) cluster_part(cx, p);
                if (card == 1) {
                    if (warp == 0) {
                        const bool use_clean = p.sc >= card;
                        const long long ssel = use_clean ? p.sc : p.sl;
                        const ArgMin b = use_clean ? p.c : p.l;
                        const bool found = ssel >= 1;
                        s_node = found ? b.i : N;
                        for (int w = wl; w < W; w += 32) {
                            nodes_w[w] = w == 0 ? s_node : N;
                            counts_w[w] = w == 0 && found ? 1 : 0;
                        }
                        if (wl == 0) sh.fit_feasible = ssel >= card;
                    }
                } else {
                    if (tid == 0) {
                        sh.psc = p.sc;
                        sh.psl = p.sl;
                    }
                    ARMADA_SYNC();
                    const long long sc = sh.psc, sl = sh.psl;
                    const bool use_clean = sc >= card;
                    const long long ssel = use_clean ? sc : sl;
                    // Gang spread: masked nodes in (score, index) order, each
                    // filled to its capacity, until the gang is covered -- the
                    // prefix of the reference's stable argsort, W rounds of a
                    // masked argmin strictly after the previous pick.
                    const int* cap = use_clean ? a.cap_c : a.cap_l;
                    const float* score = use_clean ? a.score_c : a.score_l;
                    float pv = -ARMADA_INF;
                    int pi = -1;
                    long long before = 0;
                    if (tid == 0)
                        for (int w = 0; w < W; ++w) {
                            nodes_w[w] = N;
                            counts_w[w] = 0;
                        }
                    ARMADA_SYNC();
                    for (int w = 0; w < W; ++w) {
                        ArgMin b{ARMADA_INF, ARMADA_BIGI, 0};
                        for (int n = n0 + tid; n < n1; n += blockDim.x) {
                            if (cap[n] < 1) continue;
                            const float s = score[n];
                            if (argmin_less(pv, pi, s, n)) b = argmin_pick(b, ArgMin{s, n, cap[n]});
                        }
                        b = block_argmin(b, red);
                        if constexpr (CL) cluster_combine<1, 0, 0>(cx, &b, nullptr, nullptr);
                        if (b.i == ARMADA_BIGI) break;
                        long long take = (long long)card - before;
                        if (take > b.extra) take = b.extra;
                        if (take <= 0) break;
                        if (tid == 0) {
                            nodes_w[w] = b.i;
                            counts_w[w] = (int)take;
                        }
                        before += b.extra;
                        pv = b.v;
                        pi = b.i;
                    }
                    if (tid == 0) sh.fit_feasible = ssel >= card;
                    ARMADA_SYNC();
                }
            }
        }

        // --- commit, on warp 0: its lanes take the spread's (entry, level,
        // resource) elements and the resources; lane 0 the scalars ----------------------
        PROF_BEGIN(PS_COMMIT);
        if (warp == 0) {
            __syncwarp();
            const int R = a.R, N = a.N, W = a.W;
            const long long NR = (long long)N * R;
            const bool market = sh.market;
            const int* const nodes_w = sh.nodes_w;
            const int* const counts_w = sh.counts_w;
            const bool attempt = sh.attempt;
            const bool placed = attempt && sh.fit_feasible && sh.float_ok;
            const int qstar = sh.qstar, g = sh.g, card = sh.card, pc = sh.pc;
            const bool ev = sh.is_ev;
            const int cur = sh.cursor;
            const int level = sh.level;
            __syncwarp();  // every lane has read the step's scalars before lane 0 writes
            if (placed) {
                const int lo = ev ? 1 : 0;
                const int nl = min(level, a.P1 - 1) - lo + 1;
                // a single's node from the registers of its pass; else the rows
                const int ne = s_node >= 0 ? 1 : W;
                for (int i = wl; i < ne * nl * R && nl > 0; i += 32) {
                    const int w = i / (nl * R), l = lo + (i / R) % nl, r = i % R;
                    const int node = s_node >= 0 ? s_node : nodes_w[w];
                    if (node >= N) continue;
                    const float cnt = s_node >= 0 ? 1.0f : (float)counts_w[w];
                    float* p = a.alloc + (long long)l * NR + (long long)node * R + r;
                    *p = __fsub_rn(*p, __fmul_rn(cnt, sh.req_node[r]));
                }
                float share = -ARMADA_INF;
                if (wl < R) {
                    const int r = wl;
                    const float rt = sh.req_tot[r];
                    a.q_alloc[qstar * R + r] = __fadd_rn(a.q_alloc[qstar * R + r], rt);
                    float* pp = a.q_alloc_pc + ((long long)qstar * a.C + pc) * R + r;
                    *pp = __fadd_rn(*pp, rt);
                    const float sr = __fadd_rn(a.spot_res[r], rt);
                    a.spot_res[r] = sr;
                    if (!ev) {
                        a.sched_res[r] = __fadd_rn(a.sched_res[r], rt);
                        a.float_used[r] = __fadd_rn(a.float_used[r], sh.req_float[r]);
                    }
                    if (market) {
                        const float t = a.total_pool[r];
                        const float f = t > 0.0f ? __fdiv_rn(sr, fmaxf(t, 1e-9f)) : 0.0f;
                        share = __fmul_rn(f, a.drf_mult[r]);
                    }
                }
                if (market)
                    for (int off = 16; off > 0; off >>= 1)
                        share = fmaxf(share, __shfl_xor_sync(FULL_MASK, share, off));
                if (!ev && cur < a.S)
                    for (int w = wl; w < W; w += 32) {
                        a.slot_nodes[(long long)cur * W + w] =
                            s_node >= 0 ? (w == 0 ? s_node : N) : nodes_w[w];
                        a.slot_counts[(long long)cur * W + w] =
                            s_node >= 0 ? (w == 0 ? 1 : 0) : counts_w[w];
                    }
                if (wl == 0) {
                    if (!ev) {
                        sh.sched_count += card;
                        a.q_sched[qstar] += card;
                        if (cur < a.S) a.slot_gang[cur] = g;
                        sh.cursor = cur + 1;
                    } else {
                        a.run_rescheduled[sh.run] = 1;
                    }
                    if (market && *a.spot_price < 0.0f && share > *a.spot_cutoff)
                        *a.spot_price = a.g_spot_price[g];
                    a.g_state[g] = 1;
                }
            } else if (attempt && wl == 0) {
                a.g_state[g] = 2;
                if (card == 1 && sh.key >= 0) a.key_bad[sh.key] = 1;
            }
            if (wl == 0) {
                if (sh.gate_queue) a.q_killed[qstar] = 1;
                if (sh.gate_global) {
                    sh.new_blocked = 1;
                    if (sh.termination == 0) sh.termination = sh.hit_burst ? 1 : 2;
                }
                sh.done = !sh.any_q && !sh.advanced;
                sh.placed = placed;
                sh.n_ext = 0;
                if (!EXT && !BK) {
                    sh.iterations += 1;
                    sh.kiters += 1;
                }
            }
        }
        ARMADA_SYNC();
        PROF_BEGIN(PS_AFTER);
        // --- the multi-commit extension (K10) ---------------------------------------
        if (EXT && sh.placed && !sh.market && !sh.hidden) {
            extension<typename std::remove_reference<decltype(ext)>::type, CL>(a, sh, ext, cx);
            ARMADA_SYNC();
        }
        // --- K11: the fit cache's upkeep, or the pick chain -------------------------
        if (a.CS > 0 && sh.placed)
            cache_upkeep(a, sh.nodes_w, EXT ? &ext.node[0] : nullptr, EXT ? sh.n_ext : 0, sh.n0, sh.n1);
        if (BK && sh.placed) {
            pick_chain<HET, typename std::remove_reference<decltype(ch)>::type, CL>(a, sh, ch, redq, npart,
                                                                                    cx);
            ARMADA_SYNC();
        }
        PROF_BEGIN(PS_END);
        if (EXT || BK) {
            if (tid == 0) {
                sh.iterations += 1 + sh.n_ext;
                sh.kiters += 1;
            }
            ARMADA_SYNC();
        }
    }
#ifdef ROUND_STEP_PROFILE
    PROF_BEGIN(PS_END);
    if (prof_thread()) {
        prof_acc[PS_LOOP_NS] = prof_ns() - prof_ns0;
        prof_acc[PS_LOOP_CYCLES] = clock64() - prof_c0;
        for (int i = 0; i < PS_SLOTS; ++i) round_prof_out[i] = prof_acc[i];
    }
#endif
    if (hotq) {
        for (long long i = tid; i < (long long)a.Q * a.R; i += blockDim.x) sh.out_q_alloc[i] = a.q_alloc[i];
        for (int q = tid; q < a.Q; q += blockDim.x) {
            sh.out_q_sched[q] = a.q_sched[q];
            sh.out_q_head[q] = a.q_head[q];
            sh.out_q_killed[q] = a.q_killed[q];
        }
    }
    for (int r = tid; r < a.R; r += blockDim.x) {
        sh.out_sched_res[r] = sh.h_sched_res[r];
        sh.out_float_used[r] = sh.h_float_used[r];
        sh.out_spot_res[r] = sh.h_spot_res[r];
    }
    if (tid == 0) {
        *sh.out_spot_price = sh.h_spot_price;
        int term = sh.termination;
        if (!sh.done && sh.iterations >= a.max_iter) term = 3;
        a.scal[SC_NSLOTS * a.P] = sh.cursor;
        a.scal[SC_ITERS * a.P] = sh.iterations;
        a.scal[SC_TERM * a.P] = term;
        a.scal[SC_SCHED * a.P] = sh.sched_count;
        a.scal[SC_DONE * a.P] = sh.done;
        a.scal[SC_KITERS * a.P] = sh.kiters;
        a.scal[SC_CHITS * a.P] = sh.nhits;
        a.scal[SC_CMISSES * a.P] = sh.nmisses;
    }
    // no CTA leaves while another may still read its shared memory
    if constexpr (CL) {
        ARMADA_BAR_HOOK();
        cg::this_cluster().sync();
    }
}

// The placement loop's launchers: the narrow instantiations (round.cu), the
// wide ones (round_wide.cu) and K-K's cluster (round_cluster.cu).  Each
// returns the launch's cudaError_t.
typedef void (*PlaceLoop)(RoundArgs, int*, int*, int);

// The dynamic shared memory that holds the loop's per-queue state
// (q_alloc [Q, R] f32, q_sched and q_head i32, q_killed u8) beside kernel
// k's static shared memory, after raising k's limit to it; 0 when it does
// not fit (the state then stays in global memory).  *err: a failed query.
static inline int hot_bytes(const RoundArgs& a, const void* k, int* err) {
    *err = 0;
    const long long need = (long long)a.Q * (4LL * a.R + 9);
    cudaFuncAttributes fa;
    int dev = 0, optin = 0;
    cudaError_t e = cudaFuncGetAttributes(&fa, k);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) {
        *err = (int)e;
        return 0;
    }
    if (need > (long long)optin - (long long)fa.sharedSizeBytes) return 0;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (e != cudaSuccess) *err = (int)e;
    return (int)need;
}
int launch_place_loop_wide(const RoundArgs& a, dim3 grid, int* nodes_w, int* counts_w,
                           cudaStream_t stream);
int launch_place_loop_cluster(const RoundArgs& a, int S, int* nodes_w, int* counts_w,
                              cudaStream_t stream);
int place_loop_cluster_max(const RoundArgs& a, int S);
#ifdef ROUND_STEP_PROFILE
static int round_prof_fetch(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, round_prof_out, sizeof(round_prof_out));
}
int round_prof_fetch_wide(long long* out);
int round_prof_fetch_cluster(long long* out);
#endif

// The loop's block size at a loop shape.
static inline int place_loop_block(const RoundArgs& a) {
    return a.commit_k > 1 ? EXT_BLOCK : a.batch_k > 1 ? BK_BLOCK : a.TR > 1 ? LOOP_BLOCK_HET : LOOP_BLOCK;
}

