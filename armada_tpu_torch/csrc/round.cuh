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
// per-iteration passes and block barriers, not by device bandwidth.
//
// The simple design: the prologue, the DRF gate, the eviction move, the key
// sweep and the unbind are grid-wide kernels (scatter-adds with atomics, exact
// because every value is integral in resolution units); the placement loop is
// ONE persistent single-block kernel that keeps the carry scalars in shared
// memory and alloc[P1, N, R] in global memory (it fits in L2 at the
// reference scale); phase B's fixed point is a second single-block kernel.
// No host synchronisation between the launches.
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
// pool lane on its own SM.  Lane l's arrays start l x (per-lane element
// count) past lane 0's (`lane_of`), so one RoundArgs by value serves every
// lane and nothing per lane is uploaded.  The lanes never meet and the
// block's arithmetic is the solo round's, so each lane equals the solo
// round on its slice bit for bit (vmap runs the lanes in lockstep and masks
// finished ones; that gives the same per-lane result).  Past 132 lanes the
// persistent blocks queue for a free SM: the round's device time grows by
// the longest lane per extra wave, the results do not change.  A solo
// round is the stacked one at P = 1.

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

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
// problem's arrays and K-A's shares (`inputs_of`), then the state the round
// writes (`state_of`); the sharded round (K-K) offsets only the state, by
// its replica (round_cluster.cu).
static __device__ __forceinline__ RoundArgs inputs_of(RoundArgs a, long long l) {
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
    return a;
}

static __device__ __forceinline__ RoundArgs state_of(RoundArgs a, long long l, long long scal_off) {
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
    return a;
}

static __device__ __forceinline__ RoundArgs lane_of(RoundArgs a, long long l) {
    return state_of(inputs_of(a, l), l, l);
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
};

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
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        QPick b = lane < nw ? sh[lane] : QPick{ARMADA_INF, -ARMADA_INF, ARMADA_BIGI, 0};
        for (int off = 16; off > 0; off >>= 1) {
            const QPick o = qpick_shfl(b, off);
            if (qpick_less(o, b)) b = o;
        }
        if (lane == 0) sh[ARMADA_WARPS] = b;
    }
    __syncthreads();
    const QPick r = sh[ARMADA_WARPS];
    __syncthreads();
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

struct LoopShared {
    int nlive;
    int done, iterations, kiters, termination, cursor, sched_count, new_blocked;
    int advanced, hidden;
    // the iteration's pick
    int any_q, qstar, g, card, level, key, pc, run, is_ev, pinned, trow;
    int attempt, gate_global, gate_queue, hit_burst, float_ok, placed, n_ext;
    float req[MAX_R], req_node[MAX_R], req_tot[MAX_R], req_float[MAX_R];
    // the fit
    int fit_feasible;
    // the fit cache: the pick is a cacheable single; its slot; a hit; the
    // round's hits and misses
    int cacheable, cslot, chit, nhits, nmisses;
    // the node range this CTA reduces over: [0, N) but in the sharded round
    int n0, n1;
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
    const int ph = cx.phase;
    ClusterPub* mine = &cx.pub[ph];
    if (threadIdx.x == 0) {
        for (int i = 0; i < NM; ++i) mine->m[i] = m[i];
        for (int i = 0; i < NS; ++i) mine->s[i] = s[i];
        for (int i = 0; i < NK; ++i) mine->k[i] = k[i];
    }
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
    __syncthreads();
    for (int i = 0; i < NM; ++i) m[i] = cx.comb.m[i];
    for (int i = 0; i < NS; ++i) s[i] = cx.comb.s[i];
    for (int i = 0; i < NK; ++i) k[i] = cx.comb.k[i];
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
    __syncthreads();
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
    __syncthreads();

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
    __syncthreads();
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
        __syncthreads();
        if (CL) {
            if (tid < cn) {
                unsigned long long v = ~0ull;
                const int nw = (blockDim.x + 31) >> 5;
                for (int w = 0; w < nw; ++w)
                    if (ext.red[w][tid] < v) v = ext.red[w][tid];
                ext.kmin[tid] = v;
            }
            __syncthreads();
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
        __syncthreads();
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
    __syncthreads();

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
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
    // (3) the touched blocks' minima, from the patched bits and scores
    for (int i = tid; i < CS * T; i += blockDim.x) {
        const int sl = i / T, t = i % T;
        const int n = t < W ? nodes_w[t] : ext_node[t - W];
        if (n >= N || n < n0 || n >= n1) continue;
        const int blk = n / CB;
        const u8* f0 = a.fitc_clean + (long long)sl * N + (long long)blk * CB;
        const u8* fl = a.fitc_lvl + (long long)sl * N + (long long)blk * CB;
        const float* s0 = a.cscore + (long long)blk * CB;
        const float* sl_ = a.cscore + (long long)a.cslot_lvl[sl] * N + (long long)blk * CB;
        float m0 = ARMADA_INF, ml = ARMADA_INF;
        for (int k = 0; k < CB; ++k) {
            if (f0[k] && s0[k] < m0) m0 = s0[k];
            if (fl[k] && sl_[k] < ml) ml = sl_[k];
        }
        a.bmc_clean[(long long)sl * NB + blk] = m0;
        a.bmc_lvl[(long long)sl * NB + blk] = ml;
    }
    __syncthreads();
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
                                  ArgMin* red, long long* redl, ClusterX& cx) {
    const int tid = threadIdx.x;
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
    __syncthreads();

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
        __syncthreads();
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
            if (!match) n0 = block_sum_ll(n0, redl);
            b0 = block_argmin(b0, red);
            bl = block_argmin(bl, red);
            if (CL) {
                ArgMin m2[2] = {b0, bl};
                long long s1 = match ? 0 : n0;
                cluster_combine<2, 1, 0>(cx, m2, &s1, nullptr);
                b0 = m2[0];
                bl = m2[1];
                n0 = s1;
            }
            // (4) the clean count and the touched nodes at their adjusted
            // allocatable; the pick is the least (score, node) of both
            if (tid == 0) {
                if (!match) {
                    ch.rc_valid = 1;
                    ch.rc_key = key;
                    ch.rc_lvl = lvl;
                    ch.rc_ban = ch.ban;
                    ch.rc_n0 = n0;
                    for (int r = 0; r < R; ++r) ch.rc_req[r] = ch.cur_reqn[r];
                }
                long long n0_adj = ch.rc_n0;
                for (int e = 0; e < nprev; ++e) {
                    const int nd = ch.node[e];
                    bool first = true;
                    for (int f = 0; f < e; ++f) first &= ch.node[f] != nd;
                    if (!first || !(CL ? chain_fit(a, ch, nd, 0) : a.bk_fit0[nd] != 0)) continue;
                    float adj[MAX_R];
                    chain_adjusted(a, ch, nd, 0, adj);
                    if (!fits_row(adj, ch.cur_reqn, R)) --n0_adj;
                }
                const bool use_clean = n0_adj >= 1;
                const int lvl_sel = use_clean ? 0 : lvl;
                const u8* fsel = use_clean ? a.bk_fit0 : a.bk_fitl;
                ArgMin bb = use_clean ? b0 : bl;
                for (int e = 0; e < nprev; ++e) {
                    const int nd = ch.node[e];
                    float adj[MAX_R];
                    chain_adjusted(a, ch, nd, lvl_sel, adj);
                    const bool fit_sel = CL ? chain_fit(a, ch, nd, lvl_sel) : fsel[nd] != 0;
                    if (!(fits_row(adj, ch.cur_reqn, R) && fit_sel)) continue;
                    float sc = packing_score(adj, a.inv_scale, R);
                    if (bias) sc = __fadd_rn(sc, bias[a.node_type[nd]]);
                    bb = argmin_pick(bb, ArgMin{sc, nd, 0});
                }
                if (bb.v < ARMADA_INF) {
                    ch.node_j = bb.i;
                } else {
                    ch.stop = 1;
                }
            }
            __syncthreads();
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
        __syncthreads();
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
// CL: K-K, the round over S node shards as one thread-block cluster of S
// CTAs (grid S x 1, cluster S x 1; round_cluster.cu).  Every CTA runs the
// whole loop on its own replica of the round's state (`state_of`, replica
// `rank`; rank 0's is the round's output, the wrapper allocates the others
// and round.cu copies the post-eviction state into them), reduces every node
// pass over its own node range only, and combines the partials across the
// cluster (`cluster_combine`).  Every CTA so makes every decision and every
// commit itself, on identical state: no CTA writes an address another reads,
// and distributed shared memory carries the only traffic between them.  The
// replicas cost a copy of the mutable state a CTA (the [P1, N, R] allocatable
// among it); a commit touches a few rows.  The job axis (the gang and run
// arrays) is read in place in global memory by every CTA: job shards only
// pad and lay it out.
template <bool EXT, bool PL, bool HET, bool BK, bool WIDE, bool CL>
__global__ void __launch_bounds__(EXT ? EXT_BLOCK : BK ? BK_BLOCK : ARMADA_BLOCK, 1)
    place_loop_kernel(RoundArgs a0, int* nodes_w, int* counts_w) {
    int rank = 0, S_ = 1;
    if constexpr (CL) {
        rank = (int)cg::this_cluster().block_rank();
        S_ = (int)cg::this_cluster().num_blocks();
    }
    const RoundArgs a = CL ? state_of(inputs_of(a0, 0), rank, 8LL * rank) : lane_of(a0, blockIdx.y);
    const long long lane = CL ? rank : blockIdx.y;
    nodes_w += lane * a.W;
    counts_w += lane * a.W;
    __shared__ LoopShared sh;
    __shared__ typename std::conditional<WIDE, ExtWide, ExtShared>::type ext;
    __shared__ typename std::conditional<WIDE, ChainWide, ChainShared>::type ch;
    __shared__ QPick redq[ARMADA_WARPS + 1];
    __shared__ ArgMin red[ARMADA_WARPS + 1];
    __shared__ long long redl[ARMADA_WARPS + 1];
    __shared__ ClusterX cx;
    const int tid = threadIdx.x;
    const int R = a.R, N = a.N, W = a.W;
    const long long NR = (long long)N * R;
    const int n0 = CL ? rank * (N / S_) : 0, n1 = CL ? n0 + N / S_ : N;

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
        sh.n0 = n0;
        sh.n1 = n1;
        cx.phase = 0;
        cx.S = S_;
        if constexpr (WIDE) wide_bind(a, ext, ch);
    }
    for (int q = tid; q < a.Q; q += blockDim.x) {
        a.q_head[q] = 0;
        a.q_sched[q] = 0;
        a.q_killed[q] = a.q_weight[q] > 0.0f ? 0 : 1;
    }
    for (int r = tid; r < R; r += blockDim.x) {
        a.sched_res[r] = 0.0f;
        a.spot_res[r] = 0.0f;
    }
    if (tid == 0) *a.spot_price = -1.0f;
    // the fit cache's scores over the post-eviction allocatable
    if (a.CS > 0) {
        const long long span = n1 - n0;
        for (long long i = tid; i < (long long)a.P1 * span; i += blockDim.x) {
            const long long c = (i / span) * N + n0 + i % span;
            a.cscore[c] = packing_score(a.alloc + c * R, a.inv_scale, R);
        }
    }
    __syncthreads();
    const bool market = *a.market != 0;

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
        // --- cursors, candidates and the queue pick -----------------------------
        QPick best{ARMADA_INF, -ARMADA_INF, ARMADA_BIGI, 0};
        bool any_has = false, adv = false, hid = false;  // hid: EXT only
        for (int li = tid; li < sh.nlive; li += blockDim.x) {
            const int q = a.live_q[li];
            const int head = a.q_head[q], len = a.q_len[q], start = a.q_start[q];
            int nskip = 0;
            for (int w = 0; w < SKIP_WINDOW; ++w) {
                const int off = head + w;
                if (off >= len) break;
                const int gang = gq_at(a, (long long)start + off);
                const int key = a.g_key[gang];
                const bool bad = key >= 0 && a.key_bad[key];
                if (!(a.g_state[gang] != 0 || bad)) break;
                ++nskip;
            }
            a.q_head[q] = head + nskip;
            adv |= nskip > 0;
            // the extensions read the window from its pre-skip start
            if (EXT || BK) a.q_nskip[q] = nskip;
            if (EXT) hid |= nskip >= SKIP_WINDOW && head + nskip < len;
            const bool visible = nskip < SKIP_WINDOW && head + nskip < len;
            const int cand = visible ? gq_at(a, (long long)start + head + nskip) : 0;
            const bool cand_new = a.g_run[cand] < 0;
            const bool has = visible && !(cand_new && (sh.new_blocked || a.q_killed[q])) &&
                             a.q_weight[q] > 0.0f;
            float key = ARMADA_INF;
            if (has) {
                if (market) {
                    key = -a.g_price[cand];
                } else {
                    float x[MAX_R];
                    const float cardf = (float)a.g_card[cand];
                    for (int r = 0; r < R; ++r)
                        x[r] = __fadd_rn(__fadd_rn(a.q_alloc[q * R + r], a.q_penalty[q * R + r]),
                                         __fmul_rn(a.g_req[(long long)cand * R + r], cardf));
                    key = drf_weighted(x, a.total_pool, a.drf_mult, a.q_weight[q], R);
                    if (PL) {
                        // within budget: the current cost; over budget:
                        // PL_OVER + the proposed cost, rounded in f32
                        const float w = a.q_weight[q];
                        const float budget = w > 0.0f ? __fdiv_rn(a.dcafs[q], fmaxf(w, 1e-9f)) : 0.0f;
                        if (key <= budget) {
                            for (int r = 0; r < R; ++r)
                                x[r] = __fadd_rn(a.q_alloc[q * R + r], a.q_penalty[q * R + r]);
                            key = drf_weighted(x, a.total_pool, a.drf_mult, w, R);
                        } else {
                            key = __fadd_rn(PL_OVER, key);
                        }
                    }
                }
                const QPick c{key, PL ? gang_size(a, cand) : 0.0f, q, cand};
                if (qpick_less(c, best)) best = c;
                any_has = true;
            }
            if (EXT) a.okey[q] = key;
        }
        const bool any_q = block_any(any_has);
        const bool advanced = block_any(adv);
        const bool hidden = EXT && block_any(hid);
        best = block_qpick(best, redq);

        if (tid == 0) {
            sh.any_q = any_q;
            sh.advanced = advanced;
            sh.hidden = hidden;
            sh.attempt = 0;
            sh.gate_global = 0;
            sh.gate_queue = 0;
            sh.hit_burst = 0;
            if (any_q) {
                const int qstar = best.q, g = best.g;
                sh.qstar = qstar;
                sh.g = g;
                const int card = a.g_card[g];
                const float cardf = (float)card;
                sh.card = card;
                sh.level = a.g_level[g];
                sh.key = a.g_key[g];
                sh.trow = HET && sh.key >= 0 ? a.key_type_row[sh.key] : 0;
                sh.pc = a.g_pc[g];
                const int run = a.g_run[g];
                sh.run = run;
                sh.is_ev = run >= 0;
                sh.pinned = run >= 0 ? a.run_node[run] : -1;
                bool round_cap = false, q_cap = false, float_ok = true;
                for (int r = 0; r < R; ++r) {
                    const float req = a.g_req[(long long)g * R + r];
                    sh.req[r] = req;
                    sh.req_node[r] = __fmul_rn(req, a.node_axes[r]);
                    sh.req_tot[r] = __fmul_rn(req, cardf);
                    sh.req_float[r] =
                        __fmul_rn(__fmul_rn(req, __fsub_rn(1.0f, a.node_axes[r])), cardf);
                    round_cap |= __fadd_rn(a.sched_res[r], sh.req_tot[r]) > a.round_cap[r];
                    q_cap |= __fadd_rn(a.q_alloc_pc[((long long)qstar * a.C + sh.pc) * R + r],
                                       sh.req_tot[r]) > a.pc_queue_cap[sh.pc * R + r];
                    float_ok &= __fadd_rn(a.float_used[r], sh.req_float[r]) <=
                                __fadd_rn(a.float_total[r], 1e-3f);
                }
                const bool ev = run >= 0;
                const bool hit_burst = !ev && (long long)sh.sched_count + card > *a.global_burst;
                const bool hit_round_cap = !ev && round_cap;
                const bool hit_q_burst = !ev && (long long)a.q_sched[qstar] + card > a.perq_burst[qstar];
                const bool hit_q_cap = !ev && q_cap;
                const bool gate_global = hit_burst || hit_round_cap;
                const bool gate_queue = (hit_q_burst || hit_q_cap) && !gate_global;
                sh.hit_burst = hit_burst;
                sh.gate_global = gate_global;
                sh.gate_queue = gate_queue;
                sh.attempt = !gate_global && !gate_queue;
                sh.float_ok = ev || float_ok;
                // cacheable: an unbanned, keyed, type-insensitive single
                sh.cacheable = a.CS > 0 && !ev && card == 1 && sh.key >= 0 &&
                               a.g_ban_row[g] == 0 && sh.trow == 0;
            }
            sh.fit_feasible = 0;
        }
        __syncthreads();

        // --- fit and node selection -------------------------------------------------
        if (sh.attempt) {
            const int card = sh.card, level = sh.level;
            if (sh.is_ev) {
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
                __syncthreads();
            } else if (sh.cacheable) {
                cached_pick<CL>(a, sh, nodes_w, counts_w, red, cx);
            } else {
                const int key = sh.key;
                const u8* ban = a.ban_mask + (long long)a.g_ban_row[sh.g] * N;
                // the node-type bias row of the gang's key: one f32 add after
                // the packing-score chain (TR > 1 only)
                const float* bias = HET ? a.type_bias + (long long)sh.trow * a.T : nullptr;
                const float* al0 = a.alloc;
                const float* all = a.alloc + (long long)level * NR;
                ArgMin bc{ARMADA_INF, ARMADA_BIGI, 0}, bl{ARMADA_INF, ARMADA_BIGI, 0};
                long long sc = 0, sl = 0;
                for (int n = n0 + tid; n < n1; n += blockDim.x) {
                    const bool ok = (key < 0 || a.compat[(long long)key * a.T + a.node_type[n]]) &&
                                    a.node_ok[n] && !ban[n];
                    int cc = 0, cl = 0;
                    float s0 = ARMADA_INF, s1 = ARMADA_INF;
                    if (ok) {
                        cc = min(member_capacity(al0 + (long long)n * R, sh.req_node, R), card);
                        cl = min(member_capacity(all + (long long)n * R, sh.req_node, R), card);
                        s0 = packing_score(al0 + (long long)n * R, a.inv_scale, R);
                        s1 = packing_score(all + (long long)n * R, a.inv_scale, R);
                        if (bias) {
                            const float b = bias[a.node_type[n]];
                            s0 = __fadd_rn(s0, b);
                            s1 = __fadd_rn(s1, b);
                        }
                    }
                    sc += cc;
                    sl += cl;
                    if (cc >= 1) bc = argmin_pick(bc, ArgMin{s0, n, 0});
                    if (cl >= 1) bl = argmin_pick(bl, ArgMin{s1, n, 0});
                    if (card > 1) {
                        a.cap_c[n] = cc;
                        a.cap_l[n] = cl;
                        a.score_c[n] = s0;
                        a.score_l[n] = s1;
                    }
                }
                sc = block_sum_ll(sc, redl);
                sl = block_sum_ll(sl, redl);
                bc = block_argmin(bc, red);
                bl = block_argmin(bl, red);
                if constexpr (CL) {
                    // the pass's four reductions in one exchange
                    ArgMin m2[2] = {bc, bl};
                    long long s2[2] = {sc, sl};
                    cluster_combine<2, 2, 0>(cx, m2, s2, nullptr);
                    bc = m2[0];
                    bl = m2[1];
                    sc = s2[0];
                    sl = s2[1];
                }
                const bool use_clean = sc >= card;
                const long long ssel = use_clean ? sc : sl;
                if (card == 1) {
                    if (tid == 0) {
                        const ArgMin b = use_clean ? bc : bl;
                        const bool found = ssel >= 1;
                        for (int w = 0; w < W; ++w) {
                            nodes_w[w] = N;
                            counts_w[w] = 0;
                        }
                        nodes_w[0] = found ? b.i : N;
                        counts_w[0] = found ? 1 : 0;
                        sh.fit_feasible = ssel >= card;
                    }
                    __syncthreads();
                } else {
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
                    __syncthreads();
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
                    __syncthreads();
                }
            }
        }

        // --- commit ---------------------------------------------------------------------
        if (tid == 0) {
            const bool attempt = sh.attempt;
            const bool placed = attempt && sh.fit_feasible && sh.float_ok;
            const int qstar = sh.qstar, g = sh.g, card = sh.card, pc = sh.pc;
            const bool ev = sh.is_ev;
            if (placed) {
                const int lo = ev ? 1 : 0;
                for (int w = 0; w < W; ++w) {
                    const int node = nodes_w[w];
                    if (node >= N) continue;
                    const float cnt = (float)counts_w[w];
                    for (int l = lo; l <= sh.level && l < a.P1; ++l)
                        for (int r = 0; r < R; ++r) {
                            float* p = a.alloc + (long long)l * NR + (long long)node * R + r;
                            *p = __fsub_rn(*p, __fmul_rn(cnt, sh.req_node[r]));
                        }
                }
                for (int r = 0; r < R; ++r) {
                    a.q_alloc[qstar * R + r] = __fadd_rn(a.q_alloc[qstar * R + r], sh.req_tot[r]);
                    float* pp = a.q_alloc_pc + ((long long)qstar * a.C + pc) * R + r;
                    *pp = __fadd_rn(*pp, sh.req_tot[r]);
                    a.spot_res[r] = __fadd_rn(a.spot_res[r], sh.req_tot[r]);
                }
                if (!ev) {
                    sh.sched_count += card;
                    for (int r = 0; r < R; ++r) {
                        a.sched_res[r] = __fadd_rn(a.sched_res[r], sh.req_tot[r]);
                        a.float_used[r] = __fadd_rn(a.float_used[r], sh.req_float[r]);
                    }
                    a.q_sched[qstar] += card;
                } else {
                    a.run_rescheduled[sh.run] = 1;
                }
                if (market && *a.spot_price < 0.0f) {
                    float share = -ARMADA_INF;
                    for (int r = 0; r < R; ++r) {
                        const float t = a.total_pool[r];
                        float f = t > 0.0f ? __fdiv_rn(a.spot_res[r], fmaxf(t, 1e-9f)) : 0.0f;
                        f = __fmul_rn(f, a.drf_mult[r]);
                        share = fmaxf(share, f);
                    }
                    if (share > *a.spot_cutoff) *a.spot_price = a.g_spot_price[g];
                }
                if (!ev) {
                    const int cur = sh.cursor;
                    if (cur < a.S) {
                        a.slot_gang[cur] = g;
                        for (int w = 0; w < W; ++w) {
                            a.slot_nodes[(long long)cur * W + w] = nodes_w[w];
                            a.slot_counts[(long long)cur * W + w] = counts_w[w];
                        }
                    }
                    sh.cursor = cur + 1;
                }
                a.g_state[g] = 1;
            } else if (attempt) {
                a.g_state[g] = 2;
                if (card == 1 && sh.key >= 0) a.key_bad[sh.key] = 1;
            }
            if (sh.gate_queue) a.q_killed[qstar] = 1;
            if (sh.gate_global) {
                sh.new_blocked = 1;
                if (sh.termination == 0) sh.termination = sh.hit_burst ? 1 : 2;
            }
            sh.done = !sh.any_q && !sh.advanced;
            sh.placed = placed;
            sh.n_ext = 0;
        }
        __syncthreads();
        // --- the multi-commit extension (K10) ---------------------------------------
        if (EXT && sh.placed && !market && !sh.hidden) {
            extension<typename std::remove_reference<decltype(ext)>::type, CL>(a, sh, ext, cx);
            __syncthreads();
        }
        // --- K11: the fit cache's upkeep, or the pick chain -------------------------
        if (a.CS > 0 && sh.placed)
            cache_upkeep(a, nodes_w, EXT ? &ext.node[0] : nullptr, EXT ? sh.n_ext : 0, n0, n1);
        if (BK && sh.placed) {
            pick_chain<HET, typename std::remove_reference<decltype(ch)>::type, CL>(a, sh, ch, redq, red,
                                                                                    redl, cx);
            __syncthreads();
        }
        if (tid == 0) {
            sh.iterations += 1 + sh.n_ext;
            sh.kiters += 1;
        }
        __syncthreads();
    }
    if (tid == 0) {
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
    if constexpr (CL) cg::this_cluster().sync();
}

// The placement loop's launchers: the narrow instantiations (round.cu), the
// wide ones (round_wide.cu) and K-K's cluster (round_cluster.cu).  Each
// returns the launch's cudaError_t.
typedef void (*PlaceLoop)(RoundArgs, int*, int*);
int launch_place_loop_wide(const RoundArgs& a, dim3 grid, int* nodes_w, int* counts_w,
                           cudaStream_t stream);
int launch_place_loop_cluster(const RoundArgs& a, int S, int* nodes_w, int* counts_w,
                              cudaStream_t stream);
int place_loop_cluster_max(const RoundArgs& a, int S);

// The loop's block size at a loop shape.
static inline int place_loop_block(const RoundArgs& a) {
    return a.commit_k > 1 ? EXT_BLOCK : a.batch_k > 1 ? BK_BLOCK : ARMADA_BLOCK;
}

