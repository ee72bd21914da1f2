// K-B: the scheduling round.
//
// Replaces the JAX package's models/fair_scheduler.py `_schedule_round_jit`
// (with `_make_place_iteration`, `_phase_b`, `_move_runs_to_evicted`,
// `_fit_row`, and ops/fit.py, ops/packing.py, ops/fairness.py inlined), at the
// single-commit, uncached loop shape (commit_k=1, cache_slots=0, batch_k=1,
// unroll=1).  Plain version: armada_tpu_torch/models/fair_scheduler.py
// `schedule_round_plain`, which this file follows step by step.
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

#include "common.cuh"

#define SKIP_WINDOW 16
#define MAX_R 8

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
                               //      sched_count, done, kernel_iters
    // shapes and statics
    int N, R, G, Q, RJ, K, T, C, P1, S, W, max_iter;
};

enum { SC_NSLOTS = 0, SC_ITERS = 1, SC_TERM = 2, SC_SCHED = 3, SC_DONE = 4, SC_KITERS = 5 };

#define GRID_STRIDE(i, n) \
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
         i += (long long)gridDim.x * blockDim.x)

// --- prologue ------------------------------------------------------------------

// used[level, node] += run_req * node_axes for valid runs; q_alloc and
// q_alloc_pc += run_req; float_used += run_req * (1 - node_axes).
__global__ void prologue_scatter_kernel(RoundArgs a) {
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        if (!a.run_valid[j]) continue;
        const int node = a.run_node[j], lvl = a.run_level[j];
        const int q = a.run_queue[j], pc = a.run_pc[j];
        for (int r = 0; r < R; ++r) {
            const float req = a.run_req[j * R + r];
            atomicAdd(&a.used[((long long)lvl * a.N + node) * R + r], __fmul_rn(req, a.node_axes[r]));
            atomicAdd(&a.q_alloc[q * R + r], req);
            atomicAdd(&a.q_alloc_pc[((long long)q * a.C + pc) * R + r], req);
            atomicAdd(&a.float_used[r], __fmul_rn(req, __fsub_rn(1.0f, a.node_axes[r])));
        }
    }
}

// alloc[p] = total - sum_{p' >= p} used[p'] (suffix sum over the ladder).
__global__ void prologue_alloc_kernel(RoundArgs a) {
    const long long NR = (long long)a.N * a.R;
    GRID_STRIDE(i, NR) {
        float s = 0.0f;
        for (int p = a.P1 - 1; p >= 0; --p) {
            s = p == a.P1 - 1 ? a.used[p * NR + i] : __fadd_rn(s, a.used[p * NR + i]);
            a.alloc[p * NR + i] = __fsub_rn(a.node_total[i], s);
        }
    }
}

// The fair-share eviction gate and the move of evicted runs' usage to level 0.
__global__ void evict_kernel(RoundArgs a) {
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        const int q = a.run_queue[j];
        bool ev = false;
        if (a.run_valid[j] && a.run_preemptible[j] && a.run_gang[j] >= 0 && a.q_weight[q] > 0.0f) {
            const float actual = drf_unweighted(a.q_alloc + q * R, a.total_pool, a.drf_mult, R);
            const float fairsh = fmaxf(a.dcafs[q], a.fair_share[q]);
            const float frac = fairsh > 0.0f ? __fdiv_rn(actual, fairsh) : ARMADA_INF;
            ev = frac > *a.protected_fraction;
        }
        a.run_evicted[j] = ev ? 1 : 0;
    }
}

// Runs flagged in `move` give their usage back at levels 1..run_level and
// leave their queue's allocation (the marker at level 0 stays).
__global__ void move_to_evicted_kernel(RoundArgs a, const u8* move, int with_pc) {
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        if (!move[j]) continue;
        const int node = a.run_node[j], lvl = a.run_level[j];
        const int q = a.run_queue[j], pc = a.run_pc[j];
        for (int r = 0; r < R; ++r) {
            const float d = a.run_req[j * R + r];
            const float dn = __fmul_rn(d, a.node_axes[r]);
            for (int l = 1; l <= lvl && l < a.P1; ++l)
                atomicAdd(&a.alloc[((long long)l * a.N + node) * R + r], dn);
            atomicAdd(&a.q_alloc[q * R + r], -d);
            if (with_pc) atomicAdd(&a.q_alloc_pc[((long long)q * a.C + pc) * R + r], -d);
        }
    }
}

__global__ void gstate_init_kernel(RoundArgs a) {
    GRID_STRIDE(g, a.G) {
        const int run = a.g_run[g];
        const bool active = run >= 0 ? a.run_evicted[run] != 0 : false;
        const bool valid = a.g_valid[g] != 0;
        int s = (valid && (run < 0 || active)) ? 0 : 2;
        if (valid && run >= 0 && !active) s = 3;
        if (!valid) s = 2;
        if (a.g_absent[g]) s = 3;
        a.g_state[g] = s;
    }
}

// --- the placement loop ----------------------------------------------------------

struct LoopShared {
    int nlive;
    int done, iterations, termination, cursor, sched_count, new_blocked;
    int advanced;
    // the iteration's pick
    int any_q, qstar, g, card, level, key, pc, run, is_ev, pinned;
    int attempt, gate_global, gate_queue, hit_burst, float_ok;
    float req[MAX_R], req_node[MAX_R], req_tot[MAX_R], req_float[MAX_R];
    // the fit
    int fit_feasible;
};

__device__ __forceinline__ int gq_at(const RoundArgs& a, long long idx) {
    if (idx < 0) idx = 0;
    if (idx > a.G - 1) idx = a.G - 1;
    return a.gq_gang[idx];
}

// nodes_w / counts_w: i32[W] rows holding the (node, count) spread of the
// gang being placed; node N marks an unused entry.
__global__ void __launch_bounds__(ARMADA_BLOCK) place_loop_kernel(RoundArgs a, int* nodes_w,
                                                                  int* counts_w) {
    __shared__ LoopShared sh;
    __shared__ ArgMin red[ARMADA_WARPS + 1];
    __shared__ long long redl[ARMADA_WARPS + 1];
    const int tid = threadIdx.x;
    const int R = a.R, N = a.N, W = a.W;
    const long long NR = (long long)N * R;

    // live queues (those holding gangs), ascending; and the loop state
    if (tid == 0) {
        int n = 0;
        for (int q = 0; q < a.Q; ++q)
            if (a.q_len[q] > 0) a.live_q[n++] = q;
        sh.nlive = n;
        sh.done = 0;
        sh.iterations = 0;
        sh.termination = 0;
        sh.cursor = 0;
        sh.sched_count = 0;
        sh.new_blocked = 0;
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
    __syncthreads();
    const bool market = *a.market != 0;

    while (!sh.done && sh.iterations < a.max_iter) {
        // --- cursors, candidates and the queue pick -----------------------------
        ArgMin best{ARMADA_INF, ARMADA_BIGI, 0};
        bool any_has = false, adv = false;
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
            const bool visible = nskip < SKIP_WINDOW && head + nskip < len;
            const int cand = visible ? gq_at(a, (long long)start + head + nskip) : 0;
            const bool cand_new = a.g_run[cand] < 0;
            const bool has = visible && !(cand_new && (sh.new_blocked || a.q_killed[q])) &&
                             a.q_weight[q] > 0.0f;
            if (has) {
                float key;
                if (market) {
                    key = -a.g_price[cand];
                } else {
                    float x[MAX_R];
                    const float cardf = (float)a.g_card[cand];
                    for (int r = 0; r < R; ++r)
                        x[r] = __fadd_rn(__fadd_rn(a.q_alloc[q * R + r], a.q_penalty[q * R + r]),
                                         __fmul_rn(a.g_req[(long long)cand * R + r], cardf));
                    key = drf_weighted(x, a.total_pool, a.drf_mult, a.q_weight[q], R);
                }
                ArgMin c{key, q, cand};
                best = argmin_pick(best, c);
                any_has = true;
            }
        }
        const bool any_q = block_any(any_has);
        const bool advanced = block_any(adv);
        best = block_argmin(best, red);

        if (tid == 0) {
            sh.any_q = any_q;
            sh.advanced = advanced;
            sh.attempt = 0;
            sh.gate_global = 0;
            sh.gate_queue = 0;
            sh.hit_burst = 0;
            if (any_q) {
                const int qstar = best.i, g = best.extra;
                sh.qstar = qstar;
                sh.g = g;
                const int card = a.g_card[g];
                const float cardf = (float)card;
                sh.card = card;
                sh.level = a.g_level[g];
                sh.key = a.g_key[g];
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
            } else {
                const int key = sh.key;
                const u8* ban = a.ban_mask + (long long)a.g_ban_row[sh.g] * N;
                const float* al0 = a.alloc;
                const float* all = a.alloc + (long long)level * NR;
                ArgMin bc{ARMADA_INF, ARMADA_BIGI, 0}, bl{ARMADA_INF, ARMADA_BIGI, 0};
                long long sc = 0, sl = 0;
                for (int n = tid; n < N; n += blockDim.x) {
                    const bool ok = (key < 0 || a.compat[(long long)key * a.T + a.node_type[n]]) &&
                                    a.node_ok[n] && !ban[n];
                    int cc = 0, cl = 0;
                    float s0 = ARMADA_INF, s1 = ARMADA_INF;
                    if (ok) {
                        cc = min(member_capacity(al0 + (long long)n * R, sh.req_node, R), card);
                        cl = min(member_capacity(all + (long long)n * R, sh.req_node, R), card);
                        s0 = packing_score(al0 + (long long)n * R, a.inv_scale, R);
                        s1 = packing_score(all + (long long)n * R, a.inv_scale, R);
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
                        for (int n = tid; n < N; n += blockDim.x) {
                            if (cap[n] < 1) continue;
                            const float s = score[n];
                            if (argmin_less(pv, pi, s, n)) b = argmin_pick(b, ArgMin{s, n, cap[n]});
                        }
                        b = block_argmin(b, red);
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
            sh.iterations += 1;
        }
        __syncthreads();
    }
    if (tid == 0) {
        int term = sh.termination;
        if (!sh.done && sh.iterations >= a.max_iter) term = 3;
        a.scal[SC_NSLOTS] = sh.cursor;
        a.scal[SC_ITERS] = sh.iterations;
        a.scal[SC_TERM] = term;
        a.scal[SC_SCHED] = sh.sched_count;
        a.scal[SC_DONE] = sh.done;
        a.scal[SC_KITERS] = sh.iterations;
    }
}

// Gangs whose key was registered unfeasible but which no cursor reached.
__global__ void key_sweep_kernel(RoundArgs a) {
    GRID_STRIDE(g, a.G) {
        const int key = a.g_key[g];
        if (a.g_state[g] == 0 && a.g_valid[g] && key >= 0 && a.key_bad[key]) a.g_state[g] = 2;
    }
}

// --- phase B ------------------------------------------------------------------------

// Oversubscription eviction: runs holding a slot on a node whose allocatable
// is negative at their (real) level.
__global__ void over_evict_kernel(RoundArgs a) {
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        const int lvl = a.run_level[j], node = a.run_node[j];
        bool over = false;
        if (lvl != 0)
            for (int r = 0; r < R; ++r)
                over |= a.alloc[((long long)lvl * a.N + node) * R + r] < 0.0f;
        const bool holds = a.run_valid[j] && (!a.run_evicted[j] || a.run_rescheduled[j]);
        const bool e2 = holds && a.run_preemptible[j] && a.run_gang[j] >= 0 && over;
        a.pending[j] = e2 ? 1 : 0;
    }
}

__global__ void over_apply_kernel(RoundArgs a) {
    GRID_STRIDE(j, a.RJ) {
        if (a.pending[j]) {
            a.run_evicted[j] = 1;
            a.run_rescheduled[j] = 0;
        }
    }
}

// The pinned re-schedule fixed point: per iteration each node admits its
// cheapest-queue pending evictee that fits (ties to the lowest run index).
// One block; at most max_fix iterations, ending when nothing was admitted.
__global__ void __launch_bounds__(ARMADA_BLOCK) fixpoint_kernel(RoundArgs a, int max_fix) {
    const int tid = threadIdx.x;
    const int R = a.R, N = a.N;
    bool progress = false;
    for (int j = tid; j < a.RJ; j += blockDim.x) progress |= a.pending[j] != 0;
    progress = block_any(progress);
    int it = 0;
    while (it < max_fix && progress) {
        for (int n = tid; n < N; n += blockDim.x) {
            a.nmin[n] = ordered_bits(ARMADA_INF);
            a.rmin[n] = ARMADA_BIGI;
        }
        __syncthreads();
        for (int j = tid; j < a.RJ; j += blockDim.x) {
            float c = ARMADA_INF;
            if (a.pending[j]) {
                const int lvl = a.run_level[j], node = a.run_node[j], q = a.run_queue[j];
                bool fits = true;
                float x[MAX_R];
                for (int r = 0; r < R; ++r) {
                    const float req = a.run_req[j * R + r];
                    fits &= a.alloc[((long long)lvl * N + node) * R + r] >= __fmul_rn(req, a.node_axes[r]);
                    x[r] = __fadd_rn(a.q_alloc[q * R + r], req);
                }
                if (fits) c = drf_weighted(x, a.total_pool, a.drf_mult, a.q_weight[q], R);
                if (fits) atomicMin(&a.nmin[node], ordered_bits(c));
            }
            a.cost[j] = c;
        }
        __syncthreads();
        for (int j = tid; j < a.RJ; j += blockDim.x) {
            if (!a.pending[j] || !(a.cost[j] < ARMADA_INF)) continue;
            const int node = a.run_node[j];
            if (ordered_bits(a.cost[j]) <= a.nmin[node]) atomicMin(&a.rmin[node], (int)j);
        }
        __syncthreads();
        bool won = false;
        for (int j = tid; j < a.RJ; j += blockDim.x) {
            if (!a.pending[j] || !(a.cost[j] < ARMADA_INF)) continue;
            const int node = a.run_node[j];
            if (a.rmin[node] != j) continue;
            won = true;
            const int lvl = a.run_level[j], q = a.run_queue[j];
            for (int r = 0; r < R; ++r) {
                const float req = a.run_req[j * R + r];
                const float dn = __fmul_rn(req, a.node_axes[r]);
                for (int l = 1; l <= lvl && l < a.P1; ++l) {
                    float* p = a.alloc + ((long long)l * N + node) * R + r;
                    *p = __fsub_rn(*p, dn);
                }
                atomicAdd(&a.q_alloc[q * R + r], req);
            }
            a.run_rescheduled[j] = 1;
            a.pending[j] = 0;
        }
        progress = block_any(won);
        ++it;
    }
}

// Drop the evicted markers of runs that did not come back.
__global__ void unbind_kernel(RoundArgs a) {
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        if (!(a.run_evicted[j] && !a.run_rescheduled[j])) continue;
        const int node = a.run_node[j];
        for (int r = 0; r < R; ++r)
            atomicAdd(&a.alloc[(long long)node * R + r], __fmul_rn(a.run_req[j * R + r], a.node_axes[r]));
    }
}

static int grid_for(long long n) {
    long long b = (n + 255) / 256;
    if (b < 1) b = 1;
    if (b > 4096) b = 4096;
    return (int)b;
}

// Running usage into used/alloc/q_alloc/q_alloc_pc/float_used.  The caller
// zeroes used, q_alloc, q_alloc_pc and float_used first.
extern "C" int armada_round_prologue(const RoundArgs* args, cudaStream_t stream) {
    RoundArgs a = *args;
    if (a.R > MAX_R) return -1;
    ARMADA_LAUNCH(prologue_scatter_kernel, grid_for(a.RJ), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(prologue_alloc_kernel, grid_for((long long)a.N * a.R), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

// Everything after the fair shares: the eviction gate and move, gang
// activation, the placement loop, the key sweep, phase B and the unbind.
// nodes_w / counts_w: i32[W] scratch rows for the spread being built.
extern "C" int armada_round_main(const RoundArgs* args, int* nodes_w, int* counts_w,
                                 int max_fix, cudaStream_t stream) {
    RoundArgs a = *args;
    if (a.R > MAX_R) return -1;
    ARMADA_LAUNCH(evict_kernel, grid_for(a.RJ), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(move_to_evicted_kernel, grid_for(a.RJ), 256, stream)(a, a.run_evicted, 1);
    ARMADA_CHECK();
    ARMADA_LAUNCH(gstate_init_kernel, grid_for(a.G), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(place_loop_kernel, 1, ARMADA_BLOCK, stream)(a, nodes_w, counts_w);
    ARMADA_CHECK();
    ARMADA_LAUNCH(key_sweep_kernel, grid_for(a.G), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(over_evict_kernel, grid_for(a.RJ), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(move_to_evicted_kernel, grid_for(a.RJ), 256, stream)(a, a.pending, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(over_apply_kernel, grid_for(a.RJ), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(fixpoint_kernel, 1, ARMADA_BLOCK, stream)(a, max_fix);
    ARMADA_CHECK();
    ARMADA_LAUNCH(unbind_kernel, grid_for(a.RJ), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_round_args_size(void) { return (int)sizeof(RoundArgs); }
