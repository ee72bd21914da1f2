#include "round.cuh"

// --- prologue ------------------------------------------------------------------

// used[level, node] += run_req * node_axes for valid runs; q_alloc and
// q_alloc_pc += run_req; float_used += run_req * (1 - node_axes).
__global__ void prologue_scatter_kernel(RoundArgs a0) {
    LANE_ARGS;
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
__global__ void prologue_alloc_kernel(RoundArgs a0) {
    LANE_ARGS;
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
__global__ void evict_kernel(RoundArgs a0) {
    LANE_ARGS;
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
// use_pending: 0 moves the runs flagged in run_evicted, 1 those in pending.
__global__ void move_to_evicted_kernel(RoundArgs a0, int use_pending, int with_pc) {
    LANE_ARGS;
    const u8* move = use_pending ? a.pending : a.run_evicted;
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

__global__ void gstate_init_kernel(RoundArgs a0) {
    LANE_ARGS;
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

// Gangs whose key was registered unfeasible but which no cursor reached.
__global__ void key_sweep_kernel(RoundArgs a0) {
    LANE_ARGS;
    GRID_STRIDE(g, a.G) {
        const int key = a.g_key[g];
        if (a.g_state[g] == 0 && a.g_valid[g] && key >= 0 && a.key_bad[key]) a.g_state[g] = 2;
    }
}

// --- phase B ------------------------------------------------------------------------

// Oversubscription eviction: runs holding a slot on a node whose allocatable
// is negative at their (real) level.
__global__ void over_evict_kernel(RoundArgs a0) {
    LANE_ARGS;
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

__global__ void over_apply_kernel(RoundArgs a0) {
    LANE_ARGS;
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
__global__ void __launch_bounds__(ARMADA_BLOCK) fixpoint_kernel(RoundArgs a0, int max_fix) {
    LANE_ARGS;
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
__global__ void unbind_kernel(RoundArgs a0) {
    LANE_ARGS;
    const int R = a.R;
    GRID_STRIDE(j, a.RJ) {
        if (!(a.run_evicted[j] && !a.run_rescheduled[j])) continue;
        const int node = a.run_node[j];
        for (int r = 0; r < R; ++r)
            atomicAdd(&a.alloc[(long long)node * R + r], __fmul_rn(a.run_req[j * R + r], a.node_axes[r]));
    }
}

// Grid of a grid-stride kernel over n elements of each of P lanes.
static dim3 grid_for(long long n, int lanes) {
    long long b = (n + 255) / 256;
    if (b < 1) b = 1;
    if (b > 4096) b = 4096;
    return dim3((unsigned)b, (unsigned)lanes);
}

static bool args_ok(const RoundArgs& a) {
    const bool base = a.R <= MAX_R && a.P >= 1 && a.P <= 65535 && a.TR >= 1 && a.commit_k >= 1 &&
                      !(a.prefer_large && a.commit_k > 1);
    const bool cache = a.CS >= 0 && a.CB >= 1 && a.CB <= 64 && a.N % a.CB == 0;
    const bool chain = a.batch_k >= 1 &&
                       (a.batch_k == 1 || (a.commit_k == 1 && !a.prefer_large && a.CS == 0));
    long long ni, nf, nb;
    wide_need(a.commit_k, a.batch_k, &ni, &nf, &nb);
    const bool wide = a.WI >= ni && a.WF >= nf && a.WB >= nb &&
                      (ni == 0 || (a.wide_i != nullptr && a.wide_f != nullptr)) &&
                      (nb == 0 || a.wide_b != nullptr);
    return base && cache && chain && wide && a.unroll >= 1;
}

// The placement loop's narrow instantiation for the round's loop shape, or
// the wide one's launcher (round_wide.cu).
static int launch_place_loop(const RoundArgs& a, dim3 grid, int* nodes_w, int* counts_w,
                             cudaStream_t stream) {
    if (a.commit_k > MAX_COMMIT_K || a.batch_k > MAX_BATCH_K)
        return launch_place_loop_wide(a, grid, nodes_w, counts_w, stream);
    const bool het = a.TR > 1;
    PlaceLoop k;
    if (a.commit_k > 1)
        k = het ? place_loop_kernel<true, false, true, false, false, false>
                : place_loop_kernel<true, false, false, false, false, false>;
    else if (a.prefer_large)
        k = het ? place_loop_kernel<false, true, true, false, false, false>
                : place_loop_kernel<false, true, false, false, false, false>;
    else if (a.batch_k > 1)
        k = het ? place_loop_kernel<false, false, true, true, false, false>
                : place_loop_kernel<false, false, false, true, false, false>;
    else
        k = het ? place_loop_kernel<false, false, true, false, false, false>
                : place_loop_kernel<false, false, false, false, false, false>;
    int err = 0;
    const int hot = hot_bytes(a, (const void*)k, &err);
    if (err) return err;
    ARMADA_LAUNCH_SMEM(k, grid, place_loop_block(a), hot, stream)(a, nodes_w, counts_w, hot > 0);
    return (int)cudaGetLastError();
}

// Running usage into used/alloc/q_alloc/q_alloc_pc/float_used.  The caller
// zeroes used, q_alloc, q_alloc_pc and float_used first.
extern "C" int armada_round_prologue(const RoundArgs* args, cudaStream_t stream) {
    RoundArgs a = *args;
    if (!args_ok(a)) return -1;
    ARMADA_LAUNCH(prologue_scatter_kernel, grid_for(a.RJ, a.P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(prologue_alloc_kernel, grid_for((long long)a.N * a.R, a.P), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

// The launches before the placement loop: the eviction gate and move, gang
// activation.
static int round_head(const RoundArgs& a, cudaStream_t stream) {
    ARMADA_LAUNCH(evict_kernel, grid_for(a.RJ, a.P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(move_to_evicted_kernel, grid_for(a.RJ, a.P), 256, stream)(a, 0, 1);
    ARMADA_CHECK();
    ARMADA_LAUNCH(gstate_init_kernel, grid_for(a.G, a.P), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

// The launches after it: the key sweep, phase B and the unbind.  Phase B's
// fixed point stays one block reading the whole node axis, in the sharded
// round too: on one card it can.
static int round_tail(const RoundArgs& a, int max_fix, cudaStream_t stream) {
    ARMADA_LAUNCH(key_sweep_kernel, grid_for(a.G, a.P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(over_evict_kernel, grid_for(a.RJ, a.P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(move_to_evicted_kernel, grid_for(a.RJ, a.P), 256, stream)(a, 1, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(over_apply_kernel, grid_for(a.RJ, a.P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(fixpoint_kernel, dim3(1, a.P), ARMADA_BLOCK, stream)(a, max_fix);
    ARMADA_CHECK();
    ARMADA_LAUNCH(unbind_kernel, grid_for(a.RJ, a.P), 256, stream)(a);
    ARMADA_CHECK();
    return 0;
}

// Everything after the fair shares: the eviction gate and move, gang
// activation, the placement loop, the key sweep, phase B and the unbind.
// nodes_w / counts_w: i32[P, W] scratch rows for the spreads being built.
extern "C" int armada_round_main(const RoundArgs* args, int* nodes_w, int* counts_w,
                                 int max_fix, cudaStream_t stream) {
    RoundArgs a = *args;
    if (!args_ok(a)) return -1;
    int rc = round_head(a, stream);
    if (rc) return rc;
    rc = launch_place_loop(a, dim3(1, a.P), nodes_w, counts_w, stream);
    if (rc) return rc;
    return round_tail(a, max_fix, stream);
}

// The cluster's replicas: the state the placement loop reads before it
// writes it (the post-eviction allocatable, the queues' allocations, the
// floating usage, the gang states), copied from replica 0 -- the round's own
// state, P lanes -- into replicas 1..S-1, each P lanes' size further on.
__global__ void replicate_kernel(RoundArgs a, int S) {
    const long long L = a.P;
    const long long P1NR = L * a.P1 * a.N * a.R, QR = L * a.Q * a.R;
    const long long QCR = QR * a.C, RR = L * a.R, total = P1NR + QR + QCR + RR + L * a.G;
    GRID_STRIDE(i, total) {
        long long j = i;
        if (j < P1NR) {
            for (int r = 1; r < S; ++r) a.alloc[r * P1NR + j] = a.alloc[j];
            continue;
        }
        j -= P1NR;
        if (j < QR) {
            for (int r = 1; r < S; ++r) a.q_alloc[r * QR + j] = a.q_alloc[j];
            continue;
        }
        j -= QR;
        if (j < QCR) {
            for (int r = 1; r < S; ++r) a.q_alloc_pc[r * QCR + j] = a.q_alloc_pc[j];
            continue;
        }
        j -= QCR;
        if (j < RR) {
            for (int r = 1; r < S; ++r) a.float_used[r * RR + j] = a.float_used[j];
            continue;
        }
        j -= RR;
        for (int r = 1; r < S; ++r) a.g_state[r * L * a.G + j] = a.g_state[j];
    }
}

// The round with its placement loop over S node shards, one cluster of S
// CTAs a lane (round_cluster.cu): solo (P = 1) or stacked, its state
// buffers holding S replicas of the P lanes, replica r's P lanes at r x P;
// replica 0 is the result.
extern "C" int armada_round_sharded_main(const RoundArgs* args, int S, int* nodes_w, int* counts_w,
                                         int max_fix, cudaStream_t stream) {
    RoundArgs a = *args;
    if (!args_ok(a) || S < 2 || S > MAX_CLUSTER || a.N % S != 0 ||
        (a.CS > 0 && (a.N / S) % a.CB != 0) ||
        a.commit_k > MAX_COMMIT_K || a.batch_k > MAX_BATCH_K)
        return -1;
    int rc = round_head(a, stream);
    if (rc) return rc;
    ARMADA_LAUNCH(replicate_kernel, grid_for((long long)a.P * a.P1 * a.N * a.R, 1), 256,
                  stream)(a, S);
    ARMADA_CHECK();
    rc = launch_place_loop_cluster(a, S, nodes_w, counts_w, stream);
    if (rc) return rc;
    return round_tail(a, max_fix, stream);
}

// How many S-CTA clusters of the round's loop instantiation the card can
// hold at once (cudaOccupancyMaxActiveClusters); 0: it cannot launch one.
extern "C" int armada_round_cluster_max(const RoundArgs* args, int S) {
    return place_loop_cluster_max(*args, S);
}

// The wide instantiations' scratch a lane needs: {ints, floats, bytes}.
extern "C" void armada_round_wide_need(int commit_k, int batch_k, long long* out) {
    wide_need(commit_k, batch_k, out, out + 1, out + 2);
}

extern "C" int armada_round_args_size(void) { return (int)sizeof(RoundArgs); }

#ifdef ROUND_STEP_PROFILE
// The step profile of the last placement loop launched in one form: 0 the
// narrow instantiations, 1 the cluster, 2 the wide ones (PS_SLOTS values).
extern "C" int armada_round_step_profile(long long* out, int form) {
    if (form == 1) return round_prof_fetch_cluster(out);
    if (form == 2) return round_prof_fetch_wide(out);
    return round_prof_fetch(out);
}

extern "C" int armada_round_step_profile_slots(void) { return PS_SLOTS; }
#endif
