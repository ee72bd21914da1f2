// K-I: round verification -- eight conservation invariants over the
// round-final state and a fingerprint of the compact decode buffer, one
// i32[16] buffer out.
//
// Replaces the JAX package's armada_tpu/models/verify.py
// `_verify_kernel_impl`.  Plain version: armada_tpu_torch/models/verify.py
// `verify_kernel_plain` (layout and invariants documented there).
//
// Exactness: the integer invariants and the fingerprint are order-free (XOR,
// and int32 sums that wrap like jnp.sum(dtype=int32)).  The two f32
// accumulators (per-node usage [N,R] and per-queue allocation [Q,R]) add
// values integral in resolution units, so atomics give the JAX result bit
// for bit while every sum stays below 2^24 (chip_smoke.py checks the bound
// at the reference scale).  A zero term is skipped: adding +-0 to a sum that
// starts at +0 and never becomes -0 changes nothing, while a NaN or inf term
// is still added.  The two tolerances are fused multiply-adds, as XLA:CPU
// contracts the JAX package's `0.5 + 1e-3 * node_total` and
// `1.0 + 1e-3 * max(...)` (tests/test_torch_verify.py pins it).  The maxima
// of |difference| are order-free: an unsigned max on the bits of fabsf(d),
// so a NaN (any payload, sign cleared) beats +inf beats every finite value,
// as jnp.max propagates NaN; a NaN maximum is written as 0x7fc00000, the
// quiet NaN XLA:CPU writes (the plain version does the same).
//
// The stacked form (K-I stacked) replaces `_kernel_stacked` (verify.py:496,
// jax.vmap of the kernel over a stacked round's P lanes): both kernels take
// their lane from blockIdx.y; lane l's inputs, workspace and i32[16] output
// row start l x (per-lane length) past lane 0's, and its real gang count
// rides in the argument block (a device table past VF_INLINE lanes).
//
// Bound on this card: every input read once -- the problem's run and gang
// rows, the slots, the allocatable rows at the clean level, the compact
// buffer (~41 MB on the incremental path, G = 1,187,840) -- so ~12 us of
// HBM time.  Design: two launches a call and no memset.
//   accumulate: one grid whose blocks take a role each -- slots, runs,
//     fingerprint words, gangs (two a thread: their four i32 fields and the
//     tile's g_req rows, read flat and coalesced, all loaded before any is
//     used; 40 registers, so six blocks an SM keep enough bytes in flight).
//     Terms of [Q, R] go to a shared copy of the table (added to the
//     workspace's once a block per nonzero entry; a gang block opens it
//     only when one of its terms can be nonzero), terms of [N, R] to the
//     workspace's table; counts, flags and folds are reduced in the warp,
//     then the block, and reach global memory as one atomic a block.
//   compare: node-capacity and queue-alloc over [N, R] and [Q, R], each
//     cell read and then cleared for the next call; the last block of a
//     lane (an atomic ticket after __threadfence) writes the 16 words and
//     clears the lane's counters.  It is the accumulate pass's programmatic
//     dependent, so its launch and its loads of the inputs that pass does
//     not write overlap that pass's tail.
// Measured (chip_smoke.py --split, H100 SXM at 700 W): a call alone 0.023 ms
// on the incremental path, about half of its bound; see PERF.md.
// The slot-state invariant needs no pass over G: occurrences equal
// placed-queue exactly iff no live slot hits a gang that is not
// placed-queue, no gang is hit twice (an atomicExch of the call's epoch on a
// per-gang stamp that is never cleared), and the live slots that hit a gang
// are as many as the placed-queue gangs.  The workspace (kernels/verify.py
// keeps one per device, stream and shape) is zero where a call starts
// reading it, and stamps of an earlier epoch read as unhit.

#include "common.cuh"

#ifndef VF_DYN_SHARED
#define VF_DYN_SHARED(name) extern __shared__ __align__(16) u8 name[]
#endif
// Programmatic dependent launch (sm_90): the accumulate pass lets the
// compare pass launch once all its blocks run; the compare pass waits for
// the accumulate pass to complete, its writes visible, before it reads them.
#ifndef VF_LAUNCH_DEPENDENTS
#define VF_LAUNCH_DEPENDENTS() asm volatile("griddepcontrol.launch_dependents;")
#define VF_GRID_WAIT() asm volatile("griddepcontrol.wait;" ::: "memory")
#endif

#define VF_THREADS 256             // and runs or slots of a block
#define VF_GPT 2                    // gangs a thread of a gang block
#define VF_GANG_TILE (VF_THREADS * VF_GPT)
#define VF_MINB 6                   // accumulate blocks an SM holds: 40 registers a thread
#define VF_ROW 4                    // resources of a row loaded ahead (more: read in a loop)
#define VF_WORDS (VF_THREADS * 16)  // compact words of a fingerprint block
#define VF_CELLS (VF_THREADS * 4)   // [N, R] or [Q, R] cells of a compare block
#define VF_EXPQ_SHARED 8192         // [Q, R] cells the shared copy of the table holds
#define VF_INLINE 256               // lanes whose real gang counts ride in the arguments

enum {
    A_FLAGS = 0,
    A_FP_XOR,
    A_FP_SUM,
    A_SLOT_MEMBERS,
    A_PLACED_GANGS,
    A_PLACED_MEMBERS,
    A_NODE_DIFF,
    A_QUEUE_DIFF,
    A_N_EVICTED,
    A_N_RESCHEDULED,
    A_HITS,
    A_TICKET,
    A_LEN
};

// The argument block: int64 words (kernels/verify.py WORD), passed to both
// kernels by value.
struct VerifyArgs {
    const float* node_total;      // [N, R]
    const u8* node_ok;            // [N]
    const float* node_axes;       // [R]
    const float* run_req;         // [RJ, R]
    const int* run_node;          // [RJ]
    const int* run_queue;         // [RJ]
    const u8* run_valid;          // [RJ]
    const float* g_req;           // [G, R]
    const int* g_card;            // [G]
    const int* g_queue;           // [G]
    const int* g_run;             // [G]
    const int* g_state;           // [G]
    const int* slot_gang;         // [S]
    const int* slot_nodes;        // [S, W]
    const int* slot_counts;       // [S, W]
    const int* n_slots;           // scalar
    const u8* run_evicted;        // [RJ]
    const u8* run_rescheduled;    // [RJ]
    const float* alloc0;          // [N, R] clean-level allocatable
    const float* q_alloc;         // [Q, R]
    const int* sched_count;       // scalar
    const int* compact;           // [L]
    int* out;                     // [16]
    u8* ws;                       // lanes x ws_lane_bytes (vf_layout)
    const int* real_table;        // [P] real gang counts past VF_INLINE lanes, else null
    long long alloc0_stride;      // elements between two lanes' alloc0 (P1 * N * R)
    long long N, R, RJ, G, Q, S, W, L, lanes, epoch;
    long long real_inline[VF_INLINE];  // real gang counts of lanes < VF_INLINE
};

// One lane's workspace: used [N, R] f32, expq [Q, R] f32, the counters
// [A_LEN] u32, the stamps [G] u32; 256-byte pieces.
struct WsLayout {
    long long used, expq, acc, stamp, lane_bytes;
};

static __host__ __device__ __forceinline__ long long vf_piece(long long b) {
    return (b + 255) / 256 * 256;
}

static __host__ __device__ __forceinline__ WsLayout vf_layout(long long N, long long R,
                                                              long long Q, long long G) {
    WsLayout w;
    w.used = 0;
    w.expq = vf_piece(4 * N * R);
    w.acc = w.expq + vf_piece(4 * Q * R);
    w.stamp = w.acc + vf_piece(4 * A_LEN);
    w.lane_bytes = w.stamp + vf_piece(4 * G);
    return w;
}

// Lane l of a call (every lane has lane 0's shapes).
struct Lane {
    const float *node_total, *node_axes, *run_req, *g_req, *alloc0, *q_alloc;
    const u8 *node_ok, *run_valid, *run_evicted, *run_rescheduled;
    const int *run_node, *run_queue, *g_card, *g_queue, *g_run, *g_state, *slot_gang,
        *slot_nodes, *slot_counts, *n_slots, *sched_count, *compact;
    float *used, *expq;
    unsigned int *acc, *stamp;
    int* out;
    long long real_g;
};

static __device__ __forceinline__ Lane lane_of(const VerifyArgs& a, long long l) {
    const long long N = a.N, R = a.R, RJ = a.RJ, G = a.G, Q = a.Q, SW = a.S * a.W;
    Lane v;
    v.node_total = a.node_total + l * N * R;
    v.node_ok = a.node_ok + l * N;
    v.node_axes = a.node_axes + l * R;
    v.run_req = a.run_req + l * RJ * R;
    v.run_node = a.run_node + l * RJ;
    v.run_queue = a.run_queue + l * RJ;
    v.run_valid = a.run_valid + l * RJ;
    v.g_req = a.g_req + l * G * R;
    v.g_card = a.g_card + l * G;
    v.g_queue = a.g_queue + l * G;
    v.g_run = a.g_run + l * G;
    v.g_state = a.g_state + l * G;
    v.slot_gang = a.slot_gang + l * a.S;
    v.slot_nodes = a.slot_nodes + l * SW;
    v.slot_counts = a.slot_counts + l * SW;
    v.n_slots = a.n_slots + l;
    v.run_evicted = a.run_evicted + l * RJ;
    v.run_rescheduled = a.run_rescheduled + l * RJ;
    v.alloc0 = a.alloc0 + l * a.alloc0_stride;
    v.q_alloc = a.q_alloc + l * Q * R;
    v.sched_count = a.sched_count + l;
    v.compact = a.compact + l * a.L;
    v.out = a.out + l * 16;
    const WsLayout w = vf_layout(N, R, Q, G);
    u8* ws = a.ws + l * w.lane_bytes;
    v.used = (float*)(ws + w.used);
    v.expq = (float*)(ws + w.expq);
    v.acc = (unsigned int*)(ws + w.acc);
    v.stamp = (unsigned int*)(ws + w.stamp);
    v.real_g = l < VF_INLINE ? a.real_inline[l] : a.real_table[l];
    return v;
}

enum { OP_ADD, OP_OR, OP_XOR, OP_MAX };

// Every thread of the block calls it: v reduced over the warp, then lane 0
// folds a nonzero result into the block's shared counter k.
template <int OP>
static __device__ __forceinline__ void warp_into(unsigned int* sh, int k, unsigned int v) {
    const unsigned int full = 0xffffffffu;
    unsigned int r;
    if (OP == OP_ADD) r = __reduce_add_sync(full, v);
    else if (OP == OP_OR) r = __reduce_or_sync(full, v);
    else if (OP == OP_XOR) r = __reduce_xor_sync(full, v);
    else r = __reduce_max_sync(full, v);
    if ((threadIdx.x & 31) == 0 && r != 0) {
        if (OP == OP_ADD) atomicAdd(&sh[k], r);
        else if (OP == OP_OR) atomicOr(&sh[k], r);
        else if (OP == OP_XOR) atomicXor(&sh[k], r);
        else atomicMax(&sh[k], r);
    }
}

// After a barrier: the accumulate block's nonzero counters into the lane's,
// one atomic each (the maxima are the compare pass's).
static __device__ __forceinline__ void flush_counters(const unsigned int* sh, unsigned int* acc) {
    const int k = threadIdx.x;
    if (k >= A_TICKET || sh[k] == 0) return;
    if (k == A_FLAGS) atomicOr(&acc[k], sh[k]);
    else if (k == A_FP_XOR) atomicXor(&acc[k], sh[k]);
    else atomicAdd(&acc[k], sh[k]);
}

static __device__ __forceinline__ void add_f(float* p, float v) {
    if (v != 0.0f) atomicAdd(p, v);
}

// max as jnp.maximum: NaN propagates.
static __device__ __forceinline__ float jmax(float x, float y) {
    if (x != x) return x;
    if (y != y) return y;
    return x > y ? x : y;
}

// A NaN maximum (any payload: the card's arithmetic writes 0x7fffffff) as
// the quiet NaN XLA:CPU writes for it.
static __device__ __forceinline__ unsigned int qnan(unsigned int bits) {
    return bits > 0x7f800000u ? 0x7fc00000u : bits;
}

static __device__ __forceinline__ long long clamp_index(long long i, long long n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The [Q, R] table a block adds queue terms into: its shared copy where
// the table fits (`sq`, zeroed when the block opens it, then added to the
// lane's once per nonzero entry), else the lane's table.  Every thread of
// the block calls both.
static __device__ __forceinline__ float* qtable_open(float* sq, const Lane& v, long long QR) {
    if (!sq) return v.expq;
    for (long long i = threadIdx.x; i < QR; i += VF_THREADS) sq[i] = 0.0f;
    __syncthreads();
    return sq;
}

static __device__ __forceinline__ void qtable_close(float* sq, const Lane& v, long long QR) {
    if (!sq) return;
    __syncthreads();
    for (long long i = threadIdx.x; i < QR; i += VF_THREADS)
        if (sq[i] != 0.0f) atomicAdd(&v.expq[i], sq[i]);
}

// A gang block, VF_GPT gangs a thread: every load of the tile first (its
// four i32 fields, then its g_req rows read flat), placed-queue counts,
// then the queue terms -- only where some gang of the tile is placed-queue
// or some request is NaN or inf (else every term is +-0).
static __device__ void gang_block(const VerifyArgs& a, const Lane& v, long long b,
                                  unsigned int* sh, float* sq) {
    __shared__ float sh_w[VF_GANG_TILE];
    __shared__ int sh_q[VF_GANG_TILE];
    const int t = threadIdx.x;
    const int R = (int)a.R;
    const long long g0 = b * VF_GANG_TILE;
    const int ng = (int)(a.G - g0 < VF_GANG_TILE ? a.G - g0 : VF_GANG_TILE);
    const int n = ng * R;  // the tile's g_req cells
    const float* rows = v.g_req + g0 * R;
    int st[VF_GPT], rn[VF_GPT], cd[VF_GPT], qu[VF_GPT];
#pragma unroll
    for (int k = 0; k < VF_GPT; ++k) {
        const int j = t + k * VF_THREADS;
        const bool in = j < ng;
        st[k] = in ? v.g_state[g0 + j] : 0;
        rn[k] = in ? v.g_run[g0 + j] : 0;
        cd[k] = in ? v.g_card[g0 + j] : 0;
        qu[k] = in ? v.g_queue[g0 + j] : 0;
    }
    float x[VF_GPT * VF_ROW];
#pragma unroll
    for (int k = 0; k < VF_GPT * VF_ROW; ++k) {
        const int i = t + k * VF_THREADS;
        x[k] = i < n ? rows[i] : 0.0f;
    }
    unsigned int placed = 0, members = 0;
    bool nz = false;
#pragma unroll
    for (int k = 0; k < VF_GPT; ++k) {
        const int j = t + k * VF_THREADS;
        const bool pq = j < ng && g0 + j < v.real_g && st[k] == 1 && rn[k] < 0;
        const float w = __fmul_rn((float)cd[k], pq ? 1.0f : 0.0f);
        placed += pq ? 1u : 0u;
        members += pq ? (unsigned int)cd[k] : 0u;
        sh_w[j] = w;
        sh_q[j] = j < ng ? (int)jax_index(qu[k], a.Q) : -1;
        nz |= w != 0.0f;
    }
#pragma unroll
    for (int k = 0; k < VF_GPT * VF_ROW; ++k) nz |= !isfinite(x[k]);
    for (int i = t + VF_GPT * VF_ROW * VF_THREADS; i < n; i += VF_THREADS)
        nz |= !isfinite(rows[i]);
    warp_into<OP_ADD>(sh, A_PLACED_GANGS, placed);
    warp_into<OP_ADD>(sh, A_PLACED_MEMBERS, members);
    if (!__syncthreads_or(nz)) return;
    const long long QR = a.Q * a.R;
    float* dst = qtable_open(sq, v, QR);
#pragma unroll
    for (int k = 0; k < VF_GPT * VF_ROW; ++k) {
        const int i = t + k * VF_THREADS;
        if (i >= n) break;
        const int gl = i / R;
        const float term = __fmul_rn(x[k], sh_w[gl]);
        const int q = sh_q[gl];
        if (term != 0.0f && q >= 0) atomicAdd(&dst[(long long)q * R + (i - gl * R)], term);
    }
    for (int i = t + VF_GPT * VF_ROW * VF_THREADS; i < n; i += VF_THREADS) {
        const int gl = i / R;
        const float term = __fmul_rn(rows[i], sh_w[gl]);
        const int q = sh_q[gl];
        if (term != 0.0f && q >= 0) atomicAdd(&dst[(long long)q * R + (i - gl * R)], term);
    }
    qtable_close(sq, v, QR);
}

// A run block, one run a thread, its loads first.
static __device__ void run_block(const VerifyArgs& a, const Lane& v, long long b,
                                 unsigned int* sh, float* sq) {
    const long long i = b * VF_THREADS + threadIdx.x;
    const int R = (int)a.R;
    const bool in = i < a.RJ;
    const bool valid = in && v.run_valid[i] != 0, ev = in && v.run_evicted[i] != 0;
    const bool rs = in && v.run_rescheduled[i] != 0;
    const long long n = in ? jax_index(v.run_node[i], a.N) : -1;
    const long long q = in ? jax_index(v.run_queue[i], a.Q) : -1;
    float req[VF_ROW];
#pragma unroll
    for (int k = 0; k < VF_ROW; ++k) req[k] = (in && k < R) ? v.run_req[i * R + k] : 0.0f;
    warp_into<OP_OR>(sh, A_FLAGS, (valid && rs && !ev) ? 1u << 7 : 0u);
    warp_into<OP_ADD>(sh, A_N_EVICTED, (valid && ev) ? 1u : 0u);
    warp_into<OP_ADD>(sh, A_N_RESCHEDULED, (valid && rs) ? 1u : 0u);
    const long long QR = a.Q * a.R;
    float* dst = qtable_open(sq, v, QR);
    const float h = (valid && (!ev || rs)) ? 1.0f : 0.0f;
    for (int r = 0; r < R; ++r) {
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < VF_ROW; ++k) x = k == r ? req[k] : x;
        if (r >= VF_ROW && in) x = v.run_req[i * R + r];
        if (n >= 0) add_f(&v.used[n * R + r], __fmul_rn(__fmul_rn(x, v.node_axes[r]), h));
        if (q >= 0) add_f(&dst[q * R + r], __fmul_rn(x, h));
    }
    qtable_close(sq, v, QR);
}

static __device__ void slot_block(const VerifyArgs& a, const Lane& v, long long b,
                                  unsigned int* sh) {
    const long long s = b * VF_THREADS + threadIdx.x;
    unsigned int members = 0, hits = 0, flags = 0;
    if (s < a.S) {
        const int ns = *v.n_slots;
        const bool live = s < ns;
        const int* cnt = v.slot_counts + s * a.W;
        const int* nodes = v.slot_nodes + s * a.W;
        unsigned int sum = 0;
        bool neg = false;
        for (int w = 0; w < a.W; ++w) {
            sum += (unsigned int)cnt[w];
            neg |= cnt[w] < 0;
        }
        const int mc = live ? (int)sum : 0;
        members = (unsigned int)mc;
        if (live && neg) flags |= 1u << 0;
        const int sg = v.slot_gang[s];
        const long long gi = jax_index(sg, a.G);
        if (live && gi >= 0) {
            hits = 1;
            const bool pq = gi < v.real_g && v.g_state[gi] == 1 && v.g_run[gi] < 0;
            const unsigned int old = atomicExch(&v.stamp[gi], (unsigned int)a.epoch);
            if (!pq || old == (unsigned int)a.epoch) flags |= 1u << 2;
        }
        const long long sg_safe = clamp_index(sg, a.G);
        if (live && mc != v.g_card[sg_safe]) flags |= 1u << 3;
        for (int w = 0; w < a.W; ++w) {
            const int node = nodes[w];
            const bool lane_live = live && cnt[w] > 0;
            const bool in_range = node >= 0 && node < a.N;
            if (lane_live && !(in_range && v.node_ok[clamp_index(node, a.N)])) flags |= 1u << 4;
            const float m = (float)(lane_live ? cnt[w] : 0);
            const long long tn = jax_index(node, a.N);
            if (tn < 0) continue;
            for (int r = 0; r < a.R; ++r) {
                const float req = __fmul_rn(v.g_req[sg_safe * a.R + r], v.node_axes[r]);
                add_f(&v.used[tn * a.R + r], __fmul_rn(m, req));
            }
        }
    }
    warp_into<OP_ADD>(sh, A_SLOT_MEMBERS, members);
    warp_into<OP_ADD>(sh, A_HITS, hits);
    warp_into<OP_OR>(sh, A_FLAGS, flags);
}

static __device__ void fingerprint_block(const VerifyArgs& a, const Lane& v, long long b,
                                         unsigned int* sh) {
    unsigned int x = 0, s = 0;
#pragma unroll
    for (int k = 0; k < VF_WORDS / VF_THREADS; ++k) {
        const long long i = b * VF_WORDS + threadIdx.x + k * VF_THREADS;
        const unsigned int w = i < a.L ? (unsigned int)v.compact[i] : 0u;
        x ^= w;
        s += w;
    }
    warp_into<OP_XOR>(sh, A_FP_XOR, x);
    warp_into<OP_ADD>(sh, A_FP_SUM, s);
}

// Blocks [0, nbs) slots, then nbr of runs, nbf of fingerprint words, the
// rest gangs (the short roles first: the slots' chain of dependent loads
// starts while the gang blocks stream); grid (x, lanes).
__global__ void __launch_bounds__(VF_THREADS, VF_MINB)
verify_accumulate_kernel(const VerifyArgs a, int nbs, int nbr, int nbf, int shared_expq) {
    __shared__ unsigned int sh[A_LEN];
    VF_DYN_SHARED(dyn);
    const Lane v = lane_of(a, blockIdx.y);
    float* sq = shared_expq ? (float*)dyn : nullptr;
    VF_LAUNCH_DEPENDENTS();
    if (threadIdx.x < A_LEN) sh[threadIdx.x] = 0;
    __syncthreads();
    long long b = blockIdx.x;
    if (b < nbs) {
        slot_block(a, v, b, sh);
    } else if ((b -= nbs) < nbr) {
        run_block(a, v, b, sh, sq);
    } else if ((b -= nbr) < nbf) {
        fingerprint_block(a, v, b, sh);
    } else {
        gang_block(a, v, b - nbf, sh, sq);
    }
    __syncthreads();
    flush_counters(sh, v.acc);
}

// Blocks [0, nbn) over [N, R], the rest over [Q, R]; each cell read, then
// cleared.  The lane's last block writes its 16 words.  Launched as the
// accumulate pass's programmatic dependent: its blocks load what that pass
// does not write (the allocatable rows, node_total, q_alloc, the scalars,
// the maxima so far) before they wait for it.
__global__ void __launch_bounds__(VF_THREADS)
verify_compare_kernel(const VerifyArgs a, int nbn) {
    __shared__ unsigned int sh[A_LEN];
    __shared__ unsigned int c[A_LEN];
    __shared__ bool last;
    const Lane v = lane_of(a, blockIdx.y);
    const int t = threadIdx.x;
    if (t < A_LEN) sh[t] = 0;
    const bool node = (int)blockIdx.x < nbn;
    const long long n = node ? a.N * a.R : a.Q * a.R;
    const long long e0 = (long long)(node ? blockIdx.x : blockIdx.x - nbn) * VF_CELLS;
    const float* want = node ? v.alloc0 : v.q_alloc;
    const float* tot = v.node_total;
    float* acc = node ? v.used : v.expq;
    float x[4], y[4], z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long e = e0 + t + k * VF_THREADS;
        const bool in = e < n;
        x[k] = in ? want[e] : 0.0f;
        z[k] = (in && node) ? tot[e] : 0.0f;
    }
    const int ns = t == 0 ? *v.n_slots : 0;
    const int sched = t == 0 ? *v.sched_count : 0;
    // the lane's maximum so far: the accumulate pass does not write it, and
    // it only grows while this grid runs
    const int kmax = node ? A_NODE_DIFF : A_QUEUE_DIFF;
    const unsigned int seen = t == 0 ? *(volatile unsigned int*)&v.acc[kmax] : 0u;
    VF_GRID_WAIT();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long e = e0 + t + k * VF_THREADS;
        y[k] = e < n ? acc[e] : 0.0f;
    }
    __syncthreads();
    unsigned int m = 0, f = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long e = e0 + t + k * VF_THREADS;
        if (e >= n) continue;
        float d;
        bool bad;
        if (node) {
            d = fabsf(__fsub_rn(x[k], __fsub_rn(z[k], y[k])));
            bad = d > __fmaf_rn(1e-3f, z[k], 0.5f);
        } else {
            d = fabsf(__fsub_rn(x[k], y[k]));
            bad = d > __fmaf_rn(1e-3f, jmax(fabsf(y[k]), fabsf(x[k])), 1.0f);
        }
        const unsigned int bits = __float_as_uint(d);
        m = bits > m ? bits : m;
        if (bad) f = 1u << (node ? 5 : 6);
        acc[e] = 0.0f;
    }
    if (node) warp_into<OP_MAX>(sh, A_NODE_DIFF, m);
    else warp_into<OP_MAX>(sh, A_QUEUE_DIFF, m);
    warp_into<OP_OR>(sh, A_FLAGS, f);
    __syncthreads();
    if (t == 0 && sh[kmax] > seen) atomicMax(&v.acc[kmax], sh[kmax]);  // the maxima only grow
    if (t == 0 && sh[A_FLAGS]) atomicOr(&v.acc[A_FLAGS], sh[A_FLAGS]);
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&v.acc[A_TICKET], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (t < A_LEN) c[t] = atomicExch(&v.acc[t], 0u);  // read, and clear for the next call
    __syncthreads();
    if (t != 0) return;
    const int slot_members = (int)c[A_SLOT_MEMBERS];
    const int placed_members = (int)c[A_PLACED_MEMBERS];
    unsigned int flags = c[A_FLAGS];
    if (slot_members != sched || ns < 0 || ns > a.S) flags |= 1u << 0;
    if (placed_members != sched) flags |= 1u << 1;
    if (c[A_HITS] != c[A_PLACED_GANGS]) flags |= 1u << 2;
    v.out[0] = 1;  // version
    v.out[1] = (int)flags;
    v.out[2] = (int)c[A_FP_XOR];
    v.out[3] = (int)c[A_FP_SUM];
    v.out[4] = ns;
    v.out[5] = slot_members;
    v.out[6] = sched;
    v.out[7] = (int)c[A_PLACED_GANGS];
    v.out[8] = placed_members;
    v.out[9] = (int)qnan(c[A_NODE_DIFF]);
    v.out[10] = (int)qnan(c[A_QUEUE_DIFF]);
    v.out[11] = (int)a.L;
    v.out[12] = (int)c[A_N_EVICTED];
    v.out[13] = (int)c[A_N_RESCHEDULED];
    v.out[14] = 0;
    v.out[15] = 0;
}

static inline long long blocks_of(long long n, long long per) { return (n + per - 1) / per; }

extern "C" int armada_verify(const VerifyArgs* args, cudaStream_t stream) {
    const VerifyArgs& a = *args;
    if (a.N <= 0 || a.R <= 0 || a.G <= 0 || a.Q <= 0 || a.S <= 0 || a.W <= 0 || a.RJ < 0
        || a.L < 0 || a.lanes < 1 || a.lanes > 65535 || !a.ws || !a.out
        || (a.lanes > VF_INLINE && !a.real_table))
        return -1;
    const long long nbg = blocks_of(a.G, VF_GANG_TILE), nbr = blocks_of(a.RJ, VF_THREADS);
    const long long nbs = blocks_of(a.S, VF_THREADS), nbf = blocks_of(a.L, VF_WORDS);
    const long long nbn = blocks_of(a.N * a.R, VF_CELLS), nbq = blocks_of(a.Q * a.R, VF_CELLS);
    if (nbg + nbr + nbs + nbf >= (1ll << 31) || nbn + nbq >= (1ll << 31)
        || a.N * a.R >= (1ll << 31) || a.G * a.R >= (1ll << 31))
        return -1;
    const int P = (int)a.lanes;
    const int shared_expq = a.Q * a.R <= VF_EXPQ_SHARED;
    const size_t smem = shared_expq ? sizeof(float) * a.Q * a.R : 0;
    ARMADA_LAUNCH_SMEM(verify_accumulate_kernel, dim3((unsigned)(nbg + nbr + nbs + nbf), P),
                       VF_THREADS, smem, stream)(a, (int)nbs, (int)nbr, (int)nbf, shared_expq);
    ARMADA_CHECK();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(nbn + nbq), P);
    cfg.blockDim = dim3(VF_THREADS);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, verify_compare_kernel, a, (int)nbn);
    if (e != cudaSuccess) return (int)e;
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_verify_args_size(void) { return (int)sizeof(VerifyArgs); }

extern "C" long long armada_verify_ws_bytes(long long N, long long R, long long Q, long long G) {
    return vf_layout(N, R, Q, G).lane_bytes;
}
