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
// of |difference| are order-free (atomicMax on the bits of non-negative
// floats).
//
// The stacked form (K-I stacked) replaces `_kernel_stacked` (verify.py:496,
// jax.vmap of the kernel over a stacked round's P lanes): every kernel takes
// its lane from blockIdx.y (grid (x, P)); lane l's inputs, scratch and
// i32[16] output row start l x (per-lane length) past lane 0's, its real
// gang count comes from an i32 [P] table on the card, and its fingerprint
// folds over row l of the stacked [P, L] compact buffer.
//
// Bound on this card: every input read once -- the problem's run and gang
// rows, the slots, the allocatable rows at the clean level, the compact
// buffer (~45 MB at the reference scale, G ~ 1.1M) -- so ~15 us of HBM
// time.  Design: one thread per run, per slot, per gang, per (node,
// resource) and per (queue, resource), each a plain grid launch; counts and
// flags go through a few global atomics, taken only where the term is
// nonzero.

#include "common.cuh"

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
    A_LEN
};

struct VerifyArgs {
    const float* node_total;  // [N, R]
    const u8* node_ok;        // [N]
    const float* node_axes;   // [R]
    const float* run_req;     // [RJ, R]
    const int* run_node;      // [RJ]
    const int* run_queue;     // [RJ]
    const u8* run_valid;      // [RJ]
    const float* g_req;       // [G, R]
    const int* g_card;        // [G]
    const int* g_queue;       // [G]
    const int* g_run;         // [G]
    const int* g_state;       // [G]
    const int* slot_gang;     // [S]
    const int* slot_nodes;    // [S, W]
    const int* slot_counts;   // [S, W]
    const int* n_slots;       // scalar
    const u8* run_evicted;    // [RJ]
    const u8* run_rescheduled;  // [RJ]
    const float* alloc0;      // [N, R] clean-level allocatable
    const float* q_alloc;     // [Q, R]
    const int* sched_count;   // scalar
    const int* compact;       // [L]
    float* used;              // [N, R] scratch
    float* expq;              // [Q, R] scratch
    int* occ;                 // [G] scratch
    unsigned int* acc;        // [A_LEN] scratch
    int* out;                 // [16]
    const int* real_lanes;    // [P] real gang counts of a stacked round, or null: real_g
    long long alloc0_stride;  // elements between two lanes' alloc0 (P1 * N * R)
    int N, R, RJ, G, Q, S, W, L, real_g, lanes;
};

// Lane l of a stacked verification (every lane has lane 0's shapes).
static __device__ __forceinline__ VerifyArgs vlane_of(VerifyArgs a, long long l) {
    const long long N = a.N, R = a.R, RJ = a.RJ, G = a.G, Q = a.Q, SW = (long long)a.S * a.W;
    a.node_total += l * N * R;
    a.node_ok += l * N;
    a.node_axes += l * R;
    a.run_req += l * RJ * R;
    a.run_node += l * RJ;
    a.run_queue += l * RJ;
    a.run_valid += l * RJ;
    a.g_req += l * G * R;
    a.g_card += l * G;
    a.g_queue += l * G;
    a.g_run += l * G;
    a.g_state += l * G;
    a.slot_gang += l * a.S;
    a.slot_nodes += l * SW;
    a.slot_counts += l * SW;
    a.n_slots += l;
    a.run_evicted += l * RJ;
    a.run_rescheduled += l * RJ;
    a.alloc0 += l * a.alloc0_stride;
    a.q_alloc += l * Q * R;
    a.sched_count += l;
    a.compact += l * a.L;
    a.used += l * N * R;
    a.expq += l * Q * R;
    a.occ += l * G;
    a.acc += l * A_LEN;
    a.out += l * 16;
    if (a.real_lanes) a.real_g = a.real_lanes[l];
    return a;
}

#define VLANE const VerifyArgs a = vlane_of(a0, blockIdx.y)

static __device__ __forceinline__ void add_f(float* p, float v) {
    if (v != 0.0f) atomicAdd(p, v);
}

static __device__ __forceinline__ void flag(const VerifyArgs& a, int bit) {
    atomicOr(&a.acc[A_FLAGS], 1u << bit);
}

// max as jnp.maximum: NaN propagates.
static __device__ __forceinline__ float jmax(float x, float y) {
    if (x != x) return x;
    if (y != y) return y;
    return x > y ? x : y;
}

__global__ void verify_runs_kernel(VerifyArgs a0) {
    VLANE;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.RJ) return;
    const bool valid = a.run_valid[i] != 0, ev = a.run_evicted[i] != 0;
    const bool rs = a.run_rescheduled[i] != 0;
    if (valid && rs && !ev) flag(a, 7);
    if (valid && ev) atomicAdd(&a.acc[A_N_EVICTED], 1u);
    if (valid && rs) atomicAdd(&a.acc[A_N_RESCHEDULED], 1u);
    const float h = (valid && (!ev || rs)) ? 1.0f : 0.0f;
    const long long n = jax_index(a.run_node[i], a.N);
    const long long q = jax_index(a.run_queue[i], a.Q);
    for (int r = 0; r < a.R; ++r) {
        const float req = a.run_req[(long long)i * a.R + r];
        if (n >= 0) add_f(&a.used[n * a.R + r], __fmul_rn(__fmul_rn(req, a.node_axes[r]), h));
        if (q >= 0) add_f(&a.expq[q * a.R + r], __fmul_rn(req, h));
    }
}

__global__ void verify_slots_kernel(VerifyArgs a0) {
    VLANE;
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= a.S) return;
    const int ns = *a.n_slots;
    const bool live = s < ns;
    const int livef = live ? 1 : 0;
    const int* cnt = a.slot_counts + (long long)s * a.W;
    const int* nodes = a.slot_nodes + (long long)s * a.W;
    unsigned int sum = 0;
    bool neg = false;
    for (int w = 0; w < a.W; ++w) {
        sum += (unsigned int)cnt[w];
        neg |= cnt[w] < 0;
    }
    const int mc = (int)sum * livef;
    if (mc != 0) atomicAdd(&a.acc[A_SLOT_MEMBERS], (unsigned int)mc);
    if (live && neg) flag(a, 0);
    const int sg = a.slot_gang[s];
    const long long gi = jax_index(sg, a.G);
    if (gi >= 0 && livef) atomicAdd(&a.occ[gi], livef);
    const int sg_safe = sg < 0 ? 0 : (sg >= a.G ? a.G - 1 : sg);
    if (live && mc != a.g_card[sg_safe] * livef) flag(a, 3);
    for (int w = 0; w < a.W; ++w) {
        const int node = nodes[w];
        const bool lane_live = live && cnt[w] > 0;
        const bool in_range = node >= 0 && node < a.N;
        const int nsafe = node < 0 ? 0 : (node >= a.N ? a.N - 1 : node);
        if (lane_live && !(in_range && a.node_ok[nsafe])) flag(a, 4);
        const float members = (float)(lane_live ? cnt[w] : 0);
        const long long t = jax_index(node, a.N);
        if (t < 0) continue;
        for (int r = 0; r < a.R; ++r) {
            const float req = __fmul_rn(a.g_req[(long long)sg_safe * a.R + r], a.node_axes[r]);
            add_f(&a.used[t * a.R + r], __fmul_rn(members, req));
        }
    }
}

__global__ void verify_gangs_kernel(VerifyArgs a0) {
    VLANE;
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= a.G) return;
    const bool pq = g < a.real_g && a.g_state[g] == 1 && a.g_run[g] < 0;
    if (pq) {
        atomicAdd(&a.acc[A_PLACED_GANGS], 1u);
        if (a.g_card[g] != 0) atomicAdd(&a.acc[A_PLACED_MEMBERS], (unsigned int)a.g_card[g]);
    }
    const float wgt = __fmul_rn((float)a.g_card[g], pq ? 1.0f : 0.0f);
    const long long q = jax_index(a.g_queue[g], a.Q);
    if (q < 0) return;
    for (int r = 0; r < a.R; ++r)
        add_f(&a.expq[q * a.R + r], __fmul_rn(a.g_req[(long long)g * a.R + r], wgt));
}

__global__ void verify_occ_kernel(VerifyArgs a0) {
    VLANE;
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= a.G) return;
    const int pq = (g < a.real_g && a.g_state[g] == 1 && a.g_run[g] < 0) ? 1 : 0;
    if (a.occ[g] != pq) flag(a, 2);
}

__global__ void verify_nodes_kernel(VerifyArgs a0) {
    VLANE;
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)a.N * a.R) return;
    const float total = a.node_total[e];
    const float d = fabsf(__fsub_rn(a.alloc0[e], __fsub_rn(total, a.used[e])));
    atomicMax(&a.acc[A_NODE_DIFF], __float_as_uint(d));
    if (d > __fmaf_rn(1e-3f, total, 0.5f)) flag(a, 5);
}

__global__ void verify_queues_kernel(VerifyArgs a0) {
    VLANE;
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)a.Q * a.R) return;
    const float x = a.q_alloc[e], y = a.expq[e];
    const float d = fabsf(__fsub_rn(x, y));
    atomicMax(&a.acc[A_QUEUE_DIFF], __float_as_uint(d));
    if (d > __fmaf_rn(1e-3f, jmax(fabsf(y), fabsf(x)), 1.0f)) flag(a, 6);
}

__global__ void verify_fingerprint_kernel(VerifyArgs a0) {
    VLANE;
    unsigned int x = 0, s = 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.L;
         i += (long long)gridDim.x * blockDim.x) {
        x ^= (unsigned int)a.compact[i];
        s += (unsigned int)a.compact[i];
    }
    for (int off = 16; off > 0; off >>= 1) {
        x ^= __shfl_down_sync(0xffffffffu, x, off);
        s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if ((threadIdx.x & 31) == 0) {
        atomicXor(&a.acc[A_FP_XOR], x);
        atomicAdd(&a.acc[A_FP_SUM], s);
    }
}

__global__ void verify_final_kernel(VerifyArgs a0) {
    VLANE;
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    const int ns = *a.n_slots;
    const int sched = *a.sched_count;
    const int slot_members = (int)a.acc[A_SLOT_MEMBERS];
    const int placed_members = (int)a.acc[A_PLACED_MEMBERS];
    unsigned int flags = a.acc[A_FLAGS];
    if (slot_members != sched || ns < 0 || ns > a.S) flags |= 1u << 0;
    if (placed_members != sched) flags |= 1u << 1;
    a.out[0] = 1;  // version
    a.out[1] = (int)flags;
    a.out[2] = (int)a.acc[A_FP_XOR];
    a.out[3] = (int)a.acc[A_FP_SUM];
    a.out[4] = ns;
    a.out[5] = slot_members;
    a.out[6] = sched;
    a.out[7] = (int)a.acc[A_PLACED_GANGS];
    a.out[8] = placed_members;
    a.out[9] = (int)a.acc[A_NODE_DIFF];
    a.out[10] = (int)a.acc[A_QUEUE_DIFF];
    a.out[11] = a.L;
    a.out[12] = (int)a.acc[A_N_EVICTED];
    a.out[13] = (int)a.acc[A_N_RESCHEDULED];
    a.out[14] = 0;
    a.out[15] = 0;
}

static inline int grid_of(long long n, int block) {
    const long long g = (n + block - 1) / block;
    return g > 0 ? (int)g : 1;
}

extern "C" int armada_verify(const VerifyArgs* args, cudaStream_t stream) {
    const VerifyArgs a = *args;
    if (a.N <= 0 || a.R <= 0 || a.G <= 0 || a.Q <= 0 || a.S <= 0 || a.W <= 0) return -1;
    if (a.lanes < 1 || a.lanes > 65535) return -1;
    const int P = a.lanes;
    const size_t lanes = (size_t)P;
    cudaMemsetAsync(a.used, 0, sizeof(float) * lanes * a.N * a.R, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.expq, 0, sizeof(float) * lanes * a.Q * a.R, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.occ, 0, sizeof(int) * lanes * a.G, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.acc, 0, sizeof(unsigned int) * lanes * A_LEN, stream);
    ARMADA_CHECK();
    if (a.RJ > 0) {
        ARMADA_LAUNCH(verify_runs_kernel, dim3(grid_of(a.RJ, 256), P), 256, stream)(a);
        ARMADA_CHECK();
    }
    ARMADA_LAUNCH(verify_slots_kernel, dim3(grid_of(a.S, 256), P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(verify_gangs_kernel, dim3(grid_of(a.G, 256), P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(verify_occ_kernel, dim3(grid_of(a.G, 256), P), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(verify_nodes_kernel, dim3(grid_of((long long)a.N * a.R, 256), P), 256,
                  stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(verify_queues_kernel, dim3(grid_of((long long)a.Q * a.R, 256), P), 256,
                  stream)(a);
    ARMADA_CHECK();
    if (a.L > 0) {
        int grid = grid_of(a.L, 256);
        if (grid > 1024) grid = 1024;
        ARMADA_LAUNCH(verify_fingerprint_kernel, dim3(grid, P), 256, stream)(a);
        ARMADA_CHECK();
    }
    ARMADA_LAUNCH(verify_final_kernel, dim3(1, P), 32, stream)(a);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_verify_args_size(void) { return (int)sizeof(VerifyArgs); }
