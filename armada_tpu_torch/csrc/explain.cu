// K-J: the explain pass -- unschedulable-reason attribution over the
// round-final state, one i32 buffer out.
//
// Replaces the JAX package's armada_tpu/models/explain.py
// `_explain_kernel_impl`.  Plain version: armada_tpu_torch/models/explain.py
// `explain_kernel_plain` (reasons and buffer layout documented there).
//
// Exactness: every count is an integer (order-free atomics, int32 wrap);
// argmax keeps the first maximum; the key and failed-gang lists are K-C's
// ascending compaction (csrc/scan.cuh).  The f32 fragmentation sums pass
// 2^24 at the reference scale (~57k nodes x 16,000-96,000 millicores), so
// their association is reproduced, not tolerated: frag_free in XLA:CPU's
// reduction order (windows of 32 nodes left to right with the padding split
// around the axis, recursing on the window sums), type_frag_free in its
// scatter order (left to right in node order, per type).  The maxima are
// order-free.
//
// Bound on this card: operations -- the [K, N] fit checks (three masks, R
// compares each) -- against bytes read once (the gang rows, ~30 MB at
// G ~ 1.1M, and the node rows); at the reference scale the bytes dominate,
// ~10 us of HBM time.  Design: the fit checks are one thread per (key,
// node) over a grid of node tiles x keys, with a block OR per key into
// three flag bytes; the reasons are one thread per gang with the small
// histograms accumulated in shared memory; the per-type sums are one thread
// per (type, resource) walking the nodes in order.

#include "scan.cuh"

#define EX_NR 7  // reasons
#define EX_WINDOW 32

struct ExplainArgs {
    const u8* compat;           // [K, T]
    const u8* compat_pre_type;  // [K, T]
    const int* node_type;       // [N]
    const u8* node_ok;          // [N]
    const float* node_total;    // [N, R]
    const float* node_axes;     // [R]
    const float* g_req;         // [G, R]
    const int* g_card;          // [G]
    const int* g_queue;         // [G]
    const int* g_key;           // [G]
    const int* g_run;           // [G]
    const u8* g_valid;          // [G]
    const u8* g_absent;         // [G]
    const int* g_state;         // [G]
    const float* alloc0;        // [N, R] clean-level allocatable
    const u8* q_killed;         // [Q]
    // scratch
    float* req_k;     // [K, R]
    float* free_;     // [N, R]
    u8* key_ok;       // [K, 3]: shape_ok, shape_ok_pre, now_ok
    int* reason_g;    // [G]
    u8* cfailed;      // [G]
    int* kr;          // [K, EX_NR]
    int* key_count;   // [K]
    int* key_reason;  // [K]
    u8* key_has;      // [K]
    int* offsets;     // [nbK + nbG]
    int* totals;      // [2]: n_keys, n_failed_gangs
    float* wbuf;      // [2 * (ceil(N/32) + 1) * R] window sums
    int* out;
    int N, R, G, K, T, Q, real_g, kcap, fcap;
};

// Offsets of the output sections.
struct ExLayout {
    long long cf, cp, qc, kid, kre, kco, fid, fre, ff, fm, tff, tfm, len;
};

static __host__ __device__ ExLayout ex_layout(const ExplainArgs& a) {
    ExLayout l;
    l.cf = 8;
    l.cp = l.cf + EX_NR;
    l.qc = l.cp + EX_NR;
    l.kid = l.qc + (long long)a.Q * EX_NR;
    l.kre = l.kid + a.kcap;
    l.kco = l.kre + a.kcap;
    l.fid = l.kco + a.kcap;
    l.fre = l.fid + a.fcap;
    l.ff = l.fre + a.fcap;
    l.fm = l.ff + a.R;
    l.tff = l.fm + a.R;
    l.tfm = l.tff + (long long)a.T * a.R;
    l.len = l.tfm + (long long)a.T * a.R;
    return l;
}

// req_k = zeros.at[key].max(g_req) over the unplaced keyed job gangs (all
// values >= 0, so the float max is an integer max on the bits).
__global__ void ex_reqk_kernel(ExplainArgs a) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= a.G) return;
    const bool jobg = g < a.real_g && a.g_run[g] < 0 && !a.g_absent[g];
    const int st = a.g_state[g];
    const int key = a.g_key[g];
    if (!(jobg && (st == 2 || st == 0) && key >= 0 && key < a.K)) return;
    for (int r = 0; r < a.R; ++r) {
        const float v = a.g_req[(long long)g * a.R + r];
        if (v > 0.0f) atomicMax((int*)&a.req_k[(long long)key * a.R + r], __float_as_int(v));
    }
}

// free = where(node_ok, max(alloc0, 0), 0), its maxima per resource and per
// (type, resource).
__global__ void ex_free_kernel(ExplainArgs a, const ExLayout l) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)a.N * a.R) return;
    const long long n = e / a.R;
    const int r = (int)(e % a.R);
    const float x = a.alloc0[e];
    const float f = a.node_ok[n] ? (x != x ? x : (x > 0.0f ? x : 0.0f)) : 0.0f;
    a.free_[e] = f;
    if (f > 0.0f) {
        atomicMax(&a.out[l.fm + r], __float_as_int(f));
        atomicMax(&a.out[l.tfm + (long long)a.node_type[n] * a.R + r], __float_as_int(f));
    }
}

// Per key: does it fit some empty schedulable node (with and without the
// node-type whitelist), and some node at round-final free capacity?
__global__ void ex_fit_kernel(ExplainArgs a) {
    const int k = blockIdx.y;
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    u8* ok = a.key_ok + (long long)k * 3;
    __shared__ int done;
    if (threadIdx.x == 0) done = ok[0] && ok[1] && ok[2];
    __syncthreads();
    if (done) return;  // every flag already set by another tile (uniform per block)
    bool fe = false, fp = false, fn = false;
    if (n < a.N && a.node_ok[n]) {
        const int t = a.node_type[n];
        fe = a.compat[(long long)k * a.T + t] != 0;
        fp = a.compat_pre_type[(long long)k * a.T + t] != 0;
        fn = fe;
        for (int r = 0; r < a.R; ++r) {
            const float req = __fmul_rn(a.req_k[(long long)k * a.R + r], a.node_axes[r]);
            const bool size_ok = a.node_total[(long long)n * a.R + r] >= req;
            fe = fe && size_ok;
            fp = fp && size_ok;
            fn = fn && a.free_[(long long)n * a.R + r] >= req;
        }
    }
    const bool any_e = __syncthreads_or(fe), any_p = __syncthreads_or(fp);
    const bool any_n = __syncthreads_or(fn);
    if (threadIdx.x == 0) {
        if (any_e) ok[0] = 1;
        if (any_p) ok[1] = 1;
        if (any_n) ok[2] = 1;
    }
}

// The reason per gang and its histograms.
__global__ void ex_reason_kernel(ExplainArgs a, const ExLayout l) {
    __shared__ int hist[2 * EX_NR];
    if (threadIdx.x < 2 * EX_NR) hist[threadIdx.x] = 0;
    __syncthreads();
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g < a.G) {
        const bool real = g < a.real_g;
        const int st = a.g_state[g];
        const bool jobg = real && a.g_run[g] < 0 && !a.g_absent[g];
        const bool failed = jobg && st == 2, pending = jobg && st == 0;
        const int key = a.g_key[g];
        const bool keyed = key >= 0;
        const int ks = keyed ? key : 0;
        // a gather clamps its index into range, a scatter drops it (JAX)
        const u8* ok = a.key_ok + (long long)(ks < a.K ? ks : a.K - 1) * 3;
        int reason = 0;
        if (failed || pending) {
            if (keyed && !ok[1]) reason = 1;       // shape-infeasible
            else if (keyed && !ok[0]) reason = 6;  // type-mismatch
            else if (failed) reason = (a.g_card[g] > 1 || !a.g_valid[g]) ? 4 : 2;
            else if (a.q_killed[a.g_queue[g]]) reason = 3;
            else reason = (keyed && !ok[2]) ? 2 : 5;
        }
        a.reason_g[g] = reason;
        a.cfailed[g] = (real && st == 2) ? 1 : 0;
        const int w = reason > 0 ? a.g_card[g] : 0;
        if (w != 0) {
            if (failed) atomicAdd(&hist[reason], w);
            if (pending) atomicAdd(&hist[EX_NR + reason], w);
            const long long qi = jax_index((long long)a.g_queue[g] * EX_NR + reason,
                                           (long long)a.Q * EX_NR);
            if (qi >= 0) atomicAdd(&a.out[l.qc + qi], w);
            if (keyed) {
                const long long ki = jax_index((long long)ks * EX_NR + reason,
                                               (long long)a.K * EX_NR);
                if (ki >= 0) atomicAdd(&a.kr[ki], w);
            }
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * EX_NR && hist[threadIdx.x] != 0)
        atomicAdd(&a.out[l.cf + threadIdx.x], hist[threadIdx.x]);
}

// Per key: count, dominant reason (first maximum), presence flag.
__global__ void ex_keys_kernel(ExplainArgs a) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= a.K) return;
    const int* row = a.kr + (long long)k * EX_NR;
    unsigned int sum = 0;
    int best = 0;
    for (int r = 0; r < EX_NR; ++r) {
        sum += (unsigned int)row[r];
        if (row[r] > row[best]) best = r;
    }
    a.key_count[k] = (int)sum;
    a.key_reason[k] = best;
    a.key_has[k] = (int)sum > 0 ? 1 : 0;
}

// Gather the reasons and counts behind the compacted key and failed lists.
__global__ void ex_lists_kernel(ExplainArgs a, const ExLayout l) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.kcap) {
        const int k = a.out[l.kid + i];
        a.out[l.kre + i] = k >= 0 ? a.key_reason[k] : 0;
        a.out[l.kco + i] = k >= 0 ? a.key_count[k] : 0;
    }
    if (i < a.fcap) {
        const int g = a.out[l.fid + i];
        a.out[l.fre + i] = g >= 0 ? a.reason_g[g] : 0;
    }
}

// One stage of the windowed column sums: window j of column r sums, left to
// right from +0, the rows j*32 - lo .. j*32 - lo + 31 that exist.
__global__ void ex_window_kernel(const float* in, long long n, int R, long long k, int lo,
                                 float* outp) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= k * R) return;
    const long long j = e / R;
    const int r = (int)(e % R);
    float acc = 0.0f;
    for (int w = 0; w < EX_WINDOW; ++w) {
        const long long i = j * EX_WINDOW - lo + w;
        if (i >= 0 && i < n) acc = __fadd_rn(acc, in[i * R + r]);
    }
    outp[e] = acc;
}

// The last stage (<= 32 rows): left to right into the output bits.
__global__ void ex_colsum_kernel(const float* in, long long n, int R, int* dst) {
    const int r = threadIdx.x;
    if (r >= R) return;
    float acc = 0.0f;
    for (long long i = 0; i < n; ++i) acc = __fadd_rn(acc, in[i * R + r]);
    dst[r] = __float_as_int(acc);
}

// type_frag_free: one thread per (type, resource), nodes in order.
__global__ void ex_type_sum_kernel(ExplainArgs a, const ExLayout l) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= a.T * a.R) return;
    const int t = e / a.R, r = e % a.R;
    float acc = 0.0f;
    int n = 0;
    for (; n + 8 <= a.N; n += 8) {
        int ty[8];
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            ty[j] = a.node_type[n + j];
            v[j] = a.free_[(long long)(n + j) * a.R + r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (ty[j] == t) acc = __fadd_rn(acc, v[j]);
    }
    for (; n < a.N; ++n)
        if (a.node_type[n] == t) acc = __fadd_rn(acc, a.free_[(long long)n * a.R + r]);
    a.out[l.tff + e] = __float_as_int(acc);
}

__global__ void ex_header_kernel(ExplainArgs a, const ExLayout l) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    unsigned int nf = 0;
    for (int r = 0; r < EX_NR; ++r) nf += (unsigned int)a.out[l.cf + r];
    a.out[0] = 2;  // version
    a.out[1] = a.totals[0];
    a.out[2] = a.totals[1];
    a.out[3] = (int)nf;
    a.out[4] = a.Q;
    a.out[5] = a.R;
    a.out[6] = a.T;
    a.out[7] = 0;
}

static inline int ex_grid(long long n, int block) {
    const long long g = (n + block - 1) / block;
    return g > 0 ? (int)g : 1;
}

extern "C" long long armada_explain_len(const ExplainArgs* args) { return ex_layout(*args).len; }

extern "C" int armada_explain(const ExplainArgs* args, cudaStream_t stream) {
    const ExplainArgs a = *args;
    if (a.N <= 0 || a.R <= 0 || a.G <= 0 || a.K <= 0 || a.T <= 0 || a.Q <= 0 ||
        a.kcap < 0 || a.fcap < 0 || a.kcap > a.K || a.fcap > a.G || a.R > 32)
        return -1;
    const ExLayout l = ex_layout(a);
    cudaMemsetAsync(a.out, 0, sizeof(int) * (size_t)l.len, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.out + l.kid, 0xff, sizeof(int) * (size_t)a.kcap, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.out + l.fid, 0xff, sizeof(int) * (size_t)a.fcap, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.req_k, 0, sizeof(float) * (size_t)a.K * a.R, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.key_ok, 0, (size_t)a.K * 3, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.kr, 0, sizeof(int) * (size_t)a.K * EX_NR, stream);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_reqk_kernel, ex_grid(a.G, 256), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_free_kernel, ex_grid((long long)a.N * a.R, 256), 256, stream)(a, l);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_fit_kernel, dim3(ex_grid(a.N, 256), a.K), 256, stream)(a);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_reason_kernel, ex_grid(a.G, 256), 256, stream)(a, l);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_keys_kernel, ex_grid(a.K, 256), 256, stream)(a);
    ARMADA_CHECK();
    // the ascending key and failed-gang lists
    const int nbK = scan_blocks(a.K), nbG = scan_blocks(a.G);
    int* offK = a.offsets;
    int* offG = a.offsets + nbK;
    const U8Flag keys{a.key_has, a.K, 1}, failed{a.cfailed, a.G, 1};
    ARMADA_LAUNCH(scan_count_kernel, nbK, SCAN_BLOCK, stream)(keys, offK, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, nbG, SCAN_BLOCK, stream)(failed, offG, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_offsets_kernel, 1, 32, stream)(offK, nbK, a.totals);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_offsets_kernel, 1, 32, stream)(offG, nbG, a.totals + 1);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, nbK, SCAN_BLOCK, stream)(keys, offK, a.out + l.kid,
                                                             a.kcap, 0, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_index_kernel, nbG, SCAN_BLOCK, stream)(failed, offG, a.out + l.fid,
                                                             a.fcap, 0, 0);
    ARMADA_CHECK();
    const int lists = a.kcap > a.fcap ? a.kcap : a.fcap;
    if (lists > 0) {
        ARMADA_LAUNCH(ex_lists_kernel, ex_grid(lists, 256), 256, stream)(a, l);
        ARMADA_CHECK();
    }
    // frag_free: windows of 32 rows until <= 32 remain, then left to right
    const float* in = a.free_;
    long long n = a.N;
    const long long wcap = (a.N + EX_WINDOW - 1) / EX_WINDOW + 1;
    float* bufs[2] = {a.wbuf, a.wbuf + wcap * a.R};
    int which = 0;
    while (n > EX_WINDOW) {
        const long long k = (n + EX_WINDOW - 1) / EX_WINDOW;
        const int lo = (int)((k * EX_WINDOW - n) / 2);
        ARMADA_LAUNCH(ex_window_kernel, ex_grid(k * a.R, 256), 256, stream)(in, n, a.R, k, lo,
                                                                           bufs[which]);
        ARMADA_CHECK();
        in = bufs[which];
        which ^= 1;
        n = k;
    }
    ARMADA_LAUNCH(ex_colsum_kernel, 1, 32, stream)(in, n, a.R, a.out + l.ff);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_type_sum_kernel, ex_grid((long long)a.T * a.R, 32), 32, stream)(a, l);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_header_kernel, 1, 32, stream)(a, l);
    ARMADA_CHECK();
    return 0;
}

extern "C" int armada_explain_args_size(void) { return (int)sizeof(ExplainArgs); }
