// K-A: water-filling fair shares.
//
// Replaces the JAX package's ops/fairness.py `_fair_shares_jit` (a jitted
// lax.while_loop of at most 10 iterations over [Q] vectors).  Plain version:
// armada_tpu_torch/ops/fairness.py `fair_shares_plain`.
//
// Bound on this card: a few hundred bytes to a few hundred KB (Q f32 weights
// and demand shares in, three Q f32 vectors out) and ~20 flops per queue per
// iteration -- far below a microsecond of memory or compute; the launch and
// the <= 10 sequential iterations with their block barriers are what it costs.
// The simple design: one block, threads stride over Q, the iterations run
// inside the block.  A stacked round (K-D) launches one block per pool lane
// (grid (1, P)); lane l reads and writes rows l of [P, Q] inputs, outputs
// and scratch, so the lanes never meet.
//
// Reduction order.  Every [Q] sum feeds the eviction gate, so it is taken in
// XLA:CPU's order, as the plain version takes it: lengths <= 32 left to right
// from 0; longer ones padded to a multiple of 32 with floor(pad/2) of the
// padding before element 0, each window of 32 summed left to right over its
// real elements, then the window sums the same way, recursively.  Window sums
// are independent, so threads take one window each.  The loop's sum of spare
// shares at 25..32 queues is XLA's 8-lane vectorized loop instead (see
// spare_sum_vec8).

#include "common.cuh"

#define FS_MAX_WINDOWS 1024  // Q <= 32 * 1024

// Sum of window j of one level: src[32j - lo .. 32j - lo + 31], left to
// right, skipping indices outside [0, n).
__device__ __forceinline__ float window_sum(const float* src, int n, int lo, int j) {
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) {
        const int idx = j * 32 - lo + i;
        if (idx >= 0 && idx < n) s = __fadd_rn(s, src[idx]);
    }
    return s;
}

// Block-cooperative ordered sum of x[0..n) (see the note above).  `win` holds
// FS_MAX_WINDOWS floats; `res` one float for the broadcast.
__device__ float ordered_sum(const float* x, int n, float* win, float* res) {
    const int tid = threadIdx.x;
    if (n <= 32) {
        if (tid == 0) {
            float s = 0.0f;
            for (int i = 0; i < n; ++i) s = __fadd_rn(s, x[i]);
            *res = s;
        }
        __syncthreads();
        float r = *res;
        __syncthreads();
        return r;
    }
    // first level: windows of x
    int k = (n + 31) / 32;
    int lo = (k * 32 - n) / 2;
    for (int j = tid; j < k; j += blockDim.x) win[j] = window_sum(x, n, lo, j);
    __syncthreads();
    // further levels in place: window j reads win[32j - lo ..] and writes
    // win[j], so every thread reads its inputs before any thread writes.
    while (k > 32) {
        const int k2 = (k + 31) / 32;
        lo = (k2 * 32 - k) / 2;
        float s = 0.0f;
        if (tid < k2) s = window_sum(win, k, lo, tid);
        __syncthreads();
        if (tid < k2) win[tid] = s;
        __syncthreads();
        k = k2;
    }
    if (tid == 0) {
        float s = 0.0f;
        for (int i = 0; i < k; ++i) s = __fadd_rn(s, win[i]);
        *res = s;
    }
    __syncthreads();
    float r = *res;
    __syncthreads();
    return r;
}

// The in-loop sum of spare shares at 25..32 queues, which XLA:CPU vectorizes
// into 8 lanes: lane i adds x[i], x[8+i], ... over the first n/8 groups of
// 8, then lanes are halved pairwise (i + i+4, i + i+2, 0 + 1), then the
// remaining n % 8 elements are added left to right.  One thread; the result
// is broadcast through `res`.
__device__ float spare_sum_vec8(const float* x, int n, float* res) {
    if (threadIdx.x == 0) {
        const int m = n / 8;
        float lane[8];
        for (int i = 0; i < 8; ++i) {
            lane[i] = x[i];
            for (int v = 1; v < m; ++v) lane[i] = __fadd_rn(lane[i], x[8 * v + i]);
        }
        for (int i = 0; i < 4; ++i) lane[i] = __fadd_rn(lane[i], lane[i + 4]);
        for (int i = 0; i < 2; ++i) lane[i] = __fadd_rn(lane[i], lane[i + 2]);
        float s = __fadd_rn(lane[0], lane[1]);
        for (int i = 8 * m; i < n; ++i) s = __fadd_rn(s, x[i]);
        *res = s;
    }
    __syncthreads();
    float r = *res;
    __syncthreads();
    return r;
}

// scratch: f32[2 * Q] (active weights / spare products, spare).
__global__ void __launch_bounds__(ARMADA_BLOCK) fair_shares_kernel(
    const float* __restrict__ w, const float* __restrict__ cds, float* fs,
    float* dcafs, float* ucafs, float* scratch, u8* achieved, int Q, int max_iter) {
    __shared__ float win[FS_MAX_WINDOWS];
    __shared__ float res;
    const int tid = threadIdx.x;
    const long long lane = blockIdx.y;
    w += lane * Q;
    cds += lane * Q;
    fs += lane * Q;
    dcafs += lane * Q;
    ucafs += lane * Q;
    scratch += lane * 2 * Q;
    achieved += lane * Q;
    float* tmp = scratch;
    float* spare = scratch + Q;

    float wsum = ordered_sum(w, Q, win, &res);
    for (int q = tid; q < Q; q += blockDim.x) {
        fs[q] = wsum > 0.0f ? __fdiv_rn(w[q], wsum) : 0.0f;
        dcafs[q] = 0.0f;
        ucafs[q] = 0.0f;
        spare[q] = 0.0f;
        achieved[q] = 0;
    }
    __syncthreads();
    float unalloc = 1.0f;
    bool running = true;
    int it = 0;
    while (it < max_iter && unalloc > 0.01f && running) {
        for (int q = tid; q < Q; q += blockDim.x) tmp[q] = achieved[q] ? 0.0f : w[q];
        __syncthreads();
        const float tw = ordered_sum(tmp, Q, win, &res);
        running = tw > 0.0f;
        const float safe_tw = tw > 0.0f ? tw : 1.0f;
        for (int q = tid; q < Q; q += blockDim.x) {
            const bool ach = achieved[q] != 0;
            const float denom = __fadd_rn(tw, ach ? w[q] : 0.0f);
            const float take = denom > 0.0f ? __fdiv_rn(w[q], denom) : 0.0f;
            // XLA:CPU contracts ucafs + take * (unalloc - spare) to one fma
            ucafs[q] = __fmaf_rn(take, __fsub_rn(unalloc, spare[q]), ucafs[q]);
            const float add =
                (ach || tw <= 0.0f) ? 0.0f : __fmul_rn(__fdiv_rn(w[q], safe_tw), unalloc);
            float d = __fadd_rn(dcafs[q], add);
            const float spare_new = __fsub_rn(d, cds[q]);
            const bool newly = spare_new > 0.0f;
            d = newly ? cds[q] : d;
            dcafs[q] = d;
            spare[q] = newly ? spare_new : 0.0f;
            achieved[q] = (ach || newly) ? 1 : 0;
            tmp[q] = newly ? __fmul_rn(spare_new, 1.0f) : 0.0f;
        }
        __syncthreads();
        const float s = (Q >= 25 && Q <= 32) ? spare_sum_vec8(tmp, Q, &res)
                                              : ordered_sum(tmp, Q, win, &res);
        unalloc = running ? s : 0.0f;
        ++it;
    }
}

// lanes: the number of [Q] rows (1 for a solo round, P for a stacked one).
extern "C" int armada_fair_shares(const float* w, const float* cds, float* fs, float* dcafs,
                                  float* ucafs, float* scratch, u8* achieved, int Q,
                                  int max_iter, int lanes, cudaStream_t stream) {
    if (Q <= 0 || Q > 32 * FS_MAX_WINDOWS || lanes <= 0 || lanes > 65535) return -1;
    ARMADA_LAUNCH(fair_shares_kernel, dim3(1, lanes), ARMADA_BLOCK, stream)(
        w, cds, fs, dcafs, ucafs, scratch, achieved, Q, max_iter);
    ARMADA_CHECK();
    return 0;
}
