// K-A: water-filling fair shares.
//
// Replaces the JAX package's ops/fairness.py `_fair_shares_jit` (a jitted
// lax.while_loop of at most 10 iterations over [Q] vectors).  Plain version:
// armada_tpu_torch/ops/fairness.py `fair_shares_plain`.
//
// Reduction order.  Every [Q] sum feeds the eviction gate, so it is taken in
// XLA:CPU's order, as the plain version takes it: lengths <= 32 left to right
// from 0; longer ones padded to a multiple of 32 with floor(pad/2) of the
// padding before element 0, each window of 32 summed left to right over its
// real elements, then the window sums the same way, recursively.  The loop's
// sum of spare shares at 25..32 queues is XLA's 8-lane vectorized loop
// instead (fs_vec8).  The uncapped share's update is one fma, divisions are
// IEEE (__fdiv_rn), and the library is built with -fmad=false.
//
// Bound on this card.  Its bytes (two [Q] f32 rows in, three out) take
// nanoseconds; what bounds it is its chain of dependent f32 adds: the
// ordered sums (72 adds a sum at Q = 8,192: a window of 32, a window of the
// 256 window sums, the last 8), one for the weights and two an iteration,
// up to 10 iterations.
//
// Design: one launch, no scratch in device memory.  A lane's [Q] rows are
// read once, coalesced, into shared memory and stay there for the whole
// loop; the shares are written once at the end.  The rows the sums read --
// the active weights (the weight until the queue is achieved, then +0) and
// the spares -- are laid out by the padded position p = q + lo (lo the
// split padding before element 0) at slot p + p/32, padding +0, so that
// window j's 32 positions sit at 33j .. 33j + 31, free of bank conflicts;
// the rows only a queue's own thread reads (weight, demand, the two shares,
// the achieved flags) are laid out by queue.
//  - The per-queue pass strides over the lane's threads (queue t, t + T,
//    ...), so the queues' divisions run side by side.  A queue whose weight
//    and demand are +0 (the padding) keeps a +0 state while the unallocated
//    share is finite, so a thread walks only its other queues (and all of
//    them once that share has not been finite).
//  - A sum: thread j < k owns window j and adds its 32 slots left to right
//    (no sum is ever a tree; the +0 padding changes nothing), all loads
//    before the first add.  In a block the window sums meet in a
//    double-buffered shared row, and after one barrier every warp takes the
//    upper levels itself (lane L adds window L of the window sums, then the
//    last <= 32 go left to right through shuffles, leaving the total in
//    every lane), so no barrier broadcasts it.
//  - The weights' sum is the first iteration's total active weight; the
//    spare sum is not taken once the total active weight is not positive
//    (the plain version takes none).  So an iteration costs the two sums'
//    barriers and one between the per-queue pass and the spare sum.
// Three forms, chosen at launch by the number of windows k (Q <= 32: 1):
//  - warp form (k <= 32, Q <= 1,024): a warp a lane, up to 8 lanes a block,
//    its barriers __syncwarp; the upper level is the warp's shuffle chain,
//    and the 8-lane spare sum at 25..32 queues is taken by lanes 0..7.
//  - shared form (k <= FS_SHM_WINDOWS, Q <= 8,448): a block of 32 ceil(k /
//    32) threads a lane (Q = 8,192: 256 threads; Q + 1 = 8,193: 288), every
//    row in shared memory.
//  - global form (wider, up to MAX_QUEUES = 32,768): the same, with weight
//    and demand read from the inputs, the two shares kept in their outputs
//    and the active weights in the fair-share output; the spares and the
//    achieved flags stay in shared memory.
// A stacked round (K-D) passes [P, Q] rows; lane l reads and writes rows l.

#include "common.cuh"

#ifndef FS_DYN_SHARED
#define FS_DYN_SHARED(name) extern __shared__ __align__(16) u8 name[]
#endif

#define FS_WIN 32
#define FS_MAX_WINDOWS 1024   // Q <= 32 * 1024
#define FS_SHM_WINDOWS 264    // the shared form's widest row (225,984 bytes of rows)
#define FS_WARP_LANES 8       // lanes a block of the warp form
#define FS_SKEW(j) ((j) + ((j) >> 5))
#define FS_WROW FS_SKEW(FS_MAX_WINDOWS)  // a row of window sums

struct FsArgs {
    const float* w;    // [P, Q]
    const float* cds;  // [P, Q]
    float* fs;         // [P, Q]
    float* dcafs;      // [P, Q]
    float* ucafs;      // [P, Q]
    int Q, max_iter, lanes;
};

// Windows of a row of n (1 at n <= 32).
static __host__ __device__ __forceinline__ int fs_windows(int n) {
    return n <= FS_WIN ? 1 : (n + FS_WIN - 1) / FS_WIN;
}

// One lane's shared rows: window layout (33 k slots: spares, and the
// active weights in the shared form), queue layout (n each: weight,
// demand, the two shares in the shared form; the achieved flags), each
// piece a multiple of 16 bytes.
static __host__ __device__ __forceinline__ long long fs_piece(long long b) {
    return (b + 15) / 16 * 16;
}

static __host__ __device__ __forceinline__ long long fs_lane_bytes(int n, bool shm) {
    const int k = fs_windows(n);
    return (shm ? 2 : 1) * fs_piece(4LL * 33 * k) + (shm ? 4 : 0) * fs_piece(4LL * n) +
           fs_piece(n);
}

static __device__ __forceinline__ void fs_carve(u8* p, int n, bool shm, float** s, float** aw,
                                                float** w, float** c, float** d, float** u,
                                                u8** ach) {
    const long long win = fs_piece(4LL * 33 * fs_windows(n)), row = fs_piece(4LL * n);
    *s = (float*)p;
    p += win;
    *aw = (float*)p;
    if (shm) p += win;
    *w = (float*)p;
    *c = (float*)(p + row);
    *d = (float*)(p + 2 * row);
    *u = (float*)(p + 3 * row);
    if (shm) p += 4 * row;
    *ach = p;
}

// The left-to-right sum, from +0, of lanes 0..n-1's x (n <= 32); every lane
// of the warp gets it.
static __device__ __forceinline__ float fs_warp_l2r(float x, int n) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = __shfl_sync(0xffffffffu, x, i);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
        if (i < n) s = __fadd_rn(s, v[i]);
    return s;
}

// The in-loop sum of spare shares at 25..32 queues, as XLA:CPU vectorizes it
// into 8 lanes: lane i adds x[i], x[8+i], ... over the first n/8 groups of
// 8, lanes are halved pairwise (i + i+4, i + i+2, 0 + 1), then the last
// n % 8 elements are added left to right.  Every lane gets the sum.
static __device__ __forceinline__ float fs_vec8(const float* x, int n) {
    const int lane = threadIdx.x & 31;
    const int m = n / 8;
    float acc = x[lane & 7];
    for (int v = 1; v < m; ++v) acc = __fadd_rn(acc, x[8 * v + (lane & 7)]);
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 4));
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 2));
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 1));
    if (lane == 0)
        for (int i = 8 * m; i < n; ++i) acc = __fadd_rn(acc, x[i]);
    return __shfl_sync(0xffffffffu, acc, 0);
}

// One queue's iteration (the plain version's loop body, in its order).
// Both divisions of the body divide the weight by the same value whenever
// both are used (by tw + w if achieved, else by tw), so one is taken; a
// weight of +-0 over a positive divisor is itself.  Returns `newly`.
static __device__ __forceinline__ bool fs_step(float w, float c, float& d, float& u, float& s,
                                               bool ach, float tw, float safe_tw,
                                               float unalloc) {
    const float denom = __fadd_rn(tw, ach ? w : 0.0f);
    const float q = w == 0.0f ? w : __fdiv_rn(w, ach ? denom : safe_tw);
    const float take = denom > 0.0f ? q : 0.0f;
    // XLA:CPU contracts ucafs + take * (unalloc - spare) to one fma
    u = __fmaf_rn(take, __fsub_rn(unalloc, s), u);
    const float add = (ach || tw <= 0.0f) ? 0.0f : __fmul_rn(q, unalloc);
    const float dn = __fadd_rn(d, add);
    const float sn = __fsub_rn(dn, c);
    const bool newly = sn > 0.0f;
    d = newly ? c : dn;
    s = newly ? sn : 0.0f;
    return newly;
}

// A lane's rows.  Window layout (the sums read it): the active weights
// (`aw`: the weight until the queue is achieved, then +0) and the spares,
// position p = q + lo at slot p + p/32, padding slots +0.  Queue layout (only
// the queue's own thread reads it): weight, demand, the two shares, the
// achieved flags.  SHM: all in shared memory; otherwise weight and demand
// are the inputs, the two shares live in their outputs and the active
// weights in the fair-share output (the shares are written there at the
// end), and only the spares and the flags are shared.
template <bool SHM>
struct FsRows {
    int n, k, lo;
    long long off;  // the lane's first element in the [P, Q] rows
    float *aw, *s;  // window layout
    float *w, *c, *d, *u;  // queue layout
    u8* ach;
    const FsArgs* a;
    __device__ __forceinline__ int slot(int q) const { return FS_SKEW(q + lo); }
    __device__ __forceinline__ float W(int q) const { return SHM ? w[q] : a->w[off + q]; }
    __device__ __forceinline__ float C(int q) const { return SHM ? c[q] : a->cds[off + q]; }
    __device__ __forceinline__ float* D(int q) const { return SHM ? &d[q] : &a->dcafs[off + q]; }
    __device__ __forceinline__ float* U(int q) const { return SHM ? &u[q] : &a->ucafs[off + q]; }
    __device__ __forceinline__ float* AW(int q) const {
        return SHM ? &aw[slot(q)] : &a->fs[off + q];
    }
};

// The ordered sum of the lane's row from its window threads' sums `part`
// (+0 past the k windows).  WARP: the lane is one warp.  Otherwise the
// window sums meet in shared row `buf` (flipped a call; window j at
// position j + lo2 of a row whose padding is +0), and after one barrier
// every warp takes the upper levels.
template <bool WARP>
static __device__ __forceinline__ float fs_total(float part, int k, int j, float* win,
                                                 int& buf) {
    if (WARP) return fs_warp_l2r(part, k);
    const int k2 = (k + FS_WIN - 1) / FS_WIN;  // k > 32: windows of the window sums
    const int lo2 = (k2 * FS_WIN - k) / 2;
    float* row = win + buf * FS_WROW;
    buf ^= 1;
    if (j < k) row[FS_SKEW(j + lo2)] = part;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    float s = 0.0f;
    if (lane < k2) {
        float v[FS_WIN];
#pragma unroll
        for (int i = 0; i < FS_WIN; ++i) v[i] = row[FS_SKEW(lane * FS_WIN + i)];
#pragma unroll
        for (int i = 0; i < FS_WIN; ++i) s = __fadd_rn(s, v[i]);  // +0 padding: exact
    }
    return fs_warp_l2r(s, k2);
}

// Window j's left-to-right sum of a window-layout row (+0 past the k
// windows): its padding slots hold +0, and adding +0 to a sum that starts at
// +0 changes nothing, so all 32 are added.  `glob`: the active weights of
// the global form, at off + q of the fair-share output.
template <bool GLOB>
static __device__ __forceinline__ float fs_window(const float* row, int j, int k, int n, int lo,
                                                  const float* glob) {
    if (j >= k) return 0.0f;
    float v[FS_WIN];
#pragma unroll
    for (int i = 0; i < FS_WIN; ++i) {
        const int q = j * FS_WIN - lo + i;
        v[i] = GLOB ? (q >= 0 && q < n ? glob[q] : 0.0f) : row[33 * j + i];
    }
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < FS_WIN; ++i) part = __fadd_rn(part, v[i]);
    return part;
}

template <bool SHM, bool WARP>
__global__ void __launch_bounds__(WARP ? 32 * FS_WARP_LANES : FS_MAX_WINDOWS)
    fair_shares_kernel(const FsArgs a) {
    FS_DYN_SHARED(smem);
    const int n = a.Q;
    const int k = fs_windows(n);
    const int sub = WARP ? threadIdx.x >> 5 : 0;  // the lane's warp in the block
    const long long lane = WARP ? (long long)blockIdx.x * (blockDim.x >> 5) + sub : blockIdx.x;
    if (lane >= a.lanes) return;  // a whole warp of the warp form
    const int T = WARP ? 32 : blockDim.x;
    const int t = WARP ? (threadIdx.x & 31) : threadIdx.x;  // also the window it sums
    float* win = (float*)smem;  // block forms: two rows of window sums
    FsRows<SHM> r;
    r.a = &a;
    r.n = n;
    r.k = k;
    r.lo = n <= FS_WIN ? 0 : (k * FS_WIN - n) / 2;
    r.off = lane * n;
    fs_carve(smem + (WARP ? 0 : 2 * FS_WROW * sizeof(float)) + sub * fs_lane_bytes(n, SHM), n,
             SHM, &r.s, &r.aw, &r.w, &r.c, &r.d, &r.u, &r.ach);
    const float* gaw = a.fs + r.off;  // the global form's active weights
    // the rows in: window layout slot by slot (padding +0), queue layout
    // queue by queue, both coalesced; queues with weight and demand +0 marked
    for (int p = t; p < 33 * k; p += T) {
        const int i = p % 33, q = (p / 33) * FS_WIN + i - r.lo;
        r.s[p] = 0.0f;
        if (SHM) r.aw[p] = i < FS_WIN && q >= 0 && q < n ? a.w[r.off + q] : 0.0f;
    }
    if (!WARP)
        for (int p = t; p < 2 * FS_WROW; p += T) win[p] = 0.0f;
    unsigned skip = 0;  // bit m: queue t + m T (at most 32 of them: T >= k)
    for (int q = t, m = 0; q < n; q += T, ++m) {
        const float w = a.w[r.off + q], c = a.cds[r.off + q];
        if (SHM) {
            r.w[q] = w;
            r.c[q] = c;
        } else {
            *r.AW(q) = w;
        }
        *r.D(q) = 0.0f;
        *r.U(q) = 0.0f;
        r.ach[q] = 0;
        if ((__float_as_uint(w) | __float_as_uint(c)) == 0u) skip |= 1u << m;
    }
    const int mine = t < n ? (n - t + T - 1) / T : 0;  // this thread's queues
    const unsigned all = mine >= 32 ? 0xffffffffu : (1u << mine) - 1u;
    if (WARP) __syncwarp();
    else __syncthreads();
    int buf = 0;
    // the weights' sum is the first iteration's total active weight: no
    // queue is achieved yet, so the active weights are the weights
    const float wsum = fs_total<WARP>(fs_window<!SHM>(r.aw, t, k, n, r.lo, gaw), k, t, win, buf);
    float unalloc = 1.0f;
    bool running = true;
    int it = 0;
    while (it < a.max_iter && unalloc > 0.01f && running) {
        const float tw =
            it == 0 ? wsum
                    : fs_total<WARP>(fs_window<!SHM>(r.aw, t, k, n, r.lo, gaw), k, t, win, buf);
        running = tw > 0.0f;
        const float safe_tw = tw > 0.0f ? tw : 1.0f;
        if (!isfinite(unalloc)) skip = 0;  // the +0 states turn NaN: every queue from now on
        for (unsigned live = all & ~skip; live; live &= live - 1) {
            const int q = t + (__ffs(live) - 1) * T;
            const int sl = r.slot(q);
            float* dp = r.D(q);
            float* up = r.U(q);
            float d = *dp, u = *up, s = r.s[sl];
            const bool ach = r.ach[q] != 0;
            const bool newly = fs_step(r.W(q), r.C(q), d, u, s, ach, tw, safe_tw, unalloc);
            *dp = d;
            *up = u;
            r.s[sl] = s;
            if (newly) {
                r.ach[q] = 1;
                *r.AW(q) = 0.0f;
            }
        }
        if (WARP) __syncwarp();
        else __syncthreads();
        float spare = 0.0f;  // the plain version takes no spare sum once nothing runs
        if (running) {
            if (WARP && n >= 25 && n <= FS_WIN) spare = fs_vec8(r.s, n);  // k = 1, lo = 0
            else spare = fs_total<WARP>(fs_window<false>(r.s, t, k, n, r.lo, nullptr), k, t,
                                        win, buf);
        }
        unalloc = spare;
        ++it;
    }
    // the shares out, coalesced (every queue's state was its own thread's;
    // in the global form the active weights' last reader passed a barrier)
    for (int q = t; q < n; q += T) {
        const float w = r.W(q);
        a.fs[r.off + q] = wsum > 0.0f ? (w == 0.0f ? w : __fdiv_rn(w, wsum)) : 0.0f;
        if (SHM) {
            a.dcafs[r.off + q] = *r.D(q);
            a.ucafs[r.off + q] = *r.U(q);
        }
    }
}

// Launches one form with its dynamic shared memory (the attribute raised
// once a device).
template <bool SHM, bool WARP>
static int fs_launch(const FsArgs& a, unsigned grid, int threads, long long bytes,
                     cudaStream_t stream) {
    static long long set[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
    void (*kernel)(const FsArgs) = fair_shares_kernel<SHM, WARP>;
    if (bytes > 48 * 1024 && set[dev] < bytes) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        ARMADA_CHECK();
        set[dev] = bytes;
    }
    ARMADA_LAUNCH_SMEM(kernel, grid, threads, (size_t)bytes, stream)(a);
    ARMADA_CHECK();
    return 0;
}

// lanes: the number of [Q] rows (1 for a solo round, P for a stacked one).
extern "C" int armada_fair_shares(const float* w, const float* cds, float* fs, float* dcafs,
                                  float* ucafs, int Q, int max_iter, int lanes,
                                  cudaStream_t stream) {
    if (Q <= 0 || Q > FS_WIN * FS_MAX_WINDOWS || lanes <= 0 || lanes > 65535) return -1;
    const FsArgs a{w, cds, fs, dcafs, ucafs, Q, max_iter, lanes};
    const int k = fs_windows(Q);
    const int threads = (k + 31) / 32 * 32;
    const long long wins = 2LL * FS_WROW * sizeof(float);
    if (k <= 32) {
        const int per = lanes < FS_WARP_LANES ? lanes : FS_WARP_LANES;
        return fs_launch<true, true>(a, (unsigned)((lanes + per - 1) / per), 32 * per,
                                     per * fs_lane_bytes(Q, true), stream);
    }
    if (k <= FS_SHM_WINDOWS)
        return fs_launch<true, false>(a, (unsigned)lanes, threads, wins + fs_lane_bytes(Q, true),
                                      stream);
    return fs_launch<false, false>(a, (unsigned)lanes, threads, wins + fs_lane_bytes(Q, false),
                                   stream);
}

// The form a Q takes: 0 warp, 1 shared, 2 global (kernels/fair_shares.py
// form_of is held against it).
extern "C" int armada_fair_shares_form(int Q) {
    const int k = fs_windows(Q);
    return k <= 32 ? 0 : (k <= FS_SHM_WINDOWS ? 1 : 2);
}
