// K-J: the explain pass -- unschedulable-reason attribution over the
// round-final state, one i32 buffer out.
//
// Replaces the JAX package's armada_tpu/models/explain.py
// `_explain_kernel_impl`.  Plain version: armada_tpu_torch/models/explain.py
// `explain_kernel_plain` (reasons and buffer layout documented there).
//
// Exactness: every count is an integer (order-free atomics, int32 wrap);
// argmax keeps the first maximum; the key and failed-gang lists are
// ascending compactions (block ranks, csrc/scan.cuh).  The f32
// fragmentation sums pass 2^24 at the reference scale, so their association
// is reproduced, not tolerated: frag_free in XLA:CPU's reduction order
// (windows of 32 nodes left to right with the padding split around the
// axis, recursing on the window sums), type_frag_free in its scatter order
// (left to right in node order, per type).  The maxima are order-free.
// `node_type` takes JAX's index rules: the compat gathers clamp it into
// [0, T) after a negative index counts from the end; the per-type scatters
// (type_frag_free, type_frag_max) drop an index outside [-T, T).
//
// Bound on this card: the bytes read once (the gang rows, ~30 MB at
// G ~ 1.19M, and the node rows), ~10 us of HBM time, against the [K, N] fit
// checks' operations; and the per-type sums' chain floor: each (type,
// resource) sum is a chain of dependent f32 adds in node order, so no
// design beats the longest type's node count x the add's latency (on the
// incremental path every real node has type 0: 50,176 adds, ~0.1 ms).  The
// design aims at the chain floor, with everything else under it: one
// memset and five launches, the type sums on a side stream forked after the
// memset and joined before the call returns.
//  1. `ex_type_kernel` (side stream): type_frag_free, one block a type, R
//     chain lanes in warp 0.  The other warps (the producers) stage the
//     nodes in tiles in shared memory by cp.async, two tiles ahead, and
//     compact each tile's nodes of the block's type in node order (a scan
//     over the producers) as their free values, one padded row a resource;
//     meanwhile warp 0's lane r adds row r of the tile before left to
//     right, four 16-byte loads a block of 16 adds, the next block loaded
//     while these add (5.55 cycles an add on the H100 against the add's
//     4.11: the chain floor's 68 % on the incremental path).
//  2. `ex_pass1_kernel`: per gang, the keys' representative requests (a
//     scatter-max) and the failed gangs' block counts; per node, the free
//     capacity's maxima; the first stage of frag_free's windows.  Gangs of
//     one key (and nodes of one type) meet in a block's shared-memory cache
//     of the table, and a max that would not grow is not attempted; a gang
//     block walks EX_SUB tiles of gangs, so the global atomics are one a
//     block and entry for 4,096 gangs: a handful of keys took most of the
//     parent's time in atomics on the same few addresses.
//  3. `ex_pass2_kernel`: the [K, N] fit checks (a block a node tile and 64
//     keys, the node's rows in registers, a warp ballot a flag), the failed
//     counts' scan, and frag_free's later window stages (one block).
//  4. `ex_reason_kernel`: the reason of every gang; its histograms in
//     shared memory and the caches of the queue and key tables, over EX_SUB
//     tiles of gangs a block; the failed-gang list by block rank.
//  5. `ex_final_kernel` (one block): the key table, the list tails and the
//     header.

#include "scan.cuh"

#define EX_NR 7  // reasons
#define EX_WINDOW 32
#define EX_THREADS SCAN_BLOCK
#define EX_CACHE 2048           // slots of a block's cache of a global table
#define EX_SUB 4                // tiles of EX_THREADS gangs a gang block walks
#define EX_TILE_MAX 4096        // nodes of a type-kernel tile
#define EX_SMEM_MAX (200 << 10)  // dynamic shared memory of the type kernel
// floats between the rows of the type kernel's value buffer: the chain
// lanes' 16-byte loads of one column then fall in distinct banks
#define EX_ROW_PAD 4
#ifndef EX_DYN_SHARED
#define EX_DYN_SHARED(name) extern __shared__ __align__(16) u8 name[]
#endif

// Every member is 8 bytes: kernels/explain.py fills it as an int64 array.
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
    int* out;                   // the buffer; zeroed with req_k, key_ok, kr
    float* req_k;               // [K, R]
    u8* key_ok;                 // [K, 3]: shape_ok, shape_ok_pre, now_ok
    int* kr;                    // [K, EX_NR]
    int* counts;                // [ceil(G / EX_THREADS)] failed gangs a block -> offsets
    int* totals;                // [2]: -, n_failed_gangs
    float* wbuf;                // [2 * (ceil(N / 32) + 1) * R] window sums
    long long N, R, G, K, T, Q, real_g, kcap, fcap, zero_bytes;
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
    l.kid = l.qc + a.Q * EX_NR;
    l.kre = l.kid + a.kcap;
    l.kco = l.kre + a.kcap;
    l.fid = l.kco + a.kcap;
    l.fre = l.fid + a.fcap;
    l.ff = l.fre + a.fcap;
    l.fm = l.ff + a.R;
    l.tff = l.fm + a.R;
    l.tfm = l.tff + a.T * a.R;
    l.len = l.tfm + a.T * a.R;
    return l;
}

static __host__ __device__ inline long long ex_blocks(long long n) {
    const long long b = (n + EX_THREADS - 1) / EX_THREADS;
    return b > 0 ? b : 1;
}

// free = where(node_ok, max(alloc0, 0), 0) (NaN kept)
static __device__ __forceinline__ float ex_clamp(float x) {
    return x != x ? x : (x > 0.0f ? x : 0.0f);
}

static __device__ __forceinline__ float ex_free(const ExplainArgs& a, long long n, int r) {
    return a.node_ok[n] ? ex_clamp(a.alloc0[n * a.R + r]) : 0.0f;
}

// The gather rule (jnp indexing): a negative index counts from the end, then
// clamps into [0, n).
static __device__ __forceinline__ long long ex_gather_index(long long i, long long n) {
    if (i < 0) i += n;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// A block's direct-mapped cache of a global int table: entry k lives in slot
// k % EX_CACHE while no other entry holds it; a collision goes straight to
// the global table.  The ops are order-free (add with int32 wrap, max).
struct ExCache {
    int key[EX_CACHE];
    int val[EX_CACHE];
};

static __device__ __forceinline__ void ex_cache_init(ExCache& c) {
    for (int i = threadIdx.x; i < EX_CACHE; i += blockDim.x) {
        c.key[i] = -1;
        c.val[i] = 0;
    }
}

template <bool MAX>
static __device__ __forceinline__ void ex_cache_put(ExCache& c, int* table, int k, int v) {
    const int s = k & (EX_CACHE - 1);
    int cur = c.key[s];  // read first: most puts find their slot claimed
    if (cur == -1) {
        const int old = atomicCAS(&c.key[s], -1, k);
        cur = old == -1 ? k : old;
    }
    if (cur == k) {
        // a max only grows, so a value already at least v needs no atomic
        if (!MAX) atomicAdd(&c.val[s], v);
        else if (c.val[s] < v) atomicMax(&c.val[s], v);
    } else {
        if (MAX) atomicMax(&table[k], v);
        else atomicAdd(&table[k], v);
    }
}

template <bool MAX>
static __device__ __forceinline__ void ex_cache_flush(ExCache& c, int* table) {
    for (int i = threadIdx.x; i < EX_CACHE; i += blockDim.x) {
        if (c.key[i] < 0 || c.val[i] == 0) continue;
        if (MAX) atomicMax(&table[c.key[i]], c.val[i]);
        else atomicAdd(&table[c.key[i]], c.val[i]);
    }
}

// Window j of column r at one stage: left to right from +0 over the rows
// j*32 - lo .. j*32 - lo + 31 that exist (`in` null: the free capacity).
static __device__ float ex_window(const ExplainArgs& a, const float* in, long long n, long long j,
                                  long long lo, int r) {
    float acc = 0.0f;
    for (int w = 0; w < EX_WINDOW; ++w) {
        const long long i = j * EX_WINDOW - lo + w;
        if (i >= 0 && i < n) acc = __fadd_rn(acc, in ? in[i * a.R + r] : ex_free(a, i, r));
    }
    return acc;
}

__global__ void __launch_bounds__(EX_THREADS) ex_pass1_kernel(const ExplainArgs a,
                                                                const ExLayout l) {
    __shared__ ExCache cache;
    __shared__ int smax[32];
    const long long nbG = ex_blocks(a.G), nbN = ex_blocks(a.N);
    const long long nbGs = (nbG + EX_SUB - 1) / EX_SUB;
    long long b = blockIdx.x;
    const int t = threadIdx.x;
    if (b < nbGs) {
        // the keys' representative requests (every value >= 0: the float max
        // is an integer max on the bits) and the failed gangs' counts a tile,
        // over EX_SUB tiles of gangs (one cache flush for them all)
        ex_cache_init(cache);
        __syncthreads();
        for (long long tb = b * EX_SUB; tb < (b + 1) * EX_SUB && tb < nbG; ++tb) {
            const long long g = tb * EX_THREADS + t;
            bool cf = false;
            if (g < a.G) {
                const bool real = g < a.real_g;
                const int st = a.g_state[g];
                const int key = a.g_key[g];
                const bool jobg = real && a.g_run[g] < 0 && !a.g_absent[g];
                cf = real && st == 2;
                if (jobg && (st == 2 || st == 0) && key >= 0 && key < a.K)
                    for (int r = 0; r < a.R; ++r) {
                        const float v = a.g_req[g * a.R + r];
                        if (v > 0.0f) ex_cache_put<true>(cache, (int*)a.req_k, key * (int)a.R + r,
                                                         __float_as_int(v));
                    }
            }
            const int count = __syncthreads_count(cf);
            if (t == 0) a.counts[tb] = count;
        }
        ex_cache_flush<true>(cache, (int*)a.req_k);
        return;
    }
    b -= nbGs;
    if (b < nbN) {
        // frag_max and type_frag_max (dropped outside [-T, T))
        ex_cache_init(cache);
        if (t < 32) smax[t] = 0;
        __syncthreads();
        const long long n = b * EX_THREADS + t;
        if (n < a.N) {
            const long long ty = jax_index(a.node_type[n], a.T);
            for (int r = 0; r < a.R; ++r) {
                const float f = ex_free(a, n, r);
                if (f > 0.0f) {
                    if (smax[r] < __float_as_int(f)) atomicMax(&smax[r], __float_as_int(f));
                    if (ty >= 0) ex_cache_put<true>(cache, a.out + l.tfm, (int)(ty * a.R + r),
                                                    __float_as_int(f));
                }
            }
        }
        __syncthreads();
        if (t < a.R && smax[t] != 0) atomicMax(&a.out[l.fm + t], smax[t]);
        ex_cache_flush<true>(cache, a.out + l.tfm);
        return;
    }
    b -= nbN;
    // frag_free's first window stage
    const long long k = (a.N + EX_WINDOW - 1) / EX_WINDOW;
    const long long e = b * EX_THREADS + t;
    if (e < k * a.R) {
        const long long lo = (k * EX_WINDOW - a.N) / 2;
        a.wbuf[e] = ex_window(a, nullptr, a.N, e / a.R, lo, (int)(e % a.R));
    }
}

// --- type_frag_free -------------------------------------------------------------

static __device__ __forceinline__ unsigned ex_smem_addr(const void* p) {
#ifdef ARMADA_EMULATE
    return 0;
#else
    return (unsigned)__cvta_generic_to_shared(p);
#endif
}

static __device__ __forceinline__ void ex_cp16(void* dst, const void* src) {
#ifdef ARMADA_EMULATE
    memcpy(dst, src, 16);
#else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(ex_smem_addr(dst)), "l"(src)
                 : "memory");
#endif
}

static __device__ __forceinline__ void ex_cp_commit() {
#ifndef ARMADA_EMULATE
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most the newest cp.async group of this thread is in flight.
static __device__ __forceinline__ void ex_cp_wait_group1() {
#ifndef ARMADA_EMULATE
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// The type kernel's tile: the largest power of two up to EX_TILE_MAX whose
// two staging buffers (each array with 16 bytes of slack for a source not
// 16-byte aligned) and two buffers of compacted values fit in EX_SMEM_MAX.
struct ExTypeTile {
    long long nodes, vals, types, oks, cvals, bytes;  // nodes; buffer bytes; total bytes
};

static __host__ __device__ inline ExTypeTile ex_type_tile(long long R) {
    ExTypeTile s;
    for (s.nodes = EX_TILE_MAX;; s.nodes >>= 1) {
        s.vals = s.nodes * R * 4 + 16;
        s.types = s.nodes * 4 + 16;
        s.oks = (s.nodes + 15) / 16 * 16 + 16;
        s.cvals = (s.nodes + EX_ROW_PAD) * R * 4;
        s.bytes = 2 * (s.vals + s.types + s.oks + s.cvals);
        if (s.bytes <= EX_SMEM_MAX || s.nodes <= 32) return s;
    }
}

// The type kernel's producers: warps 1.. of the block (EX_PRODUCERS threads)
// stage and compact tiles while warp 0 adds; they meet on barrier 1.
#define EX_PRODUCERS (EX_THREADS - 32)
#ifndef EX_PRODUCER_SYNC
#define EX_PRODUCER_SYNC() asm volatile("bar.sync 1, %0;\n" ::"n"(EX_PRODUCERS) : "memory")
#endif

// acc + a.x + a.y + ... + d.w, left to right.
static __device__ __forceinline__ float ex_add16(float acc, float4 a, float4 b, float4 c,
                                                 float4 d) {
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a.x), a.y), a.z), a.w);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, b.x), b.y), b.z), b.w);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, c.x), c.y), c.z), c.w);
    return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, d.x), d.y), d.z), d.w);
}

// Stage bytes [src, src + nb) into shared memory at dst + (src & 15) (dst
// 16-byte aligned, nb + 16 bytes of room), by the producers (p: this
// thread's rank among them): 16-byte asynchronous copies of the aligned
// chunks inside the range, and a byte a thread for a ragged head and tail.
static __device__ __forceinline__ void ex_stage(u8* dst, const u8* src, long long nb, int p) {
    const long long mis = (long long)((unsigned long long)src & 15);
    const u8* base = src - mis;
    const long long span = mis + nb;
    const long long c0 = (mis + 15) / 16;
    const long long c1 = span / 16 > c0 ? span / 16 : c0;
    for (long long c = c0 + p; c < c1; c += EX_PRODUCERS) ex_cp16(dst + 16 * c, base + 16 * c);
    const long long head = 16 * c0 < span ? 16 * c0 : span;
    for (long long i = mis + p; i < head; i += EX_PRODUCERS) dst[i] = base[i];
    for (long long i = (16 * c1 > mis ? 16 * c1 : mis) + p; i < span; i += EX_PRODUCERS)
        dst[i] = base[i];
}

// Exclusive prefix of v over the producers (every one calls it); the total
// to *total.
static __device__ __forceinline__ int ex_producer_scan(int v, int* warp_tot, int* total) {
    const int lane = threadIdx.x & 31, pw = (threadIdx.x >> 5) - 1;  // producer warp
    int x = v;
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
    }
    if (lane == 31) warp_tot[pw] = x;
    EX_PRODUCER_SYNC();
    if (pw == 0) {
        int t = lane < EX_PRODUCERS / 32 ? warp_tot[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, t, off);
            if (lane >= off) t += y;
        }
        if (lane < EX_PRODUCERS / 32) warp_tot[lane] = t;
    }
    EX_PRODUCER_SYNC();
    const int out = (pw ? warp_tot[pw - 1] : 0) + x - v;
    *total = warp_tot[EX_PRODUCERS / 32 - 1];
    EX_PRODUCER_SYNC();
    return out;
}

#ifdef EX_TYPE_PROFILE
// Block 0's marks a tile (clock64 at its chain's start and end, and after
// the tile's barrier) and its count, read by chip_smoke.py
// `explain_type_profile` from a build of this file with -DEX_TYPE_PROFILE.
#define EX_PROF_TILES 1024
__device__ long long ex_type_prof[4 * EX_PROF_TILES];
extern "C" int armada_explain_type_profile(long long* out, int tiles) {
    if (tiles < 0 || tiles > EX_PROF_TILES) return -1;
    return (int)cudaMemcpyFromSymbol(out, ex_type_prof, sizeof(long long) * 4 * tiles);
}
#define EX_PROF_MARK(i, k, v) \
    if (blockIdx.x == 0 && (i) < EX_PROF_TILES) ex_type_prof[4 * (i) + (k)] = (v)
#else
#define EX_PROF_MARK(i, k, v) ((void)0)
#endif

__global__ void __launch_bounds__(EX_THREADS, 1) ex_type_kernel(const ExplainArgs a,
                                                                  const ExLayout l) {
    EX_DYN_SHARED(ex_smem);
    __shared__ int warp_tot[32];
    __shared__ int count[2];
    const ExTypeTile s = ex_type_tile(a.R);
    // buffer b of each array; tile offsets are multiples of 16 bytes, so a
    // tile's data sits at the source's own misalignment in every buffer
    u8* vbuf = ex_smem;
    u8* tbuf = vbuf + 2 * s.vals;
    u8* obuf = tbuf + 2 * s.types;
    float* cbuf = (float*)(obuf + 2 * s.oks);
    const long long vmis = (long long)((unsigned long long)a.alloc0 & 15);
    const long long tmis = (long long)((unsigned long long)a.node_type & 15);
    const long long omis = (long long)((unsigned long long)a.node_ok & 15);
    const long long type = blockIdx.x, R = a.R;
    const long long ntiles = (a.N + s.nodes - 1) / s.nodes;
    const int per = (int)((s.nodes + EX_PRODUCERS - 1) / EX_PRODUCERS);
    const int t = threadIdx.x, p = t - 32;  // p: rank among the producers
    // producers: stage tile i into buffer b (one cp.async group)
    auto issue = [&](long long i, int b) {
        if (i < ntiles) {
            const long long n0 = i * s.nodes;
            const long long nn = a.N - n0 < s.nodes ? a.N - n0 : s.nodes;
            ex_stage(vbuf + b * s.vals, (const u8*)(a.alloc0 + n0 * R), nn * R * 4, p);
            ex_stage(tbuf + b * s.types, (const u8*)(a.node_type + n0), nn * 4, p);
            ex_stage(obuf + b * s.oks, a.node_ok + n0, nn, p);
        }
        ex_cp_commit();
    };
    // producers: tile i (staged in buffer b) -> its nodes of `type`, in node
    // order, as free values in value buffer b
    auto compact = [&](long long i, int b) {
        const long long nn = a.N - i * s.nodes < s.nodes ? a.N - i * s.nodes : s.nodes;
        const int* ty = (const int*)(tbuf + b * s.types + tmis);
        const float* v = (const float*)(vbuf + b * s.vals + vmis);
        const u8* ok = obuf + b * s.oks + omis;
        float* cv = cbuf + b * (s.cvals / 4);
        int mine = 0, cnt = 0;
        for (int j = 0; j < per; ++j) {
            const long long li = (long long)p * per + j;
            if (li < nn && jax_index(ty[li], a.T) == type) {
                mine |= 1 << j;
                ++cnt;
            }
        }
        int total;
        int rank = ex_producer_scan(cnt, warp_tot, &total);
        for (int j = 0; j < per; ++j) {
            if (!(mine & (1 << j))) continue;
            const long long li = (long long)p * per + j;
            for (long long r = 0; r < R; ++r)  // resource-major: a chain reads a row
                cv[r * (s.nodes + EX_ROW_PAD) + rank] = ok[li] ? ex_clamp(v[li * R + r]) : 0.0f;
            ++rank;
        }
        if (p == 0) count[b] = total;
    };
    float acc = 0.0f;
    if (p >= 0) {
        issue(0, 0);
        issue(1, 1);
        ex_cp_wait_group1();
        EX_PRODUCER_SYNC();
        compact(0, 0);
    }
    __syncthreads();
    for (long long i = 0; i < ntiles; ++i) {
        const int b = (int)(i & 1);
        if (p < 0) {
            // warp 0, lanes r < R: the chain, left to right over this type's
            // values in the tile (row r of the value buffer), 16 at a time in
            // four 16-byte loads, the next 16 loaded while these 16 add
            if (t < R) {
                const float* row = cbuf + b * (s.cvals / 4) + t * (s.nodes + EX_ROW_PAD);
                const float4* q = (const float4*)row;
                const int total = count[b], nb = total / 16;
                if (t == 0) {
                    EX_PROF_MARK(i, 0, clock64());
                    EX_PROF_MARK(i, 3, total);
                }
                if (nb > 0) {
                    float4 x0 = q[0], x1 = q[1], x2 = q[2], x3 = q[3];
                    int k = 0;
                    for (; k + 2 <= nb; k += 2) {
                        const float4* qb = q + 4 * (k + 1);
                        const float4 y0 = qb[0], y1 = qb[1], y2 = qb[2], y3 = qb[3];
                        acc = ex_add16(acc, x0, x1, x2, x3);
                        const float4* qa = q + 4 * (k + 2 < nb ? k + 2 : k + 1);
                        x0 = qa[0];
                        x1 = qa[1];
                        x2 = qa[2];
                        x3 = qa[3];
                        acc = ex_add16(acc, y0, y1, y2, y3);
                    }
                    if (k < nb) acc = ex_add16(acc, x0, x1, x2, x3);
                }
                for (int j = 16 * nb; j < total; ++j) acc = __fadd_rn(acc, row[j]);
#ifdef EX_TYPE_PROFILE
                asm volatile("" ::"f"(acc));  // the chain done before the clock
                if (t == 0) EX_PROF_MARK(i, 1, clock64());
#endif
            }
        } else if (i + 1 < ntiles) {
            // tile i's staging buffer is free: stage tile i + 2 there, then
            // compact tile i + 1 into the other value buffer
            issue(i + 2, b);
            ex_cp_wait_group1();
            EX_PRODUCER_SYNC();
            compact(i + 1, b ^ 1);
        }
        __syncthreads();
        if (t == 0) EX_PROF_MARK(i, 2, clock64());
    }
    if (t < R) a.out[l.tff + type * R + t] = __float_as_int(acc);
}

// --- fit checks, the failed counts' scan, frag_free's later stages -----------

#define EX_KCHUNK 64  // keys of a fit block
#define EX_RREG 8     // resources a fit block keeps in registers

// Per key of [k0, k0 + nk): does it fit some empty schedulable node of this
// block's tile (with and without the node-type whitelist), and some node at
// round-final free capacity?  A thread holds its node's rows (in registers
// when R <= RM, else re-read); a warp's ballot sets a key's flag.
template <int RM>
static __device__ void ex_fit_tile(const ExplainArgs& a, long long tile, long long k0, int nk,
                                   const float* sreq) {
    const long long n = tile * EX_THREADS + threadIdx.x;
    const bool live = n < a.N && a.node_ok[n];
    const long long ty = live ? ex_gather_index(a.node_type[n], a.T) : 0;
    float tot[RM > 0 ? RM : 1], fre[RM > 0 ? RM : 1];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        tot[r] = live && r < a.R ? a.node_total[n * a.R + r] : 0.0f;
        fre[r] = live && r < a.R ? ex_free(a, n, r) : 0.0f;
    }
    for (int kk = 0; kk < nk; ++kk) {
        const long long k = k0 + kk;
        bool fe = false, fp = false, fn = false;
        if (live) {
            fe = a.compat[k * a.T + ty] != 0;
            fp = a.compat_pre_type[k * a.T + ty] != 0;
            fn = fe;
            if (RM > 0) {
#pragma unroll
                for (int r = 0; r < (RM > 0 ? RM : 1); ++r) {
                    if (r >= a.R) break;
                    const float req = sreq[kk * a.R + r];
                    const bool size_ok = tot[r] >= req;
                    fe = fe && size_ok;
                    fp = fp && size_ok;
                    fn = fn && fre[r] >= req;
                }
            } else {
                for (int r = 0; r < a.R; ++r) {
                    const float req = sreq[kk * a.R + r];
                    const bool size_ok = a.node_total[n * a.R + r] >= req;
                    fe = fe && size_ok;
                    fp = fp && size_ok;
                    fn = fn && ex_free(a, n, r) >= req;
                }
            }
        }
        const unsigned be = __ballot_sync(0xffffffffu, fe), bp = __ballot_sync(0xffffffffu, fp);
        const unsigned bn = __ballot_sync(0xffffffffu, fn);
        if ((threadIdx.x & 31) == 0) {
            u8* ok = a.key_ok + k * 3;
            if (be) ok[0] = 1;
            if (bp) ok[1] = 1;
            if (bn) ok[2] = 1;
        }
    }
}

__global__ void __launch_bounds__(EX_THREADS) ex_pass2_kernel(const ExplainArgs a,
                                                                const ExLayout l) {
    __shared__ int warp_tot[32];
    __shared__ float sreq[EX_KCHUNK * 32];
    const long long nbN = ex_blocks(a.N), nkc = (a.K + EX_KCHUNK - 1) / EX_KCHUNK;
    const long long nbFit = nbN * nkc;
    const long long b = blockIdx.x;
    const int t = threadIdx.x;
    if (b < nbFit) {
        // a node tile against a chunk of keys; the keys' node-axis requests
        // staged in shared memory
        const long long k0 = (b / nbN) * EX_KCHUNK;
        const int nk = (int)(a.K - k0 < EX_KCHUNK ? a.K - k0 : EX_KCHUNK);
        for (long long e = t; e < nk * a.R; e += EX_THREADS)
            sreq[e] = __fmul_rn(a.req_k[k0 * a.R + e], a.node_axes[e % a.R]);
        __syncthreads();
        if (a.R <= EX_RREG) ex_fit_tile<EX_RREG>(a, b % nbN, k0, nk, sreq);
        else ex_fit_tile<0>(a, b % nbN, k0, nk, sreq);
        return;
    }
    if (b == nbFit) {
        // exclusive scan of the failed gangs' block counts, in place
        const long long nbG = ex_blocks(a.G);
        int carry = 0;
        for (long long base = 0; base < nbG; base += EX_THREADS) {
            const long long i = base + t;
            const int v = i < nbG ? a.counts[i] : 0;
            int total;
            const int ex = block_scan_excl(v, warp_tot, &total);
            if (i < nbG) a.counts[i] = carry + ex;
            carry += total;
        }
        if (t == 0) a.totals[1] = carry;
        return;
    }
    // frag_free: windows of 32 rows until <= 32 remain, then left to right
    const long long wcap = (a.N + EX_WINDOW - 1) / EX_WINDOW + 1;
    const float* in = nullptr;
    long long n = a.N;
    int which = 0;
    if (n > EX_WINDOW) {  // the first stage ran in ex_pass1_kernel
        in = a.wbuf;
        n = (n + EX_WINDOW - 1) / EX_WINDOW;
        which = 1;
    }
    while (n > EX_WINDOW) {
        const long long k = (n + EX_WINDOW - 1) / EX_WINDOW;
        const long long lo = (k * EX_WINDOW - n) / 2;
        float* outp = a.wbuf + which * wcap * a.R;
        for (long long e = t; e < k * a.R; e += EX_THREADS)
            outp[e] = ex_window(a, in, n, e / a.R, lo, (int)(e % a.R));
        __syncthreads();
        in = outp;
        which ^= 1;
        n = k;
    }
    if (t < a.R) {
        float acc = 0.0f;
        for (long long i = 0; i < n; ++i)
            acc = __fadd_rn(acc, in ? in[i * a.R + t] : ex_free(a, i, t));
        a.out[l.ff + t] = __float_as_int(acc);
    }
}

// --- reasons ------------------------------------------------------------------

__global__ void __launch_bounds__(EX_THREADS) ex_reason_kernel(const ExplainArgs a,
                                                                 const ExLayout l) {
    __shared__ int hist[2 * EX_NR];
    __shared__ ExCache qcache, kcache;
    __shared__ int warp_tot[32];
    const int t = threadIdx.x;
    if (t < 2 * EX_NR) hist[t] = 0;
    ex_cache_init(qcache);
    ex_cache_init(kcache);
    __syncthreads();
    const long long nbG = ex_blocks(a.G), tb0 = (long long)blockIdx.x * EX_SUB;
    for (long long tb = tb0; tb < tb0 + EX_SUB && tb < nbG; ++tb) {
        const long long g = tb * EX_THREADS + t;
        int reason = 0, w = 0, hk = -1, qk = -1, kk = -1;
        bool cfailed = false;
        if (g < a.G) {
            const bool real = g < a.real_g;
            const int st = a.g_state[g];
            const bool jobg = real && a.g_run[g] < 0 && !a.g_absent[g];
            const bool failed = jobg && st == 2, pending = jobg && st == 0;
            const int key = a.g_key[g];
            const bool keyed = key >= 0;
            const long long ks = keyed ? key : 0;
            // a gather clamps its index into range, a scatter drops it (JAX)
            const u8* ok = a.key_ok + (ks < a.K ? ks : a.K - 1) * 3;
            if (failed || pending) {
                if (keyed && !ok[1]) reason = 1;       // shape-infeasible
                else if (keyed && !ok[0]) reason = 6;  // type-mismatch
                else if (failed) reason = (a.g_card[g] > 1 || !a.g_valid[g]) ? 4 : 2;
                else if (a.q_killed[a.g_queue[g]]) reason = 3;
                else reason = (keyed && !ok[2]) ? 2 : 5;
            }
            cfailed = real && st == 2;
            w = reason > 0 ? a.g_card[g] : 0;
            if (w != 0) {
                hk = failed ? reason : (pending ? EX_NR + reason : -1);
                qk = (int)jax_index((long long)a.g_queue[g] * EX_NR + reason, a.Q * EX_NR);
                if (keyed) kk = (int)jax_index(ks * EX_NR + reason, a.K * EX_NR);
            }
        }
        if (hk >= 0) atomicAdd(&hist[hk], w);
        if (qk >= 0) ex_cache_put<false>(qcache, a.out + l.qc, qk, w);
        if (kk >= 0) ex_cache_put<false>(kcache, a.kr, kk, w);
        // the failed-gang list: ascending, the first fcap
        int total;
        const long long rank = a.counts[tb] + block_scan_excl(cfailed ? 1 : 0, warp_tot, &total);
        if (cfailed && rank < a.fcap) {
            a.out[l.fid + rank] = (int)g;
            a.out[l.fre + rank] = reason;
        }
    }
    if (t < 2 * EX_NR && hist[t] != 0) atomicAdd(&a.out[l.cf + t], hist[t]);
    ex_cache_flush<false>(qcache, a.out + l.qc);
    ex_cache_flush<false>(kcache, a.kr);
}

// The key table (count, dominant reason by first maximum, the ascending
// list of keys with jobs), the lists' tails and the header.
__global__ void __launch_bounds__(EX_THREADS) ex_final_kernel(const ExplainArgs a,
                                                                const ExLayout l) {
    __shared__ int warp_tot[32];
    const int t = threadIdx.x;
    int running = 0;
    for (long long base = 0; base < a.K; base += EX_THREADS) {
        const long long k = base + t;
        int count = 0, best = 0;
        bool has = false;
        if (k < a.K) {
            const int* row = a.kr + k * EX_NR;
            unsigned int sum = 0;
            for (int r = 0; r < EX_NR; ++r) {
                sum += (unsigned int)row[r];
                if (row[r] > row[best]) best = r;
            }
            count = (int)sum;
            has = count > 0;
        }
        int total;
        const long long rank = running + block_scan_excl(has ? 1 : 0, warp_tot, &total);
        if (has && rank < a.kcap) {
            a.out[l.kid + rank] = (int)k;
            a.out[l.kre + rank] = best;
            a.out[l.kco + rank] = count;
        }
        running += total;
    }
    for (long long i = (running < a.kcap ? running : a.kcap) + t; i < a.kcap; i += EX_THREADS) {
        a.out[l.kid + i] = -1;
        a.out[l.kre + i] = 0;
        a.out[l.kco + i] = 0;
    }
    const long long nf = a.totals[1];
    for (long long i = (nf < a.fcap ? nf : a.fcap) + t; i < a.fcap; i += EX_THREADS) {
        a.out[l.fid + i] = -1;
        a.out[l.fre + i] = 0;
    }
    if (t == 0) {
        unsigned int nfj = 0;
        for (int r = 0; r < EX_NR; ++r) nfj += (unsigned int)a.out[l.cf + r];
        a.out[0] = 2;  // version
        a.out[1] = running;
        a.out[2] = (int)nf;
        a.out[3] = (int)nfj;
        a.out[4] = (int)a.Q;
        a.out[5] = (int)a.R;
        a.out[6] = (int)a.T;
        a.out[7] = 0;
    }
}

extern "C" long long armada_explain_len(const ExplainArgs* args) { return ex_layout(*args).len; }
extern "C" int armada_explain_args_size(void) { return (int)sizeof(ExplainArgs); }

extern "C" int armada_explain(const ExplainArgs* args, cudaStream_t stream) {
    const ExplainArgs a = *args;
    if (a.N <= 0 || a.R <= 0 || a.G <= 0 || a.K <= 0 || a.T <= 0 || a.Q <= 0 || a.kcap < 0 ||
        a.fcap < 0 || a.kcap > a.K || a.fcap > a.G || a.R > 32 || a.K * EX_NR >= (1ll << 31) ||
        a.Q * EX_NR >= (1ll << 31) || a.T * a.R >= (1ll << 31) || a.K * a.R >= (1ll << 31) ||
        a.zero_bytes < 0)
        return -1;
    const ExLayout l = ex_layout(a);
    const ExTypeTile tile = ex_type_tile(a.R);
    static int smem_set[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
    if (smem_set[dev] < tile.bytes) {
        cudaFuncSetAttribute(ex_type_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile.bytes);
        ARMADA_CHECK();
        smem_set[dev] = (int)tile.bytes;
    }
    // the type sums on a side stream of this device, forked after the memset
    // and joined before the call returns: they overlap the other passes
    static cudaStream_t side[64];
    static cudaEvent_t fork[64], join[64];
    if (!side[dev]) {
        if (cudaStreamCreateWithFlags(&side[dev], cudaStreamNonBlocking) != cudaSuccess ||
            cudaEventCreateWithFlags(&fork[dev], cudaEventDisableTiming) != cudaSuccess ||
            cudaEventCreateWithFlags(&join[dev], cudaEventDisableTiming) != cudaSuccess)
            return (int)cudaGetLastError();
    }
    cudaMemsetAsync(a.out, 0, (size_t)a.zero_bytes, stream);
    ARMADA_CHECK();
    cudaEventRecord(fork[dev], stream);
    cudaStreamWaitEvent(side[dev], fork[dev], 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH_SMEM(ex_type_kernel, (unsigned)a.T, EX_THREADS, (size_t)tile.bytes,
                       side[dev])(a, l);
    ARMADA_CHECK();
    cudaEventRecord(join[dev], side[dev]);
    ARMADA_CHECK();
    const long long nbGs = (ex_blocks(a.G) + EX_SUB - 1) / EX_SUB, nbN = ex_blocks(a.N);
    const long long nbW = a.N > EX_WINDOW ? ex_blocks((a.N + EX_WINDOW - 1) / EX_WINDOW * a.R) : 0;
    ARMADA_LAUNCH(ex_pass1_kernel, (unsigned)(nbGs + nbN + nbW), EX_THREADS, stream)(a, l);
    ARMADA_CHECK();
    const long long nkc = (a.K + EX_KCHUNK - 1) / EX_KCHUNK;
    ARMADA_LAUNCH(ex_pass2_kernel, (unsigned)(nbN * nkc + 2), EX_THREADS, stream)(a, l);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_reason_kernel, (unsigned)nbGs, EX_THREADS, stream)(a, l);
    ARMADA_CHECK();
    ARMADA_LAUNCH(ex_final_kernel, 1, EX_THREADS, stream)(a, l);
    ARMADA_CHECK();
    cudaStreamWaitEvent(stream, join[dev], 0);
    ARMADA_CHECK();
    return 0;
}

// The f32 add's dependent-issue latency on this card: one thread's chain of
// n adds (n a multiple of 16), cycles from clock64 into out[0].  chip_smoke.py
// turns it into K-J's chain floor.
__global__ void ex_fadd_chain_kernel(long long* out, float x, int n) {
    float acc = 0.0f;
    const long long t0 = clock64();
    for (int i = 0; i < n; i += 16) {
#pragma unroll
        for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, x);
    }
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = __float_as_int(acc);
}

extern "C" int armada_fadd_cycles(long long* out, int n, cudaStream_t stream) {
    if (n <= 0 || n % 16) return -1;
    ARMADA_LAUNCH(ex_fadd_chain_kernel, 1, 1, stream)(out, 1.0e-7f, n);
    ARMADA_CHECK();
    return 0;
}
