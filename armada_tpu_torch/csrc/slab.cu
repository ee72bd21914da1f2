// K-H: the slab delta apply -- one cycle's dirty rows into a new copy of the
// device-resident scheduling problem, and (splice) the rebuilt order vector.
//
// Replaces the JAX package's armada_tpu/models/slab.py `apply_delta` (the
// jitted scatter program of _make_apply).  Plain version:
// armada_tpu_torch/models/slab.py `apply_delta_plain`.
//
// Semantics kept from the JAX program: the apply is functional.  Every field
// the bundle touches gets a fresh buffer (a view of one arena the wrapper
// allocates a call), and nothing of the previous problem is written, so the
// tensors a dispatched round, its verify and explain passes or a rollback
// re-run still read keep their state.  Index entries follow JAX's
// mode="drop" rule: negative indices count from the end, others outside the
// axis are dropped (the bucket padding carries the sentinel G or RJ); the
// evictee group maps run indices >= RJ to G explicitly (slab.py:299).  The
// groups apply in the JAX program's order -- gang rows, run rows, evictee
// rows -- so on a slot that two groups write the later group's row wins,
// and within a group the later entry (XLA:CPU's scatter loop).
//
// Bound on this card.  The dirty rows: each row read once from the bundle
// and written once, plus the splice's [G] order vector read and written
// (a few MB at the reference scale).  The functional copies are extra
// traffic the semantics need: every touched field read once and written
// once, 131 MB at G = 1,187,840 (39 us at 3.35 TB/s).  This design aims at
// that second floor, the copies', in four launches and no memset:
//  1. `slab_mark_kernel`, one thread an index entry: each destination
//     slot's winning entry of each group by a 64-bit atomicMax of (epoch,
//     entry) into a per-slot map (the later entry of a group wins, as in
//     XLA:CPU's scatter loop); the splice's removed and inserted positions
//     likewise, with a stamp on each position's 32-position word.
//  2. (splice) `slab_rank_kernel`: one pass over the [G] order vector in
//     tiles of 4,096 positions, each block ranking its kept and unoccupied
//     positions and taking both prefixes by one decoupled look-back (a
//     warp reads 32 predecessors' statuses at a time); the kept entries
//     are compacted into `kept`.
//  3. The copies: every touched field, previous to fresh, as one table of
//     K-E's batched copy (csrc/lanes.cu: a flat grid balanced over the
//     bytes, 16 bytes a thread where source and destination agree).
//  4. `slab_overlay_kernel`: (splice) each position of the new order vector
//     gets its inserted value, the next kept entry or 0; and one thread a
//     (dirty row, field) writes the row over the copy if its entry won the
//     slot, the evictee group beating the gang group on a slot both wrote.
//     No two threads write one (slot, field); the ~5,000 dirty rows of a
//     cycle are written twice (copy, then row) among ~1.2M.
// The scratch is a workspace kept by the wrapper per (device, stream,
// shape) and never cleared: every map entry and stamp carries the call's
// epoch (a counter of the workspace), every look-back status the tag of
// its splice call, and an entry of an older call reads as empty.

#include "lanes.cuh"
#include "scan.cuh"

#define SLAB_MAX_FIELDS 24
#define SLAB_THREADS SCAN_BLOCK
#define SLAB_POS 4         // order-vector positions a thread
#define SLAB_SPLICE_TILE (SLAB_THREADS * SLAB_POS)

typedef unsigned long long u64;
typedef unsigned int u32;

// One touched field.  rows_a: the earlier group's rows [k, rb]; rows_b: the
// later group's (it wins); either may be null.
struct SlabField {
    const u8* src;
    u8* dst;
    const u8* rows_a;
    const u8* rows_b;
    long long rb;  // bytes a row
};

// Every member is 8 bytes: kernels/slab.py fills it as an int64 array.
struct SlabCall {
    SlabField f[SLAB_MAX_FIELDS];  // gang-axis fields [0, ngf), run-axis [ngf, ngf + nrf)
    const int* sg_idx;
    const int* rr_idx;
    const int* rem_pos;
    const int* ins_pos;
    const int* ins_val;
    const int* gq_prev;
    int* gq_out;
    u8* ws;
    long long G, RJ, k_sg, k_rr, kq, ngf, nrf, ev_base, splice, epoch, stag;
};

struct SlabWs {
    u64* gmap_a;    // [G] gang rows' winner (epoch << 32 | entry)
    u64* gmap_b;    // [G] evictee rows' winner
    u64* rmap;      // [RJ] run rows' winner
    u64* insmap;    // [G] inserted (final position) winner
    u64* status;    // [tiles] look-back: (tag, flag, kept, unoccupied)
    u32* remw;      // [ceil(G / 32)] removed positions' words
    u32* occw;      // [ceil(G / 32)] inserted positions' words
    u32* remflag;   // [G] epoch of the call that removed the position
    int* kept;      // [G] the kept entries, compacted
    int* unocc0;    // [tiles] unoccupied positions before the tile
    int* nkept;     // [1]
};

static __host__ __device__ inline long long slab_tiles(long long G) {
    return (G + SLAB_SPLICE_TILE - 1) / SLAB_SPLICE_TILE;
}

static __host__ __device__ inline u8* slab_take(u8* base, long long* off, long long bytes) {
    u8* p = base ? base + *off : nullptr;
    *off += (bytes + 255) / 256 * 256;
    return p;
}

// The workspace's layout from its base (256-byte aligned pieces); returns
// its bytes.  `base` may be null (sizes only).
static __host__ __device__ inline long long slab_ws_layout(long long G, long long RJ, u8* base,
                                                           SlabWs* w) {
    long long off = 0;
    const long long wg = (G + 31) / 32, nt = slab_tiles(G);
    w->gmap_a = (u64*)slab_take(base, &off, 8 * G);
    w->gmap_b = (u64*)slab_take(base, &off, 8 * G);
    w->rmap = (u64*)slab_take(base, &off, 8 * RJ);
    w->insmap = (u64*)slab_take(base, &off, 8 * G);
    w->status = (u64*)slab_take(base, &off, 8 * nt);
    w->remw = (u32*)slab_take(base, &off, 4 * wg);
    w->occw = (u32*)slab_take(base, &off, 4 * wg);
    w->remflag = (u32*)slab_take(base, &off, 4 * G);
    w->kept = (int*)slab_take(base, &off, 4 * G);
    w->unocc0 = (int*)slab_take(base, &off, 4 * nt);
    w->nkept = (int*)slab_take(base, &off, 4);
    return off;
}

static __device__ __forceinline__ bool slab_current(u64 tag, u32 epoch) {
    return (u32)(tag >> 32) == epoch;
}

__global__ void slab_mark_kernel(const SlabCall c) {
    SlabWs w;
    slab_ws_layout(c.G, c.RJ, c.ws, &w);
    const u32 ep = (u32)c.epoch;
    const u64 tag = (u64)ep << 32;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < c.k_sg) {
        const long long t = jax_index(c.sg_idx[i], c.G);
        if (t >= 0) atomicMax(&w.gmap_a[t], tag | (u64)i);
        return;
    }
    i -= c.k_sg;
    if (i < c.k_rr) {
        const long long r = c.rr_idx[i];
        const long long t = jax_index(r, c.RJ);
        if (t >= 0) atomicMax(&w.rmap[t], tag | (u64)i);
        const long long e = jax_index(r >= c.RJ ? c.G : r + c.ev_base, c.G);
        if (e >= 0) atomicMax(&w.gmap_b[e], tag | (u64)i);
        return;
    }
    i -= c.k_rr;
    if (!c.splice) return;
    if (i < c.kq) {
        const long long p = jax_index(c.rem_pos[i], c.G);
        if (p >= 0) {
            w.remflag[p] = ep;
            w.remw[p >> 5] = ep;
        }
        return;
    }
    i -= c.kq;
    if (i < c.kq) {
        const long long p = jax_index(c.ins_pos[i], c.G);
        if (p >= 0) {
            atomicMax(&w.insmap[p], tag | (u64)i);
            w.occw[p >> 5] = ep;
        }
    }
}

// A tile's look-back status: (tag, flag, kept, unoccupied) in one word, so
// one read carries both prefixes.  The tag (1..255) counts the workspace's
// splice calls, the only calls that write statuses, so the previous call's
// statuses never carry the current tag.
#define SLAB_AGG 1ull
#define SLAB_PRE 2ull
#define SLAB_CNT_BITS 27
#define SLAB_CNT_MASK ((1ull << SLAB_CNT_BITS) - 1)

static __device__ __forceinline__ void slab_publish(u64* st, long long tile, u32 tag, u64 flag,
                                                    long long k, long long u) {
    *(volatile u64*)&st[tile] =
        ((u64)tag << 56) | (flag << 54) | ((u64)k << SLAB_CNT_BITS) | (u64)u;
}

// The kept and unoccupied counts over the tiles before `tile` (decoupled
// look-back), read by one whole warp: each lane waits on one of 32
// predecessors' statuses, and the nearest inclusive prefix among them ends
// the walk.
static __device__ void slab_lookback(const u64* st, long long tile, u32 tag, long long* pk,
                                     long long* pu) {
    const int lane = threadIdx.x & 31;
    long long sk = 0, su = 0;
    for (long long hi = tile; hi > 0; hi -= 32) {
        const long long j = hi - 32 + lane;  // lane 31 reads tile hi - 1
        u64 s = 0;
        if (j >= 0) {
            do {
                s = *(const volatile u64*)&st[j];
            } while ((u32)(s >> 56) != tag || ((s >> 54) & 3ull) == 0);
        }
        const unsigned pre = __ballot_sync(0xffffffffu, j >= 0 && ((s >> 54) & 3ull) == SLAB_PRE);
        const int from = pre ? 31 - __clz((int)pre) : 0;
        const bool in = j >= 0 && lane >= from;
        long long vk = in ? (long long)((s >> SLAB_CNT_BITS) & SLAB_CNT_MASK) : 0;
        long long vu = in ? (long long)(s & SLAB_CNT_MASK) : 0;
        for (int off = 16; off > 0; off >>= 1) {
            vk += __shfl_down_sync(0xffffffffu, vk, off);
            vu += __shfl_down_sync(0xffffffffu, vu, off);
        }
        sk += __shfl_sync(0xffffffffu, vk, 0);
        su += __shfl_sync(0xffffffffu, vu, 0);
        if (pre) break;
    }
    *pk = sk;
    *pu = su;
}

static __device__ __forceinline__ bool slab_removed(const SlabWs& w, long long p, u32 ep) {
    return w.remw[p >> 5] == ep && w.remflag[p] == ep;
}

static __device__ __forceinline__ bool slab_occupied(const SlabWs& w, long long p, u32 ep) {
    return w.occw[p >> 5] == ep && slab_current(w.insmap[p], ep);
}

// Splice, pass 1: rank the kept and the unoccupied positions of a tile, take
// their prefixes over the tiles before it, compact the kept entries.
__global__ void __launch_bounds__(SLAB_THREADS) slab_rank_kernel(const SlabCall c) {
    __shared__ int warp_tot[32];
    __shared__ long long base_k;
    SlabWs w;
    slab_ws_layout(c.G, c.RJ, c.ws, &w);
    const u32 ep = (u32)c.epoch;
    // a tile waits only on tiles of lower index, which the card starts first
    const long long tile = blockIdx.x;
    const long long p0 = tile * SLAB_SPLICE_TILE + (long long)threadIdx.x * SLAB_POS;
    int kf = 0, nk = 0, nu = 0;
#pragma unroll
    for (int j = 0; j < SLAB_POS; ++j) {
        const long long p = p0 + j;
        if (p < c.G) {
            if (!slab_removed(w, p, ep)) {
                kf |= 1 << j;
                ++nk;
            }
            nu += !slab_occupied(w, p, ep);
        }
    }
    int total;
    const int excl = block_scan_excl(nk | (nu << 16), warp_tot, &total);
    if (threadIdx.x < 32) {  // warp 0: the tile's prefixes
        const u32 tag = (u32)c.stag;
        const long long tk = total & 0xffff, tu = total >> 16;
        long long pk = 0, pu = 0;
        if (tile > 0) {
            if (threadIdx.x == 0) slab_publish(w.status, tile, tag, SLAB_AGG, tk, tu);
            slab_lookback(w.status, tile, tag, &pk, &pu);
        }
        if (threadIdx.x == 0) {
            slab_publish(w.status, tile, tag, SLAB_PRE, pk + tk, pu + tu);
            base_k = pk;
            w.unocc0[tile] = (int)pu;
            if (tile == slab_tiles(c.G) - 1) *w.nkept = (int)(pk + tk);
        }
    }
    __syncthreads();
    long long r = base_k + (excl & 0xffff);
#pragma unroll
    for (int j = 0; j < SLAB_POS; ++j)
        if (kf & (1 << j)) w.kept[r++] = c.gq_prev[p0 + j];
}

// Splice, pass 2: position p of the new order vector is its inserted value
// (the last entry that inserted at p), else the next kept entry of the
// previous vector, else 0.
static __device__ void slab_splice_tile(const SlabCall& c, const SlabWs& w, long long tile,
                                        int* warp_tot) {
    const u32 ep = (u32)c.epoch;
    const long long p0 = tile * SLAB_SPLICE_TILE + (long long)threadIdx.x * SLAB_POS;
    int of = 0, nu = 0;
#pragma unroll
    for (int j = 0; j < SLAB_POS; ++j) {
        const long long p = p0 + j;
        if (p < c.G) {
            if (slab_occupied(w, p, ep)) of |= 1 << j;
            else ++nu;
        }
    }
    int total;
    long long u = w.unocc0[tile] + block_scan_excl(nu, warp_tot, &total);
    const long long nkept = *w.nkept;
    int v[SLAB_POS];
#pragma unroll
    for (int j = 0; j < SLAB_POS; ++j) {
        const long long p = p0 + j;
        v[j] = 0;
        if (p >= c.G) continue;
        if (of & (1 << j)) {
            v[j] = c.ins_val[(u32)w.insmap[p]];
        } else {
            if (u < nkept) v[j] = w.kept[u];
            ++u;
        }
    }
    if (p0 + SLAB_POS <= c.G && ((unsigned long long)(c.gq_out + p0) & 15) == 0) {
        *(int4*)(c.gq_out + p0) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int j = 0; j < SLAB_POS; ++j)
            if (p0 + j < c.G) c.gq_out[p0 + j] = v[j];
    }
}

// One row of rb bytes, in the widest words both sides are aligned to.
static __device__ __forceinline__ void slab_row_copy(u8* dst, const u8* src, long long rb) {
    const unsigned long long al = (unsigned long long)dst | (unsigned long long)src;
    if ((al & 15) == 0 && (rb & 15) == 0) {
        for (long long i = 0; i < rb; i += 16) *(int4*)(dst + i) = *(const int4*)(src + i);
    } else if ((al & 3) == 0 && (rb & 3) == 0) {
        for (long long i = 0; i < rb; i += 4) *(u32*)(dst + i) = *(const u32*)(src + i);
    } else {
        for (long long i = 0; i < rb; ++i) dst[i] = src[i];
    }
}

// The dirty rows, one thread a (row, field), over the copies: the row is
// written if its entry is its slot's winner (the group's last entry there)
// and, for a gang field the evictee rows also write, no evictee row won the
// slot.  No two threads write one (slot, field).
static __device__ void slab_overlay(const SlabCall& c, const SlabWs& w, long long i) {
    const u32 ep = (u32)c.epoch;
    const long long ngf = c.ngf, nrf = c.nrf;
    long long e, t;
    const SlabField* F;
    const u8* rows;
    if (i < c.k_sg * ngf) {  // the gang rows
        e = i / ngf;
        F = &c.f[i % ngf];
        t = jax_index(c.sg_idx[e], c.G);
        if (t < 0 || !F->rows_a) return;
        const u64 win = w.gmap_a[t];
        if (!slab_current(win, ep) || (u32)win != (u32)e) return;
        if (F->rows_b && slab_current(w.gmap_b[t], ep)) return;
        rows = F->rows_a;
    } else if ((i -= c.k_sg * ngf) < c.k_rr * nrf) {  // the run rows
        e = i / nrf;
        F = &c.f[ngf + i % nrf];
        t = jax_index(c.rr_idx[e], c.RJ);
        if (t < 0) return;
        const u64 win = w.rmap[t];
        if (!slab_current(win, ep) || (u32)win != (u32)e) return;
        rows = F->rows_a;
    } else if ((i -= c.k_rr * nrf) < c.k_rr * ngf) {  // the evictee rows
        e = i / ngf;
        F = &c.f[i % ngf];
        const long long r = c.rr_idx[e];
        t = jax_index(r >= c.RJ ? c.G : r + c.ev_base, c.G);
        if (t < 0 || !F->rows_b) return;
        const u64 win = w.gmap_b[t];
        if (!slab_current(win, ep) || (u32)win != (u32)e) return;
        rows = F->rows_b;
    } else {
        return;
    }
    slab_row_copy(F->dst + t * F->rb, rows + e * F->rb, F->rb);
}

__global__ void __launch_bounds__(SLAB_THREADS) slab_overlay_kernel(const SlabCall c) {
    __shared__ int warp_tot[32];
    SlabWs w;
    slab_ws_layout(c.G, c.RJ, c.ws, &w);
    long long b = blockIdx.x;
    if (c.splice) {
        const long long nsp = slab_tiles(c.G);
        if (b < nsp) {
            slab_splice_tile(c, w, b, warp_tot);
            return;
        }
        b -= nsp;
    }
    slab_overlay(c, w, b * SLAB_THREADS + threadIdx.x);
}

extern "C" long long armada_slab_ws_bytes(long long G, long long RJ) {
    SlabWs w;
    return slab_ws_layout(G, RJ, nullptr, &w);
}

extern "C" int armada_slab_call_size(void) { return (int)sizeof(SlabCall); }

// One apply: the marks, (splice) the rank pass, the copy grid, on `stream`.
// Returns 0, a cudaError_t, or -1 for arguments outside what the kernels take.
extern "C" int armada_slab_apply(const SlabCall* call, cudaStream_t stream) {
    SlabCall c = *call;
    if (c.G <= 0 || c.G > (long long)SLAB_CNT_MASK || c.RJ < 0 || c.k_sg < 0 || c.k_rr < 0 ||
        c.kq < 0 || c.ngf < 0 || c.nrf < 0 || c.ngf + c.nrf > SLAB_MAX_FIELDS || c.epoch <= 0 ||
        c.epoch > 0xffffffffll || c.k_sg > 0xffffffffll || c.k_rr > 0xffffffffll ||
        c.kq > 0xffffffffll || !c.ws ||
        (c.splice && (!c.gq_prev || !c.gq_out || c.stag < 1 || c.stag > 255)))
        return -1;
    for (int f = 0; f < c.ngf + c.nrf; ++f)
        if (c.f[f].rb <= 0) return -1;
    const long long marks = c.k_sg + c.k_rr + (c.splice ? 2 * c.kq : 0);
    if (marks > 0) {
        ARMADA_LAUNCH(slab_mark_kernel, (unsigned)((marks + 255) / 256), 256, stream)(c);
        ARMADA_CHECK();
    }
    const long long nsp = c.splice ? slab_tiles(c.G) : 0;
    if (nsp) {
        ARMADA_LAUNCH(slab_rank_kernel, (unsigned)nsp, SLAB_THREADS, stream)(c);
        ARMADA_CHECK();
    }
    // the functional copies: every touched field, K-E's batched copy
    CopyDesc d[SLAB_MAX_FIELDS];
    int nd = 0;
    for (int f = 0; f < c.ngf + c.nrf; ++f) {
        d[nd].src = c.f[f].src;
        d[nd].dst = c.f[f].dst;
        d[nd].bytes = c.f[f].rb * (f < c.ngf ? c.G : c.RJ);
        nd += d[nd].bytes > 0;
    }
    lanes_table(d, nd);
    const int rc = armada_lanes_copy(d, nd, stream);
    if (rc != 0) return rc;
    const long long items = (c.k_sg + c.k_rr) * c.ngf + c.k_rr * c.nrf;
    const long long blocks = nsp + (items + SLAB_THREADS - 1) / SLAB_THREADS;
    if (blocks > 0) {
        ARMADA_LAUNCH(slab_overlay_kernel, (unsigned)blocks, SLAB_THREADS, stream)(c);
        ARMADA_CHECK();
    }
    return 0;
}
