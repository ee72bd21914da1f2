// K-H: the slab delta apply -- scatter one cycle's dirty rows into the
// device-resident scheduling problem.
//
// Replaces the JAX package's armada_tpu/models/slab.py `apply_delta` (the
// jitted scatter program of _make_apply).  Plain version:
// armada_tpu_torch/models/slab.py `apply_delta_plain`.
//
// Semantics kept from the JAX program: the apply is functional.  Every field
// the bundle touches is first copied (device to device) into a fresh buffer
// the wrapper allocated, and the scatters write only into those copies, so
// the tensors a dispatched round, its verify and explain passes or a
// rollback re-run still read are never written.  Index entries follow JAX's
// mode="drop" rule: negative indices count from the end, others outside the
// axis are dropped (the bucket padding carries the sentinel G or RJ); the
// evictee group maps run sentinels to G explicitly (slab.py:299).
//
// Bound on this card: the dirty rows -- each row read once from the bundle
// and written once (a few hundred KB at the reference scale's 1,000-job
// cycle) -- plus the splice's passes over the [G] i32 order vector (read
// once, written once: ~9 MB at G ~ 1.1M), so a few microseconds of HBM time.
// The whole-field copies that keep the apply functional are extra traffic
// (~60 MB for the gang-axis fields at G ~ 1.1M); the simple design pays them.
// Design: one thread per (dirty row, field) for the row scatters, three
// launches (gang rows, run rows, evictee rows) in the JAX program's order;
// the splice is K-C's count / scan / scatter compaction (csrc/scan.cuh): a
// rank of the kept previous entries, a rank of the unoccupied final
// positions, a gather, and the inserted pairs.

#include "scan.cuh"

#define SLAB_MAX_FIELDS 16
#define SLAB_MAX_COPIES 48

struct SlabField {
    void* dst;          // the field's fresh buffer (already holding the copy)
    const void* rows;   // [k, row_bytes] update rows
    long long dst_rows; // length of the field's leading axis
    int row_bytes;
    int pad_;
};

struct SlabGroup {
    const int* idx;  // [k] dirty slots
    int k;
    int nf;
    int ev;          // 1: evictee projection (idx >= run_limit -> G, else idx + ev_base)
    int run_limit;   // RJ
    int ev_base;
    int gang_axis;   // G
    SlabField f[SLAB_MAX_FIELDS];
};

struct SlabCopy {
    void* dst;
    const void* src;
    long long nbytes;
};

struct SlabArgs {
    SlabCopy copies[SLAB_MAX_COPIES];
    SlabGroup groups[3];
    int ncopies;
    int ngroups;
};

__global__ void slab_scatter_kernel(const SlabGroup g) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int fi = blockIdx.y;
    if (i >= g.k || fi >= g.nf) return;
    const SlabField& f = g.f[fi];
    long long t = g.idx[i];
    if (g.ev) t = t >= g.run_limit ? (long long)g.gang_axis : t + g.ev_base;
    t = jax_index(t, f.dst_rows);
    if (t < 0) return;
    const int rb = f.row_bytes;
    if ((rb & 3) == 0) {
        const int* src = (const int*)((const char*)f.rows + (long long)i * rb);
        int* dst = (int*)((char*)f.dst + t * rb);
        for (int w = 0; w < (rb >> 2); ++w) dst[w] = src[w];
    } else {
        const u8* src = (const u8*)f.rows + (long long)i * rb;
        u8* dst = (u8*)f.dst + t * rb;
        for (int b = 0; b < rb; ++b) dst[b] = src[b];
    }
}

// Copy each touched field into its fresh buffer, then scatter the groups in
// order.  Each launch takes its group descriptor by value (a few hundred
// bytes of kernel parameters), so nothing is staged through host memory and
// the host never waits for the stream: the apply can be enqueued while a
// round still runs.
extern "C" int armada_slab_scatter(const SlabArgs* args, cudaStream_t stream) {
    const SlabArgs& a = *args;
    if (a.ncopies < 0 || a.ncopies > SLAB_MAX_COPIES || a.ngroups < 0 || a.ngroups > 3) return -1;
    for (int c = 0; c < a.ncopies; ++c) {
        if (a.copies[c].nbytes > 0) {
            cudaMemcpyAsync(a.copies[c].dst, a.copies[c].src, (size_t)a.copies[c].nbytes,
                            cudaMemcpyDeviceToDevice, stream);
            ARMADA_CHECK();
        }
    }
    for (int gi = 0; gi < a.ngroups; ++gi) {
        const SlabGroup& g = a.groups[gi];
        if (g.nf < 0 || g.nf > SLAB_MAX_FIELDS) return -2;
        if (g.k <= 0 || g.nf == 0) continue;
        dim3 grid((g.k + 255) / 256, g.nf);
        ARMADA_LAUNCH(slab_scatter_kernel, grid, 256, stream)(g);
        ARMADA_CHECK();
    }
    return 0;
}

struct SpliceArgs {
    const int* gq_prev;  // [G]
    const int* rem_pos;  // [kq]
    const int* ins_pos;  // [kq]
    const int* ins_val;  // [kq]
    int* out;            // [G] the new order vector
    u8* removed;         // [G] scratch
    u8* occupied;        // [G] scratch
    int* kept_buf;       // [G] scratch
    int* counts;         // [2 * nb] scratch
    int G;
    int kq;
};

__global__ void splice_mark_kernel(SpliceArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.kq) return;
    const long long r = jax_index(a.rem_pos[i], a.G);
    if (r >= 0) a.removed[r] = 1;
    const long long s = jax_index(a.ins_pos[i], a.G);
    if (s >= 0) a.occupied[s] = 1;
}

// out[p] = 0 at an inserted position, else the next kept previous entry:
// kept_buf[number of unoccupied positions before p].
__global__ void __launch_bounds__(SCAN_BLOCK) splice_gather_kernel(SpliceArgs a,
                                                                   const int* unocc_off) {
    __shared__ int warp_tot[SCAN_BLOCK / 32];
    const long long p = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
    const bool unocc = p < a.G && !a.occupied[p];
    const int rank = unocc_off[blockIdx.x] + block_rank(unocc, warp_tot);
    if (p < a.G) a.out[p] = unocc ? a.kept_buf[rank] : 0;
}

__global__ void splice_insert_kernel(SpliceArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.kq) return;
    const long long s = jax_index(a.ins_pos[i], a.G);
    if (s >= 0) a.out[s] = a.ins_val[i];
}

extern "C" int armada_slab_splice(const SpliceArgs* args, cudaStream_t stream) {
    SpliceArgs a = *args;
    if (a.G <= 0) return -1;
    const int nb = scan_blocks(a.G);
    cudaMemsetAsync(a.removed, 0, (size_t)a.G, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.occupied, 0, (size_t)a.G, stream);
    ARMADA_CHECK();
    cudaMemsetAsync(a.kept_buf, 0, sizeof(int) * (size_t)a.G, stream);
    ARMADA_CHECK();
    if (a.kq > 0) {
        ARMADA_LAUNCH(splice_mark_kernel, (a.kq + 255) / 256, 256, stream)(a);
        ARMADA_CHECK();
    }
    int* kept_off = a.counts;
    int* unocc_off = a.counts + nb;
    const U8Flag kept{a.removed, a.G, 0}, unocc{a.occupied, a.G, 0};
    ARMADA_LAUNCH(scan_count_kernel, nb, SCAN_BLOCK, stream)(kept, kept_off, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_count_kernel, nb, SCAN_BLOCK, stream)(unocc, unocc_off, 0);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_offsets_kernel, 1, 32, stream)(kept_off, nb, nullptr);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_offsets_kernel, 1, 32, stream)(unocc_off, nb, nullptr);
    ARMADA_CHECK();
    ARMADA_LAUNCH(scan_value_kernel, nb, SCAN_BLOCK, stream)(kept, kept_off, a.gq_prev,
                                                             a.kept_buf);
    ARMADA_CHECK();
    ARMADA_LAUNCH(splice_gather_kernel, nb, SCAN_BLOCK, stream)(a, unocc_off);
    ARMADA_CHECK();
    if (a.kq > 0) {
        ARMADA_LAUNCH(splice_insert_kernel, (a.kq + 255) / 256, 256, stream)(a);
        ARMADA_CHECK();
    }
    return 0;
}

extern "C" int armada_slab_args_size(void) { return (int)sizeof(SlabArgs); }
extern "C" int armada_slab_group_size(void) { return (int)sizeof(SlabGroup); }
extern "C" int armada_splice_args_size(void) { return (int)sizeof(SpliceArgs); }
