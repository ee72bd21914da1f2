// The placement loop as one thread-block cluster of S CTAs a lane
// (round.cuh place_loop_kernel, CL): K-B's and K-D's loop wherever the
// wrapper's owner of the cluster size (kernels/round.py
// `choose_cluster_size`) picks S >= 2, and K-K, the node-axis sharded round,
// at its mesh's S.
//
// Replaces the JAX package's parallel/mesh.py `_sharded_round` (:253): the
// whole `schedule_round` SPMD over S node shards, where GSPMD inserts a
// cross-shard (value, index) reduction for every [N] argmin and sum.  On one
// H100 the counterpart of shards that exchange a reduction every step is a
// cluster: S CTAs on S SMs of one GPC, each owning N / S nodes, their
// partials meeting in distributed shared memory.  Every loop shape of the
// narrow loop runs sharded, solo and stacked (the node-type bias,
// prefer-large, K10, the fit cache -- whose blocks must tile each shard --
// the pick chain and unroll); the wide instantiations do not (the owner
// picks S = 1 for them, a mesh raises).  Plain
// version: the padded problem through `schedule_round_plain`, since sharding
// changes nothing the round decides (parallel/mesh.py `sharded_schedule_round`).
//
// What bounds it on this card.  On one SM a step spends most of its time in
// the node pass (the fit and score of every node); S CTAs cut that pass to
// N / S nodes each.  The queue side (the window walk, the pick, warp 0's
// gate and commit) runs in every CTA at the solo cost, and each node pass
// adds one cluster barrier and S distributed-shared-memory reads (on an
// H100 80GB HBM3 at 700 W, the main world at S = 16: a step of ~13.5 us,
// ~1.3 of it the exchange; PERF.md §5).
#include "round.cuh"

// The cluster instantiation for the round's loop shape.
static PlaceLoop cluster_kernel(const RoundArgs& a) {
    const bool het = a.TR > 1;
    if (a.commit_k > 1)
        return het ? place_loop_kernel<true, false, true, false, false, true>
                   : place_loop_kernel<true, false, false, false, false, true>;
    if (a.prefer_large)
        return het ? place_loop_kernel<false, true, true, false, false, true>
                   : place_loop_kernel<false, true, false, false, false, true>;
    if (a.batch_k > 1)
        return het ? place_loop_kernel<false, false, true, true, false, true>
                   : place_loop_kernel<false, false, false, true, false, true>;
    return het ? place_loop_kernel<false, false, true, false, false, true>
               : place_loop_kernel<false, false, false, false, false, true>;
}

static void cluster_config(const RoundArgs& a, int S, PlaceLoop k, int smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
    // more than 8 CTAs a cluster is a non-portable size on Hopper
    if (S > 8) cudaFuncSetAttribute((const void*)k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(S, a.P > 1 ? a.P : 1, 1);
    cfg->blockDim = dim3(place_loop_block(a), 1, 1);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = S;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
}

int launch_place_loop_cluster(const RoundArgs& a, int S, int* nodes_w, int* counts_w,
                              cudaStream_t stream) {
    const PlaceLoop k = cluster_kernel(a);
    int err = 0;
    const int hot = hot_bytes(a, (const void*)k, &err);
    if (err) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(a, S, k, hot, stream, &cfg, &attr);
    cudaError_t e = cudaLaunchKernelEx(&cfg, k, a, nodes_w, counts_w, (int)(hot > 0));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int place_loop_cluster_max(const RoundArgs& a, int S) {
    const PlaceLoop k = cluster_kernel(a);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(a, S, k, 0, nullptr, &cfg, &attr);
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();  // a refused size is an answer, not a sticky error
        return 0;
    }
    return n;
}

#ifdef ROUND_STEP_PROFILE
int round_prof_fetch_cluster(long long* out) { return round_prof_fetch(out); }
#endif
