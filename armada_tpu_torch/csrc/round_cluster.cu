// K-K: the node-axis sharded round's placement loop as one thread-block
// cluster (round.cuh place_loop_kernel, CL).
//
// Replaces the JAX package's parallel/mesh.py `_sharded_round` (:253): the
// whole `schedule_round` SPMD over S node shards, where GSPMD inserts a
// cross-shard (value, index) reduction for every [N] argmin and sum.  On one
// H100 the counterpart of shards that exchange a reduction every step is a
// cluster: S CTAs on S SMs of one GPC, each owning N / S nodes, their
// partials meeting in distributed shared memory.  Every loop shape of the
// narrow solo loop runs sharded (the node-type bias, prefer-large, K10, the
// fit cache -- whose blocks must tile each shard -- the pick chain and
// unroll); the wide instantiations do not (the wrapper raises).  Plain
// version: the padded problem through `schedule_round_plain`, since sharding
// changes nothing the round decides (parallel/mesh.py `sharded_schedule_round`).
//
// What bounds it on this card.  The uncached solo loop spends most of a step
// in its node pass on one SM (the fit, capacity and score of every node, a
// few hundred instructions each); S CTAs cut that pass to N / S nodes each.
// The queue side (the cursor window, the queue pick, thread 0's commit) runs
// in every CTA at the solo cost, and each node pass adds one cluster barrier
// and S distributed-shared-memory reads.
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

static void cluster_config(const RoundArgs& a, int S, PlaceLoop k, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
    // more than 8 CTAs a cluster is a non-portable size on Hopper
    if (S > 8) cudaFuncSetAttribute((const void*)k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(S, 1, 1);
    cfg->blockDim = dim3(place_loop_block(a), 1, 1);
    cfg->dynamicSmemBytes = 0;
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
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(a, S, k, stream, &cfg, &attr);
    cudaError_t e = cudaLaunchKernelEx(&cfg, k, a, nodes_w, counts_w);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int place_loop_cluster_max(const RoundArgs& a, int S) {
    const PlaceLoop k = cluster_kernel(a);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(a, S, k, nullptr, &cfg, &attr);
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();  // a refused size is an answer, not a sticky error
        return 0;
    }
    return n;
}
