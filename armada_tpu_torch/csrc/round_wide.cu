// The placement loop's wide instantiations (round.cuh place_loop_kernel,
// WIDE): the multi-commit extension at commit_k > MAX_COMMIT_K and the pick
// chain at batch_k > MAX_BATCH_K, their per-pick and [E x E] tables in
// global scratch that the wrapper allocates by the resolved width
// (armada_tpu_torch/kernels/round.py).  Solo and stacked, as the narrow ones.
// Compiled on its own so that the build runs it beside round.cu.
#include "round.cuh"

int launch_place_loop_wide(const RoundArgs& a, dim3 grid, int* nodes_w, int* counts_w,
                           cudaStream_t stream) {
    const bool het = a.TR > 1;
    PlaceLoop k;
    if (a.commit_k > MAX_COMMIT_K)
        k = het ? place_loop_kernel<true, false, true, false, true, false>
                : place_loop_kernel<true, false, false, false, true, false>;
    else
        k = het ? place_loop_kernel<false, false, true, true, true, false>
                : place_loop_kernel<false, false, false, true, true, false>;
    int err = 0;
    const int hot = hot_bytes(a, (const void*)k, &err);
    if (err) return err;
    ARMADA_LAUNCH_SMEM(k, grid, place_loop_block(a), hot, stream)(a, nodes_w, counts_w, hot > 0);
    return (int)cudaGetLastError();
}

#ifdef ROUND_STEP_PROFILE
int round_prof_fetch_wide(long long* out) { return round_prof_fetch(out); }
#endif
