"""The hand-written CUDA kernels of the port and their wrappers.

Each wrapper takes tensors on one device: on a CUDA device it launches its
kernel (built from ../csrc at first use, see build.py) or raises; on the CPU
it runs the kernel's plain PyTorch version.  There is no fallback from the
kernel to the plain version.

LAUNCHES counts kernel launches per kernel, incremented only where a wrapper
launches its kernel, so a run can show that its path went through them.
"round_multi_commit" counts the round launches (solo or stacked) that run
the multi-commit extension, commit_k > 1; "round_fit_cache" and
"round_batch_k" those that run the per-key fit cache (cache_slots > 0) and
the certified pick chain (batch_k > 1).  "round_sharded" counts K-K, the
round whose placement loop runs as a cluster over a mesh's node shards;
"round_clustered" the solo and stacked rounds (counted under "round" and
"round_stacked" too) whose loop ran as clusters of the size
kernels/round.py `choose_cluster_size` picked; and
"slab_sharded" K-H's launches by a mesh cache (parallel/mesh_slab.py, the
counterpart of K-L).
"""

LAUNCHES = {
    "fair_shares": 0, "round": 0, "compact": 0, "slab": 0, "verify": 0, "explain": 0,
    "round_stacked": 0, "stack": 0, "compact_stacked": 0, "lane_slice": 0, "verify_stacked": 0,
    "round_multi_commit": 0, "round_fit_cache": 0, "round_batch_k": 0,
    "round_sharded": 0, "slab_sharded": 0, "round_clustered": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
