"""Wrappers of kernels K-B, K-D and K-K (csrc/round.cu, round_wide.cu,
round_cluster.cu): the scheduling round, solo, stacked over P pool lanes, or
sharded over a mesh's node shards, at every loop shape: the node-type bias,
prefer-large ordering, the multi-commit extension (K10) at any commit_k, and
K11 -- the per-key fit cache (any cache_slots; its tables, per lane,
allocated here), the certified pick chain at any batch_k, and unroll.  Up
to MAX_COMMIT_K and MAX_BATCH_K the extension's and the chain's tables live
in shared memory; wider ones run the wide instantiations, whose tables live
in scratch allocated here by the width (`wide_need`).

The placement loop runs as one thread-block cluster of S CTAs a lane, each
reducing its node passes over N / S nodes; the state buffers then hold S
replicas of the lanes, replica 0 the result.  `choose_cluster_size` is the
one owner of S: solo and stacked rounds take the S it picks from N, the
lanes, the loop shape and the card's cluster capacity (1, the single-CTA
form, for the wide instantiations and wherever no cluster fits);
parallel/serving.py clamps the serving mesh with it.  K-K (`mesh=` a
parallel.mesh.Mesh of S node shards, S >= 2) runs the solo round at the
mesh's S; the wide shapes raise there (ROADMAP Queue 2).

On the card the round is a sequence of launches on the current stream with
no host synchronisation: the prologue scatter and suffix sum, the fair
shares (kernel K-A), the eviction gate and move, gang activation (and,
for a cluster, the replicas' copy), the persistent placement loop, the key
sweep, phase B and the unbind.  The stacked round (K-D) is the same
sequence with a lane axis: one block (or cluster) per lane for the
persistent kernels.  CPU problems run the plain versions
(models/fair_scheduler.py)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle
from armada_tpu_torch.models.fair_scheduler import _INF, block_size

MAX_RESOURCES = 8
MAX_FIXPOINT_ITERS = 128
# csrc/round.cuh MAX_COMMIT_K and MAX_BATCH_K: the widest multi-commit and
# the longest pick chain whose tables the narrow instantiations hold in
# shared memory; wider ones run the wide instantiations
MAX_COMMIT_K = 16
MAX_BATCH_K = 16
# csrc/round.cuh MAX_CLUSTER: the widest cluster of the placement loop (16
# CTAs, a non-portable cluster size on Hopper)
MAX_CLUSTER = 16

_F32 = ("node_total", "run_req", "g_req", "g_price", "g_spot_price", "q_weight", "q_cds",
        "q_penalty", "total_pool", "drf_mult", "inv_scale", "round_cap", "pc_queue_cap",
        "protected_fraction", "node_axes", "float_total", "spot_cutoff", "type_bias")
_I32 = ("node_type", "run_node", "run_level", "run_queue", "run_pc", "run_gang", "g_card",
        "g_level", "g_queue", "g_key", "g_pc", "g_order", "g_run", "gq_gang", "q_start",
        "q_len", "global_burst", "perq_burst", "g_ban_row", "key_type_row")
_BOOL = ("node_ok", "run_preemptible", "run_valid", "g_valid", "g_absent", "compat",
         "market", "ban_mask", "compat_pre_type")

# Field order of struct RoundArgs in csrc/round.cu.
_PTR_FIELDS = (
    "node_total", "node_type", "node_ok", "run_req", "run_node", "run_level", "run_queue",
    "run_pc", "run_preemptible", "run_gang", "run_valid", "g_req", "g_card", "g_level",
    "g_key", "g_pc", "g_run", "g_valid", "g_absent", "g_price", "g_spot_price", "gq_gang",
    "q_start", "q_len", "q_weight", "q_penalty", "compat", "total_pool", "drf_mult",
    "inv_scale", "round_cap", "pc_queue_cap", "protected_fraction", "global_burst",
    "perq_burst", "node_axes", "float_total", "market", "spot_cutoff", "ban_mask",
    "g_ban_row", "fair_share", "dcafs", "used", "alloc", "q_alloc", "q_alloc_pc",
    "float_used", "sched_res", "spot_res", "spot_price", "run_evicted", "run_rescheduled",
    "pending", "g_state", "q_killed", "q_sched", "q_head", "live_q", "key_bad",
    "slot_gang", "slot_nodes", "slot_counts", "cap_c", "cap_l", "score_c", "score_l",
    "nmin", "rmin", "cost", "scal", "type_bias", "key_type_row", "g_queue", "okey", "q_nskip",
    "fitc_clean", "fitc_lvl", "cscore", "bmc_clean", "bmc_lvl", "cslot_key", "cslot_lvl",
    "cslot_req", "bk_m0", "bk_ml", "bk_fit0", "bk_fitl", "sim_keys", "simpos", "sim_row",
    "wide_i", "wide_f", "wide_b",
)
_INT_FIELDS = ("N", "R", "G", "Q", "RJ", "K", "T", "C", "P1", "S", "W", "max_iter", "BR",
               "P", "TR", "prefer_large", "commit_k", "CS", "CB", "batch_k", "unroll")
_LONG_FIELDS = ("WI", "WF", "WB")


class RoundArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTR_FIELDS] + [
        (n, ctypes.c_int) for n in _INT_FIELDS
    ] + [(n, ctypes.c_longlong) for n in _LONG_FIELDS]


# The last launch's [8, P] scalar block (slots 6 and 7: the fit cache's hits
# and misses per lane), for cache_stats.
_LAST = {}


def cache_stats() -> list:
    """[(hits, misses)] per lane of the last round launched, from the fit
    cache's counters (zeros when it ran uncached).  Synchronises."""
    scal = _LAST["scal"].cpu()
    return [(int(scal[6, i]), int(scal[7, i])) for i in range(scal.shape[1])]


# The owner's decisions by shape (choose_cluster_size with the card's
# capacity), and the last launch's cluster size.
_CLUSTER: dict = {}


def choose_cluster_size(N, lanes: int = 1, *, commit_k: int = 1, batch_k: int = 1,
                        prefer_large: bool = False, het: bool = False, cache_slots: int = 0,
                        device="cuda", capacity=None, sizes=None) -> int:
    """The cluster size S of the placement loop for a round of `lanes`
    lanes over N nodes at this loop shape: the one owner of the decision.
    The largest S in `sizes` (default MAX_CLUSTER down to 2) such that S
    divides N, N / S is a multiple of the fit cache's block (block_size(N))
    when the cache is armed, the shape has a cluster instantiation (the wide
    ones do not) and `lanes` clusters of S fit on the card at once
    (capacity(S) >= lanes); else 1, the single-CTA form, which the CPU
    always takes.  `capacity(S)` defaults to the card's
    (`cluster_capacity` at this loop shape); N None drops the two node
    rules (the serving mesh pads N to its S).  With the card's capacity
    the answer is cached by shape."""
    if torch.device(device).type != "cuda":
        return 1
    if commit_k > MAX_COMMIT_K or batch_k > MAX_BATCH_K:
        return 1
    key = None
    if capacity is None:
        key = (N, lanes, commit_k > 1, batch_k > 1, bool(prefer_large), bool(het),
               cache_slots > 0, None if sizes is None else tuple(sizes))
        hit = _CLUSTER.get(key)
        if hit is not None:
            return hit

        def capacity(s):
            return cluster_capacity(s, commit_k=commit_k, prefer_large=prefer_large,
                                    batch_k=batch_k, het=het)
    chosen = 1
    for s in (range(MAX_CLUSTER, 1, -1) if sizes is None else sizes):
        if not 2 <= s <= MAX_CLUSTER:
            continue
        if N is not None and (N % s or (cache_slots > 0 and (N // s) % block_size(N))):
            continue
        if capacity(s) >= lanes:
            chosen = s
            break
    if key is not None:
        _CLUSTER[key] = chosen
    return chosen


def last_cluster_size() -> int:
    """The cluster size S the last round launched ran at (1: one CTA a
    lane)."""
    return _LAST.get("shards", 1)


def _check_problem(p, lanes: int) -> None:
    for name in _F32:
        require_cuda(getattr(p, name), name, torch.float32)
    for name in _I32:
        require_cuda(getattr(p, name), name, torch.int32)
    for name in _BOOL:
        require_cuda(getattr(p, name), name, torch.bool)
    dev = p.g_req.device
    for name in p._fields:
        t = getattr(p, name)
        if t.device != dev:
            raise ValueError(f"{name}: lies on {t.device}, not {dev}")
        if lanes and (t.dim() == 0 or int(t.shape[0]) != lanes):
            raise ValueError(f"{name}: expected a leading axis of {lanes} lanes, got {tuple(t.shape)}")


def schedule_round(p, *, num_levels: int, max_slots: int, slot_width: int, max_iterations: int,
                   prefer_large: bool = False, commit_k: int = 1, cache_slots: int = 0,
                   batch_k: int = 1, unroll: int = 1, mesh=None):
    """K-B, or K-K when `mesh` has S >= 2 node shards: run the round on the
    problem's device: kernels for CUDA, the plain version for the CPU.  The
    statics are resolved ones (models/fair_scheduler.py round_statics).
    The sharded round's node axis must divide into the shards
    (parallel/mesh.py shard_problem pads it); sharding changes nothing it
    decides, so on the CPU it is the plain round."""
    from armada_tpu_torch.models.fair_scheduler import schedule_round_plain

    kw = dict(num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
              max_iterations=max_iterations, prefer_large=prefer_large, commit_k=commit_k,
              cache_slots=cache_slots, batch_k=batch_k, unroll=unroll)
    shards = 1 if mesh is None else int(mesh.node_shards)
    N = int(p.node_total.shape[0])
    if N % shards:
        raise ValueError(f"sharded round: the node axis {N} does not divide into {shards} "
                         "shards (parallel/mesh.py shard_problem pads it)")
    if not p.g_req.is_cuda:
        return schedule_round_plain(p, **kw)
    if mesh is None:
        shards = _owner_size(p, 1, kw)
    return _launch(p, 0, shards=shards, mesh=mesh is not None and shards > 1, **kw)


def _owner_size(p, lanes: int, kw: dict) -> int:
    o = 1 if p.q_weight.dim() == 2 else 0
    return choose_cluster_size(
        int(p.node_total.shape[o]), lanes, commit_k=kw["commit_k"], batch_k=kw["batch_k"],
        prefer_large=kw["prefer_large"], het=int(p.type_bias.shape[o]) > 1,
        cache_slots=kw["cache_slots"], device=p.g_req.device)


def schedule_round_stacked(p, *, num_levels: int, max_slots: int, slot_width: int,
                           max_iterations: int, prefer_large: bool = False, commit_k: int = 1,
                           cache_slots: int = 0, batch_k: int = 1, unroll: int = 1):
    """K-D: P pools' rounds as one launch sequence, every lane with the same
    statics (and its own fit cache).  Every field of `p` carries a leading
    lane axis of P; every field of the RoundResult does too.  CPU problems
    run the plain version (a loop over the lanes)."""
    from armada_tpu_torch.models.fair_scheduler import schedule_round_stacked_plain

    kw = dict(num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
              max_iterations=max_iterations, prefer_large=prefer_large, commit_k=commit_k,
              cache_slots=cache_slots, batch_k=batch_k, unroll=unroll)
    if not p.g_req.is_cuda:
        return schedule_round_stacked_plain(p, **kw)
    lanes = int(p.g_req.shape[0])
    return _launch(p, lanes, shards=_owner_size(p, lanes, kw), **kw)


def wide_need(commit_k: int, batch_k: int) -> tuple:
    """(ints, floats, bytes) of wide scratch a lane needs at these widths
    (csrc/round.cuh wide_need; zeros up to MAX_COMMIT_K and MAX_BATCH_K)."""
    out = (ctypes.c_longlong * 3)()
    library().armada_round_wide_need(int(commit_k), int(batch_k), out)
    return tuple(int(x) for x in out)


def wide_scratch(lanes: int, commit_k: int, batch_k: int, dev) -> tuple:
    """`wide_need` for `lanes` lanes, or a RuntimeError that names the bytes
    the tables need where the card has fewer free."""
    WI, WF, WB = wide_need(commit_k, batch_k)
    need = lanes * (4 * WI + 4 * WF + WB)
    free = torch.cuda.mem_get_info(dev)[0]
    if need > free:
        raise RuntimeError(
            f"round kernel: commit_k={commit_k}, batch_k={batch_k} needs {need} bytes of "
            f"scratch for its tables, the card has {free} free")
    return WI, WF, WB


def cluster_capacity(shards: int, *, commit_k: int = 1, prefer_large: bool = False,
                     batch_k: int = 1, het: bool = False) -> int:
    """How many clusters of `shards` CTAs of K-K's loop, at this loop shape,
    the card can hold at once (cudaOccupancyMaxActiveClusters): 0 when it
    cannot launch one.  The query reads only the loop shape's fields."""
    args = RoundArgs()
    args.commit_k, args.batch_k = int(commit_k), int(batch_k)
    args.prefer_large, args.TR = int(bool(prefer_large)), 2 if het else 1
    return int(library().armada_round_cluster_max(ctypes.byref(args), int(shards)))


def _launch(p, lanes: int, *, num_levels: int, max_slots: int, slot_width: int,
            max_iterations: int, prefer_large: bool, commit_k: int, cache_slots: int = 0,
            batch_k: int = 1, unroll: int = 1, shards: int = 1, mesh: bool = False):
    """The launch sequence; `lanes` = 0 for a solo round (no lane axis),
    else P; `shards` > 1 runs the placement loop as clusters of that many
    CTAs (`mesh`: K-K's, at a mesh's S; else the owner's choice)."""
    from armada_tpu_torch.models.fair_scheduler import RoundResult

    if int(commit_k) < 1:
        raise ValueError(f"round kernel: commit_k={commit_k} must be >= 1")
    if prefer_large and commit_k > 1:
        raise ValueError("round kernel: prefer_large runs at commit_k=1 (round_statics resolves it)")
    if int(batch_k) < 1:
        raise ValueError(f"round kernel: batch_k={batch_k} must be >= 1")
    if batch_k > 1 and (commit_k > 1 or prefer_large or cache_slots > 0):
        raise ValueError("round kernel: batch_k > 1 runs only at commit_k=1, without prefer_large "
                         "and without the fit cache (round_statics resolves it)")
    if int(cache_slots) < 0 or int(unroll) < 1:
        raise ValueError(f"round kernel: cache_slots={cache_slots} and unroll={unroll} must be "
                         f">= 0 and >= 1")
    wide = commit_k > MAX_COMMIT_K or batch_k > MAX_BATCH_K
    if shards > 1:
        if wide:
            raise ValueError(
                f"sharded round: commit_k={commit_k} / batch_k={batch_k} run the wide "
                f"instantiations, which K-K does not shard (above {MAX_COMMIT_K} / {MAX_BATCH_K}; "
                "ROADMAP Queue 2)")
    _check_problem(p, lanes)
    from armada_tpu_torch.kernels.fair_shares import fair_shares

    dev = p.g_req.device
    o = 1 if lanes else 0
    # state buffers: one per lane (K-D) of each replica (a cluster), or one
    lead = ((shards,) if shards > 1 else ()) + ((lanes,) if lanes else ())
    P = max(lanes, 1)
    N, R = (int(x) for x in p.node_total.shape[o:])
    G = int(p.g_req.shape[o])
    Q = int(p.q_weight.shape[o])
    RJ = int(p.run_req.shape[o])
    K, T = (int(x) for x in p.compat.shape[o:])
    C = int(p.pc_queue_cap.shape[o])
    BR = int(p.ban_mask.shape[o])
    P1, S, W = int(num_levels), int(max_slots), int(slot_width)
    if R > MAX_RESOURCES:
        raise ValueError(f"round kernel: at most {MAX_RESOURCES} resources, got {R}")
    TR = int(p.type_bias.shape[o])
    if tuple(p.type_bias.shape[o + 1:]) != (T,) or tuple(p.key_type_row.shape[o:]) != (K,):
        raise ValueError("round kernel: type_bias must be [TR, T] and key_type_row [K]")
    if min(N, G, Q, RJ, S, W) <= 0:
        raise ValueError("round kernel: every axis must be non-empty")
    if P > 65535:
        raise ValueError(f"round kernel: at most 65535 lanes, got {P}")
    if shards > 1 and cache_slots > 0 and (N // shards) % block_size(N):
        raise ValueError(
            f"sharded round: the fit cache's {block_size(N)}-node blocks must tile each shard of "
            f"{N // shards} nodes (ROADMAP Queue 2)")
    if mesh and cluster_capacity(shards, commit_k=commit_k, prefer_large=prefer_large,
                                 batch_k=batch_k, het=TR > 1) < 1:
        raise RuntimeError(f"sharded round: the card cannot launch a cluster of {shards} CTAs "
                           "of the round's loop (cudaOccupancyMaxActiveClusters is 0)")

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    st = dict(
        used=zeros((P1, N, R), f32),
        alloc=torch.empty(lead + (P1, N, R), dtype=f32, device=dev),
        q_alloc=zeros((Q, R), f32),
        q_alloc_pc=zeros((Q, C, R), f32),
        float_used=zeros((R,), f32),
        sched_res=zeros((R,), f32),
        spot_res=zeros((R,), f32),
        spot_price=torch.zeros((P * shards,), dtype=f32, device=dev),
        run_evicted=zeros((RJ,), b),
        run_rescheduled=zeros((RJ,), b),
        pending=zeros((RJ,), b),
        g_state=zeros((G,), i32),
        q_killed=zeros((Q,), b),
        q_sched=zeros((Q,), i32),
        q_head=zeros((Q,), i32),
        live_q=zeros((Q,), i32),
        key_bad=zeros((K,), b),
        slot_gang=zeros((S,), i32),
        slot_nodes=torch.full(lead + (S, W), N, dtype=i32, device=dev),
        slot_counts=zeros((S, W), i32),
        cap_c=zeros((N,), i32),
        cap_l=zeros((N,), i32),
        score_c=zeros((N,), f32),
        score_l=zeros((N,), f32),
        nmin=zeros((N,), i32),
        rmin=zeros((N,), i32),
        cost=zeros((RJ,), f32),
        okey=zeros((Q,), f32),
        q_nskip=zeros((Q,), i32),
        # [8, P]: slot k of every lane is the contiguous row scal[k]; the
        # cluster's replicas each hold their own [8, P]
        scal=torch.zeros((shards * 8, P), dtype=i32, device=dev),
    )
    # the fit cache's tables (empty slots: key -1, block minima +INF) and
    # the pick chain's scratch, per lane
    CS, CB = int(cache_slots), block_size(N)
    BN, BQ = (N, Q) if batch_k > 1 else (0, 0)
    st.update(
        fitc_clean=zeros((CS, N), torch.uint8),
        fitc_lvl=zeros((CS, N), torch.uint8),
        cscore=zeros((P1, N) if CS else (0,), f32),
        bmc_clean=torch.full(lead + (CS, N // CB), _INF, dtype=f32, device=dev),
        bmc_lvl=torch.full(lead + (CS, N // CB), _INF, dtype=f32, device=dev),
        cslot_key=torch.full(lead + (CS,), -1, dtype=i32, device=dev),
        cslot_lvl=zeros((CS,), i32),
        cslot_req=zeros((CS, R), f32),
        bk_m0=zeros((BN,), f32),
        bk_ml=zeros((BN,), f32),
        bk_fit0=zeros((BN,), torch.uint8),
        bk_fitl=zeros((BN,), torch.uint8),
        sim_keys=zeros((BQ,), f32),
        simpos=zeros((BQ,), i32),
        sim_row=zeros((BQ, R), f32),
    )
    # the wide instantiations' tables
    WI, WF, WB = wide_scratch(P, commit_k, batch_k, dev) if wide else (0, 0, 0)
    st.update(wide_i=zeros((WI,), i32), wide_f=zeros((WF,), f32), wide_b=zeros((WB,), torch.uint8))
    nodes_w = torch.full((P * shards, W), N, dtype=i32, device=dev)
    counts_w = torch.zeros((P * shards, W), dtype=i32, device=dev)
    lib = library()
    if ctypes.sizeof(RoundArgs) != lib.armada_round_args_size():
        raise RuntimeError("RoundArgs layout differs between Python and csrc/round.cu")
    args = RoundArgs()
    for name in _PTR_FIELDS:
        t = st.get(name)
        if t is None and name not in ("fair_share", "dcafs"):
            t = getattr(p, name)
        if t is not None:
            setattr(args, name, t.data_ptr())
    for name, v in zip(_INT_FIELDS, (N, R, G, Q, RJ, K, T, C, P1, S, W, int(max_iterations),
                                     BR, P, TR, int(bool(prefer_large)), int(commit_k), CS, CB,
                                     int(batch_k), int(unroll))):
        setattr(args, name, v)
    args.WI, args.WF, args.WB = WI, WF, WB
    stream = stream_handle()
    check(lib.armada_round_prologue(ctypes.byref(args), stream), "round prologue")
    fs, dcafs, _ = fair_shares(p.q_weight, p.q_cds)
    args.fair_share = fs.data_ptr()
    args.dcafs = dcafs.data_ptr()
    if shards > 1:
        check(
            lib.armada_round_sharded_main(ctypes.byref(args), shards, nodes_w.data_ptr(),
                                          counts_w.data_ptr(), MAX_FIXPOINT_ITERS, stream),
            f"round kernels (clusters of {shards} CTAs)",
        )
        # replica 0 is the round's state (spot_price is [S P], scal [8 S, P])
        st = {k: v if k in ("spot_price", "scal") else v[0] for k, v in st.items()}
        st["scal"] = st["scal"][:8]
    else:
        check(
            lib.armada_round_main(ctypes.byref(args), nodes_w.data_ptr(), counts_w.data_ptr(),
                                  MAX_FIXPOINT_ITERS, stream),
            "round kernels",
        )
    if mesh:
        kernels.LAUNCHES["round_sharded"] += 1
    else:
        kernels.LAUNCHES["round_stacked" if lanes else "round"] += 1
        if shards > 1:
            kernels.LAUNCHES["round_clustered"] += 1
    _LAST["scal"] = st["scal"]
    _LAST["shards"] = shards
    if commit_k > 1:
        kernels.LAUNCHES["round_multi_commit"] += 1
    if CS > 0:
        kernels.LAUNCHES["round_fit_cache"] += 1
    if batch_k > 1:
        kernels.LAUNCHES["round_batch_k"] += 1
    scal = st["scal"] if lanes else st["scal"][:, 0]
    spot = st["spot_price"][:P] if lanes else st["spot_price"][0]
    return RoundResult(
        g_state=st["g_state"],
        slot_gang=st["slot_gang"],
        slot_nodes=st["slot_nodes"],
        slot_counts=st["slot_counts"],
        n_slots=scal[0],
        run_evicted=st["run_evicted"],
        run_rescheduled=st["run_rescheduled"],
        alloc=st["alloc"],
        q_alloc=st["q_alloc"],
        iterations=scal[1],
        termination=scal[2],
        scheduled_count=scal[3],
        spot_price=spot,
        q_killed=st["q_killed"],
        kernel_iters=scal[5],
    )
