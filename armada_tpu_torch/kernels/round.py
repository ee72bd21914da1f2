"""Wrapper of kernel K-B (csrc/round.cu): the scheduling round.

On the card the round is a sequence of launches on the current stream with
no host synchronisation: the prologue scatter and suffix sum, the fair
shares (kernel K-A), the eviction gate and move, gang activation, the
persistent single-block placement loop, the key sweep, phase B and the
unbind.  CPU problems run the plain version (models/fair_scheduler.py)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

MAX_RESOURCES = 8
MAX_FIXPOINT_ITERS = 128

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
    "nmin", "rmin", "cost", "scal",
)
_INT_FIELDS = ("N", "R", "G", "Q", "RJ", "K", "T", "C", "P1", "S", "W", "max_iter")


class RoundArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTR_FIELDS] + [
        (n, ctypes.c_int) for n in _INT_FIELDS
    ]


def _check_problem(p) -> None:
    for name in _F32:
        require_cuda(getattr(p, name), name, torch.float32)
    for name in _I32:
        require_cuda(getattr(p, name), name, torch.int32)
    for name in _BOOL:
        require_cuda(getattr(p, name), name, torch.bool)
    dev = p.g_req.device
    for name in p._fields:
        if getattr(p, name).device != dev:
            raise ValueError(f"{name}: lies on {getattr(p, name).device}, not {dev}")


def schedule_round(p, *, num_levels: int, max_slots: int, slot_width: int, max_iterations: int):
    """Run the round on the problem's device: kernels for CUDA, the plain
    version for the CPU."""
    from armada_tpu_torch.models.fair_scheduler import RoundResult, schedule_round_plain

    if not p.g_req.is_cuda:
        return schedule_round_plain(
            p, num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
            max_iterations=max_iterations,
        )
    _check_problem(p)
    from armada_tpu_torch.kernels.fair_shares import fair_shares

    dev = p.g_req.device
    N, R = (int(x) for x in p.node_total.shape)
    G = int(p.g_req.shape[0])
    Q = int(p.q_weight.shape[0])
    RJ = int(p.run_req.shape[0])
    K, T = (int(x) for x in p.compat.shape)
    C = int(p.pc_queue_cap.shape[0])
    P1, S, W = int(num_levels), int(max_slots), int(slot_width)
    if R > MAX_RESOURCES:
        raise ValueError(f"round kernel: at most {MAX_RESOURCES} resources, got {R}")
    if int(p.type_bias.shape[0]) > 1:
        raise NotImplementedError("hetero type bias (TR > 1) is not ported yet")
    if min(N, G, Q, RJ, S, W) <= 0:
        raise ValueError("round kernel: every axis must be non-empty")

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    st = dict(
        used=zeros((P1, N, R), f32),
        alloc=torch.empty((P1, N, R), dtype=f32, device=dev),
        q_alloc=zeros((Q, R), f32),
        q_alloc_pc=zeros((Q, C, R), f32),
        float_used=zeros((R,), f32),
        sched_res=zeros((R,), f32),
        spot_res=zeros((R,), f32),
        spot_price=zeros((1,), f32),
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
        slot_nodes=torch.full((S, W), N, dtype=i32, device=dev),
        slot_counts=zeros((S, W), i32),
        cap_c=zeros((N,), i32),
        cap_l=zeros((N,), i32),
        score_c=zeros((N,), f32),
        score_l=zeros((N,), f32),
        nmin=zeros((N,), i32),
        rmin=zeros((N,), i32),
        cost=zeros((RJ,), f32),
        scal=zeros((8,), i32),
    )
    nodes_w = torch.full((W,), N, dtype=i32, device=dev)
    counts_w = zeros((W,), i32)
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
    for name, v in zip(_INT_FIELDS, (N, R, G, Q, RJ, K, T, C, P1, S, W, int(max_iterations))):
        setattr(args, name, v)
    stream = stream_handle()
    check(lib.armada_round_prologue(ctypes.byref(args), stream), "round prologue")
    fs, dcafs, _ = fair_shares(p.q_weight, p.q_cds)
    args.fair_share = fs.data_ptr()
    args.dcafs = dcafs.data_ptr()
    check(
        lib.armada_round_main(ctypes.byref(args), nodes_w.data_ptr(), counts_w.data_ptr(),
                              MAX_FIXPOINT_ITERS, stream),
        "round kernels",
    )
    kernels.LAUNCHES["round"] += 1
    scal = st["scal"]
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
        spot_price=st["spot_price"][0],
        q_killed=st["q_killed"],
        kernel_iters=scal[5],
    )
