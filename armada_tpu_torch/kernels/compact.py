"""Wrappers of kernels K-C and K-F (csrc/compact.cu): the packed decode
buffer of one round, and of a stacked round's P lanes at once."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

_PTRS = ("g_state", "run_evicted", "run_rescheduled", "slot_gang", "slot_nodes",
         "slot_counts", "n_slots", "iterations", "termination", "sched_count",
         "spot_price", "kernel_iters", "real", "counts", "out")
_INTS = ("G", "RJ", "real_g", "real_r", "S", "W", "fcap", "ecap", "lanes")
_BLOCK = 1024


class CompactArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


def compact_result(result, num_real_gangs: int, num_real_runs: int, *, fcap: int, ecap: int):
    """K-C: i32 buffer of the round's decisions (layout in
    models/fair_scheduler.py compact_result).  CPU results run the plain
    version; CUDA results the kernel."""
    from armada_tpu_torch.models.fair_scheduler import compact_result_plain

    if not result.g_state.is_cuda:
        return compact_result_plain(result, num_real_gangs, num_real_runs, fcap=fcap, ecap=ecap)
    return _launch(result, 0, int(num_real_gangs), int(num_real_runs), None, fcap, ecap)


def compact_result_stacked_plain(result, real_gangs, real_runs, *, fcap: int, ecap: int):
    """The plain version of K-F: the solo plain compaction of each lane,
    stacked into [P, L]."""
    from armada_tpu_torch.models.fair_scheduler import RoundResult, compact_result_plain

    return torch.stack([
        compact_result_plain(RoundResult(*(t[i] for t in result)), int(g), int(r),
                             fcap=fcap, ecap=ecap)
        for i, (g, r) in enumerate(zip(real_gangs, real_runs))
    ])


def compact_result_stacked(result, real_gangs, real_runs, *, fcap: int, ecap: int):
    """K-F: one i32 [P, L] buffer holding each lane's K-C buffer in its row.
    `real_gangs` / `real_runs`: per-lane counts (sequences of P ints); on the
    card they go up as one i32 [P, 2] table from pinned memory, without
    waiting for the stream."""
    if not result.g_state.is_cuda:
        return compact_result_stacked_plain(result, real_gangs, real_runs, fcap=fcap, ecap=ecap)
    P = int(result.g_state.shape[0])
    if len(real_gangs) != P or len(real_runs) != P:
        raise ValueError(f"compact_result_stacked: expected {P} real-gang and real-run counts")
    host = torch.tensor([[int(g), int(r)] for g, r in zip(real_gangs, real_runs)],
                        dtype=torch.int32).pin_memory()
    real = host.to(result.g_state.device, non_blocking=True)
    return _launch(result, P, 0, 0, real, fcap, ecap)


def _launch(result, lanes: int, real_g: int, real_r: int, real, fcap: int, ecap: int):
    from armada_tpu_torch.models.fair_scheduler import compact_len

    i32 = torch.int32
    o = 1 if lanes else 0
    require_cuda(result.g_state, "g_state", i32, 1 + o)
    require_cuda(result.run_evicted, "run_evicted", torch.bool, 1 + o)
    require_cuda(result.run_rescheduled, "run_rescheduled", torch.bool, 1 + o)
    require_cuda(result.slot_gang, "slot_gang", i32, 1 + o)
    require_cuda(result.slot_nodes, "slot_nodes", i32, 2 + o)
    require_cuda(result.slot_counts, "slot_counts", i32, 2 + o)
    P = max(lanes, 1)
    for name in ("n_slots", "iterations", "termination", "scheduled_count", "kernel_iters"):
        t = getattr(result, name)
        require_cuda(t, name, i32)
        if t.numel() != P:
            raise ValueError(f"{name}: expected {P} value(s)")
    require_cuda(result.spot_price, "spot_price", torch.float32)
    if result.spot_price.numel() != P:
        raise ValueError(f"spot_price: expected {P} value(s)")
    G = int(result.g_state.shape[o])
    RJ = int(result.run_evicted.shape[o])
    S, W = (int(x) for x in result.slot_nodes.shape[o:])
    if fcap > G or ecap > RJ or fcap < 0 or ecap < 0:
        raise ValueError("compact_result: caps exceed the axes they index")
    if lanes and any(int(t.shape[0]) != P for t in result):
        raise ValueError(f"compact_result_stacked: every field needs a lane axis of {P}")
    dev = result.g_state.device
    nbG = max(1, -(-G // _BLOCK))
    nbR = max(1, -(-RJ // _BLOCK))
    L = compact_len(S, W, fcap, ecap)
    out = torch.empty(((P, L) if lanes else (L,)), dtype=i32, device=dev)
    counts = torch.empty((P * (nbG + 2 * nbR),), dtype=i32, device=dev)
    lib = library()
    if ctypes.sizeof(CompactArgs) != lib.armada_compact_args_size():
        raise RuntimeError("CompactArgs layout differs between Python and csrc/compact.cu")
    a = CompactArgs()
    src = dict(
        g_state=result.g_state, run_evicted=result.run_evicted,
        run_rescheduled=result.run_rescheduled, slot_gang=result.slot_gang,
        slot_nodes=result.slot_nodes, slot_counts=result.slot_counts,
        n_slots=result.n_slots, iterations=result.iterations,
        termination=result.termination, sched_count=result.scheduled_count,
        spot_price=result.spot_price, kernel_iters=result.kernel_iters,
        real=real, counts=counts, out=out,
    )
    for name in _PTRS:
        t = src[name]
        setattr(a, name, None if t is None else t.data_ptr())
    for name, v in zip(_INTS, (G, RJ, real_g, real_r, S, W, int(fcap), int(ecap), P)):
        setattr(a, name, v)
    check(lib.armada_compact(ctypes.byref(a), stream_handle()), "compact kernel")
    kernels.LAUNCHES["compact_stacked" if lanes else "compact"] += 1
    return out
