"""Wrapper of kernel K-C (csrc/compact.cu): the packed decode buffer."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

_PTRS = ("g_state", "run_evicted", "run_rescheduled", "slot_gang", "slot_nodes",
         "slot_counts", "n_slots", "iterations", "termination", "sched_count",
         "spot_price", "kernel_iters", "counts", "out")
_INTS = ("G", "RJ", "real_g", "real_r", "S", "W", "fcap", "ecap")
_BLOCK = 1024


class CompactArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


def compact_result(result, num_real_gangs: int, num_real_runs: int, *, fcap: int, ecap: int):
    """i32 buffer of the round's decisions (layout in
    models/fair_scheduler.py compact_result).  CPU results run the plain
    version; CUDA results the kernel."""
    from armada_tpu_torch.models.fair_scheduler import compact_len, compact_result_plain

    if not result.g_state.is_cuda:
        return compact_result_plain(result, num_real_gangs, num_real_runs, fcap=fcap, ecap=ecap)
    i32 = torch.int32
    require_cuda(result.g_state, "g_state", i32, 1)
    require_cuda(result.run_evicted, "run_evicted", torch.bool, 1)
    require_cuda(result.run_rescheduled, "run_rescheduled", torch.bool, 1)
    require_cuda(result.slot_gang, "slot_gang", i32, 1)
    require_cuda(result.slot_nodes, "slot_nodes", i32, 2)
    require_cuda(result.slot_counts, "slot_counts", i32, 2)
    for name in ("n_slots", "iterations", "termination", "scheduled_count", "kernel_iters"):
        t = getattr(result, name)
        require_cuda(t, name, i32)
        if t.numel() != 1:
            raise ValueError(f"{name}: expected a scalar")
    require_cuda(result.spot_price, "spot_price", torch.float32)
    G = int(result.g_state.shape[0])
    RJ = int(result.run_evicted.shape[0])
    S, W = (int(x) for x in result.slot_nodes.shape)
    if fcap > G or ecap > RJ or fcap < 0 or ecap < 0:
        raise ValueError("compact_result: caps exceed the axes they index")
    dev = result.g_state.device
    nbG = max(1, -(-G // _BLOCK))
    nbR = max(1, -(-RJ // _BLOCK))
    out = torch.empty((compact_len(S, W, fcap, ecap),), dtype=i32, device=dev)
    counts = torch.empty((nbG + 2 * nbR,), dtype=i32, device=dev)
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
        counts=counts, out=out,
    )
    for name in _PTRS:
        setattr(a, name, src[name].data_ptr())
    for name, v in zip(_INTS, (G, RJ, int(num_real_gangs), int(num_real_runs), S, W,
                               int(fcap), int(ecap))):
        setattr(a, name, v)
    check(lib.armada_compact(ctypes.byref(a), stream_handle()), "compact kernel")
    kernels.LAUNCHES["compact"] += 1
    return out
