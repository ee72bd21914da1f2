"""Wrapper of kernel K-I (csrc/verify.cu): round verification.  CPU inputs
run the plain version (models/verify.py verify_kernel_plain)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

_PTRS = ("node_total", "node_ok", "node_axes", "run_req", "run_node", "run_queue",
         "run_valid", "g_req", "g_card", "g_queue", "g_run", "g_state", "slot_gang",
         "slot_nodes", "slot_counts", "n_slots", "run_evicted", "run_rescheduled", "alloc0",
         "q_alloc", "sched_count", "compact", "used", "expq", "occ", "acc", "out")
_INTS = ("N", "R", "RJ", "G", "Q", "S", "W", "L", "real_g")
_DTYPES = dict(
    node_total=torch.float32, node_ok=torch.bool, node_axes=torch.float32,
    run_req=torch.float32, run_node=torch.int32, run_queue=torch.int32, run_valid=torch.bool,
    g_req=torch.float32, g_card=torch.int32, g_queue=torch.int32, g_run=torch.int32,
    g_state=torch.int32, slot_gang=torch.int32, slot_nodes=torch.int32,
    slot_counts=torch.int32, n_slots=torch.int32, run_evicted=torch.bool,
    run_rescheduled=torch.bool, alloc0=torch.float32, q_alloc=torch.float32,
    sched_count=torch.int32, compact=torch.int32,
)


class VerifyArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


def verify_round(node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid,
                 g_req, g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts,
                 n_slots, run_evicted, run_rescheduled, alloc0, q_alloc, scheduled_count,
                 compact_buf, num_real_gangs: int) -> torch.Tensor:
    """i32[16] verification buffer (layout in models/verify.py).  CPU inputs
    run the plain version; CUDA inputs the kernel."""
    args = (node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid, g_req,
            g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts, n_slots,
            run_evicted, run_rescheduled, alloc0, q_alloc, scheduled_count, compact_buf)
    if not g_state.is_cuda:
        from armada_tpu_torch.models.verify import verify_kernel_plain

        return verify_kernel_plain(*args, num_real_gangs)
    src = dict(zip(_PTRS, args))
    for name, dt in _DTYPES.items():
        require_cuda(src[name], name, dt)
    N, R = (int(x) for x in node_total.shape)
    G = int(g_state.shape[0])
    RJ = int(run_req.shape[0])
    Q = int(q_alloc.shape[0])
    S, W = (int(x) for x in slot_nodes.shape)
    if (tuple(alloc0.shape) != (N, R) or tuple(g_req.shape) != (G, R)
            or tuple(q_alloc.shape) != (Q, R) or tuple(slot_counts.shape) != (S, W)
            or int(slot_gang.shape[0]) != S or n_slots.numel() != 1
            or scheduled_count.numel() != 1 or compact_buf.dim() != 1):
        raise ValueError("verify_round: inputs disagree in shape")
    dev = g_state.device
    src["used"] = torch.empty((N, R), dtype=torch.float32, device=dev)
    src["expq"] = torch.empty((Q, R), dtype=torch.float32, device=dev)
    src["occ"] = torch.empty((G,), dtype=torch.int32, device=dev)
    src["acc"] = torch.empty((16,), dtype=torch.int32, device=dev)
    src["out"] = torch.empty((16,), dtype=torch.int32, device=dev)
    lib = library()
    if ctypes.sizeof(VerifyArgs) != lib.armada_verify_args_size():
        raise RuntimeError("VerifyArgs layout differs between Python and csrc/verify.cu")
    a = VerifyArgs()
    for name in _PTRS:
        setattr(a, name, src[name].data_ptr())
    for name, v in zip(_INTS, (N, R, RJ, G, Q, S, W, int(compact_buf.shape[0]),
                               int(num_real_gangs))):
        setattr(a, name, v)
    check(lib.armada_verify(ctypes.byref(a), stream_handle()), "verify kernel")
    kernels.LAUNCHES["verify"] += 1
    return src["out"]
