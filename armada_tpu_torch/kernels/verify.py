"""Wrappers of kernel K-I (csrc/verify.cu): round verification, solo or
over a stacked round's P lanes.  CPU inputs run the plain versions
(models/verify.py verify_kernel_plain, and a loop of it over the lanes)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

_PTRS = ("node_total", "node_ok", "node_axes", "run_req", "run_node", "run_queue",
         "run_valid", "g_req", "g_card", "g_queue", "g_run", "g_state", "slot_gang",
         "slot_nodes", "slot_counts", "n_slots", "run_evicted", "run_rescheduled", "alloc0",
         "q_alloc", "sched_count", "compact", "used", "expq", "occ", "acc", "out")
_INTS = ("N", "R", "RJ", "G", "Q", "S", "W", "L", "real_g", "lanes")
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
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS + ("real_lanes",)]
                + [("alloc0_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in _INTS])


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
    return _launch(dict(zip(_PTRS, args)), 0, int(num_real_gangs), None, 0)


def verify_round_stacked_plain(args: tuple, real_gangs) -> torch.Tensor:
    """The plain version of the stacked K-I: verify_kernel_plain on each
    lane, stacked into [P, 16].  `args` are verify_round's first 22
    arguments with a leading lane axis (alloc0 [P, N, R])."""
    from armada_tpu_torch.models.verify import verify_kernel_plain

    return torch.stack([
        verify_kernel_plain(*(t[i] for t in args), int(g)) for i, g in enumerate(real_gangs)
    ])


def verify_round_stacked(node_total, node_ok, node_axes, run_req, run_node, run_queue,
                         run_valid, g_req, g_card, g_queue, g_run, g_state, slot_gang,
                         slot_nodes, slot_counts, n_slots, run_evicted, run_rescheduled,
                         alloc, q_alloc, scheduled_count, compact_buf,
                         real_gangs) -> torch.Tensor:
    """The stacked K-I: i32 [P, 16], row l verifying lane l of a stacked
    round against row l of the stacked [P, L] compact buffer.  `alloc` is
    the stacked result's full [P, P1, N, R] allocatable (level 0 is read);
    `real_gangs` the per-lane real gang counts (P ints, uploaded as one
    i32 [P] table from pinned memory without waiting for the stream)."""
    if not g_state.is_cuda:
        args = (node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid, g_req,
                g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts, n_slots,
                run_evicted, run_rescheduled, alloc[:, 0], q_alloc, scheduled_count,
                compact_buf)
        return verify_round_stacked_plain(args, real_gangs)
    P = int(g_state.shape[0])
    if len(real_gangs) != P or alloc.dim() != 4:
        raise ValueError("verify_round_stacked: expected P real-gang counts and [P, P1, N, R] alloc")
    args = (node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid, g_req,
            g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts, n_slots,
            run_evicted, run_rescheduled, alloc, q_alloc, scheduled_count, compact_buf)
    for name, t in zip(_PTRS, args):
        if t.dim() == 0 or int(t.shape[0]) != P:
            raise ValueError(f"verify_round_stacked: {name} has no lane axis of {P}")
    host = torch.tensor([int(g) for g in real_gangs], dtype=torch.int32).pin_memory()
    real = host.to(g_state.device, non_blocking=True)
    return _launch(dict(zip(_PTRS, args)), P, 0, real, int(alloc[0].numel()))


def _launch(src: dict, lanes: int, real_g: int, real_lanes, alloc0_stride: int) -> torch.Tensor:
    """Launch K-I on `src` (verify_round's inputs by name; for lanes > 0 each
    with a leading lane axis and alloc0 the full [P, P1, N, R] alloc)."""
    o = 1 if lanes else 0
    for name, dt in _DTYPES.items():
        require_cuda(src[name], name, dt)
    node_total, g_state, run_req = src["node_total"], src["g_state"], src["run_req"]
    q_alloc, slot_nodes, compact_buf = src["q_alloc"], src["slot_nodes"], src["compact"]
    N, R = (int(x) for x in node_total.shape[o:])
    G = int(g_state.shape[o])
    RJ = int(run_req.shape[o])
    Q = int(q_alloc.shape[o])
    S, W = (int(x) for x in slot_nodes.shape[o:])
    alloc0 = src["alloc0"]
    alloc0_rows = tuple(alloc0.shape[-2:]) if lanes else tuple(alloc0.shape)
    P = max(lanes, 1)
    if (alloc0_rows != (N, R) or tuple(src["g_req"].shape[o:]) != (G, R)
            or tuple(q_alloc.shape[o:]) != (Q, R)
            or tuple(src["slot_counts"].shape[o:]) != (S, W)
            or int(src["slot_gang"].shape[o]) != S or src["n_slots"].numel() != P
            or src["sched_count"].numel() != P or compact_buf.dim() != 1 + o):
        raise ValueError("verify_round: inputs disagree in shape")
    dev = g_state.device
    lead = (lanes,) if lanes else ()
    src["used"] = torch.empty(lead + (N, R), dtype=torch.float32, device=dev)
    src["expq"] = torch.empty(lead + (Q, R), dtype=torch.float32, device=dev)
    src["occ"] = torch.empty(lead + (G,), dtype=torch.int32, device=dev)
    src["acc"] = torch.empty(lead + (16,), dtype=torch.int32, device=dev)
    src["out"] = torch.empty(lead + (16,), dtype=torch.int32, device=dev)
    lib = library()
    if ctypes.sizeof(VerifyArgs) != lib.armada_verify_args_size():
        raise RuntimeError("VerifyArgs layout differs between Python and csrc/verify.cu")
    a = VerifyArgs()
    for name in _PTRS:
        setattr(a, name, src[name].data_ptr())
    a.real_lanes = None if real_lanes is None else real_lanes.data_ptr()
    a.alloc0_stride = int(alloc0_stride)
    for name, v in zip(_INTS, (N, R, RJ, G, Q, S, W, int(compact_buf.shape[-1]), real_g, P)):
        setattr(a, name, v)
    check(lib.armada_verify(ctypes.byref(a), stream_handle()), "verify kernel")
    kernels.LAUNCHES["verify_stacked" if lanes else "verify"] += 1
    return src["out"]
