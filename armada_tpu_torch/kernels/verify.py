"""Wrappers of kernel K-I (csrc/verify.cu): round verification, solo or
over a stacked round's P lanes.  CPU inputs run the plain versions
(models/verify.py verify_kernel_plain, and a loop of it over the lanes).

The host's work is done once per signature -- the device, the lane count,
and the inputs' shapes and dtypes -- in a `_Plan`: the kernel's argument
block (`VerifyArgs`, an array of int64 words) with its fixed words filled
in.  A call checks its inputs in one pass (device and contiguity; the
signature is the cache key, validated when its plan is built), writes their
`data_ptr()`s, the output's and the workspace's into a copy of the block,
and the real gang counts by value (a device table only past INLINE lanes),
then launches: two kernels, no memset.

The kernel's scratch is a workspace per (device, stream, lanes, N, R, Q,
G), zeroed once: the kernel clears the [N, R] and [Q, R] tables and its
counters as it consumes them, and its per-gang stamps carry the call's
epoch, a counter of the workspace, so a stamp of an earlier call reads as
unhit.  Calls on one stream are ordered, so they may share it; another
stream gets its own.  A call whose launch fails drops its workspace."""

from __future__ import annotations

import operator

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, placed, stream_handle

_IN = ("node_total", "node_ok", "node_axes", "run_req", "run_node", "run_queue",
       "run_valid", "g_req", "g_card", "g_queue", "g_run", "g_state", "slot_gang",
       "slot_nodes", "slot_counts", "n_slots", "run_evicted", "run_rescheduled", "alloc0",
       "q_alloc", "sched_count", "compact")
_PTRS = ("out", "ws", "real_table")
_INTS = ("alloc0_stride", "N", "R", "RJ", "G", "Q", "S", "W", "L", "lanes", "epoch")
INLINE = 256  # csrc/verify.cu VF_INLINE
WORD = {n: i for i, n in enumerate(_IN + _PTRS + _INTS)}
WORD["real_inline"] = len(WORD)
ARGS_WORDS = WORD["real_inline"] + INLINE
ACC_WORDS = 12  # csrc/verify.cu A_LEN
_DTYPES = dict(
    node_total=torch.float32, node_ok=torch.bool, node_axes=torch.float32,
    run_req=torch.float32, run_node=torch.int32, run_queue=torch.int32, run_valid=torch.bool,
    g_req=torch.float32, g_card=torch.int32, g_queue=torch.int32, g_run=torch.int32,
    g_state=torch.int32, slot_gang=torch.int32, slot_nodes=torch.int32,
    slot_counts=torch.int32, n_slots=torch.int32, run_evicted=torch.bool,
    run_rescheduled=torch.bool, alloc0=torch.float32, q_alloc=torch.float32,
    sched_count=torch.int32, compact=torch.int32,
)

_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")
_PLANS: dict = {}
_PLANS_CAP = 32
_WORKSPACES: dict = {}
_WORKSPACES_CAP = 8
_LIB = None


def ws_lane_bytes(N: int, R: int, Q: int, G: int) -> int:
    """Bytes of one lane's workspace: csrc/verify.cu vf_layout (used [N, R]
    f32, expq [Q, R] f32, the counters, the stamps [G] u32; 256-byte
    pieces), checked against it when the library loads."""
    def piece(b):
        return -(-b // 256) * 256

    return piece(4 * N * R) + piece(4 * Q * R) + piece(4 * ACC_WORDS) + piece(4 * G)


def _library():
    global _LIB
    if _LIB is None:
        lib = library()
        if (lib.armada_verify_args_size() != 8 * ARGS_WORDS
                or any(lib.armada_verify_ws_bytes(*s) != ws_lane_bytes(*s)
                       for s in ((1, 1, 1, 1), (50_176, 4, 256, 1_187_840), (7, 3, 65, 4_097)))):
            raise RuntimeError("VerifyArgs or the workspace layout differs between Python and "
                               "csrc/verify.cu")
        _LIB = lib
    return _LIB


class _Workspace:
    """The kernel's scratch for one (device, stream, shape), and the epoch
    of its last call (32 bits in the kernel)."""

    __slots__ = ("buf", "epoch", "key")

    def __init__(self, key: tuple, nbytes: int, device):
        self.buf = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.epoch = 0
        self.key = key

    def next_epoch(self) -> int:
        if self.epoch >= 0xFFFFFFFF:
            self.buf.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


def workspace(key: tuple, nbytes: int, device) -> _Workspace:
    ws = _WORKSPACES.get(key)
    if ws is None:
        if len(_WORKSPACES) >= _WORKSPACES_CAP:
            _WORKSPACES.clear()
        ws = _WORKSPACES[key] = _Workspace(key, nbytes, device)
    return ws


class _Plan:
    """What one signature fixes: the shapes, the output's, the workspace's
    size and the argument block's fixed words."""

    __slots__ = ("template", "out_shape", "ws_key", "ws_bytes")

    def __init__(self, shapes, dtypes, lanes: int, dev):
        src = dict(zip(_IN, shapes))
        for name, dt in zip(_IN, dtypes):
            if dt != _DTYPES[name]:
                raise TypeError(f"verify_round: {name}: expected {_DTYPES[name]}, got {dt}")
        o = 1 if lanes else 0
        P = max(lanes, 1)
        lead = (lanes,) if lanes else ()
        for name, shape in src.items():
            if tuple(shape[:o]) != lead:
                raise ValueError(f"verify_round_stacked: {name} has no lane axis of {lanes}")
        if len(src["node_total"]) != 2 + o or len(src["slot_nodes"]) != 2 + o:
            raise ValueError("verify_round: inputs disagree in shape")
        N, R = (int(x) for x in src["node_total"][o:])
        G = int(src["g_state"][o])
        RJ = int(src["run_req"][o])
        Q = int(src["q_alloc"][o])
        S, W = (int(x) for x in src["slot_nodes"][o:])
        alloc0 = src["alloc0"]
        if lanes and (len(alloc0) != 4 or int(alloc0[1]) < 1):
            raise ValueError("verify_round_stacked: expected a [P, P1, N, R] alloc")
        scalar = (lambda s: tuple(s) == (lanes,)) if lanes else (lambda s: tuple(s) in ((), (1,)))
        if (tuple(alloc0[-2:]) != (N, R) or (not lanes and len(alloc0) != 2)
                or tuple(src["g_req"][o:]) != (G, R) or tuple(src["run_req"][o:]) != (RJ, R)
                or tuple(src["q_alloc"][o:]) != (Q, R) or tuple(src["node_axes"][o:]) != (R,)
                or tuple(src["node_ok"][o:]) != (N,)
                or tuple(src["slot_counts"][o:]) != (S, W) or tuple(src["slot_gang"][o:]) != (S,)
                or any(tuple(src[n][o:]) != (G,) for n in ("g_card", "g_queue", "g_run"))
                or any(tuple(src[n][o:]) != (RJ,) for n in ("run_node", "run_queue", "run_valid",
                                                             "run_evicted", "run_rescheduled"))
                or not scalar(src["n_slots"]) or not scalar(src["sched_count"])
                or len(src["compact"]) != 1 + o):
            raise ValueError("verify_round: inputs disagree in shape")
        if min(N, R, G, Q, S, W) <= 0 or max(N * R, G * R, S * W) >= 1 << 31 or P > 65535:
            raise ValueError("verify_round: axes outside what the kernel takes")
        L = int(src["compact"][o])
        stride = int(np.prod(alloc0[1:])) if lanes else 0
        tpl = np.zeros(ARGS_WORDS, np.int64)
        for k, val in zip(_INTS, (stride, N, R, RJ, G, Q, S, W, L, P, 0)):
            tpl[WORD[k]] = val
        self.template = tpl
        self.out_shape = lead + (16,)
        self.ws_key = (dev, P, N, R, Q, G)
        self.ws_bytes = P * ws_lane_bytes(N, R, Q, G)


def verify_plan(args, real_gangs, *, lanes: int = 0, stream: int = 0):
    """(the output buffer, not yet written; the argument block; the
    workspace): everything of a K-I call but the launch, checked.  `args`
    are verify_round's 22 inputs (for lanes > 0 each with a leading lane
    axis and alloc0 the whole [P, P1, N, R] alloc); `real_gangs` an int, or
    P of them.  Runs on tensors of any device (the CPU tests hold its
    layout)."""
    args = tuple(args)
    dev = args[11].device  # g_state
    if not placed(args, dev):
        for name, t in zip(_IN, args):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"verify_round: {name}: expected a tensor")
            if t.device != dev:
                raise ValueError(f"verify_round: {name}: expected a tensor on {dev}, got one "
                                 f"on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"verify_round: {name}: expected a contiguous tensor")
    key = (dev, lanes, tuple(map(_SHAPE, args)), tuple(map(_DTYPE, args)))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(key[2], key[3], lanes, dev)
        if len(_PLANS) >= _PLANS_CAP:
            _PLANS.clear()
        _PLANS[key] = plan
    ws = workspace(plan.ws_key + (stream,), plan.ws_bytes, dev)
    out = torch.empty(plan.out_shape, dtype=torch.int32, device=dev)
    call = plan.template.copy()
    call[:len(_IN)] = np.fromiter(map(torch.Tensor.data_ptr, args), np.int64, len(_IN))
    call[WORD["out"]] = out.data_ptr()
    call[WORD["ws"]] = ws.buf.data_ptr()
    call[WORD["epoch"]] = ws.next_epoch()
    table = None
    if not lanes:
        call[WORD["real_inline"]] = int(real_gangs)
    else:
        real = np.asarray(real_gangs, np.int64)
        if real.shape != (lanes,):
            raise ValueError(f"verify_round_stacked: expected {lanes} real-gang counts")
        head = real[:INLINE]
        call[WORD["real_inline"]:WORD["real_inline"] + len(head)] = head
        if lanes > INLINE:
            table = torch.as_tensor(real.astype(np.int32), device=dev)
            call[WORD["real_table"]] = table.data_ptr()
    return out, call, ws, table


def _launch(args, real_gangs, lanes: int, what: str) -> torch.Tensor:
    lib = _library()
    stream = stream_handle()
    out, call, ws, table = verify_plan(args, real_gangs, lanes=lanes, stream=stream)
    rc = lib.armada_verify(call.ctypes.data, stream)
    if rc != 0:  # a half-run call may leave the tables dirty
        _WORKSPACES.pop(ws.key, None)
    check(rc, "verify kernel")
    kernels.LAUNCHES[what] += 1
    return out


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
    return _launch(args, int(num_real_gangs), 0, "verify")


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
    `real_gangs` the per-lane real gang counts (P ints, passed by value in
    the kernel's arguments)."""
    args = (node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid, g_req,
            g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts, n_slots,
            run_evicted, run_rescheduled, alloc, q_alloc, scheduled_count, compact_buf)
    if not g_state.is_cuda:
        return verify_round_stacked_plain(args[:18] + (alloc[:, 0],) + args[19:], real_gangs)
    return _launch(args, real_gangs, int(g_state.shape[0]), "verify_stacked")
