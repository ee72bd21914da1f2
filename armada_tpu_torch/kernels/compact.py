"""Wrappers of kernels K-C and K-F (csrc/compact.cu): the packed decode
buffer of one round, and of a stacked round's P lanes at once.  CPU results
run the plain versions (models/fair_scheduler.py compact_result_plain, and
a loop of it over the lanes).

The host's work is done once per signature -- the device, the lane count,
the caps, and the inputs' shapes and dtypes -- in a `_Plan`: the kernel's
argument block (`CompactArgs`, an array of int64 words) with its fixed
words filled in.  A call checks its inputs in one pass (device and
contiguity; the signature is the cache key, validated when its plan is
built), writes their `data_ptr()`s, the output's and the workspace's into a
copy of the block, the workspace's tag, and the real gang and run counts by
value (a device table only past INLINE lanes), then launches one kernel.

The kernel's scratch is a workspace of look-back status words per (device,
stream, lanes, tiles of G, tiles of RJ), zeroed once: every call writes
every status word with its tag (1..255, a counter of the workspace), so a
word of the previous call never carries the current tag.  Calls on one
stream are ordered, so they may share it; another stream gets its own.  A
call whose launch fails drops its workspace."""

from __future__ import annotations

import operator

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.core.watchdog import add_reset_hook
from armada_tpu_torch.kernels.build import check, library, placed, stream_handle

_IN = ("g_state", "run_evicted", "run_rescheduled", "slot_gang", "slot_nodes", "slot_counts",
       "n_slots", "iterations", "termination", "scheduled_count", "spot_price", "kernel_iters")
_PTRS = ("out", "ws", "real_table")
_INTS = ("G", "RJ", "S", "W", "fcap", "ecap", "lanes", "tag")
INLINE = 256  # csrc/compact.cu CP_INLINE
TILE = 4096   # csrc/compact.cu CP_TILE
WORD = {n: i for i, n in enumerate(_IN + _PTRS + _INTS)}
WORD["real_inline"] = len(WORD)
ARGS_WORDS = WORD["real_inline"] + INLINE  # 2 x INLINE int32 (gangs, runs) pairs
_SCALARS = ("n_slots", "iterations", "termination", "scheduled_count", "spot_price",
            "kernel_iters")
_DTYPES = dict(g_state=torch.int32, run_evicted=torch.bool, run_rescheduled=torch.bool,
               slot_gang=torch.int32, slot_nodes=torch.int32, slot_counts=torch.int32,
               n_slots=torch.int32, iterations=torch.int32, termination=torch.int32,
               scheduled_count=torch.int32, spot_price=torch.float32, kernel_iters=torch.int32)

_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")
_PLANS: dict = {}
_PLANS_CAP = 32
_WORKSPACES: dict = {}
_WORKSPACES_CAP = 8
_LIB = None


def ws_lane_words(G: int, RJ: int) -> int:
    """Status words of one lane's workspace: csrc/compact.cu (a chain for the
    failed gangs, and one each for the preempted and rescheduled runs),
    checked against it when the library loads."""
    return -(-G // TILE) + 2 * -(-RJ // TILE)


def _library():
    global _LIB
    if _LIB is None:
        lib = library()
        if (lib.armada_compact_args_size() != 8 * ARGS_WORDS
                or any(lib.armada_compact_ws_words(*s) != ws_lane_words(*s)
                       for s in ((0, 0), (1, 1), (901_120, 32_768), (4_097, 8_191)))):
            raise RuntimeError("CompactArgs or the workspace layout differs between Python and "
                               "csrc/compact.cu")
        _LIB = lib
    return _LIB


class _Workspace:
    """The kernel's status words for one (device, stream, shape), and the
    tag of its last call (1..255)."""

    __slots__ = ("buf", "tag", "key")

    def __init__(self, key: tuple, words: int, device):
        self.buf = torch.zeros(max(words, 1), dtype=torch.int64, device=device)
        self.tag = 0
        self.key = key

    def next_tag(self) -> int:
        self.tag = self.tag % 255 + 1
        return self.tag


def workspace(key: tuple, words: int, device) -> _Workspace:
    ws = _WORKSPACES.get(key)
    if ws is None:
        if len(_WORKSPACES) >= _WORKSPACES_CAP:
            _WORKSPACES.clear()
        ws = _WORKSPACES[key] = _Workspace(key, words, device)
    return ws


class _Plan:
    """What one signature fixes: the shapes, the output's, the workspace's
    size and the argument block's fixed words."""

    __slots__ = ("template", "out_shape", "ws_key", "ws_words")

    def __init__(self, shapes, dtypes, lanes: int, fcap: int, ecap: int, dev):
        src = dict(zip(_IN, shapes))
        for name, dt in zip(_IN, dtypes):
            if dt != _DTYPES[name]:
                raise TypeError(f"compact_result: {name}: expected {_DTYPES[name]}, got {dt}")
        o = 1 if lanes else 0
        P = max(lanes, 1)
        lead = (lanes,) if lanes else ()
        for name, shape in src.items():
            if tuple(shape[:o]) != lead:
                raise ValueError(f"compact_result_stacked: {name} has no lane axis of {lanes}")
        if len(src["g_state"]) != 1 + o or len(src["slot_nodes"]) != 2 + o:
            raise ValueError("compact_result: inputs disagree in shape")
        G = int(src["g_state"][o])
        RJ = int(src["run_evicted"][o])
        S, W = (int(x) for x in src["slot_nodes"][o:])
        scalar = (lambda s: tuple(s) == (lanes,)) if lanes else (lambda s: tuple(s) in ((), (1,)))
        if (tuple(src["run_rescheduled"][o:]) != (RJ,) or len(src["run_evicted"]) != 1 + o
                or tuple(src["slot_gang"][o:]) != (S,) or tuple(src["slot_counts"][o:]) != (S, W)
                or not all(scalar(src[n]) for n in _SCALARS)):
            raise ValueError("compact_result: inputs disagree in shape")
        if not (0 <= fcap <= G and 0 <= ecap <= RJ):
            raise ValueError("compact_result: caps exceed the axes they index")
        if max(G, RJ) >= 1 << 31 or P > 65535:
            raise ValueError("compact_result: axes outside what the kernel takes")
        from armada_tpu_torch.models.fair_scheduler import compact_len

        tpl = np.zeros(ARGS_WORDS, np.int64)
        for k, val in zip(_INTS, (G, RJ, S, W, fcap, ecap, P, 0)):
            tpl[WORD[k]] = val
        self.template = tpl
        self.out_shape = lead + (compact_len(S, W, fcap, ecap),)
        self.ws_key = (dev, P, -(-G // TILE), -(-RJ // TILE))
        self.ws_words = P * ws_lane_words(G, RJ)


def compact_plan(result, real_gangs, real_runs, *, lanes: int = 0, fcap: int, ecap: int,
                 stream: int = 0):
    """(the output buffer, not yet written; the argument block; the
    workspace; the device table of real counts or None): everything of a
    K-C (`lanes` 0, `real_gangs` / `real_runs` ints) or K-F (`lanes` P, P
    ints each) call but the launch, checked.  Runs on tensors of any device
    (the CPU tests hold its layout)."""
    args = tuple(getattr(result, n) for n in _IN)
    dev = args[0].device
    if not placed(args, dev):
        for name, t in zip(_IN, args):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"compact_result: {name}: expected a tensor")
            if t.device != dev:
                raise ValueError(f"compact_result: {name}: expected a tensor on {dev}, got one "
                                 f"on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"compact_result: {name}: expected a contiguous tensor")
    fcap, ecap = int(fcap), int(ecap)
    key = (dev, lanes, fcap, ecap, tuple(map(_SHAPE, args)), tuple(map(_DTYPE, args)))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(key[4], key[5], lanes, fcap, ecap, dev)
        if len(_PLANS) >= _PLANS_CAP:
            _PLANS.clear()
        _PLANS[key] = plan
    ws = workspace(plan.ws_key + (stream,), plan.ws_words, dev)
    out = torch.empty(plan.out_shape, dtype=torch.int32, device=dev)
    call = plan.template.copy()
    call[:len(_IN)] = np.fromiter(map(torch.Tensor.data_ptr, args), np.int64, len(_IN))
    call[WORD["out"]] = out.data_ptr()
    call[WORD["ws"]] = ws.buf.data_ptr()
    call[WORD["tag"]] = ws.next_tag()
    inline = call[WORD["real_inline"]:].view(np.int32)
    table = None
    if not lanes:
        inline[0] = int(real_gangs)
        inline[1] = int(real_runs)
    else:
        if len(real_gangs) != lanes or len(real_runs) != lanes:
            raise ValueError(f"compact_result_stacked: expected {lanes} real-gang and real-run "
                             "counts")
        real = np.empty((lanes, 2), np.int32)
        real[:, 0] = np.asarray(real_gangs, np.int64)
        real[:, 1] = np.asarray(real_runs, np.int64)
        head = real[:INLINE].reshape(-1)
        inline[:len(head)] = head
        if lanes > INLINE:
            table = torch.as_tensor(real, device=dev)
            call[WORD["real_table"]] = table.data_ptr()
    return out, call, ws, table


def _launch(result, real_gangs, real_runs, lanes: int, fcap: int, ecap: int, what: str):
    lib = _library()
    stream = stream_handle()
    out, call, ws, _table = compact_plan(result, real_gangs, real_runs, lanes=lanes, fcap=fcap,
                                         ecap=ecap, stream=stream)
    rc = lib.armada_compact(call.ctypes.data, stream)
    if rc != 0:  # a half-run call may leave statuses of the current tag
        _WORKSPACES.pop(ws.key, None)
    check(rc, "compact kernel")
    kernels.LAUNCHES[what] += 1
    return out


def compact_result(result, num_real_gangs: int, num_real_runs: int, *, fcap: int, ecap: int):
    """K-C: i32 buffer of the round's decisions (layout in
    models/fair_scheduler.py compact_result).  CPU results run the plain
    version; CUDA results the kernel."""
    if not result.g_state.is_cuda:
        from armada_tpu_torch.models.fair_scheduler import compact_result_plain

        return compact_result_plain(result, num_real_gangs, num_real_runs, fcap=fcap, ecap=ecap)
    return _launch(result, int(num_real_gangs), int(num_real_runs), 0, fcap, ecap, "compact")


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
    `real_gangs` / `real_runs`: per-lane counts (sequences of P ints), passed
    by value in the kernel's arguments."""
    if not result.g_state.is_cuda:
        return compact_result_stacked_plain(result, real_gangs, real_runs, fcap=fcap, ecap=ecap)
    return _launch(result, real_gangs, real_runs, int(result.g_state.shape[0]), fcap, ecap,
                   "compact_stacked")


def reset_device_state() -> None:
    """Drop every workspace of status words and cached plan, so the next call on the card starts from freshly zeroed
    scratch.  The watchdog's reset hooks call it on every backend transition
    (core/watchdog.py): a failed or abandoned round can stop between a
    kernel's passes and leave its scratch dirty."""
    _PLANS.clear()
    _WORKSPACES.clear()


add_reset_hook(reset_device_state)
