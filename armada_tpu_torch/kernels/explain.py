"""Wrapper of kernel K-J (csrc/explain.cu): the explain pass.  CPU inputs
run the plain version (models/explain.py explain_kernel_plain).

The host's work is done once per signature -- the device, the inputs'
shapes and dtypes, and the caps -- in a `_Plan`: the layout of ONE arena a
call (the output buffer first, then the kernel's scratch; the buffer is a
view of it, so the arena lives as long as the buffer) and the kernel's
argument block (`ExplainArgs`, an array of int64 words) with its fixed
words filled in.  A call checks its inputs in one pass (device and
contiguity; the signature is the cache key, validated when its plan is
built), writes their `data_ptr()`s and the arena's addresses into a copy of
the block, and launches."""

from __future__ import annotations

import operator

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, placed, stream_handle

_IN = ("compat", "compat_pre_type", "node_type", "node_ok", "node_total", "node_axes",
       "g_req", "g_card", "g_queue", "g_key", "g_run", "g_valid", "g_absent", "g_state",
       "alloc0", "q_killed")
_SCRATCH = ("out", "req_k", "key_ok", "kr", "counts", "totals", "wbuf")
_INTS = ("N", "R", "G", "K", "T", "Q", "real_g", "kcap", "fcap", "zero_bytes")
WORD = {n: i for i, n in enumerate(_IN + _SCRATCH + _INTS)}
ARGS_WORDS = len(WORD)
_DTYPES = dict(
    compat=torch.bool, compat_pre_type=torch.bool, node_type=torch.int32, node_ok=torch.bool,
    node_total=torch.float32, node_axes=torch.float32, g_req=torch.float32,
    g_card=torch.int32, g_queue=torch.int32, g_key=torch.int32, g_run=torch.int32,
    g_valid=torch.bool, g_absent=torch.bool, g_state=torch.int32, alloc0=torch.float32,
    q_killed=torch.bool,
)
NUM_REASONS = 7
THREADS = 1024  # csrc/explain.cu EX_THREADS: gangs of a block
ALIGN = 256

_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")
_PLANS: dict = {}
_PLANS_CAP = 32
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from armada_tpu_torch.models.explain import explain_len

        lib = library()
        probe = np.zeros(ARGS_WORDS, np.int64)
        for k, v in (("Q", 9), ("R", 3), ("T", 5), ("kcap", 7), ("fcap", 11)):
            probe[WORD[k]] = v
        if (lib.armada_explain_args_size() != 8 * ARGS_WORDS
                or lib.armada_explain_len(probe.ctypes.data) != explain_len(9, 3, 5, 7, 11)):
            raise RuntimeError("ExplainArgs or the buffer layout differs between Python and "
                               "csrc/explain.cu")
        _LIB = lib
    return _LIB


class _Plan:
    """The arena's layout (`offsets` of the scratch, `zero_bytes`: the
    buffer and the scratch the kernel accumulates into, zeroed by its
    memset) and the argument block's fixed words."""

    __slots__ = ("arena_bytes", "len", "template", "scratch_words", "offsets")

    def __init__(self, shapes, dtypes, kcap: int, fcap: int):
        from armada_tpu_torch.models.explain import explain_len

        src = dict(zip(_IN, shapes))
        for name, dt in zip(_IN, dtypes):
            if dt != _DTYPES[name]:
                raise TypeError(f"explain_round: {name}: expected {_DTYPES[name]}, got {dt}")
        if len(src["compat"]) != 2 or len(src["node_total"]) != 2 or len(src["alloc0"]) != 3:
            raise ValueError("explain_round: inputs disagree in shape")
        K, T = (int(x) for x in src["compat"])
        N, R = (int(x) for x in src["node_total"])
        G = int(src["g_state"][0])
        Q = int(src["q_killed"][0])
        if (tuple(src["compat_pre_type"]) != (K, T) or tuple(src["g_req"]) != (G, R)
                or tuple(src["alloc0"][1:]) != (N, R) or int(src["alloc0"][0]) < 1
                or tuple(src["node_type"]) != (N,) or tuple(src["node_ok"]) != (N,)
                or tuple(src["node_axes"]) != (R,)
                or any(tuple(src[n]) != (G,) for n in ("g_card", "g_queue", "g_key", "g_run",
                                                       "g_valid", "g_absent"))):
            raise ValueError("explain_round: inputs disagree in shape")
        if (not (0 <= kcap <= K and 0 <= fcap <= G) or R > 32 or min(N, G, K, T, Q) <= 0
                or max(K * NUM_REASONS, Q * NUM_REASONS, K * R, T * R) >= 1 << 31):
            raise ValueError("explain_round: caps or axes outside what the kernel takes")
        self.len = explain_len(Q, R, T, kcap, fcap)
        wcap = -(-N // 32) + 1
        sizes = (("out", 4 * self.len), ("req_k", 4 * K * R), ("key_ok", 3 * K),
                 ("kr", 4 * K * NUM_REASONS), ("counts", 4 * -(-G // THREADS)), ("totals", 8),
                 ("wbuf", 4 * 2 * wcap * R))
        self.offsets, pos = {}, 0
        for name, b in sizes:
            self.offsets[name] = pos
            pos += -(-b // ALIGN) * ALIGN
            if name == "kr":
                zero = self.offsets["kr"] + b
        self.arena_bytes = pos
        tpl = np.zeros(ARGS_WORDS, np.int64)
        for k, v in (("N", N), ("R", R), ("G", G), ("K", K), ("T", T), ("Q", Q),
                     ("kcap", kcap), ("fcap", fcap), ("zero_bytes", zero)):
            tpl[WORD[k]] = v
        self.template = tpl
        self.scratch_words = np.array([WORD[n] for n in _SCRATCH], np.int64)
        self.offsets = np.array([self.offsets[n] for n in _SCRATCH], np.int64)


def explain_plan(args, num_real_gangs: int, *, kcap: int, fcap: int):
    """(the output buffer, not yet written; the argument block): everything
    of a K-J call but the launch, checked.  `args` are the 16 inputs in
    `explain_kernel_plain`'s order (`alloc` whole: the kernel reads its
    level 0).  Runs on tensors of any device (the CPU tests hold its
    layout)."""
    args = tuple(args)
    dev = args[-3].device  # g_state
    if not placed(args, dev):
        for name, t in zip(_IN, args):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"explain_round: {name}: expected a tensor")
            if t.device != dev:
                raise ValueError(f"explain_round: {name}: expected a tensor on {dev}, got one "
                                 f"on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"explain_round: {name}: expected a contiguous tensor")
    key = (dev, int(kcap), int(fcap), tuple(map(_SHAPE, args)), tuple(map(_DTYPE, args)))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(key[3], key[4], int(kcap), int(fcap))
        if len(_PLANS) >= _PLANS_CAP:
            _PLANS.clear()
        _PLANS[key] = plan
    arena = torch.empty(plan.arena_bytes, dtype=torch.uint8, device=dev)
    call = plan.template.copy()
    call[:len(_IN)] = np.fromiter(map(torch.Tensor.data_ptr, args), np.int64, len(_IN))
    call[plan.scratch_words] = plan.offsets + arena.data_ptr()
    call[WORD["real_g"]] = int(num_real_gangs)
    out = torch.as_strided(arena.view(torch.int32), (plan.len,), (1,), 0)
    return out, call


def explain_round(compat, compat_pre_type, node_type, node_ok, node_total, node_axes, g_req,
                  g_card, g_queue, g_key, g_run, g_valid, g_absent, g_state, alloc, q_killed,
                  num_real_gangs: int, *, kcap: int, fcap: int) -> torch.Tensor:
    """i32 explain buffer (layout in models/explain.py).  CPU inputs run the
    plain version; CUDA inputs the kernel."""
    args = (compat, compat_pre_type, node_type, node_ok, node_total, node_axes, g_req, g_card,
            g_queue, g_key, g_run, g_valid, g_absent, g_state, alloc, q_killed)
    if not g_state.is_cuda:
        from armada_tpu_torch.models.explain import explain_kernel_plain

        return explain_kernel_plain(*args, num_real_gangs, kcap=kcap, fcap=fcap)
    lib = _library()
    out, call = explain_plan(args, num_real_gangs, kcap=kcap, fcap=fcap)
    check(lib.armada_explain(call.ctypes.data, stream_handle()), "explain kernel")
    kernels.LAUNCHES["explain"] += 1
    return out
