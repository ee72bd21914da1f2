"""Wrapper of kernel K-H (csrc/slab.cu): the slab delta apply.

The apply is functional, as the JAX program is: every field the bundle
touches gets a fresh buffer, the kernel writes into it the previous field
with the dirty rows laid over it, and the previous problem's tensors are
never written.  CPU problems run the plain version (models/slab.py
apply_delta_plain).

The host's work is done once per signature -- the device, the splice flag,
and the shapes and dtypes of every tensor the kernel reads (the touched
fields, their row columns, the index and splice vectors) -- in a `_Plan`:
where each fresh field lies in ONE arena a call (ALIGN-aligned offsets, one
`as_strided` view a field), and the kernel's argument block (`SlabCall`, an
array of int64 words) with its fixed words filled in.  A call then checks
its tensors in one pass (device and contiguity; the signature itself is the
cache key, validated when its plan is built), reads their `data_ptr()`s
into a copy of the block, allocates the arena and launches.  The arena
lives as long as any of its fields.

The kernel's scratch is a workspace per (device, stream, G, RJ), zeroed
once and never cleared: every entry the kernel writes carries the call's
epoch, a counter of the workspace (`_Workspace`), and every look-back
status of the splice the tag of its splice call, so an entry of an earlier
call reads as empty.  Calls on one stream are ordered, so they may share
it; another stream gets its own."""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.core.watchdog import add_reset_hook
from armada_tpu_torch.kernels.build import check, library, placed, stream_handle

MAX_FIELDS = 24
ALIGN = 512
SPLICE_TILE = 4096  # csrc/slab.cu SLAB_SPLICE_TILE
# SlabCall as int64 words: five a field (src, dst, rows_a, rows_b, rb),
# then the pointers and the scalars
_FIELD_WORDS = 5
_PTRS = ("sg_idx", "rr_idx", "rem_pos", "ins_pos", "ins_val", "gq_prev", "gq_out", "ws")
_SCALARS = ("G", "RJ", "k_sg", "k_rr", "kq", "ngf", "nrf", "ev_base", "splice", "epoch",
            "stag")
WORD = {n: MAX_FIELDS * _FIELD_WORDS + i for i, n in enumerate(_PTRS + _SCALARS)}
CALL_WORDS = MAX_FIELDS * _FIELD_WORDS + len(_PTRS) + len(_SCALARS)

_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")
_PLANS: dict = {}
_PLANS_CAP = 64
_WORKSPACES: dict = {}
_WORKSPACES_CAP = 8
_LIB = None


@functools.lru_cache(maxsize=None)
def _fields():
    """(gang-axis fields, run-axis fields) in the kernel's order, and the
    (group, field, rows word) triples of the row columns: the gang rows
    (rows_a of a gang field), the evictee rows (rows_b), the run rows
    (rows_a of a run field)."""
    from armada_tpu_torch.models.slab import _EV_FIELDS, _RR_FIELDS, _SG_FIELDS

    gang = tuple(dict.fromkeys(_SG_FIELDS + _EV_FIELDS))
    run = tuple(_RR_FIELDS)
    fidx = {("g", n): i for i, n in enumerate(gang)}
    fidx.update({("r", n): len(gang) + i for i, n in enumerate(run)})
    rows = ([("sg", n, fidx["g", n] * _FIELD_WORDS + 2) for n in _SG_FIELDS]
            + [("ev", n, fidx["g", n] * _FIELD_WORDS + 3) for n in _EV_FIELDS]
            + [("rr", n, fidx["r", n] * _FIELD_WORDS + 2) for n in _RR_FIELDS])
    return gang, run, tuple(rows)


def ws_bytes(G: int, RJ: int) -> int:
    """Bytes of the kernel's workspace at (G, RJ): csrc/slab.cu
    slab_ws_layout, checked against it when the library loads."""
    def piece(b):
        return -(-b // 256) * 256

    wg, nt = -(-G // 32), -(-G // SPLICE_TILE)
    return (3 * piece(8 * G) + piece(8 * RJ) + piece(8 * nt) + 2 * piece(4 * wg)
            + 2 * piece(4 * G) + piece(4 * nt) + piece(4))


def _library():
    global _LIB
    if _LIB is None:
        lib = library()
        if (lib.armada_slab_call_size() != 8 * CALL_WORDS
                or any(lib.armada_slab_ws_bytes(g, r) != ws_bytes(g, r)
                       for g, r in ((1, 0), (4097, 33), (1_187_840, 32_768)))):
            raise RuntimeError("SlabCall or the workspace layout differs between Python and "
                               "csrc/slab.cu")
        _LIB = lib
    return _LIB


class _Workspace:
    """The kernel's scratch on one (device, stream) at one (G, RJ), the
    epoch of its last call and the count of its splice calls (whose tag,
    1..255, marks the splice's look-back statuses)."""

    __slots__ = ("buf", "epoch", "splices")

    def __init__(self, nbytes: int, device):
        self.buf = torch.zeros(max(nbytes, 1), dtype=torch.uint8, device=device)
        self.epoch = 0
        self.splices = 0

    def next_epoch(self) -> int:
        if self.epoch >= 0xFFFFFFFF:  # the epoch is 32 bits in the kernel
            self.buf.zero_()
            self.epoch = self.splices = 0
        self.epoch += 1
        return self.epoch

    def next_splice_tag(self) -> int:
        self.splices += 1
        return self.splices % 255 + 1


def workspace(device, stream: int, G: int, RJ: int) -> _Workspace:
    key = (device, stream, G, RJ)
    ws = _WORKSPACES.get(key)
    if ws is None:
        if len(_WORKSPACES) >= _WORKSPACES_CAP:
            _WORKSPACES.clear()
        ws = _WORKSPACES[key] = _Workspace(ws_bytes(G, RJ), device)
    return ws


class _Plan:
    """What one signature fixes: the arena's layout (offsets, views) and the
    argument block's fixed words, with the words a call fills: `ptr_words`
    (in the order of the call's tensor list) and `dst_words` (arena base +
    `dst_off`)."""

    __slots__ = ("arena_bytes", "dtypes", "views", "names", "template", "ptr_words",
                 "dst_words", "dst_off", "G", "RJ")

    def __init__(self, srcs, names, rows, vecs, splice: bool):
        gang, run, row_slots = _fields()
        ng = len(gang)
        G, RJ = int(srcs[0].shape[0]), int(srcs[ng].shape[0])
        if not 0 < G < (1 << 27):
            raise ValueError(f"apply_delta: the gang axis ({G}) is outside what the kernel takes")
        for i, (name, t) in enumerate(zip(names, srcs)):
            n = G if i < ng else RJ
            if t.dim() == 0 or int(t.shape[0]) != n:
                raise ValueError(f"apply_delta: {name} has shape {tuple(t.shape)}, "
                                 f"expected a leading axis of {n}")
        where = {n: i for i, n in enumerate(names)}
        for (group, name, _), r in zip(row_slots, rows):
            src = srcs[where[name]]
            if r.dtype != src.dtype or r.dim() != src.dim() or r.shape[1:] != src.shape[1:]:
                raise ValueError(f"apply_delta: {name} {group} rows have shape "
                                 f"{tuple(r.shape)} and dtype {r.dtype}")
        sg_idx, rr_idx = vecs[:2]
        k_sg, k_rr = int(sg_idx.shape[0]), int(rr_idx.shape[0])
        for (group, name, _), r in zip(row_slots, rows):
            if int(r.shape[0]) != (k_sg if group == "sg" else k_rr):
                raise ValueError(f"apply_delta: {name} {group} rows have {int(r.shape[0])} rows")
        for name, t in zip(("sg_idx", "rr_idx", "rem_pos", "ins_pos", "ins_val"), vecs):
            if t.dtype != torch.int32 or t.dim() != 1:
                raise ValueError(f"apply_delta: {name} must be a 1-D int32 vector")
        kq = 0
        if splice:
            kq = int(vecs[2].shape[0])
            if int(vecs[3].shape[0]) != kq or int(vecs[4].shape[0]) != kq:
                raise ValueError("apply_delta: splice vectors differ in length")
            gq = vecs[5]
            if gq.dtype != torch.int32 or tuple(gq.shape) != (G,):
                raise ValueError(f"apply_delta: gq_gang has shape {tuple(gq.shape)}")
        self.G, self.RJ = G, RJ
        # the arena: every touched field, then (splice) the new order vector
        out = list(srcs) + ([vecs[5]] if splice else [])
        self.names = tuple(names) + (("gq_gang",) if splice else ())
        offsets, pos = [], 0
        for t in out:
            b = t.numel() * t.element_size()
            offsets.append(pos if b else 0)
            pos += -(-b // ALIGN) * ALIGN
        self.arena_bytes = pos
        self.dtypes = tuple(dict.fromkeys(t.dtype for t in out))
        self.views = tuple((t.dtype, tuple(t.shape), t.stride(), off // t.element_size())
                           for t, off in zip(out, offsets))
        # the argument block
        tpl = np.zeros(CALL_WORDS, np.int64)
        for i, t in enumerate(srcs):
            tpl[i * _FIELD_WORDS + 4] = t[0].numel() * t.element_size() if t.shape[0] else 1
        for k, v in (("G", G), ("RJ", RJ), ("k_sg", k_sg), ("k_rr", k_rr), ("kq", kq),
                     ("ngf", ng), ("nrf", len(run)), ("splice", int(splice))):
            tpl[WORD[k]] = v
        self.template = tpl
        ptr = [i * _FIELD_WORDS for i in range(len(srcs))] + [w for _, _, w in row_slots]
        ptr += [WORD["sg_idx"], WORD["rr_idx"]]
        if splice:
            ptr += [WORD["rem_pos"], WORD["ins_pos"], WORD["ins_val"], WORD["gq_prev"]]
        self.ptr_words = np.array(ptr, np.int64)
        dst = [i * _FIELD_WORDS + 1 for i in range(len(srcs))]
        if splice:
            dst.append(WORD["gq_out"])
        self.dst_words = np.array(dst, np.int64)
        self.dst_off = np.array(offsets, np.int64)

    def output(self, device):
        """A fresh arena and its field views, in `names` order."""
        arena = torch.empty(self.arena_bytes, dtype=torch.uint8, device=device)
        typed = {dt: arena.view(dt) for dt in self.dtypes}
        return arena, [torch.as_strided(typed[dt], shape, strides, off)
                       for dt, shape, strides, off in self.views]


def _require_each(names, tensors, dev) -> None:
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"apply_delta: {name}: expected a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"apply_delta: {name}: expected a tensor on {dev}, got one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"apply_delta: {name}: expected a contiguous tensor")


def apply_plan(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args, *,
               ev_base: int, splice: bool, stream: int = 0):
    """(the new problem with its fresh fields not yet written, the argument
    block, the workspace): everything of a K-H call but the launch, checked.
    Runs on tensors of any device (the CPU tests hold its layout)."""
    gang, run, row_slots = _fields()
    out = prev._asdict()
    dev = prev.g_req.device
    for name, t in fulls.items():
        if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != out[name].dtype:
            raise ValueError(f"apply_delta: full field {name} must be a {out[name].dtype} "
                             f"tensor on {dev}")
        out[name] = t
    names = gang + run
    srcs = [out[n] for n in names]
    cols = {"sg": sg_cols, "ev": ev_cols, "rr": rr_cols}
    try:
        rows = [cols[g][n] for g, n, _ in row_slots]
    except KeyError as e:
        raise ValueError(f"apply_delta: no rows for field {e}") from None
    vecs = [sg_idx, rr_idx] + ([*gq_args, prev.gq_gang] if splice else [])
    ts = srcs + rows + vecs
    if not placed(ts, dev):
        _require_each(list(names) + [f"{g} rows of {n}" for g, n, _ in row_slots]
                      + ["sg_idx", "rr_idx", "rem_pos", "ins_pos", "ins_val", "gq_gang"],
                      ts, dev)
    key = (dev, bool(splice), tuple(map(_SHAPE, ts)), tuple(map(_DTYPE, ts)))
    plan = _PLANS.get(key)
    if plan is None:
        if splice and len(gq_args) != 3:
            raise ValueError("apply_delta: a splice takes (rem_pos, ins_pos, ins_val)")
        plan = _Plan(srcs, names, rows, vecs, bool(splice))
        if len(_PLANS) >= _PLANS_CAP:
            _PLANS.clear()
        _PLANS[key] = plan
    ws = workspace(dev, stream, plan.G, plan.RJ)
    arena, fresh = plan.output(dev)
    call = plan.template.copy()
    call[plan.ptr_words] = np.fromiter(map(torch.Tensor.data_ptr, ts), np.int64, len(ts))
    call[plan.dst_words] = plan.dst_off + arena.data_ptr()
    call[WORD["ws"]] = ws.buf.data_ptr()
    call[WORD["ev_base"]] = int(ev_base)
    call[WORD["epoch"]] = ws.next_epoch()
    if splice:
        call[WORD["stag"]] = ws.next_splice_tag()
    out.update(zip(plan.names, fresh))
    return type(prev)(**out), call, ws


def apply_delta(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args, *,
                ev_base: int, splice: bool, mesh=None):
    """A new SchedulingProblem: `prev` with `fulls` replaced, the gang, run
    and evictee rows scattered in, and (splice=True) gq_gang rebuilt from
    (rem_pos, ins_pos, ins_val).  Index vectors are i32 and bucket-padded
    with the sentinels G / RJ.  CPU problems run the plain version; CUDA
    problems the kernel.

    `mesh`: the apply of a mesh cache (parallel/mesh_slab.py), the
    counterpart of the JAX package's `_sharded_apply_for` (K-L).  On the
    serving mesh the job axis is not split, so every row it scatters is
    replicated, and the node-axis fields arrive whole in `fulls`; the
    mesh's shard-contiguous node layout is the plain layout on one card.
    So the kernel is K-H's, on a problem whose node axis divides into the
    mesh's node shards; its launches count as "slab_sharded"."""
    from armada_tpu_torch.models.slab import apply_delta_plain

    if mesh is not None:
        N = int(prev.node_total.shape[0])
        if N % mesh.node_shards or int(prev.g_req.shape[0]) % mesh.job_shards:
            raise ValueError(f"sharded apply: the resident problem (N={N}) does not divide into "
                             f"the mesh's {mesh.node_shards} x {mesh.job_shards} shards")
    if not prev.g_req.is_cuda:
        return apply_delta_plain(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls,
                                 gq_args, ev_base=ev_base, splice=splice)
    lib = _library()
    stream = stream_handle()
    out, call, _ = apply_plan(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args,
                              ev_base=ev_base, splice=splice, stream=stream)
    check(lib.armada_slab_apply(call.ctypes.data, stream), "slab apply kernel")
    kernels.LAUNCHES["slab" if mesh is None else "slab_sharded"] += 1
    return out


def reset_device_state() -> None:
    """Drop every workspace and cached plan, so the next call on the card starts from freshly zeroed
    scratch.  The watchdog's reset hooks call it on every backend transition
    (core/watchdog.py): a failed or abandoned round can stop between a
    kernel's passes and leave its scratch dirty."""
    _PLANS.clear()
    _WORKSPACES.clear()


add_reset_hook(reset_device_state)
