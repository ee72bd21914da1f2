"""Wrappers of kernels K-E and K-G (csrc/lanes.cu): stacking pool problems
along a leading lane axis, and slicing one lane back out, each as ONE
batched-copy launch over every field.

Both take and return NamedTuples of tensors (SchedulingProblem,
RoundResult).  CUDA tensors run the kernel; CPU tensors the plain versions
(`stack_plain`, `slice_plain`).  Like the JAX programs they replace, both
return fresh buffers: nothing aliases the inputs.

The fields of one output are views of ONE arena: a single `torch.empty` of
bytes a call, each field at an ALIGN-aligned offset (the caching
allocator's own block alignment, so every `view(dtype)` is legal and every
field starts where a buffer of its own would), contiguous, with its dtype
and shape.  The arena lives as long as any of its fields: a lane a caller
keeps, or the stack memo (models._STACK_CACHE), pins all of it.  Nothing
in the port resizes a field, re-points it or reads its storage, so a view
behaves as the buffer of its own that it replaces
(tests/test_torch_pool_parallel.py holds that).

The host's work is done once per signature -- the tree's type, P, and each
field's shape and dtype -- in a `_Layout`: the fields' offsets, strides and
byte counts, and the descriptor table's fixed columns (bytes, and `tile0`,
the prefix sums of the kernel's tiles).  A call then checks its tensors
against the signature in one pass a tree (a mismatch still raises, naming
the field), allocates the arena, makes one `as_strided` view a field (one
dispatcher call each, fewer than slice + view(dtype) + view(shape), and
measured cheaper than `split_with_sizes` over per-dtype arenas, whose
alignment gaps are tensors too), reads the `data_ptr()`s, fills a copy of
the layout's fixed columns with numpy (for K-G `src = base + i x lane
bytes`), and launches.  The table's word sizes (`wlog`) are decided here,
per call, from the addresses.  A table a plan returns is the caller's:
no later call writes into it.

chip_smoke.py's pools path times each kernel in turns with its library
call on the same inputs (torch.stack per field for K-E, t[i].clone() per
field for K-G: the plain versions), the launch alone with its table
prebuilt, and the host time of one call.
"""

from __future__ import annotations

import itertools
import math
import operator

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.core.watchdog import add_reset_hook
from armada_tpu_torch.kernels.build import check, library, placed, stream_handle

ALIGN = 512
TILE = 16384  # csrc/lanes.cu LANES_TILE; checked when the library loads
# csrc/lanes.cu CopyDesc; its size is checked when the library loads
DESC = np.dtype([("src", "<i8"), ("dst", "<i8"), ("bytes", "<i8"), ("tile0", "<i4"),
                 ("wlog", "<i4")])
# log2 of the widest word (up to 16 bytes) at which src and dst agree in
# alignment, indexed by (src ^ dst) & 15
_WLOG = np.array([4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0], dtype=np.int32)
_LAYOUTS: dict = {}
_LAYOUTS_CAP = 64
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = library()
        if lib.armada_lanes_desc_size() != DESC.itemsize or lib.armada_lanes_tile_bytes() != TILE:
            raise RuntimeError("CopyDesc or the tile size differs between Python and csrc/lanes.cu")
        _LIB = lib
    return _LIB


def _copy(table: np.ndarray) -> None:
    """Launch the batched copy over the rows of `table` (DESC)."""
    check(_library().armada_lanes_copy(table.ctypes.data, len(table), stream_handle()),
          "lanes copy kernel")


class _Layout:
    """What one signature fixes: where each output field lies in the arena
    and the descriptor table's fixed columns.  `rows` are (index of the
    source tensor, destination offset, bytes), in the order of the table."""

    __slots__ = ("arena_bytes", "dtypes", "views", "src_idx", "dst_off", "row_bytes", "table")

    def __init__(self, out_shapes, dtypes, offsets, arena_bytes: int, rows):
        self.arena_bytes = arena_bytes
        self.dtypes = tuple(dict.fromkeys(dtypes))
        views = []
        for shape, dt, off in zip(out_shapes, dtypes, offsets):
            strides, acc = [], 1
            for d in reversed(shape):
                strides.append(acc)
                acc *= d
            views.append((dt, tuple(shape), tuple(reversed(strides)), off // dt.itemsize))
        self.views = tuple(views)
        cols = np.array(rows, dtype=np.int64).reshape(-1, 3)
        self.src_idx, self.dst_off, nbytes = (cols[:, k].copy() for k in range(3))
        self.row_bytes = nbytes
        tiles = (nbytes + TILE - 1) // TILE
        self.table = np.zeros(len(rows), DESC)
        self.table["bytes"] = nbytes
        self.table["tile0"] = np.cumsum(tiles) - tiles

    def output(self, device):
        """A fresh arena and its field views."""
        arena = torch.empty(self.arena_bytes, dtype=torch.uint8, device=device)
        typed = {dt: arena.view(dt) for dt in self.dtypes}
        return arena, [torch.as_strided(typed[dt], shape, strides, off)
                       for dt, shape, strides, off in self.views]

    def fill(self, src: np.ndarray, arena_ptr: int) -> np.ndarray:
        """A fresh table: the fixed columns with this call's addresses."""
        table = self.table.copy()
        dst = self.dst_off + arena_ptr
        table["src"] = src
        table["dst"] = dst
        table["wlog"] = _WLOG[(src ^ dst) & 15]
        return table


def _offsets(field_bytes):
    """Each field's ALIGN-aligned offset in one arena (0 for an empty
    field), and the arena's bytes."""
    offsets, pos = [], 0
    for b in field_bytes:
        offsets.append(pos if b else 0)
        pos += -(-b // ALIGN) * ALIGN
    return offsets, pos


def _layout(key, build) -> _Layout:
    layout = _LAYOUTS.get(key)
    if layout is None:
        layout = build()
        if len(_LAYOUTS) >= _LAYOUTS_CAP:
            _LAYOUTS.clear()
        _LAYOUTS[key] = layout
    return layout


_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")


def _signature(tree):
    """(shapes, dtypes) of a tree's fields."""
    try:
        return tuple(map(_SHAPE, tree)), tuple(map(_DTYPE, tree))
    except AttributeError:
        bad = next(n for n, t in zip(tree._fields, tree) if not isinstance(t, torch.Tensor))
        raise ValueError(f"{bad}: expected a tensor") from None


def _require_each(tree, dev, what: str, shapes=None, dtypes=None) -> None:
    """The checks one at a time, raising with the first failing field's
    name: a tensor, on `dev`, contiguous, of the signature's shape and
    dtype."""
    for f, (name, t) in enumerate(zip(tree._fields, tree)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{what}{name}: expected a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{what}{name}: expected a tensor on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}{name}: expected a contiguous tensor")
        if shapes is not None and (t.shape != shapes[f] or t.dtype != dtypes[f]):
            raise ValueError(f"{what}field {name} differs in shape or dtype")


def stack_plain(trees):
    """The plain version of K-E: torch.stack per field."""
    return type(trees[0])(*(torch.stack(list(lanes)) for lanes in zip(*trees)))


def slice_plain(tree, i: int):
    """The plain version of K-G: t[i].clone() per field."""
    return type(tree)(*(t[i].clone() for t in tree))


def stack(trees):
    """K-E: the P trees' fields stacked along a new leading axis.  Every
    tree must match the first in each field's shape and dtype."""
    trees = tuple(trees)
    if not trees:
        raise ValueError("stack: no lanes")
    if not trees[0][0].is_cuda:
        return stack_plain(trees)
    out, table = stack_plan(trees)
    if len(table):
        _copy(table)
        kernels.LAUNCHES["stack"] += 1
    return out


def stack_plan(trees):
    """(fresh stacked tree, descriptor table) of K-E, checked; the kernel
    run over the table fills the tree."""
    trees = tuple(trees)
    first = trees[0]
    P = len(trees)
    shapes, dtypes = _signature(first)
    dev = first[0].device

    def build():
        _require_each(first, dev, "stack: lane 0 ")
        F = len(shapes)
        lane_bytes = [math.prod(s) * dt.itemsize for s, dt in zip(shapes, dtypes)]
        offsets, arena_bytes = _offsets([P * b for b in lane_bytes])
        rows = [(li * F + f, offsets[f] + li * b, b)
                for f, b in enumerate(lane_bytes) if b for li in range(P)]
        return _Layout([(P,) + tuple(s) for s in shapes], dtypes, offsets, arena_bytes, rows)

    layout = _layout(("stack", type(first), P, shapes, dtypes), build)
    flat = tuple(itertools.chain.from_iterable(trees))
    # a tree at a time: the shapes of all P trees at once are P x 47 more
    # objects for the collector to count, and a pass of it inside the call
    if not (all(type(tree) is type(first) for tree in trees) and placed(flat, dev)
            and all(tuple(map(_SHAPE, tree)) == shapes and tuple(map(_DTYPE, tree)) == dtypes
                    for tree in trees)):
        for li, tree in enumerate(trees):
            if type(tree) is not type(first):
                raise ValueError(f"stack: lane {li} is a {type(tree).__name__}, not a "
                                 f"{type(first).__name__}")
            _require_each(tree, dev, f"stack: lane {li} ", shapes, dtypes)
    ptrs = np.fromiter(map(torch.Tensor.data_ptr, flat), np.int64, count=len(flat))
    arena, fields = layout.output(dev)
    return type(first)(*fields), layout.fill(ptrs[layout.src_idx], arena.data_ptr())


def lane_slice(tree, i: int):
    """K-G: lane `i` of a stacked tree, every field copied into a fresh
    buffer (a view of the call's one arena)."""
    if not tree[0].is_cuda:
        return slice_plain(tree, i)
    out, table = slice_plan(tree, i)
    if len(table):
        _copy(table)
        kernels.LAUNCHES["lane_slice"] += 1
    return out


def slice_plan(tree, i: int):
    """(fresh lane tree, descriptor table) of K-G, checked; as stack_plan."""
    shapes, dtypes = _signature(tree)
    dev = tree[0].device
    P = int(shapes[0][0]) if shapes[0] else 0

    def build():
        _require_each(tree, dev, "lane_slice: ")
        for name, s in zip(tree._fields, shapes):
            if len(s) == 0 or int(s[0]) != P:
                raise ValueError(f"lane_slice: field {name} has no lane axis of {P}")
        lane_bytes = [math.prod(s[1:]) * dt.itemsize for s, dt in zip(shapes, dtypes)]
        offsets, arena_bytes = _offsets(lane_bytes)
        rows = [(f, offsets[f], b) for f, b in enumerate(lane_bytes) if b]
        return _Layout([tuple(s[1:]) for s in shapes], dtypes, offsets, arena_bytes, rows)

    layout = _layout(("slice", type(tree), shapes, dtypes), build)
    if not placed(tree, dev):
        _require_each(tree, dev, "lane_slice: ")
    if not 0 <= i < P:
        raise IndexError(f"lane_slice: lane {i} of {P}")
    ptrs = np.fromiter(map(torch.Tensor.data_ptr, tree), np.int64, count=len(shapes))
    arena, fields = layout.output(dev)
    src = ptrs[layout.src_idx] + int(i) * layout.row_bytes
    return type(tree)(*fields), layout.fill(src, arena.data_ptr())


def reset_device_state() -> None:
    """Drop every cached layout and descriptor table, so the next call on the card starts from freshly zeroed
    scratch.  The watchdog's reset hooks call it on every backend transition
    (core/watchdog.py): a failed or abandoned round can stop between a
    kernel's passes and leave its scratch dirty."""
    _LAYOUTS.clear()


add_reset_hook(reset_device_state)
