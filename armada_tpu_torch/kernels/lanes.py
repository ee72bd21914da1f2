"""Wrappers of kernels K-E and K-G (csrc/lanes.cu): stacking pool problems
along a leading lane axis, and slicing one lane back out, each as ONE
batched-copy launch over every field.

Both take and return NamedTuples of tensors (SchedulingProblem,
RoundResult).  CUDA tensors run the kernel; CPU tensors the plain versions
(`stack_plain`, `slice_plain`).  Like the JAX programs they replace, both
return fresh buffers: nothing aliases the inputs."""

from __future__ import annotations

import numpy as np
import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, stream_handle


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _copy(descs: list) -> None:
    """Launch the batched copy over `descs`, (src, dst, bytes) triples: one
    int64 [n, 3] table, the layout of csrc/lanes.cu's CopyDesc."""
    lib = library()
    if lib.armada_lanes_desc_size() != 24:
        raise RuntimeError("CopyDesc layout differs between Python and csrc/lanes.cu")
    table = np.asarray(descs, dtype=np.int64).reshape(-1, 3)
    check(lib.armada_lanes_copy(table.ctypes.data, len(descs), stream_handle()),
          "lanes copy kernel")


def _require(t, name: str, dev) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda or t.device != dev:
        raise ValueError(f"{name}: expected a CUDA tensor on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stack_plain(trees):
    """The plain version of K-E: torch.stack per field."""
    return type(trees[0])(*(torch.stack(list(lanes)) for lanes in zip(*trees)))


def slice_plain(tree, i: int):
    """The plain version of K-G: t[i].clone() per field."""
    return type(tree)(*(t[i].clone() for t in tree))


def stack(trees):
    """K-E: the P trees' fields stacked along a new leading axis.  Every
    tree must match the first in each field's shape and dtype."""
    trees = list(trees)
    if not trees:
        raise ValueError("stack: no lanes")
    if not trees[0][0].is_cuda:
        return stack_plain(trees)
    out, descs = stack_plan(trees)
    _copy(descs)
    kernels.LAUNCHES["stack"] += 1
    return out


def stack_plan(trees):
    """(fresh stacked tree, copy descriptors) of K-E, checked; `_copy`
    of the descriptors fills the tree."""
    first = trees[0]
    dev = first[0].device
    P = len(trees)
    outs, descs = [], []
    for f, name in enumerate(first._fields):
        ref = first[f]
        out = torch.empty((P,) + tuple(ref.shape), dtype=ref.dtype, device=dev)
        lane_bytes = _nbytes(ref)
        for li, tree in enumerate(trees):
            t = tree[f]
            _require(t, name, dev)
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(f"stack: lane {li} field {name} differs in shape or dtype")
            if lane_bytes:
                descs.append((t.data_ptr(), out.data_ptr() + li * lane_bytes, lane_bytes))
        outs.append(out)
    return type(first)(*outs), descs


def lane_slice(tree, i: int):
    """K-G: lane `i` of a stacked tree, every field copied into a fresh
    buffer."""
    if not tree[0].is_cuda:
        return slice_plain(tree, i)
    out, descs = slice_plan(tree, i)
    _copy(descs)
    kernels.LAUNCHES["lane_slice"] += 1
    return out


def slice_plan(tree, i: int):
    """(fresh lane tree, copy descriptors) of K-G, checked."""
    dev = tree[0].device
    P = int(tree[0].shape[0])
    if not 0 <= i < P:
        raise IndexError(f"lane_slice: lane {i} of {P}")
    outs, descs = [], []
    for name, t in zip(tree._fields, tree):
        _require(t, name, dev)
        if t.dim() == 0 or int(t.shape[0]) != P:
            raise ValueError(f"lane_slice: field {name} has no lane axis of {P}")
        out = torch.empty(tuple(t.shape[1:]), dtype=t.dtype, device=dev)
        lane_bytes = _nbytes(out)
        if lane_bytes:
            descs.append((t.data_ptr() + i * lane_bytes, out.data_ptr(), lane_bytes))
        outs.append(out)
    return type(tree)(*outs), descs
