"""Wrapper of kernel K-H (csrc/slab.cu): the slab delta apply.

The apply is functional, as the JAX program is: every field the bundle
touches gets a fresh buffer here, the kernel copies the previous field into
it and scatters the dirty rows into the copy, and the previous problem's
tensors are never written.  CPU problems run the plain version
(models/slab.py apply_delta_plain)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

MAX_FIELDS = 16
MAX_COPIES = 48


class SlabField(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("rows", ctypes.c_void_p),
                ("dst_rows", ctypes.c_longlong), ("row_bytes", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class SlabGroup(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_void_p), ("k", ctypes.c_int), ("nf", ctypes.c_int),
                ("ev", ctypes.c_int), ("run_limit", ctypes.c_int), ("ev_base", ctypes.c_int),
                ("gang_axis", ctypes.c_int), ("f", SlabField * MAX_FIELDS)]


class SlabCopy(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("nbytes", ctypes.c_longlong)]


class SlabArgs(ctypes.Structure):
    _fields_ = [("copies", SlabCopy * MAX_COPIES), ("groups", SlabGroup * 3),
                ("ncopies", ctypes.c_int), ("ngroups", ctypes.c_int)]


class SpliceArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "gq_prev", "rem_pos", "ins_pos", "ins_val", "out", "removed", "occupied", "kept_buf",
        "counts")] + [("G", ctypes.c_int), ("kq", ctypes.c_int)]


def _row_bytes(t: torch.Tensor) -> int:
    return int(t[0].numel() * t.element_size()) if t.shape[0] else 0


def _splice(gq_prev, rem_pos, ins_pos, ins_val):
    lib = library()
    G = int(gq_prev.shape[0])
    kq = int(rem_pos.shape[0])
    for name, t in (("rem_pos", rem_pos), ("ins_pos", ins_pos), ("ins_val", ins_val)):
        require_cuda(t, name, torch.int32, 1)
        if int(t.shape[0]) != kq:
            raise ValueError("apply_delta: splice vectors differ in length")
    dev = gq_prev.device
    out = torch.empty_like(gq_prev)
    removed = torch.empty((G,), dtype=torch.uint8, device=dev)
    occupied = torch.empty((G,), dtype=torch.uint8, device=dev)
    kept = torch.empty((G,), dtype=torch.int32, device=dev)
    nb = max(1, -(-G // 1024))
    counts = torch.empty((2 * nb,), dtype=torch.int32, device=dev)
    a = SpliceArgs()
    for name, t in (("gq_prev", gq_prev), ("rem_pos", rem_pos), ("ins_pos", ins_pos),
                    ("ins_val", ins_val), ("out", out), ("removed", removed),
                    ("occupied", occupied), ("kept_buf", kept), ("counts", counts)):
        setattr(a, name, t.data_ptr())
    a.G, a.kq = G, kq
    if ctypes.sizeof(SpliceArgs) != lib.armada_splice_args_size():
        raise RuntimeError("SpliceArgs layout differs between Python and csrc/slab.cu")
    check(lib.armada_slab_splice(ctypes.byref(a), stream_handle()), "slab splice kernel")
    return out


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
    from armada_tpu_torch.models.slab import (
        _EV_FIELDS, _RR_FIELDS, _SG_FIELDS, apply_delta_plain,
    )

    if mesh is not None:
        N = int(prev.node_total.shape[0])
        if N % mesh.node_shards or int(prev.g_req.shape[0]) % mesh.job_shards:
            raise ValueError(f"sharded apply: the resident problem (N={N}) does not divide into "
                             f"the mesh's {mesh.node_shards} x {mesh.job_shards} shards")
    if not prev.g_req.is_cuda:
        return apply_delta_plain(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls,
                                 gq_args, ev_base=ev_base, splice=splice)
    lib = library()
    if (ctypes.sizeof(SlabArgs) != lib.armada_slab_args_size()
            or ctypes.sizeof(SlabGroup) != lib.armada_slab_group_size()):
        raise RuntimeError("SlabArgs layout differs between Python and csrc/slab.cu")
    G = int(prev.g_req.shape[0])
    RJ = int(prev.run_req.shape[0])
    out = prev._asdict()
    for name, t in fulls.items():
        require_cuda(t, name, out[name].dtype)
        out[name] = t
    require_cuda(sg_idx, "sg_idx", torch.int32, 1)
    require_cuda(rr_idx, "rr_idx", torch.int32, 1)
    # one fresh buffer per touched field, filled by the kernel's copy
    fresh: dict = {}
    a = SlabArgs()
    for name in dict.fromkeys(_SG_FIELDS + _RR_FIELDS + _EV_FIELDS):
        src = out[name]
        require_cuda(src, name, src.dtype)
        fresh[name] = torch.empty_like(src)
        c = a.copies[len(fresh) - 1]
        c.dst, c.src = fresh[name].data_ptr(), src.data_ptr()
        c.nbytes = src.numel() * src.element_size()
    a.ncopies = len(fresh)
    groups = ((sg_idx, sg_cols, _SG_FIELDS, 0), (rr_idx, rr_cols, _RR_FIELDS, 0),
              (rr_idx, ev_cols, _EV_FIELDS, 1))
    for gi, (idx, cols, names, ev) in enumerate(groups):
        g = a.groups[gi]
        g.idx, g.k, g.nf, g.ev = idx.data_ptr(), int(idx.shape[0]), len(names), ev
        g.run_limit, g.ev_base, g.gang_axis = RJ, int(ev_base), G
        for fi, name in enumerate(names):
            rows = cols[name]
            dst = fresh[name]
            require_cuda(rows, f"{name} rows", dst.dtype)
            if rows.shape[1:] != dst.shape[1:] or int(rows.shape[0]) != int(idx.shape[0]):
                raise ValueError(f"apply_delta: {name} rows have shape {tuple(rows.shape)}")
            f = g.f[fi]
            f.dst, f.rows = dst.data_ptr(), rows.data_ptr()
            f.dst_rows, f.row_bytes = int(dst.shape[0]), _row_bytes(dst)
    a.ngroups = 3
    check(lib.armada_slab_scatter(ctypes.byref(a), stream_handle()), "slab scatter kernel")
    out.update(fresh)
    if splice:
        out["gq_gang"] = _splice(prev.gq_gang, *gq_args)
    kernels.LAUNCHES["slab" if mesh is None else "slab_sharded"] += 1
    return type(prev)(**out)
