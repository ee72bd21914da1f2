"""Slot-stable problem slabs: O(deltas) device update per scheduling cycle.

The incremental builder's tables give O(1) host work per delta, but a
dense problem laid out positionally shifts on every insert and removal, so
most of the 1M-row job tensors would change content every cycle.  This
module fixes the layout: every queued single, running job and gang unit
owns a SLOT whose content never moves.  Slots come from a free-list (no
compaction, no shifts); candidate order is carried entirely by the
per-cycle ``gq_gang`` permutation.  The gang axis is three fixed regions::

    [ singles 0..s_cap | evictee slots s_cap..s_cap+r_cap | units ... ]

The evictee region is a projection of the run slab (evictee slot i mirrors
run slot i), so run-slot writes dirty both axes at once.  Slots not in the
current cycle's problem (free-list holes, jobs beyond the queue lookback,
unknown-queue rows, unit slack) are marked ``g_absent`` so the round gives
them state 3 (absent), which decode ignores.

Per cycle the builder emits a :class:`DeltaBundle` -- dirty slot ids and
their rows, the rebuilt order/queue tensors, and scalars -- and
:class:`DeviceDeltaCache` applies it to the device-resident problem with
one scatter program: kernel K-H (csrc/slab.cu) on a card, ``apply_delta_plain``
on the CPU.  Both keep the JAX program's functional semantics: the apply
returns a new problem and never writes into a tensor of the previous one,
so a round in flight, its verify and explain passes and a rollback re-run
all see the state they started from.  Exactness: slot content is written
once per logical row, and the bundle carries a ``materialize`` thunk that
builds the complete host problem; the scattered device state equals a
fresh upload of it bit for bit (tests/test_torch_slab.py).

Replaces the JAX package's armada_tpu/models/slab.py, with its trace spans
(`devcache_apply`, `scatter_content`) and its race-harness generation
checks (analysis/tsan.py).  Every upload goes to
core/watchdog.data_device(): the CPU while the supervisor is degraded, else
the cache's device; a resident problem on another device than that is
dropped at the next apply, which then uploads whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from armada_tpu_torch.analysis.tsan import GenerationGuard
from armada_tpu_torch.core.watchdog import data_device, launch_guard
from armada_tpu_torch.models.xfer import TRANSFER_STATS
from armada_tpu_torch.ops.scatter import set_drop
from armada_tpu_torch.ops.trace import recorder as _trace

_ID_DTYPE = "S48"

# Dirty-index buckets: scatter index vectors are padded to these sizes so
# the apply's shapes change only on bucket crossings.
_IDX_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144, 1048576)


def _pad_bucket(n: int) -> int:
    for b in _IDX_BUCKETS:
        if n <= b:
            return b
    return n


def _grow2(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _pad_rows(arr: np.ndarray, k: int) -> np.ndarray:
    if arr.shape[0] == k:
        return arr
    out = np.zeros((k,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class RowSlab:
    """Append-only columnar slot store with free-list reuse.

    Content at a slot is immutable while the slot is held; ``write_batch``
    marks slots dirty, ``release`` invalidates (valid=False) and returns to
    the free-list.  ``epoch`` bumps when capacity grows: all content must
    re-upload, and shapes changed anyway so the kernel recompiles."""

    def __init__(self, num_resources: int, columns: dict, bucket: int):
        self.R = num_resources
        self.bucket = max(64, bucket)
        self.cap = 0
        self.hw = 0  # high-water mark
        self.free: list[int] = []
        self.epoch = 0
        self._columns = dict(columns)  # name -> dtype (besides req/ids/valid)
        self.req = np.zeros((0, num_resources), np.float32)
        self.ids = np.zeros((0,), _ID_DTYPE)
        self.valid = np.zeros((0,), bool)
        for name, dt in self._columns.items():
            setattr(self, name, np.zeros((0,), dt))
        # Mutation log of dirtied slots; assemble_delta drains and clears
        # it once per cycle (single consumer; a skipped bundle is caught by
        # the DeltaBundle seq guard and forces a full upload).
        self.dirty_log: list[int] = []
        # Copy-on-write guard for the ids vector: share_ids() hands the
        # CURRENT array to a decode context; the next in-place id write
        # copies first, so the snapshot costs nothing on mutation-free
        # cycles and otherwise lands in the overlapped decode shadow.
        self._ids_shared = False

    def _grow(self, need: int) -> None:
        # GEOMETRIC growth (>=1.5x), not fixed-bucket: the slab cap IS the
        # padded problem axis, and every cap change forces a full upload
        # (and, in the JAX package, a recompile of every program).
        # Geometric caps make crossings logarithmic in backlog growth; the
        # bucket stays the floor and the alignment grain.
        new_cap = self.cap
        while new_cap < need:
            scaled = int(new_cap * 1.5)
            new_cap = max(
                new_cap + self.bucket,
                # ceil-aligned so the >=1.5x guarantee actually holds
                ((scaled + self.bucket - 1) // self.bucket) * self.bucket,
            )
        self.req = _grow2(self.req, new_cap)
        self.ids = _grow2(self.ids, new_cap)  # fresh object: snapshots keep the old one
        self._ids_shared = False
        self.valid = _grow2(self.valid, new_cap)
        for name in self._columns:
            setattr(self, name, _grow2(getattr(self, name), new_cap))
        self.cap = new_cap
        self.epoch += 1

    def alloc(self, n: int = 1) -> np.ndarray:
        take = min(n, len(self.free))
        slots = [self.free.pop() for _ in range(take)]
        fresh = n - take
        if fresh:
            if self.hw + fresh > self.cap:
                self._grow(self.hw + fresh)
            slots.extend(range(self.hw, self.hw + fresh))
            self.hw += fresh
        return np.asarray(slots, np.int64)

    def share_ids(self) -> np.ndarray:
        """Snapshot of the ids vector for a decode context (copy-on-write)."""
        self._ids_shared = True
        return self.ids

    def _own_ids(self) -> None:
        if self._ids_shared:
            self.ids = self.ids.copy()
            self._ids_shared = False

    def write_batch(self, slots: np.ndarray, ids, reqs, **cols) -> None:
        self.req[slots] = reqs
        self._own_ids()
        self.ids[slots] = ids
        self.valid[slots] = True
        for name, vals in cols.items():
            getattr(self, name)[slots] = vals
        self.dirty_log.extend(int(s) for s in slots)

    def release(self, slot: int) -> None:
        self.valid[slot] = False
        self._own_ids()
        self.ids[slot] = b""
        self.free.append(slot)
        self.dirty_log.append(slot)

    def set_valid(self, slots: np.ndarray, value) -> None:
        """Participation flips (lookback/queue/node filters); content stays."""
        if len(slots):
            self.valid[slots] = value
            self.dirty_log.extend(int(s) for s in slots)


@dataclasses.dataclass
class DeltaBundle:
    """One cycle's device update.

    `sig` guards shape/epoch compatibility: a mismatch with the device
    cache's stored sig (slab growth, node-fleet change, first cycle) falls
    back to a full upload via `materialize()`.  `materialize` is a thunk
    building the complete current host-side SchedulingProblem -- the ground
    truth the scatter path must reproduce exactly.  It closes over live
    slab state: call it before any further builder mutation.

    `gq_splice`: when set, the per-cycle candidate-order vector gq_gang is
    NOT shipped whole (4MB at 1M gangs, the dominant per-cycle upload).
    Instead the device rebuilds it
    from ITS previous gq: (rem_pos, ins_pos, ins_val) -- positions removed
    from the previous order, plus (final position, slot) pairs inserted --
    a few KB in steady state.  The builder only emits a splice when the
    surviving candidates' relative order is unchanged (verified host-side
    against its own previous gq); anything else ships the full vector."""

    sig: tuple
    seq: int  # consecutive-cycle guard: a skipped bundle forces full upload
    materialize: object  # () -> SchedulingProblem of host arrays (ground truth)
    ev_base: int  # gang-axis offset of the evictee region (= s_cap)
    sg_idx: np.ndarray  # gang-axis dirty slots (singles + units regions)
    sg_cols: dict  # field -> rows at sg_idx
    rr_idx: np.ndarray  # run-axis dirty slots
    rr_cols: dict  # run_* field -> rows at rr_idx
    ev_cols: dict  # evictee g-row field -> rows at ev_base + rr_idx
    fulls: dict  # field name -> host array re-uploaded whole (identity-skipped)
    gq_splice: tuple = None  # (rem_pos[R], ins_pos[M], ins_val[M]) or None

    def stats_view(self):
        """The small host tensors run_round_on_device / queue-stats read
        (problem.market, q_weight, ...) without materializing the problem."""
        import types

        f = self.fulls
        return types.SimpleNamespace(
            market=f["market"],
            q_weight=f["q_weight"],
            q_cds=f["q_cds"],
            total_pool=f["total_pool"],
            drf_mult=f["drf_mult"],
            q_penalty=f["q_penalty"],
        )


# Node-axis fields: identity-cached (same array objects across cycles while
# the fleet is unchanged), re-uploaded only on node-epoch change.
_NODE_FIELDS = (
    "node_total", "node_type", "node_ok", "compat",
    "type_bias", "key_type_row", "compat_pre_type",
)

_SG_FIELDS = (
    "g_req", "g_card", "g_level", "g_queue", "g_key", "g_pc", "g_run",
    "g_valid", "g_absent", "g_price", "g_spot_price", "g_ban_row",
)
_RR_FIELDS = (
    "run_req", "run_node", "run_level", "run_queue", "run_pc",
    "run_preemptible", "run_gang", "run_valid",
)
_EV_FIELDS = (
    "g_req", "g_level", "g_queue", "g_pc", "g_run", "g_valid", "g_absent",
    "g_price", "g_spot_price",
)


def apply_delta_plain(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args,
                      *, ev_base: int, splice: bool):
    """The plain version of kernel K-H: the JAX package's `apply_delta`.

    Scatters one cycle's dirty rows into a copy of the device-resident
    problem.  Index vectors are bucket-padded; padding entries carry the
    sentinel G (gang axis) or RJ (run axis) and are dropped; the evictee
    projection maps run sentinels to G explicitly so they cannot land on the
    units region.

    splice=True rebuilds gq_gang from prev.gq_gang and (rem_pos, ins_pos,
    ins_val): delete the removed positions, close the gaps, and write the
    inserted (final position, slot) pairs."""
    out = prev._asdict()
    G = prev.g_req.shape[0]
    RJ = prev.run_req.shape[0]
    dev = prev.g_req.device
    out.update(fulls)
    if splice:
        rem_pos, ins_pos, ins_val = gq_args
        gq_prev = prev.gq_gang
        keep = set_drop(torch.ones((G,), dtype=torch.bool, device=dev), rem_pos,
                        torch.zeros(rem_pos.shape, dtype=torch.bool, device=dev))
        # compact the kept entries: kept_buf[j] = j-th kept prev value
        krank = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
        kept_buf = set_drop(torch.zeros((G,), dtype=gq_prev.dtype, device=dev),
                            torch.where(keep, krank, torch.full_like(krank, G)), gq_prev)
        # final position p: an inserted entry, or the next kept entry
        occupied = set_drop(torch.zeros((G,), dtype=torch.bool, device=dev), ins_pos,
                            torch.ones(ins_pos.shape, dtype=torch.bool, device=dev))
        kidx = torch.cumsum((~occupied).to(torch.int32), 0, dtype=torch.int32) - 1
        gq = torch.where(occupied, torch.zeros((), dtype=gq_prev.dtype, device=dev),
                         kept_buf[kidx.long()])
        out["gq_gang"] = set_drop(gq, ins_pos, ins_val)
    for name in _SG_FIELDS:
        out[name] = set_drop(out[name], sg_idx, sg_cols[name])
    for name in _RR_FIELDS:
        out[name] = set_drop(out[name], rr_idx, rr_cols[name])
    ev_idx = torch.where(rr_idx >= RJ, torch.full_like(rr_idx, G), rr_idx + ev_base)
    for name in _EV_FIELDS:
        out[name] = set_drop(out[name], ev_idx, ev_cols[name])
    return type(prev)(**out)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller passes device='cpu'"
        )
    return device


class DeviceDeltaCache:
    """Device-resident SchedulingProblem updated by DeltaBundle scatters.

    A full upload happens whenever the bundle's shape/epoch signature
    changes (slab growth, node-fleet change, first cycle) or a bundle was
    skipped (seq gap) -- the JAX package's own semantics.  `device` is where
    the problem lives: the card unless the caller passes device='cpu' (or
    the CPU while the watchdog's supervisor is degraded)."""

    def __init__(self, device="cuda"):
        self.device = _resolve_device(device)
        # where this apply uploads: data_device(self.device), resolved at
        # each apply's entry and pinned for the call
        self._dev = self.device
        # the scatter program fork() gave this cache; None: `_apply_fn()`'s
        # default, kernels.slab.apply_delta (K-H on a card, the plain
        # version on the CPU)
        self._apply = None
        self._sig = None
        self._seq = None
        self._prev = None
        self.splice_applies = 0  # cycles where gq rode the device splice
        self.content_prefetches = 0  # scatter_content applications
        self.resets = 0
        self.last_apply = None  # "full", "noop" or "scatter": what apply() did
        # host-object identity of what is currently on the device, per
        # field; node tensors also keep their device copy for reuse across
        # full uploads (the fleet rarely changes).
        self._host_ids: dict = {}
        self._node_dev: dict = {}
        # Race harness (analysis/tsan, ARMADA_TSAN=1): every mutation must
        # commit under the generation it began under; reset() bumps.  An
        # abandoned watchdog worker finishing a scatter after a reset is
        # recorded as a violation.
        self._tsan = GenerationGuard("devcache")

    def fork(self, apply_fn=None) -> "DeviceDeltaCache":
        """A copy of this cache at its current state that scatters with
        `apply_fn` -- used to hold the kernel against its plain version on
        the same previous problem and bundle.  The two share the resident
        tensors, which neither ever writes (the apply is functional)."""
        twin = type(self).__new__(type(self))
        twin.__dict__.update(self.__dict__)
        twin._host_ids = dict(self._host_ids)
        twin._node_dev = dict(self._node_dev)
        twin._apply = apply_fn
        return twin

    def reset(self) -> None:
        """Drop everything that refers to device buffers (the resident
        problem, the seq chain, the reusable node-tensor copies), so the
        next apply() is a full upload to the device the supervisor targets
        then."""
        self._tsan.bump()
        self._sig = None
        self._seq = None
        self._prev = None
        self._host_ids = {}
        self._node_dev = {}
        self.resets += 1

    @property
    def resident(self):
        """The device-resident problem the last apply produced (or None)."""
        return self._prev

    def _to_device(self, arr, name=None) -> torch.Tensor:
        """Upload one host array to the cache's device.  `name` is the
        problem field (None for unnamed payloads); the mesh cache overrides
        this to place each field in its mesh layout."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self._dev)
        # a copy: later host mutations never reach the device state, and
        # 0-d scalars stay 0-d
        return torch.tensor(np.asarray(arr), device=self._dev)

    def _count_up(self, arr, name=None) -> None:
        """Per-field upload accounting; the mesh cache overrides it to count
        the per-shard bytes of node-axis-sharded fields."""
        TRANSFER_STATS.count_up(np.asarray(arr).nbytes)

    def _apply_fn(self):
        """The scatter program this cache applies deltas with: the one
        fork() gave it, else K-H's wrapper; the mesh cache's default is its
        mesh's (parallel/mesh_slab.py)."""
        from armada_tpu_torch.kernels.slab import apply_delta

        return self._apply if self._apply is not None else apply_delta

    def _to_device_async(self, arr) -> torch.Tensor:
        """A copy of a host array on the device that does not wait for the
        stream.  On a card it is staged through pinned memory: a copy from
        pageable memory waits for the stream to drain, and the content
        prefetch uploads its rows while a round is still on the card."""
        if self._dev.type != "cuda":
            return self._to_device(arr)
        arr = np.asarray(arr)
        host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
        host.numpy()[...] = arr
        return host.to(self._dev, non_blocking=True)

    def _full_upload(self, problem):
        out = []
        for name, arr in zip(problem._fields, problem):
            if name in _NODE_FIELDS and self._host_ids.get(name) is arr and name in self._node_dev:
                out.append(self._node_dev[name])
            else:
                self._count_up(arr, name)
                dev = self._to_device(arr, name)
                if name in _NODE_FIELDS:
                    self._node_dev[name] = dev
                out.append(dev)
            self._host_ids[name] = arr
        from armada_tpu_torch.models.problem import SchedulingProblem

        self._prev = SchedulingProblem(*out)
        return self._prev

    def _upload_rows(self, idx: np.ndarray, sentinel: int, cols: dict, names) -> tuple:
        """Bucket-pad an index vector (sentinel entries are dropped by the
        scatter) and its row columns, and upload them."""
        k = _pad_bucket(idx.shape[0])
        pad = np.full((k,), sentinel, np.int32)
        pad[: idx.shape[0]] = idx
        self._count_up(pad)
        rows = {}
        for n in names:
            arr = _pad_rows(np.asarray(cols[n]), k)
            self._count_up(arr)
            rows[n] = self._to_device_async(arr)
        return self._to_device_async(pad), rows

    def _scatter(self, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args, ev_base,
                 splice):
        apply_fn = self._apply_fn()
        G = self._prev.g_req.shape[0]
        RJ = self._prev.run_req.shape[0]
        sg_i, sg_rows = self._upload_rows(sg_idx, G, sg_cols, _SG_FIELDS)
        rr_i, rr_rows = self._upload_rows(rr_idx, RJ, rr_cols, _RR_FIELDS)
        _, ev_rows = self._upload_rows(rr_idx, RJ, ev_cols, _EV_FIELDS)
        return apply_fn(self._prev, sg_i, sg_rows, rr_i, rr_rows, ev_rows, fulls, gq_args,
                        ev_base=int(ev_base), splice=splice)

    def _sync_device(self) -> None:
        """Entry guard of apply()/scatter_content(): resolve where this call
        uploads (the CPU while the supervisor is degraded), and drop a
        resident problem that lies elsewhere -- the next apply is then a
        full upload from the host tables; nothing is copied off the card."""
        launch_guard("slab apply")
        dev = data_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._dev = dev
        if self._prev is not None and self._prev.g_req.device != dev:
            self.reset()

    def apply(self, bundle: DeltaBundle):
        self._sync_device()
        tok = self._tsan.begin()
        if (
            self._sig != bundle.sig
            or self._prev is None
            or self._seq is None
            or bundle.seq != self._seq + 1
        ):
            self._sig = bundle.sig
            self._seq = bundle.seq
            self.last_apply = "full"
            with _trace().span("devcache_apply", full_upload=True):
                problem = bundle.materialize()
                self._tsan.commit(tok, "apply/full-upload")
                return self._full_upload(problem)
        self._seq = bundle.seq

        # Steady-state no-op: a cycle that changed nothing -- no dirty gang
        # or run rows, an empty gq splice, and every full-field payload
        # equal to what is resident (identity for big tables, value
        # equality for the small per-cycle scalars and vectors) -- keeps
        # the resident problem untouched; bit-exact by construction.
        if (
            bundle.sg_idx.shape[0] == 0
            and bundle.rr_idx.shape[0] == 0
            and bundle.gq_splice is not None
            and bundle.gq_splice[0].shape[0] == 0
            and bundle.gq_splice[1].shape[0] == 0
            and all(
                self._host_ids.get(name) is arr
                or (
                    getattr(arr, "nbytes", 1 << 30) <= 4096
                    and np.array_equal(arr, self._host_ids.get(name))
                )
                for name, arr in bundle.fulls.items()
            )
        ):
            self._tsan.commit(tok, "apply/steady-noop")
            self.last_apply = "noop"
            return self._prev

        with _trace().span(
            "devcache_apply",
            full_upload=False,
            sg_rows=int(bundle.sg_idx.shape[0]),
            rr_rows=int(bundle.rr_idx.shape[0]),
            splice=bundle.gq_splice is not None,
        ):
            self._tsan.commit(tok, "apply/scatter")
            return self._apply_scatter(bundle)

    def _apply_scatter(self, bundle: DeltaBundle):
        G = self._prev.g_req.shape[0]
        fulls = {}
        for name, arr in bundle.fulls.items():
            if self._host_ids.get(name) is arr:
                continue  # unchanged object, the device copy is current
            self._count_up(arr, name)
            dev = self._to_device(arr, name)
            if name in _NODE_FIELDS:
                # keep the reusable device copy current, else a later full
                # upload would resurrect a stale buffer
                self._node_dev[name] = dev
            fulls[name] = dev
            self._host_ids[name] = arr
        splice = bundle.gq_splice is not None
        if splice:
            rem, ins, vals = bundle.gq_splice
            kq = _pad_bucket(max(rem.shape[0], ins.shape[0]))
            rem_pos = np.full((kq,), G, np.int32)
            rem_pos[: rem.shape[0]] = rem
            ins_pos = np.full((kq,), G, np.int32)
            ins_pos[: ins.shape[0]] = ins
            ins_val = np.zeros((kq,), np.int32)
            ins_val[: ins.shape[0]] = vals
            for arr in (rem_pos, ins_pos, ins_val):
                self._count_up(arr)
            gq_args = tuple(self._to_device(a) for a in (rem_pos, ins_pos, ins_val))
            self.splice_applies += 1
        else:
            gq_args = ()
        self.last_apply = "scatter"
        self._prev = self._scatter(
            bundle.sg_idx, bundle.sg_cols, bundle.rr_idx, bundle.rr_cols, bundle.ev_cols,
            fulls, gq_args, bundle.ev_base, splice,
        )
        return self._prev

    def scatter_content(
        self, *, sig, seq, ev_base, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols
    ) -> bool:
        """Content-only prefetch: scatter already-final slot rows into the
        device problem without a cycle bundle, while the current round and
        its decode are in flight, so the next bundle only carries the rows
        that had to wait for decode.  This is the decision-independent half
        of the delta stream (no order vectors, queue tensors or scalars); it
        never consumes a seq.  Like apply(), it builds a new problem and
        leaves the tensors a dispatched round reads untouched.

        Guards: same sig and the very next seq as the last bundle; anything
        else returns False and the rows ride the next bundle."""
        self._sync_device()
        tok = self._tsan.begin()
        if (
            self._prev is None
            or self._sig != sig
            or self._seq is None
            or seq != self._seq + 1
        ):
            return False
        with _trace().span("scatter_content", sg_rows=int(sg_idx.shape[0]),
                           rr_rows=int(rr_idx.shape[0])):
            self._tsan.commit(tok, "scatter_content")
            self._prev = self._scatter(sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, {}, (),
                                       ev_base, False)
        self.content_prefetches += 1
        return True
