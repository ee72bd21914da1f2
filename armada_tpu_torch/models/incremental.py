"""Incremental problem state: device-ready tensors maintained across cycles.

The reference keeps its jobDb and nodeDb alive between scheduling cycles and
applies event deltas (internal/scheduler/scheduler.go:240-246 "skip creating
state from scratch"); rebuilding the dense SchedulingProblem from host
objects every cycle costs ~10us of Python per job, which at 1M queued jobs
dwarfs the round itself.  This module is the alternative: a columnar backlog kept SORTED
between cycles, where

  * per-delta work (submit / remove / reprioritise / lease / unlease) is O(1)
    Python per touched job -- the only place a JobSpec object is ever read;
  * per-cycle work (`assemble`) is pure vectorized numpy over the columns:
    no per-job Python, no re-sorting (the tables stay sorted; inserts find
    their slot by binary refinement at delta time);
  * the output is the same `SchedulingProblem` pytree the kernel compiles
    against, so `schedule_round` is unchanged and `decode_result` only gains
    a vectorized id path.

Sorted order is the ONE scheduling order (core.ordering scheduling_order_key,
reference jobdb/comparison.go): tables are sorted by
(queue, -pc_priority, priority, submit_time, id), so the per-queue candidate
slices fall out of the stored order instead of a lexsort (a string-keyed
lexsort at 1M rows costs ~3.5s -- measured; keeping the order is ~30x cheaper
than recreating it).

Market-driven pools order by (-bid_price, submit_time, id) instead
(scheduling/market_iterator.go:245), and prices move between cycles -- but a
job's price BAND is immutable and the price is a function of (queue, band)
(pkg/bidstore).  So market tables sort by (queue, band, submit_time, id): the
stored order is cycle-stable, and the per-cycle "bid re-sort" reduces to
permuting whole contiguous (queue, band) slices by current price
(`_market_perm`), O(bands) bookkeeping + one index gather -- never a row
sort.  Bands tied on price are merged exactly by (submit_time, id).

Gang jobs and retry-banned jobs ride a small per-cycle Python path (they are
a sliver of a 1M-job backlog); singleton jobs never touch Python after
submission.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from armada_tpu_torch.analysis.tsan import check_generation as _tsan_check_gen
from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.keys import (
    NodeTypeIndex,
    SchedulingKeyIndex,
    static_fit_matrix,
    type_score_tables,
)
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob
from armada_tpu_torch.models.problem import (
    HostContext,
    SchedulingProblem,
    _pad,
)
from armada_tpu_torch.ops.trace import recorder as _trace


def _node_bucket(bucket: int) -> int:
    """Node-axis pad bucket: min(bucket, 1024) -- the kernel scans O(Q) per
    iteration and node churn is rare, so the node axis takes a smaller
    bucket than the job axis -- rounded up to the mesh serving shard
    multiple (parallel/serving.mesh_axis_multiple, 1 when mesh serving is
    off), so a node-axis-sharded slab always divides the mesh:
    divisibility is a build-time property, never a mid-serve error."""
    nb = min(bucket, 1024)
    from armada_tpu_torch.parallel.serving import mesh_axis_multiple

    mult = mesh_axis_multiple()
    if mult > 1:
        nb = ((nb + mult - 1) // mult) * mult
    return nb


_INF = np.float32(3.0e38)
_ID_DTYPE = "S48"


def _grow(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _lex_equal_ranges(
    cols: Sequence[np.ndarray],
    vals_by_col: Sequence[np.ndarray],
    lo: np.ndarray,
    hi: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized lexicographic equal-range narrowing over sorted columns.

    For k probes, narrow each probe's [lo[i], hi[i]) to the equal-range of
    its column tuple -- bit-identical bounds to the scalar per-column
    searchsorted refinement (lo[i] is the probe's 'left' insertion point
    even when the final range is empty), but the searchsorted calls run
    per RUN of probes sharing a range instead of two numpy dispatches per
    probe per column.  A soak profile measured the scalar form
    as the steady cycle's hottest host loop: ~47k searchsorted calls per
    cycle across insert_batch/remove_many at 1k-row batches (~0.7us of
    dispatch each); grouped, a 1k batch over 64 queues needs a few hundred
    vectorized calls.

    `vals_by_col` entries MUST be dtype-matched to their column (a
    mismatched probe array promotes-and-copies the column, the
    searchsorted lesson); callers build them with np.asarray(..., col.dtype).
    Probes need no ordering for correctness (searchsorted probes its array
    elements independently); callers pass them in table order so runs stay
    contiguous and the grouping pays off.  lo/hi are mutated in place.
    """
    for a, vals in zip(cols, vals_by_col):
        span = hi - lo
        # Singleton ranges (the common case once a float column has
        # refined) have searchsorted's closed form -- one vectorized
        # gather + compare for ALL of them, no per-run python at all.
        m1 = span == 1
        if m1.any():
            idx = lo[m1]
            av = a[idx]
            v = vals[m1]
            lo[m1] = idx + (av < v)
            hi[m1] = idx + (av <= v)
        # Multi-row ranges: contiguous runs of identical (lo, hi); a
        # non-empty equal-range is shared only by probes agreeing on every
        # earlier column, so one sorted segment serves the whole run.
        multi = np.flatnonzero(span > 1)
        if not multi.size:
            continue
        mlo = lo[multi]
        bounds = np.flatnonzero(np.diff(mlo) != 0) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [multi.size]))
        for s, e in zip(starts, ends):
            sel = multi[s:e]
            l0, h0 = int(mlo[s]), int(hi[sel[0]])
            seg = a[l0:h0]
            vs = vals[sel]
            # lint: allow(searchsorted-dtype) -- vals_by_col entries are np.asarray(..., col.dtype) by contract (docstring)
            lo[sel] = l0 + seg.searchsorted(vs, "left")
            hi[sel] = l0 + seg.searchsorted(vs, "right")  # lint: allow(searchsorted-dtype) -- same coerced array
    return lo, hi


class _SortedTable:
    """Columnar store kept sorted by `sort_cols` (default
    (qi, npc, prio, sub, id); market tables use (qi, band, sub, id)).

    `extra` declares additional numeric columns beyond the sort key and the
    [*, R] request matrix.  Rows are located by binary refinement on the sort
    key (kept per id in `key_of_id`), never by a positional index -- inserts
    shift positions, and rebuilding a 1M-entry dict per cycle would cost the
    second the whole design is buying back.  Removal tombstones via `alive`;
    compaction runs when tombstones pass 25%.

    LSM layout : physical rows [0, sorted_n)
    are the sorted BASE; rows [sorted_n, n) are the OVERLAY -- recent
    inserts kept in the same key order among themselves, with ``ov_pos[j]``
    = the base slot row ``sorted_n + j`` sorts before (its searchsorted-left
    position, computed once at insert time).  Every column is ONE plain
    ndarray over the whole [0, n) space (with geometric slack capacity), so
    consumers keep gathering/scalar-indexing rows directly; only ORDER needs
    the two-region interleave, which ``live_rows()`` produces in O(live).
    ``insert_batch`` therefore costs O(batch·log n + overlay) -- not the
    full-table np.insert per column (~130MB of memcpy per 1k-row batch at
    1M rows, the dominant host cost of the sidecar's steady cycle) -- and
    the overlay folds into the base only when it exceeds
    ``max(2048, sorted_n // 16)`` rows: one vectorized merge per ~16 cycles,
    amortized O(delta) per cycle.  ``copied_rows`` counts every full-width
    row the table copies (merge/compact/growth) so tests can pin the
    amortized bound without timing.
    """

    _SORT_COLS = ("qi", "npc", "prio", "sub", "ids")

    def __init__(
        self,
        num_resources: int,
        extra: Mapping[str, np.dtype],
        cap: int = 1024,
        sort_cols: tuple = _SORT_COLS,
        with_atoms: bool = False,
    ):
        self.R = num_resources
        self.n = 0  # total physical rows: base + overlay
        self.sorted_n = 0  # rows [0, sorted_n) are the sorted base
        self.dead = 0
        self.cap = cap
        assert sort_cols[0] == "qi" and sort_cols[-1] == "ids"
        self.sort_cols = tuple(sort_cols)
        self.ids = np.zeros((cap,), _ID_DTYPE)
        self.qi = np.zeros((cap,), np.int32)
        self.npc = np.zeros((cap,), np.int64)
        self.prio = np.zeros((cap,), np.int64)
        self.sub = np.zeros((cap,), np.float64)
        self.alive = np.zeros((cap,), bool)
        self._extra = tuple(extra)
        for name, dt in extra.items():
            setattr(self, name, np.zeros((cap,), dt))
        self.req = np.zeros((cap, num_resources), np.float32)
        # Raw-atom [*, R] mirror of req (market pools only): observability
        # valuation uses RAW atoms (idealised.value_of_jobs), which the
        # quantised req rows cannot recover.
        self.atoms: Optional[np.ndarray] = (
            np.zeros((cap, num_resources), np.int64) if with_atoms else None
        )
        # overlay row j (physical row sorted_n + j) belongs at base slot
        # ov_pos[j]; non-decreasing because the overlay is key-sorted
        self.ov_pos = np.zeros((0,), np.int64)
        # id -> sort_cols[:-1] column values: enough to re-find the row by
        # binary search; also the membership test.
        self.key_of_id: dict[bytes, tuple] = {}
        # full-width rows copied by merges/compactions/growth (test guard)
        self.copied_rows = 0
        self._live_cache: Optional[np.ndarray] = None

    def _cols(self):
        return ("ids", "qi", "npc", "prio", "sub", "alive") + self._extra

    def _mat_cols(self):
        """All physical arrays, matrix columns included."""
        cols = [getattr(self, c) for c in self._cols()]
        cols.append(self.req)
        if self.atoms is not None:
            cols.append(self.atoms)
        return cols

    def __contains__(self, jid: bytes) -> bool:
        return jid in self.key_of_id

    def _ensure_cap(self, need: int) -> None:
        if need <= self.cap:
            return
        new_cap = max(need, self.cap * 2, 1024)
        for c in self._cols():
            setattr(self, c, _grow(getattr(self, c), new_cap))
        self.req = _grow(self.req, new_cap)
        if self.atoms is not None:
            self.atoms = _grow(self.atoms, new_cap)
        self.copied_rows += self.n
        self.cap = new_cap

    def _find_in_region(self, rlo: int, rhi: int, key: tuple) -> Optional[int]:
        """Live row with this full key (sort key + id) in [rlo, rhi)."""
        lo, hi = rlo, rhi
        for col, v in zip(
            [getattr(self, c) for c in self.sort_cols], key
        ):
            a = col[lo:hi]
            # The probe MUST match the column dtype: searchsorted with e.g. a
            # python int against an int32 column promotes-and-copies the
            # whole column (~230us/call at 300k rows -- measured; typed it
            # is ~2us).
            v = a.dtype.type(v)
            lo, hi = lo + int(np.searchsorted(a, v, "left")), lo + int(
                np.searchsorted(a, v, "right")
            )
        # Ties on the full key are impossible (id is unique), but a removed+
        # reinserted id may leave a dead twin: take the live row.
        for row in range(lo, hi):
            if self.alive[row]:
                return row
        return None

    def _locate(self, jid: bytes) -> Optional[int]:
        key = self.key_of_id.get(jid)
        if key is None:
            return None
        probe = key + (jid,)
        row = self._find_in_region(0, self.sorted_n, probe)
        if row is None and self.n > self.sorted_n:
            row = self._find_in_region(self.sorted_n, self.n, probe)
        return row

    def insert_batch(
        self,
        rows: list[dict],
        reqs: list[np.ndarray],
        atoms: Optional[list[np.ndarray]] = None,
    ) -> None:
        """rows: per-row dict of every column value (ids as bytes).  Thin
        adapter over :meth:`insert_batch_cols` (kept for the small-batch
        callers -- the run table's lease_many, the gang path); the hot
        submit feed builds columns directly and skips the dicts."""
        if not rows:
            return
        cols = {
            c: [r.get(c, True if c == "alive" else 0) for r in rows]
            for c in self._cols()
        }
        self.insert_batch_cols(
            cols,
            np.stack(reqs),
            np.stack(atoms) if atoms is not None else None,
        )

    def insert_batch_cols(
        self,
        cols: Mapping,
        reqs: np.ndarray,
        atoms: Optional[np.ndarray] = None,
    ) -> None:
        """Columnar insert: ``cols`` maps every column name (``_cols()``)
        to a length-k sequence, ``reqs`` is [k, R].  O(batch log n)
        position search + one small np.insert per column on the OVERLAY
        region only; the base never copies here.

        Why columnar: in the submit feed's row build, the per-row dict
        construction, the python
        tuple-key sort and the per-column list comprehensions were ~40% of
        submit_many at 1k-spec batches; columns arrive as flat lists, the
        sort is one np.lexsort, and each column materializes with a single
        np.asarray + fancy-index."""
        scols = self.sort_cols
        typed = {
            c: np.asarray(cols[c], getattr(self, c).dtype)
            for c in self._cols()
        }
        k = typed["ids"].shape[0]
        if k == 0:
            return
        # np.lexsort keys: LAST key is primary, so feed the sort columns
        # reversed.  Stable, like the python sorted() it replaces.
        order = np.lexsort(tuple(typed[c] for c in reversed(scols)))
        typed = {c: v[order] for c, v in typed.items()}
        reqs = np.asarray(reqs, np.float32)[order]
        if atoms is not None:
            atoms = np.asarray(atoms, np.int64)[order]
        self._live_cache = None
        if self.n == 0:
            # Bulk-load fast path (initial backlog fill): the sorted batch IS
            # the (base) table.
            self._ensure_cap(k)
            for c in self._cols():
                getattr(self, c)[:k] = typed[c]
            self.req[:k] = reqs
            if self.atoms is not None:
                self.atoms[:k] = atoms if atoms is not None else 0
            self.n = self.sorted_n = k
        else:
            # Batched binary refinement (_lex_equal_ranges): the probe batch
            # is lex-sorted, so probes sharing a range form contiguous runs
            # and the whole batch costs a few hundred vectorized
            # searchsorted calls instead of ~10 scalar dispatches per row
            # (measured 15.5 -> 9.0ms per 1k-row batch at 1M rows, r10).
            sn = self.sorted_n
            base_cols = [getattr(self, c) for c in scols]
            vals_by_col = [typed[c] for c in scols]
            base_pos, _ = _lex_equal_ranges(
                base_cols,
                vals_by_col,
                np.zeros((k,), np.int64),
                np.full((k,), sn, np.int64),
            )
            # slot within the key-sorted overlay: rows at other base
            # positions order by position; the runs SHARING a base gap
            # (common: a queue tail absorbing several cycles of arrivals)
            # need the key refinement, but only over those runs
            ov_pos = self.ov_pos
            olo = ov_pos.searchsorted(base_pos, "left").astype(np.int64)
            ohi = ov_pos.searchsorted(base_pos, "right").astype(np.int64)
            ov_ins = olo.copy()
            need = np.flatnonzero(olo != ohi)
            if need.size:
                plo, _ = _lex_equal_ranges(
                    base_cols,
                    [v[need] for v in vals_by_col],
                    sn + olo[need],
                    sn + ohi[need],
                )
                ov_ins[need] = plo - sn
            self._ensure_cap(self.n + k)
            end = self.n
            for c in self._cols():
                col = getattr(self, c)
                col[sn : end + k] = np.insert(col[sn:end], ov_ins, typed[c])
            self.req[sn : end + k] = np.insert(
                self.req[sn:end], ov_ins, reqs, axis=0
            )
            if self.atoms is not None:
                self.atoms[sn : end + k] = np.insert(
                    self.atoms[sn:end],
                    ov_ins,
                    atoms
                    if atoms is not None
                    else np.zeros((k, self.R), np.int64),
                    axis=0,
                )
            self.ov_pos = np.insert(ov_pos, ov_ins, base_pos)
            self.n += k
            if self.n - self.sorted_n > max(2048, self.sorted_n // 16):
                self._merge_overlay()
        # key_of_id values stay python-typed (tolist), matching the scalar
        # insert path -- _find_in_region coerces probes per column anyway.
        key_lists = [typed[c].tolist() for c in scols[:-1]]
        for jid, *key in zip(typed["ids"].tolist(), *key_lists):
            self.key_of_id[jid] = tuple(key)

    def _merge_overlay(self) -> None:
        """Fold the overlay into the base: one vectorized np.insert per
        column at the precomputed positions (no re-search)."""
        k = self.n - self.sorted_n
        if not k:
            return
        sn = self.sorted_n
        self._live_cache = None
        for col in self._mat_cols():
            merged = np.insert(col[:sn], self.ov_pos, col[sn : self.n], axis=0)
            col[: self.n] = merged
        self.copied_rows += self.n
        self.sorted_n = self.n
        self.ov_pos = np.zeros((0,), np.int64)

    def remove(self, jid: bytes) -> Optional[dict]:
        """Tombstone the row; returns its column values (qi + extras + req
        copy) so callers can release slab slots / adjust demand, or None if
        the id was absent.  The snapshot is taken BEFORE any compaction."""
        row = self._locate(jid)
        self.key_of_id.pop(jid, None)
        if row is None:
            return None
        info = {c: getattr(self, c)[row] for c in ("qi",) + self._extra}
        info["req"] = self.req[row].copy()
        self.alive[row] = False
        self._live_cache = None
        self.dead += 1
        if self.dead > max(1024, self.n // 4):
            self.compact()
        return info

    def remove_many(self, jids: Sequence[bytes]) -> list:
        """Batched tombstone: same per-id semantics as remove(), but the
        binary searches run on locally-bound columns via the ndarray method
        (the numpy dispatch wrappers are most of remove()'s cost for the
        per-cycle ~1k-decision feedback at 1M rows) and the compaction
        check runs once for the whole batch."""
        cols = [getattr(self, c) for c in self.sort_cols]
        alive = self.alive
        extra = ("qi",) + self._extra
        extra_cols = {c: getattr(self, c) for c in extra}
        pop_key = self.key_of_id.pop
        out: list = [None] * len(jids)
        # Collect known probes, then sort them lexicographically so the
        # batched narrowing (_lex_equal_ranges) sees contiguous equal-range
        # runs -- the decision feedback arrives in schedule order, not
        # table order.
        probe_keys: list = []
        probe_out: list = []
        for i, jid in enumerate(jids):
            key = pop_key(jid, None)
            if key is not None:
                probe_keys.append(key + (jid,))
                probe_out.append(i)
        removed = 0
        if probe_keys:
            order = sorted(range(len(probe_keys)), key=probe_keys.__getitem__)
            probe_keys = [probe_keys[j] for j in order]
            probe_out = [probe_out[j] for j in order]
            k = len(probe_keys)
            vals_by_col = [
                np.asarray([p[ci] for p in probe_keys], col.dtype)
                for ci, col in enumerate(cols)
            ]
            lo, hi = _lex_equal_ranges(
                cols,
                vals_by_col,
                np.zeros((k,), np.int64),
                np.full((k,), self.sorted_n, np.int64),
            )
            rows_found = np.full((k,), -1, np.int64)
            for j in range(k):
                # ties on the full key are impossible (id unique); a dead
                # twin of a removed+reinserted id makes hi-lo tiny, never
                # a scan
                for r in range(int(lo[j]), int(hi[j])):
                    if alive[r]:
                        rows_found[j] = r
                        break
            if self.n > self.sorted_n:
                miss = np.flatnonzero(rows_found < 0)
                if miss.size:
                    mlo, mhi = _lex_equal_ranges(
                        cols,
                        [v[miss] for v in vals_by_col],
                        np.full((miss.size,), self.sorted_n, np.int64),
                        np.full((miss.size,), self.n, np.int64),
                    )
                    for t, j in enumerate(miss):
                        for r in range(int(mlo[t]), int(mhi[t])):
                            if alive[r]:
                                rows_found[j] = r
                                break
            for j, out_i in enumerate(probe_out):
                row = int(rows_found[j])
                if row < 0:
                    continue
                info = {c: extra_cols[c][row] for c in extra}
                info["req"] = self.req[row].copy()
                alive[row] = False
                self.dead += 1
                removed += 1
                out[out_i] = info
        if removed:
            self._live_cache = None
        if self.dead > max(1024, self.n // 4):
            self.compact()
        return out

    def compact(self) -> None:
        self._merge_overlay()
        keep = self.alive[: self.n]
        kept = int(keep.sum())
        for c in self._cols():
            cur = getattr(self, c)
            setattr(self, c, cur[: self.n][keep])
        self.req = self.req[: self.n][keep]
        if self.atoms is not None:
            self.atoms = self.atoms[: self.n][keep]
        self.copied_rows += kept
        self.n = self.sorted_n = self.cap = kept
        self.dead = 0
        self._live_cache = None

    def live_rows(self) -> np.ndarray:
        """Live physical rows in KEY order (no longer ascending once an
        overlay exists -- every consumer gathers column values by row, so
        only the order is load-bearing).  Cached until the next mutation;
        treat the result as read-only."""
        out = self._live_cache
        if out is not None:
            return out
        base_live = np.flatnonzero(self.alive[: self.sorted_n])
        if self.n == self.sorted_n:
            out = base_live
        else:
            ov_live = np.flatnonzero(self.alive[self.sorted_n : self.n])
            ins = np.searchsorted(base_live, self.ov_pos[ov_live], "left")
            out = np.insert(base_live, ins, self.sorted_n + ov_live)
        self._live_cache = out
        return out

    def rank_of_key(self, probe: tuple) -> int:
        """Count of live rows whose full sort key precedes `probe` (which
        includes the id), restricted to probe's queue -- the builder's
        virtual-rank primitive, summed over both regions."""
        total = 0
        qv = probe[0]
        for rlo, rhi in ((0, self.sorted_n), (self.sorted_n, self.n)):
            if rlo == rhi:
                continue
            qcol = self.qi[rlo:rhi]
            q_lo = rlo + int(np.searchsorted(qcol, qcol.dtype.type(qv), "left"))
            lo, hi = q_lo, rlo + int(
                np.searchsorted(qcol, qcol.dtype.type(qv), "right")
            )
            for col, v in zip(
                [getattr(self, c) for c in self.sort_cols[1:]], probe[1:]
            ):
                a = col[lo:hi]
                v = a.dtype.type(v)
                lo, hi = lo + int(np.searchsorted(a, v, "left")), lo + int(
                    np.searchsorted(a, v, "right")
                )
            total += int(self.alive[q_lo:lo].sum())
        return total


class IncrementalBuilder:
    """Cycle-persistent problem state for ONE pool.

    Feed deltas as they happen (`submit` / `remove` / `reprioritise` /
    `lease` / `unlease` / `set_nodes` / `set_queues`), then call `assemble()`
    once per cycle for a (SchedulingProblem, HostContext) pair equivalent to
    models.problem.build_problem's -- pinned by tests/test_incremental.py.

    Slow-path residue (per-cycle Python, expected to be a sliver of the
    backlog): gang jobs and retry-banned jobs.
    """

    def __init__(
        self,
        config: SchedulingConfig,
        pool: str,
        queues: Sequence[Queue] = (),
        bid_price_of: Optional[Callable] = None,
    ):
        self.config = config
        self.pool = pool
        self.factory = config.resource_list_factory()
        self.R = self.factory.num_resources
        pool_cfg = next((p for p in config.pools if p.name == pool), None)
        self.market = bool(pool_cfg is not None and pool_cfg.market_driven)
        self.spot_cutoff = np.float32(
            pool_cfg.spot_price_cutoff
            if self.market and pool_cfg is not None and pool_cfg.spot_price_cutoff > 0
            else _INF
        )
        # Market pools sort by (queue, band, submit, id) -- see module
        # docstring: the band is immutable per job, so the stored order is
        # cycle-stable and the per-cycle bid re-sort is a permutation of
        # contiguous band slices by current price (_market_perm).
        self._sort_cols = (
            ("qi", "band", "sub", "ids")
            if self.market
            else _SortedTable._SORT_COLS
        )
        self.bid_price_of = bid_price_of

        self.ladder = config.priority_ladder()
        self.level_of_priority = {p: i + 2 for i, p in enumerate(self.ladder)}
        self.pc_names = sorted(config.priority_classes)
        self.pc_index = {name: i for i, name in enumerate(self.pc_names)}
        # priority-class name -> (npc, level, pc_index): the submit feed's
        # per-spec resolution, memoized (classes are config-immutable).
        self._pc_row_memo: dict[str, tuple] = {}

        self.kidx = SchedulingKeyIndex()
        self._indexed = set(config.indexed_node_labels)
        self.ntidx = NodeTypeIndex(self._indexed)
        self._compat: Optional[np.ndarray] = None
        self._compat_dims = (0, 0)
        self._type_tables_cache: Optional[tuple] = None
        self._type_tables_dims = (0, 0)

        self.jobs = _SortedTable(
            self.R,
            {
                "level": np.int32,
                "pc": np.int32,
                "key": np.int32,
                "band": np.int32,
                "slot": np.int32,
                "hasres": bool,
            },
            sort_cols=self._sort_cols,
            with_atoms=self.market,
        )
        self.runs = _SortedTable(
            self.R,
            {
                "node": np.int32,
                "level": np.int32,
                "pc": np.int32,
                "preempt": bool,
                "band": np.int32,
                "slot": np.int32,
                # Observability extras: `hasres` distinguishes a resources-None
                # job from an all-zero request (value_of_jobs skips the
                # former); `pok` = this pool satisfies the spec's validated
                # pools restriction (build_problem's per-job pool filter,
                # problem.py queued-job loop).
                "hasres": bool,
                "pok": bool,
            },
            cap=256,
            sort_cols=self._sort_cols,
            with_atoms=self.market,
        )
        # Leased gang members' full specs (market pools): the idealised
        # mega-round re-enters running jobs as candidates and must regroup
        # gang siblings exactly as the legacy spec walk does; gangs are few
        # by design (the same slow path as gang_jobs).
        self.running_gang_specs: dict[str, JobSpec] = {}
        # Slot-stable slabs mirroring the tables (models/slab.py): device
        # content lives at a fixed slot per job/run so the per-cycle upload
        # is O(deltas); the sorted tables keep serving order/lookup.
        from armada_tpu_torch.models.slab import RowSlab

        bucket = max(64, config.shape_bucket)
        self._sg = RowSlab(
            self.R,
            {
                "level": np.int32,
                "queue": np.int32,
                "key": np.int32,
                "pc": np.int32,
                "band": np.int32,
            },
            bucket=bucket,
        )
        self._rr = RowSlab(
            self.R,
            {
                "node": np.int32,
                "level": np.int32,
                "queue": np.int32,
                "pc": np.int32,
                "band": np.int32,
                "preempt": bool,
            },
            bucket=bucket,
        )
        # Gang-unit region sizing (units rebuilt wholesale each cycle).
        self._u_cap = 0
        self._br_cap = 1
        self._u_prev_n = 0
        self._unit_cols: dict[str, np.ndarray] = {}
        # Device-visible gang ids across all regions ([G] grows with caps).
        self._g_ids = np.zeros((0,), self.jobs.ids.dtype)
        self._g_ids_shared = False  # copy-on-write, see _own_g_ids
        # Exact integral demand accounting per (queue, pc): resolution units
        # are integers, so incremental float64 +=/-= is exact and
        # order-independent (matches assemble()'s fresh bincounts).
        C = len(self.pc_names)
        self._demand_sg = np.zeros((0, C, self.R), np.float64)
        self._demand_run = np.zeros((0, C, self.R), np.float64)
        # Bundle sequencing for the single DeviceDeltaCache consumer (a
        # skipped bundle forces its full-upload fallback).
        self._bundle_seq = 0
        # Shadow-pipeline prefetch state (prefetch_content): the sig of the
        # last emitted bundle, and how much of each slab's dirty log was
        # already shipped to the device mid-cycle.  Shipped rows stay in the
        # dirty log (the gq splice must treat them as moved) but drop out of
        # the next bundle's scatter payload.
        self._last_sig: Optional[tuple] = None
        self._shipped_sg = 0
        self._shipped_rr = 0
        # Bumped by invalidate_prefetch() (device loss / promotion): an
        # in-flight prefetch from an ABANDONED watchdog worker must never
        # mark rows shipped against a device state that was reset under it.
        self._prefetch_gen = 0
        # Market: g_price is a function of per-slot (queue, band) and the
        # per-cycle price table; a price MOVE invalidates every slot's price
        # at once, so it bumps an epoch in the bundle sig and rides the
        # device cache's full-upload fallback (cheap: providers re-price at
        # poll granularity, not per 1s cycle; unchanged prices cost nothing).
        self._last_prices: Optional[np.ndarray] = None
        self._price_epoch = 0
        # Previous cycle's candidate order, for the device-side gq splice
        # (DeltaBundle.gq_splice): shipping the 4MB [G] order vector whole
        # every cycle would be the dominant per-cycle upload.
        self._prev_gq: Optional[np.ndarray] = None
        self._prev_gq_real = 0
        # Identity-stable small tensors (re-sent only when values change).
        self._stable_smalls: dict[str, np.ndarray] = {}
        self.gang_jobs: dict[str, JobSpec] = {}  # job id -> spec (slow path)
        self.banned: dict[str, tuple] = {}  # job id -> banned node ids
        self.bands: list[str] = [""]
        self._band_index: dict[str, int] = {"": 0}
        self._unknown_queue: dict[str, tuple] = {}
        # Leases whose node or queue the builder has not seen yet: state can
        # legitimately arrive runs-first (restart replay; a sidecar session
        # syncing its mirror before the first round) and a silent drop would
        # make every running job invisible to fairness/preemption.  Flushed
        # by set_nodes/set_queues once the reference appears.
        self._pending_runs: dict[str, RunningJob] = {}

        self.node_ids: list[str] = []
        self.node_index: dict[str, int] = {}
        self.node_specs: list[NodeSpec] = []
        self.node_total = np.zeros((0, self.R), np.float32)
        self.node_type = np.zeros((0,), np.int32)
        self.node_ok = np.zeros((0,), bool)
        # present != ok: cordoned/unschedulable nodes (ok=False, present=True)
        # still count in pool totals, exactly as build_problem counts every
        # snapshot node; REMOVED nodes (present=False) must vanish from
        # totals/scale/caps and drop their runs, matching the legacy builder
        # which only ever sees snapshot nodes (problem.py run_list filter).
        self.node_present = np.zeros((0,), bool)
        # Last set_nodes snapshot (strong refs, so object identity is a
        # sound sameness proxy): the steady cycle re-presents the SAME
        # NodeSpec instances (executor snapshots only change on executor
        # sync), and the full 50k-node Python diff costs ~100ms/cycle.
        self._last_nodes: Optional[list] = None
        self._retype_needed = False
        # Node-derived tensors are identical between cycles unless the fleet
        # changed; cache them keyed on an epoch so assemble() can hand back
        # the SAME array objects and the device cache skips the re-upload.
        self._node_epoch = 0
        self._node_cache: Optional[dict] = None

        self.queue_names: list[str] = []
        self.queue_by_name: dict[str, int] = {}
        self.queue_weight = np.zeros((0,), np.float32)
        # Queue indices only ever append (the sorted tables key on qi), so a
        # DELETED queue keeps its index but goes un-known: its jobs must stop
        # being scheduling candidates and its runs stop counting, matching
        # the legacy path's known-queues filter (algo.py job scan;
        # pqs.go:129-131 for runs).
        self.queue_known = np.zeros((0,), bool)
        if queues:
            self.set_queues(queues)

    # ------------------------------------------------------------ queues ----

    def set_queues(self, queues: Sequence[Queue]) -> None:
        """Queue set / weights changed.  New queues APPEND to the index
        order (the sorted tables key on qi; renumbering would invalidate
        them -- the kernel is indifferent, candidate order is cost-based)."""
        for q in sorted(queues, key=lambda q: q.name):
            if q.name not in self.queue_by_name:
                self.queue_by_name[q.name] = len(self.queue_names)
                self.queue_names.append(q.name)
        self.queue_weight = np.zeros((len(self.queue_names),), np.float32)
        self.queue_known = np.zeros((len(self.queue_names),), bool)
        known = {q.name: q.weight for q in queues}
        for name, qi in self.queue_by_name.items():
            self.queue_weight[qi] = known.get(name, 0.0)
            self.queue_known[qi] = name in known
        nq = len(self.queue_names)
        if self._demand_sg.shape[0] < nq:
            self._demand_sg = _grow(self._demand_sg, nq)
            self._demand_run = _grow(self._demand_run, nq)
        if self._unknown_queue:
            flush = [
                args
                for args in list(self._unknown_queue.values())
                if args[0].queue in self.queue_by_name
            ]
            if flush:
                # ONE batched submit: a per-spec loop here is O(flush x
                # table) np.insert -- 95s for a 100k backlog arriving before
                # its queues (the sidecar mirror-load shape), vs one
                # table insert for the whole flush.
                for spec, _ in flush:
                    self._unknown_queue.pop(spec.id, None)
                bans = {s.id: b for s, b in flush if b}
                self.submit_many([s for s, _ in flush], bans or None)
        self._flush_pending_runs()

    # ------------------------------------------------------------- nodes ----

    def set_nodes(self, nodes: Sequence[NodeSpec]) -> None:
        """Full node snapshot for this pool, diffed against current state.
        Node indices are stable for the life of the builder (run rows key on
        them); removed nodes become !ok tombstones."""
        # Identity fast path: NodeSpecs are immutable snapshot rows, so the
        # same instances in the same order mean the same outcome as last
        # cycle's diff.  An `is`-walk over 50k nodes is ~2ms; the full diff
        # below (dict probes + per-node compares) is ~100ms.
        prev = self._last_nodes
        if prev is not None and len(prev) == len(nodes):
            for a, b in zip(prev, nodes):
                if a is not b:
                    break
            else:
                if self._retype_needed:
                    self._retype_nodes()
                self._flush_pending_runs()
                return
        # Recorded only once the diff below COMPLETES: a mid-diff raise (one
        # malformed NodeSpec) must not arm the fast path, or every retry with
        # the same instances would silently skip repairing half-applied state.
        self._last_nodes = None
        seen = set()
        changed = False
        new_rows: list[NodeSpec] = []
        for n in nodes:
            if n.pool != self.pool:
                continue
            seen.add(n.id)
            i = self.node_index.get(n.id)
            if i is None:
                new_rows.append(n)
            else:
                old = self.node_specs[i]
                if old is not n and old != n:
                    changed = True
                    self.node_specs[i] = n
                    self.node_total[i] = (
                        self.factory.floor_units(n.total_resources.atoms)
                        if n.total_resources is not None
                        else 0
                    )
                    self.node_type[i] = self.ntidx.type_of(n)
                if self.node_ok[i] != (not n.unschedulable) or not self.node_present[i]:
                    changed = True
                self.node_ok[i] = not n.unschedulable
                self.node_present[i] = True
        for i, nid in enumerate(self.node_ids):
            if nid not in seen:
                if self.node_ok[i] or self.node_present[i]:
                    changed = True
                self.node_ok[i] = False
                self.node_present[i] = False
        if new_rows:
            base = len(self.node_ids)
            total = _grow(self.node_total, base + len(new_rows))
            ntype = _grow(self.node_type, base + len(new_rows))
            ok = _grow(self.node_ok, base + len(new_rows))
            present = _grow(self.node_present, base + len(new_rows))
            for j, n in enumerate(new_rows):
                i = base + j
                self.node_index[n.id] = i
                self.node_ids.append(n.id)
                self.node_specs.append(n)
                if n.total_resources is not None:
                    total[i] = self.factory.floor_units(n.total_resources.atoms)
                ntype[i] = self.ntidx.type_of(n)
                ok[i] = not n.unschedulable
                present[i] = True
            self.node_total, self.node_type = total, ntype
            self.node_ok, self.node_present = ok, present
            changed = True
        if changed:
            self._node_epoch += 1
        self._last_nodes = list(nodes)
        if self._retype_needed:
            self._retype_nodes()
        self._flush_pending_runs()

    def _retype_nodes(self) -> None:
        """A selector referenced a label outside the indexed set: node types
        must be re-derived with the wider set (build_problem derives the set
        per round via labels_referenced_by_selectors; here it only grows)."""
        self.ntidx = NodeTypeIndex(self._indexed)
        for i, n in enumerate(self.node_specs):
            self.node_type[i] = self.ntidx.type_of(n)
        self._compat = None
        self._compat_dims = (0, 0)
        self._type_tables_cache = None
        self._type_tables_dims = (0, 0)
        self._retype_needed = False
        self._node_epoch += 1

    # -------------------------------------------------------------- jobs ----

    def _band(self, band: str) -> int:
        bi = self._band_index.get(band)
        if bi is None:
            bi = len(self.bands)
            self.bands.append(band)
            self._band_index[band] = bi
        return bi

    def _note_selector_labels(self, spec: JobSpec) -> None:
        for k in spec.node_selector:
            if k != self.config.node_id_label and k not in self._indexed:
                self._indexed.add(k)
                self._retype_needed = True

    def _batch_reqs(self, res_list: Sequence) -> np.ndarray:
        """Vectorized ceil_units over a batch of ResourceLists (None =
        zero request): ONE numpy pass for the whole batch instead of three
        numpy ops per job -- the submit/lease feed's row-building loop was
        ~100ms/cycle at 1k-job bursts, about half of it
        per-job numpy dispatch."""
        if not res_list:
            return np.zeros((0, self.R), np.float32)
        zero = np.zeros((self.R,), np.int64)
        A = np.stack(
            [zero if res is None else res.atoms for res in res_list]
        ).astype(np.int64, copy=False)
        res_v = np.asarray(self.factory.resolutions, np.int64)
        return (-((-A) // res_v[None, :])).astype(np.float32)

    def submit(self, spec: JobSpec, banned_nodes: Sequence[str] = ()) -> None:
        """A queued job entered (or re-entered) the backlog.  `spec.priority`
        must be the CURRENT priority (reprioritisation updates it)."""
        self.submit_many([spec], {spec.id: tuple(banned_nodes)} if banned_nodes else None)

    def _release_single(self, info: Optional[dict]) -> None:
        """Free a removed single's slab slot + retire its demand share."""
        if info is None:
            return
        slot = int(info["slot"])
        if self._sg.valid[slot]:
            self._demand_sg[int(info["qi"]), int(info["pc"])] -= info["req"].astype(
                np.float64
            )
        self._sg.release(slot)
        if slot < self._g_ids.shape[0]:
            self._own_g_ids()
            self._g_ids[slot] = b""

    def _release_run(self, info: Optional[dict]) -> None:
        if info is None:
            return
        slot = int(info["slot"])
        if self._rr.valid[slot]:
            self._demand_run[int(info["qi"]), int(info["pc"])] -= info["req"].astype(
                np.float64
            )
        self._rr.release(slot)

    def _own_g_ids(self) -> None:
        """Copy-on-write for the shared [G] id snapshot (assemble_delta hands
        self._g_ids to the HostContext; the first in-place write after that
        copies, so mutation-free cycles pay nothing and the copy otherwise
        runs in the overlapped decode shadow, not the assemble path)."""
        if self._g_ids_shared:
            self._g_ids = self._g_ids.copy()
            self._g_ids_shared = False

    def _share_g_ids(self) -> np.ndarray:
        self._g_ids_shared = True
        return self._g_ids

    def _ensure_g_ids(self) -> None:
        """Keep the [G] id vector covering the singles region after growth
        (a fresh array object, so an outstanding snapshot keeps the old)."""
        if self._g_ids.shape[0] < self._sg.cap:
            old = self._g_ids
            self._g_ids = np.zeros((self._sg.cap,), _ID_DTYPE)
            self._g_ids[: old.shape[0]] = old
            self._g_ids_shared = False

    def submit_many(
        self, specs: Sequence[JobSpec], banned: Optional[Mapping] = None
    ) -> None:
        with _trace().span("submit_many", pool=self.pool, n=len(specs)):
            self._submit_many(specs, banned)

    def _pc_row(self, name: str) -> tuple:
        """(npc, level, pc_index) for a priority-class name, memoized --
        the per-spec priority_class() resolution was a visible slice of the
        submit feed's row build."""
        hit = self._pc_row_memo.get(name)
        if hit is None:
            pc = self.config.priority_class(name)
            hit = self._pc_row_memo[name] = (
                -pc.priority,
                self.level_of_priority[pc.priority],
                self.pc_index[pc.name],
            )
        return hit

    def _submit_many(
        self, specs: Sequence[JobSpec], banned: Optional[Mapping] = None
    ) -> None:
        """Batched submit: one np.insert for the whole batch.

        Row building is COLUMNAR: flat per-column lists feed
        insert_batch_cols directly -- no per-spec dict, no python tuple
        sort -- which halved the ~15ms/1k-batch row build the trace
        surfaced at 200k rows."""
        k0 = len(specs)
        c_ids: list = []
        c_qi: list = []
        c_npc: list = []
        c_prio: list = []
        c_sub: list = []
        c_level: list = []
        c_pc: list = []
        c_key: list = []
        c_band: list = []
        c_hasres: list = []
        resl: list = []
        atoms: Optional[list] = [] if self.market else None
        queue_by_name = self.queue_by_name
        kidx_key_of = self.kidx.key_of
        node_id_label = self.config.node_id_label
        band_of = self._band
        jobs = self.jobs
        for spec in specs:
            if spec.pools and self.pool not in spec.pools:
                continue
            self._note_selector_labels(spec)
            bans = (banned or {}).get(spec.id, ())
            if spec.queue not in queue_by_name:
                self._unknown_queue[spec.id] = (spec, tuple(bans))
                continue
            # a resubmit may switch paths (gained/lost gang or bans)
            self.gang_jobs.pop(spec.id, None)
            self.banned.pop(spec.id, None)
            if spec.gang_id or bans:
                self.gang_jobs[spec.id] = spec
                if bans:
                    self.banned[spec.id] = tuple(bans)
                self._release_single(jobs.remove(spec.id.encode()))
                continue
            jid = spec.id.encode()
            if jid in jobs:
                self._release_single(jobs.remove(jid))
            npc, level, pci = self._pc_row(spec.priority_class)
            c_ids.append(jid)
            c_qi.append(queue_by_name[spec.queue])
            c_npc.append(npc)
            c_prio.append(spec.priority)
            c_sub.append(spec.submit_time)
            c_level.append(level)
            c_pc.append(pci)
            c_key.append(kidx_key_of(spec, node_id_label))
            c_band.append(band_of(spec.price_band))
            c_hasres.append(spec.resources is not None)
            resl.append(spec.resources)
            if atoms is not None:
                atoms.append(
                    np.asarray(spec.resources.atoms, np.int64)
                    if spec.resources is not None
                    else np.zeros((self.R,), np.int64)
                )
        if not c_ids:
            return
        reqs_arr = self._batch_reqs(resl)
        slots = self._sg.alloc(len(c_ids))
        jobs.insert_batch_cols(
            {
                "ids": c_ids,
                "qi": c_qi,
                "npc": c_npc,
                "prio": c_prio,
                "sub": c_sub,
                "alive": np.ones((len(c_ids),), bool),
                "level": c_level,
                "pc": c_pc,
                "key": c_key,
                "band": c_band,
                "slot": slots,
                "hasres": c_hasres,
            },
            reqs_arr,
            np.stack(atoms) if atoms else None,
        )
        ids_arr = np.asarray(c_ids, _ID_DTYPE)
        qis = np.asarray(c_qi, np.int64)
        pcs = np.asarray(c_pc, np.int64)
        self._sg.write_batch(
            slots,
            ids_arr,
            reqs_arr,
            level=np.asarray(c_level, np.int32),
            queue=qis.astype(np.int32),
            key=np.asarray(c_key, np.int32),
            pc=pcs.astype(np.int32),
            band=np.asarray(c_band, np.int32),
        )
        self._ensure_g_ids()
        self._own_g_ids()
        self._g_ids[slots] = ids_arr
        np.add.at(
            self._demand_sg,
            (qis, pcs),
            reqs_arr.astype(np.float64),
        )

    def remove(self, job_id: str) -> None:
        """Job left the backlog (scheduled, cancelled, or terminal)."""
        self.gang_jobs.pop(job_id, None)
        self.banned.pop(job_id, None)
        self._unknown_queue.pop(job_id, None)
        self.running_gang_specs.pop(job_id, None)
        self._release_single(self.jobs.remove(job_id.encode()))

    def remove_many(self, job_ids: Sequence[str]) -> None:
        with _trace().span("remove_many", pool=self.pool, n=len(job_ids)):
            self._remove_many(job_ids)

    def _remove_many(self, job_ids: Sequence[str]) -> None:
        """Batched remove() for the cycle's decision feedback (~1k scheduled
        jobs leave the backlog per cycle): one table pass + ONE vectorized
        demand update instead of per-job numpy scalar ops."""
        enc = []
        for job_id in job_ids:
            self.gang_jobs.pop(job_id, None)
            self.banned.pop(job_id, None)
            self._unknown_queue.pop(job_id, None)
            self.running_gang_specs.pop(job_id, None)
            enc.append(job_id.encode())
        qis, pcs, reqs = [], [], []
        own_gids = False
        gw = self._g_ids.shape[0]
        for info in self.jobs.remove_many(enc):
            if info is None:
                continue
            slot = int(info["slot"])
            if self._sg.valid[slot]:
                qis.append(int(info["qi"]))
                pcs.append(int(info["pc"]))
                reqs.append(info["req"])
            self._sg.release(slot)
            if slot < gw:
                if not own_gids:
                    self._own_g_ids()
                    own_gids = True
                self._g_ids[slot] = b""
        if qis:
            np.subtract.at(
                self._demand_sg,
                (np.asarray(qis, np.int64), np.asarray(pcs, np.int64)),
                np.stack(reqs).astype(np.float64),
            )

    def reprioritise(self, spec: JobSpec) -> None:
        """Priority changed: re-slot (the order key embeds the priority)."""
        bans = self.banned.get(spec.id, ())
        self.remove(spec.id)
        self.submit(spec, bans)

    # -------------------------------------------------------------- runs ----

    def lease(self, r: RunningJob) -> None:
        """A job started running on a node of this pool."""
        self.lease_many([r])

    def lease_many(self, rs: Sequence[RunningJob]) -> None:
        with _trace().span("lease_many", pool=self.pool, n=len(rs)):
            self._lease_many(rs)

    def _lease_many(self, rs: Sequence[RunningJob]) -> None:
        """Batched lease: one np.insert on the run table for the whole
        cycle's placements (a per-lease insert is O(run table) each)."""
        rows, resl = [], []
        atoms: Optional[list] = [] if self.market else None
        for r in rs:
            ni = self.node_index.get(r.node_id)
            if ni is None or r.job.queue not in self.queue_by_name:
                self._pending_runs[r.job.id] = r
                continue
            self._pending_runs.pop(r.job.id, None)
            if self.market and r.job.gang_id:
                # Stored spec carries the priority current at lease time;
                # reprioritisation of a running member refreshes it because
                # the feed re-leases on every job upsert (apply_job's
                # leased/running branch) -- pinned by
                # test_incremental.test_running_gang_spec_refreshes_on_reprioritise.
                self.running_gang_specs[r.job.id] = r.job
            pc = self.config.priority_class(r.job.priority_class)
            if r.away:
                level, preemptible = 1, True
            else:
                level = self.level_of_priority[pc.priority]
                preemptible = pc.preemptible
            jid = r.job.id.encode()
            if jid in self.runs:
                self._release_run(self.runs.remove(jid))
            rows.append(
                {
                    "ids": jid,
                    "qi": self.queue_by_name[r.job.queue],
                    # Evictee ordering priority: the ladder priority of the
                    # level the run's resources are held at (problem.py
                    # evictee sort).
                    "npc": -self.ladder[max(level - 2, 0)],
                    "prio": r.job.priority,
                    "sub": r.job.submit_time,
                    "node": ni,
                    "level": level,
                    "pc": self.pc_index[pc.name],
                    "preempt": preemptible,
                    "band": self._band(r.job.price_band),
                    "hasres": r.job.resources is not None,
                    "pok": (not r.job.pools) or (self.pool in r.job.pools),
                }
            )
            resl.append(r.job.resources)
            if atoms is not None:
                atoms.append(
                    np.asarray(r.job.resources.atoms, np.int64)
                    if r.job.resources is not None
                    else np.zeros((self.R,), np.int64)
                )
        if not rows:
            return
        reqs_arr = self._batch_reqs(resl)
        reqs = list(reqs_arr)
        slots = self._rr.alloc(len(rows))
        for r, s in zip(rows, slots):
            r["slot"] = s
        self.runs.insert_batch(rows, reqs, atoms)
        qis = np.array([r["qi"] for r in rows], np.int64)
        pcs = np.array([r["pc"] for r in rows], np.int64)
        self._rr.write_batch(
            slots,
            [r["ids"] for r in rows],
            reqs_arr,
            node=np.array([r["node"] for r in rows], np.int32),
            level=np.array([r["level"] for r in rows], np.int32),
            queue=qis.astype(np.int32),
            pc=pcs.astype(np.int32),
            band=np.array([r["band"] for r in rows], np.int32),
            preempt=np.array([r["preempt"] for r in rows], bool),
        )
        np.add.at(self._demand_run, (qis, pcs), reqs_arr.astype(np.float64))

    def unlease(self, job_id: str) -> None:
        """The run ended (terminal or preempted)."""
        self.running_gang_specs.pop(job_id, None)
        self._pending_runs.pop(job_id, None)
        self._release_run(self.runs.remove(job_id.encode()))

    def unlease_if_present(self, job_id: str, jid_b: Optional[bytes] = None) -> None:
        """Feed hot-path unlease: O(1) dict membership checks first, so the
        common case -- a fresh submit that was never leased in this pool --
        skips the encode + run-table probe the JobDb feed otherwise pays
        per builder per upsert (scheduler/incremental_algo.apply_job)."""
        if (
            (jid_b if jid_b is not None else job_id.encode()) in self.runs
            or job_id in self._pending_runs
            or job_id in self.running_gang_specs
        ):
            self.unlease(job_id)

    def _flush_pending_runs(self) -> None:
        ready = [
            r
            for r in self._pending_runs.values()
            if r.node_id in self.node_index
            and r.job.queue in self.queue_by_name
        ]
        if ready:
            for r in ready:
                self._pending_runs.pop(r.job.id, None)
            self.lease_many(ready)

    # ---------------------------------------------------------- assemble ----

    def _build_node_tensors(self, N: int, Nreal: int) -> dict:
        """Padded node tensors + pool totals/caps; rebuilt only when the node
        epoch moves (fleet change, retype) so steady cycles reuse the same
        array objects and skip the device re-upload."""
        cfg = self.config
        R = self.R
        # Removed nodes are tombstones (stable indices for the run table) but
        # must not contribute capacity anywhere: zero their rows and exclude
        # them from totals/scale/caps, matching build_problem which never
        # sees them at all.
        live_total = self.node_total * self.node_present[:, None]
        node_total = np.zeros((N, R), np.float32)
        node_total[:Nreal] = live_total
        node_type = np.zeros((N,), np.int32)
        node_type[:Nreal] = self.node_type
        node_ok = np.zeros((N,), bool)
        node_ok[:Nreal] = self.node_ok
        floating_names = set(cfg.floating_resource_names())
        node_axes = np.array(
            [0.0 if name in floating_names else 1.0 for name in self.factory.names],
            np.float32,
        )
        float_total = np.zeros((R,), np.float32)
        if floating_names:
            fl = self.factory.from_mapping(cfg.floating_totals_for_pool(self.pool))
            float_total = (
                self.factory.floor_units(fl.atoms).astype(np.float64) * (1 - node_axes)
            ).astype(np.float32)
        total_pool64 = live_total.sum(axis=0, dtype=np.float64)
        total_pool64 = total_pool64 + float_total.astype(np.float64)
        total_pool = total_pool64.astype(np.float32)
        drf_mult = self.factory.multipliers_for(cfg.drf_multipliers()).astype(
            np.float32
        )
        scale = live_total.max(axis=0) if Nreal else np.zeros(R, np.float32)
        inv_scale = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-9), 0.0).astype(
            np.float32
        )
        round_cap = np.full((R,), _INF, np.float32)
        for name, frac in cfg.maximum_resource_fraction_to_schedule.items():
            if name in self.factory.names:
                i = self.factory.index_of(name)
                round_cap[i] = frac * total_pool[i]
        from armada_tpu_torch.models.problem import pc_queue_caps

        pc_queue_cap = pc_queue_caps(cfg, self.pc_names, self.factory, total_pool)
        return {
            "key": (self._node_epoch, N),
            "node_total": node_total,
            "node_type": node_type,
            "node_ok": node_ok,
            "node_axes": node_axes,
            "float_total": float_total,
            "total_pool64": total_pool64,
            "total_pool": total_pool,
            "drf_mult": drf_mult,
            "inv_scale": inv_scale,
            "round_cap": round_cap,
            "pc_queue_cap": pc_queue_cap.astype(np.float32),
        }

    def _compat_matrix(self) -> np.ndarray:
        # Shape padded to buckets of 32 so a single new interned key does not
        # change the compiled shape (a shape change costs a kernel recompile
        # mid-steady-state) -- but the rebuild decision must key on the REAL
        # dims: a key added within the same bucket still needs its row.
        real = (len(self.kidx), len(self.ntidx))
        if self._compat is None or self._compat_dims != real:
            K = _pad(max(1, real[0]), 32)
            T = _pad(max(1, real[1]), 32)
            compat = np.zeros((K, T), bool)
            if real[0] and real[1]:
                compat[: real[0], : real[1]] = static_fit_matrix(
                    self.kidx.keys, self.ntidx.types
                )
            self._compat = compat
            self._compat_dims = real
        return self._compat

    def _type_tables(self) -> tuple:
        """(type_bias f32[TR,T], key_type_row i32[K], compat_pre_type bool[K,T])
        padded to the SAME bucketed dims as _compat_matrix (the kernel gathers
        all three through the same key/type ids); cached and invalidated on
        the same (real K, real T) as the compat rebuild."""
        real = (len(self.kidx), len(self.ntidx))
        if self._type_tables_cache is None or self._type_tables_dims != real:
            K = _pad(max(1, real[0]), 32)
            T = _pad(max(1, real[1]), 32)
            pre = np.zeros((K, T), bool)
            if real[0] and real[1]:
                pre[: real[0], : real[1]] = static_fit_matrix(
                    self.kidx.keys, self.ntidx.types, pre_type=True
                )
            key_type_row, type_bias = type_score_tables(
                self.kidx.keys, self.ntidx.types, K, T
            )
            self._type_tables_cache = (type_bias, key_type_row, pre)
            self._type_tables_dims = real
        return self._type_tables_cache

    def _prices(self) -> Optional[np.ndarray]:
        """f32[Q, B] bid-price table for market pools, refreshed per cycle
        (prices move between cycles; jobs only store their band index)."""
        if not self.market:
            return None
        B = max(1, len(self.bands))
        table = np.zeros((max(1, len(self.queue_names)), B), np.float32)
        for qname, qi in self.queue_by_name.items():
            for band, bi in self._band_index.items():
                table[qi, bi] = float(self.bid_price_of(_BandProbe(qname, band)))
        return table

    def _market_perm(
        self, table: _SortedTable, rows: np.ndarray, prices: np.ndarray
    ) -> np.ndarray:
        """Permutation of `rows` (live rows in stored (qi, band, sub, id)
        order) into the market serving order (qi, -price, sub, id)
        (market_iterator.go:245 orders by price, then submit time, then id).

        Rows within one (queue, band) slice are already (sub, id)-sorted, so
        the "re-sort" moves WHOLE contiguous slices by current price:
        O(#slices log #slices) keys + one index gather.  Only bands tied on
        price need an exact (sub, id) row merge."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        q = table.qi[rows].astype(np.int64)
        b = table.band[rows].astype(np.int64)
        new_grp = np.empty(n, bool)
        new_grp[0] = True
        np.logical_or(q[1:] != q[:-1], b[1:] != b[:-1], out=new_grp[1:])
        gstart = np.flatnonzero(new_grp)
        glen = np.diff(np.append(gstart, n))
        gq = q[gstart]
        gp = prices[gq, b[gstart]]
        # groups by (queue, -price, band): the band tiebreak is provisional,
        # fixed to the exact (sub, id) merge below
        gorder = np.lexsort((b[gstart], -gp, gq))
        lens = glen[gorder]
        new_start = np.zeros(gorder.shape[0], np.int64)
        if gorder.shape[0] > 1:
            new_start[1:] = np.cumsum(lens)[:-1]
        perm = np.repeat(gstart[gorder] - new_start, lens) + np.arange(n)
        oq, op = gq[gorder], gp[gorder]
        tie = np.flatnonzero((oq[1:] == oq[:-1]) & (op[1:] == op[:-1]))
        k = 0
        while k < tie.size:
            # run of consecutive tied groups [j0, j1] in the new order
            j0 = int(tie[k])
            j1 = j0 + 1
            while k + 1 < tie.size and int(tie[k + 1]) == int(tie[k]) + 1:
                k += 1
                j1 = int(tie[k]) + 1
            k += 1
            lo, hi = int(new_start[j0]), int(new_start[j1] + lens[j1])
            seg = perm[lo:hi]
            r = rows[seg]
            perm[lo:hi] = seg[np.lexsort((table.ids[r], table.sub[r]))]
        return perm

    def assemble(
        self,
        *,
        global_tokens=None,
        queue_tokens=None,
        queue_penalty: Optional[Mapping] = None,
        away_mode: bool = False,
    ) -> tuple[SchedulingProblem, HostContext]:
        with _trace().span("assemble", pool=self.pool, dense=True):
            return self._assemble(
                global_tokens=global_tokens,
                queue_tokens=queue_tokens,
                queue_penalty=queue_penalty,
                away_mode=away_mode,
            )

    def _assemble(
        self,
        *,
        global_tokens=None,
        queue_tokens=None,
        queue_penalty: Optional[Mapping] = None,
        away_mode: bool = False,
    ) -> tuple[SchedulingProblem, HostContext]:
        """One cycle's dense problem from the current table state.  All O(G)
        work is vectorized numpy; Python appears per gang/banned job and per
        queue only."""
        if self._retype_needed:
            self._retype_nodes()
        cfg = self.config
        R = self.R
        bucket = cfg.shape_bucket
        # The jobs/runs axes take the full bucket (that is where delta churn
        # must not change shapes); queues and nodes churn far less and the
        # kernel's candidate scan is O(Q) per iteration, so a 1M-scale job
        # bucket must never inflate the queue axis.
        qbucket = min(bucket, 256)
        nbucket = _node_bucket(bucket)
        Qreal = len(self.queue_names)
        Nreal = len(self.node_ids)
        N = _pad(Nreal, nbucket)

        nc = self._node_cache
        if nc is None or nc["key"] != (self._node_epoch, N):
            nc = self._build_node_tensors(N, Nreal)
            self._node_cache = nc
        node_total = nc["node_total"]
        node_type = nc["node_type"]
        node_ok = nc["node_ok"]

        # --- singles: live rows, already in (queue, order-key) order ----------
        prices = self._prices()  # market: per-cycle (queue, band) bid table
        jt = self.jobs
        rows = jt.live_rows()
        if Qreal and not self.queue_known.all():
            rows = rows[self.queue_known[jt.qi[rows]]]
        if prices is not None:
            rows = rows[self._market_perm(jt, rows, prices)]
        sq = jt.qi[rows].astype(np.int64)
        counts_s = np.bincount(sq, minlength=Qreal)
        starts_s = np.zeros((max(1, Qreal),), np.int64)
        if Qreal:
            starts_s[1:Qreal] = np.cumsum(counts_s)[:-1]
        rank_s = np.arange(rows.shape[0], dtype=np.int64) - starts_s[sq]

        # --- slow path: gang units + banned singles ---------------------------
        units, unit_members, unit_ubans = self._gang_units(prices)

        # Merge units into the per-queue order.  Every element's merged rank
        # is unique within its queue; the lookback cap and atomic split-gang
        # truncation are applied on merged ranks, after which the final gq
        # sequence is rebuilt by exact sorted merge -- no rank gaps.
        if units:
            unit_qi = np.array([u["qi"] for u in units], np.int64)
            unit_vrank = np.array([u["rank"] for u in units], np.int64)
            shift = np.zeros(rows.shape[0], np.int64)
            units_before = np.zeros(len(units), np.int64)
            for q in np.unique(unit_qi):
                in_q = np.flatnonzero(unit_qi == q)
                order_q = in_q[np.argsort(unit_vrank[in_q], kind="stable")]
                units_before[order_q] = np.arange(in_q.shape[0])
                ur = np.sort(unit_vrank[in_q])
                sel = sq == q
                shift[sel] = np.searchsorted(ur, rank_s[sel], "right")
            merged_rank_s = rank_s + shift
            merged_rank_u = unit_vrank + units_before
        else:
            unit_qi = np.zeros((0,), np.int64)
            merged_rank_s = rank_s
            merged_rank_u = np.zeros((0,), np.int64)

        L = cfg.max_queue_lookback
        keep_s = merged_rank_s < L
        rows = rows[keep_s]
        sq = sq[keep_s]
        merged_rank_s = merged_rank_s[keep_s]
        kept_units: list[tuple] = []
        if units:
            cut_tags = {
                units[i]["tag"]
                for i in range(len(units))
                if units[i]["tag"] and merged_rank_u[i] >= L
            }
            for i, u in enumerate(units):
                if merged_rank_u[i] >= L or (u["tag"] and u["tag"] in cut_tags):
                    continue
                kept_units.append((u, merged_rank_u[i], unit_members[i], unit_ubans[i]))

        # --- evictee slots from the run table ---------------------------------
        rt = self.runs
        run_rows = rt.live_rows()
        if Qreal and not self.queue_known.all():
            # Runs of deleted queues neither count nor get evictee slots
            # (the reference skips unknown-queue jobs entirely,
            # pqs.go:129-131).
            run_rows = run_rows[self.queue_known[rt.qi[run_rows]]]
        if Nreal and not self.node_present.all():
            # Runs on REMOVED nodes drop out of the problem entirely, like
            # build_problem's `r.node_id in node_index` filter: they neither
            # count toward queue usage nor get evictee slots (heartbeat
            # expiry fails them through the scheduler, not the builder).
            run_rows = run_rows[self.node_present[rt.node[run_rows]]]
        nr = run_rows.shape[0]
        rq = rt.qi[run_rows].astype(np.int64)
        ev_mask = rt.preempt[run_rows]
        ev_rows = run_rows[ev_mask]
        if prices is not None:
            # evictees order among themselves by the same market comparator
            # (build_problem's evictee sort)
            ev_rows = ev_rows[self._market_perm(rt, ev_rows, prices)]
        evq = rt.qi[ev_rows].astype(np.int64)
        counts_e = np.bincount(evq, minlength=Qreal)
        starts_e = np.zeros((max(1, Qreal),), np.int64)
        if Qreal:
            starts_e[1:Qreal] = np.cumsum(counts_e)[:-1]
        rank_e = np.arange(ev_rows.shape[0], dtype=np.int64) - starts_e[evq]

        # --- gang axis layout: [evictees | singles | units] -------------------
        E, S, U = ev_rows.shape[0], rows.shape[0], len(kept_units)
        nreal_g = E + S + U
        G = _pad(nreal_g, bucket)
        g_req = np.zeros((G, R), np.float32)
        g_card = np.ones((G,), np.int32)
        g_level = np.ones((G,), np.int32)
        g_queue = np.zeros((G,), np.int32)
        g_key = np.full((G,), -1, np.int32)
        g_pc = np.zeros((G,), np.int32)
        g_order = np.zeros((G,), np.int64)
        g_run = np.full((G,), -1, np.int32)
        g_valid = np.zeros((G,), bool)
        g_price = np.zeros((G,), np.float32)
        g_spot = np.zeros((G,), np.float32)

        RJ = _pad(nr, bucket)
        run_req = np.zeros((RJ, R), np.float32)
        run_node = np.zeros((RJ,), np.int32)
        run_level = np.ones((RJ,), np.int32)
        run_queue = np.zeros((RJ,), np.int32)
        run_pc = np.zeros((RJ,), np.int32)
        run_preempt = np.zeros((RJ,), bool)
        run_valid = np.zeros((RJ,), bool)
        run_gang = np.full((RJ,), -1, np.int32)
        run_req[:nr] = rt.req[run_rows]
        run_node[:nr] = rt.node[run_rows]
        run_level[:nr] = rt.level[run_rows]
        run_queue[:nr] = rq
        run_pc[:nr] = rt.pc[run_rows]
        run_preempt[:nr] = rt.preempt[run_rows]
        run_valid[:nr] = True

        if E:
            g_req[:E] = rt.req[ev_rows]
            g_level[:E] = rt.level[ev_rows]
            g_queue[:E] = evq
            g_pc[:E] = rt.pc[ev_rows]
            # (g_order for ALL real gangs is written once from the final
            # merged sequence below.)
            run_pos = np.empty(rt.n, np.int64)
            run_pos[run_rows] = np.arange(nr)
            g_run[:E] = run_pos[ev_rows].astype(np.int32)
            g_valid[:E] = True
            run_gang[run_pos[ev_rows]] = np.arange(E, dtype=np.int32)
            if prices is not None:
                g_price[:E] = prices[evq, rt.band[ev_rows]]
                g_spot[:E] = g_price[:E]

        if S:
            sl = slice(E, E + S)
            g_req[sl] = jt.req[rows]
            g_level[sl] = 1 if away_mode else jt.level[rows]
            g_queue[sl] = sq
            g_key[sl] = jt.key[rows]
            g_pc[sl] = jt.pc[rows]
            g_valid[sl] = True
            if prices is not None:
                g_price[sl] = prices[sq, jt.band[rows]]
                g_spot[sl] = g_price[sl]

        unit_offset = E + S
        for i, (u, _, members, uban) in enumerate(kept_units):
            gi = unit_offset + i
            g_req[gi] = u["req"]
            g_card[gi] = u["card"]
            g_level[gi] = 1 if away_mode else u["level"]
            g_queue[gi] = u["qi"]
            g_key[gi] = u["key"]
            g_pc[gi] = u["pc"]
            g_valid[gi] = not u["dead"]
            g_price[gi] = u["price"]
            g_spot[gi] = u["spot"]

        # --- final queued order: exact sorted merge of singles and units ------
        # Composite key (queue << 32 | merged rank) is unique per element;
        # both sequences are sorted by it, so one searchsorted + np.insert
        # produces the final per-queue candidate order.
        key_s = (sq << 32) | merged_rank_s
        seq_s = np.arange(E, E + S, dtype=np.int32)
        if kept_units:
            key_u = np.array(
                [(int(u["qi"]) << 32) | int(mr) for (u, mr, _, _) in kept_units],
                np.int64,
            )
            order_u = np.argsort(key_u, kind="stable")
            key_u = key_u[order_u]
            seq_u = (unit_offset + order_u).astype(np.int32)
            pos = np.searchsorted(key_s, key_u)
            queued_seq = np.insert(seq_s, pos, seq_u)
            # queue of each queued element, merged the same way
            queued_q = np.insert(sq, pos, np.array(
                [u["qi"] for (u, _, _, _) in kept_units], np.int64
            )[order_u])
        else:
            queued_seq = seq_s
            queued_q = sq

        # evictees precede queued elements within each queue
        ev_seq = np.arange(E, dtype=np.int32)
        pos_e = np.searchsorted(queued_q, evq, "left")
        gq_real = np.insert(queued_seq, pos_e, ev_seq)
        gq_q = np.insert(queued_q, pos_e, evq)

        Q = _pad(Qreal, qbucket)
        q_len64 = np.bincount(gq_q, minlength=Q)
        q_start = np.zeros((Q,), np.int32)
        q_start[1:] = np.cumsum(q_len64)[:-1].astype(np.int32)
        q_len = q_len64.astype(np.int32)
        gq_gang = np.zeros((G,), np.int32)
        gq_gang[: nreal_g] = gq_real
        # g_order = rank within queue, derived from the final sequence
        if nreal_g:
            g_order_seq = np.arange(nreal_g, dtype=np.int64) - q_start[gq_q].astype(
                np.int64
            )
            g_order[gq_real] = g_order_seq

        # --- ban rows (unit ubans + retry bans) -------------------------------
        g_ban_row = np.zeros((G,), np.int32)
        ban_rows: list[np.ndarray] = []
        for i, (u, _, members, uban) in enumerate(kept_units):
            bans = set()
            for jid in members:
                bans.update(self.banned.get(jid, ()))
            if not uban and not bans:
                continue
            row = np.zeros((N,), bool)
            for ni in uban or ():
                row[ni] = True
            for nid in bans:
                ni = self.node_index.get(nid)
                if ni is not None:
                    row[ni] = True
            if row.any():
                ban_rows.append(row)
                g_ban_row[unit_offset + i] = len(ban_rows)
        BR = _pad(len(ban_rows) + 1, 8) if ban_rows else 1
        ban_mask = np.zeros((BR, N), bool)
        for i, row in enumerate(ban_rows):
            ban_mask[i + 1] = row

        # --- pool-level tensors (node-epoch cached) ---------------------------
        node_axes = nc["node_axes"]
        float_total = nc["float_total"]
        total_pool64 = nc["total_pool64"]
        total_pool = nc["total_pool"]
        drf_mult = nc["drf_mult"]
        inv_scale = nc["inv_scale"]
        round_cap = nc["round_cap"]
        C = len(self.pc_names)
        pc_queue_cap = nc["pc_queue_cap"]

        # --- per-queue demand shares (bincount per resource, not add.at) ------
        q_weight = np.zeros((Q,), np.float32)
        q_weight[:Qreal] = self.queue_weight
        q_cds = np.zeros((Q,), np.float32)
        q_penalty = np.zeros((Q, R), np.float32)
        if queue_penalty:
            for qname, atoms in queue_penalty.items():
                qi = self.queue_by_name.get(qname)
                if qi is not None:
                    q_penalty[qi] = self.factory.ceil_units(atoms).astype(np.float32)
        q_demand_raw = [0.0] * Qreal
        if Qreal and R:
            demand_by_pc = np.zeros((Qreal * C, R), np.float64)
            queued_slice = slice(E, nreal_g)
            qidx = (
                g_queue[queued_slice].astype(np.int64) * C
                + g_pc[queued_slice].astype(np.int64)
            )
            contrib = (
                g_req[queued_slice].astype(np.float64) * g_card[queued_slice, None]
            )
            ridx = run_queue[:nr].astype(np.int64) * C + run_pc[:nr].astype(np.int64)
            for r in range(R):
                if qidx.shape[0]:
                    demand_by_pc[:, r] += np.bincount(
                        qidx, weights=contrib[:, r], minlength=Qreal * C
                    )
                if nr:
                    demand_by_pc[:, r] += np.bincount(
                        ridx,
                        weights=run_req[:nr, r].astype(np.float64),
                        minlength=Qreal * C,
                    )
            demand_by_pc = demand_by_pc.reshape(Qreal, C, R)
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = np.maximum(total_pool, 1e-9)
                raw = demand_by_pc.sum(axis=1)
                capped = np.minimum(demand_by_pc, pc_queue_cap[None]).sum(axis=1)
                capped = np.minimum(capped, total_pool.astype(np.float64)[None])
                frac = np.where(total_pool[None] > 0, capped / denom[None], 0.0)
                rawfrac = np.where(total_pool[None] > 0, raw / denom[None], 0.0)
            q_cds[:Qreal] = np.maximum(0.0, (frac * drf_mult[None]).max(axis=1))
            q_demand_raw = [
                float(v)
                for v in np.maximum(0.0, (rawfrac * drf_mult[None]).max(axis=1))
            ]

        # --- burst caps -------------------------------------------------------
        burst_cfg = cfg.maximum_scheduling_burst or 2**31 - 1
        if global_tokens is not None:
            burst_cfg = max(0, min(burst_cfg, int(global_tokens)))
        perq_cfg = cfg.maximum_per_queue_scheduling_burst or 2**31 - 1
        perq_burst = np.full((Q,), 2**31 - 1, np.int32)
        for qname, qi in self.queue_by_name.items():
            cap = perq_cfg
            if queue_tokens is not None and qname in queue_tokens:
                cap = max(0, min(cap, int(queue_tokens[qname])))
            perq_burst[qi] = min(cap, 2**31 - 1)

        max_card = int(g_card[:nreal_g].max()) if nreal_g else 1
        if max_card > 10_000:
            raise ValueError(f"gang cardinality {max_card} exceeds the supported 10k")
        W = max(1, min(max_card, N))
        S_slots = max(1, min(nreal_g, burst_cfg))
        type_bias, key_type_row, compat_pre_type = self._type_tables()

        problem = SchedulingProblem(
            node_total=node_total,
            node_type=node_type,
            node_ok=node_ok,
            run_req=run_req,
            run_node=run_node,
            run_level=run_level,
            run_queue=run_queue,
            run_pc=run_pc,
            run_preemptible=run_preempt,
            run_gang=run_gang,
            run_valid=run_valid,
            g_req=g_req,
            g_card=g_card,
            g_level=g_level,
            g_queue=g_queue,
            g_key=g_key,
            g_pc=g_pc,
            g_order=g_order.astype(np.int32),
            g_run=g_run,
            g_valid=g_valid,
            g_absent=np.zeros_like(g_valid),
            g_price=g_price,
            g_spot_price=g_spot,
            gq_gang=gq_gang,
            q_start=q_start,
            q_len=q_len,
            q_weight=q_weight,
            q_cds=q_cds,
            q_penalty=q_penalty,
            compat=self._compat_matrix(),
            total_pool=total_pool,
            drf_mult=drf_mult,
            inv_scale=inv_scale,
            round_cap=round_cap,
            pc_queue_cap=pc_queue_cap,
            protected_fraction=np.float32(
                _INF if away_mode else cfg.protected_fraction_of_fair_share
            ),
            global_burst=np.int32(min(burst_cfg, 2**31 - 1)),
            perq_burst=perq_burst,
            node_axes=node_axes,
            float_total=float_total,
            market=np.bool_(self.market),
            spot_cutoff=self.spot_cutoff,
            ban_mask=ban_mask,
            g_ban_row=g_ban_row,
            type_bias=type_bias,
            key_type_row=key_type_row,
            compat_pre_type=compat_pre_type,
        )

        gang_ids_vec = np.zeros((nreal_g,), _ID_DTYPE)
        if S:
            gang_ids_vec[E : E + S] = jt.ids[rows]
        members_over: dict[int, list] = {}
        gang_group = [""] * nreal_g
        for i, (u, _, members, _) in enumerate(kept_units):
            members_over[unit_offset + i] = list(members)
            gang_group[unit_offset + i] = u["tag"]

        ctx = HostContext(
            config=cfg,
            pool=self.pool,
            queue_names=list(self.queue_names),
            node_ids=list(self.node_ids),
            gang_members=None,
            gang_group=gang_group,
            run_job_ids=None,
            num_real_nodes=Nreal,
            num_real_queues=Qreal,
            num_real_gangs=nreal_g,
            num_real_runs=nr,
            ladder=self.ladder,
            pc_names=list(self.pc_names),
            max_slots=S_slots,
            slot_width=W,
            type_names=[nt.hw_type for nt in self.ntidx.types],
            q_demand_raw=q_demand_raw,
            pool_total_atoms={
                name: int(round(float(total_pool64[i]) * self.factory.resolutions[i]))
                for i, name in enumerate(self.factory.names)
                if total_pool64[i]
            },
            gang_ids_vec=gang_ids_vec,
            gang_members_over=members_over,
            run_ids_vec=rt.ids[run_rows],
            # lazy: materialized only by a round that actually preempted
            # (models._iter_partial_gangs); eager per-member locates would
            # tax every assemble for a rarely-consumed mapping.  run_rows is
            # in KEY order (not ascending) since the table grew its overlay
            # region, so the row -> axis-position map is a dict, built when
            # the thunk fires.
            running_gangs=lambda: self._running_gang_ctx_groups(
                lambda row, _m={int(r): i for i, r in enumerate(run_rows)}: (
                    _m.get(int(row))
                )
            ),
        )
        return problem, ctx

    # ------------------------------------------------ slab delta assemble ----

    def _stable(self, name: str, arr: np.ndarray) -> np.ndarray:
        """Identity-stable small tensor: hand back the previous object while
        the VALUE is unchanged, so the device cache's identity check skips
        the re-upload (the same trick _node_cache plays for node tensors)."""
        prev = self._stable_smalls.get(name)
        if (
            prev is not None
            and prev.shape == arr.shape
            and prev.dtype == arr.dtype
            and np.array_equal(prev, arr)
        ):
            return prev
        self._stable_smalls[name] = arr
        return arr

    def _single_content_cols(self, i_sing: np.ndarray, prices) -> dict:
        """Gang-axis content rows for singles-region slots `i_sing` -- the
        ONE extraction both assemble_delta's bundle and prefetch_content
        share, so the prefetched bytes are bit-identical to what the cycle
        bundle would have scattered."""
        sg = self._sg
        n = i_sing.shape[0]
        if prices is not None:
            # per-slot price is a pure function of (queue, band); stale
            # content at free slots is g_absent so any value is harmless
            sing_price = prices[
                sg.queue[i_sing].astype(np.int64), sg.band[i_sing].astype(np.int64)
            ]
        else:
            sing_price = np.zeros((n,), np.float32)
        valid = sg.valid[i_sing]
        return {
            "g_req": sg.req[i_sing],
            "g_card": np.ones((n,), np.int32),
            "g_level": sg.level[i_sing],
            "g_queue": sg.queue[i_sing],
            "g_key": sg.key[i_sing],
            "g_pc": sg.pc[i_sing],
            "g_run": np.full((n,), -1, np.int32),
            "g_valid": valid,
            "g_absent": ~valid,
            "g_price": sing_price,
            "g_spot_price": sing_price,
            "g_ban_row": np.zeros((n,), np.int32),
        }

    def _run_content_cols(
        self, rr_dirty: np.ndarray, s_cap: int, prices
    ) -> tuple[dict, dict]:
        """Run-axis rows + their evictee-region projection for run slots
        `rr_dirty` (shared by assemble_delta and prefetch_content)."""
        rr = self._rr
        if prices is not None:
            ev_price = prices[
                rr.queue[rr_dirty].astype(np.int64), rr.band[rr_dirty].astype(np.int64)
            ]
        else:
            ev_price = np.zeros((rr_dirty.shape[0],), np.float32)
        rr_valid_rows = rr.valid[rr_dirty]
        rr_preempt_rows = rr.preempt[rr_dirty]
        ev_valid_rows = rr_valid_rows & rr_preempt_rows
        rr_cols = {
            "run_req": rr.req[rr_dirty],
            "run_node": rr.node[rr_dirty],
            "run_level": rr.level[rr_dirty],
            "run_queue": rr.queue[rr_dirty],
            "run_pc": rr.pc[rr_dirty],
            "run_preemptible": rr_preempt_rows,
            "run_gang": np.where(
                ev_valid_rows, (s_cap + rr_dirty).astype(np.int32), np.int32(-1)
            ),
            "run_valid": rr_valid_rows,
        }
        ev_cols = {
            "g_req": rr.req[rr_dirty],
            "g_level": rr.level[rr_dirty],
            "g_queue": rr.queue[rr_dirty],
            "g_pc": rr.pc[rr_dirty],
            "g_run": rr_dirty.astype(np.int32),
            "g_valid": ev_valid_rows,
            "g_absent": ~ev_valid_rows,
            "g_price": ev_price,
            "g_spot_price": ev_price,
        }
        return rr_cols, ev_cols

    def prefetch_content(self, devcache) -> int:
        with _trace().span("prefetch_content", pool=self.pool):
            return self._prefetch_content(devcache)

    def _prefetch_content(self, devcache) -> int:
        """Shadow-pipeline stage (b): ship decision-INDEPENDENT dirty slot
        rows (new submits, caller-synced leases) to the device NOW -- while
        the current round's kernel and result transfer are in flight --
        so the next assemble_delta's bundle only carries lease/evict rows
        that genuinely had to wait for decode.

        The dependency classification this encodes: slot CONTENT
        is final the moment the table mutation lands and may ship any time
        before the next assemble; candidate ORDER, queue tensors, demand
        shares and scalars are functions of the whole post-decision state
        and only ever ship with assemble_delta's bundle.  Shipping content
        early is bit-neutral -- the device ends the next apply identical to
        materialize() either way (tests/test_pipeline.py pins it).

        Returns the number of rows shipped (0 = skipped).  Skips -- and the
        rows simply ride the next bundle or its full-upload fallback --
        when: the pool is market-driven (per-slot prices are a per-cycle
        function of the bid table, not final until assemble); no bundle was
        emitted yet; slab/node/price epochs moved since the last bundle
        (the next apply full-uploads anyway, and a scatter against the old
        shapes would silently drop rows); or the device cache is not
        exactly at the last bundle's state."""
        if self.market or self._last_sig is None:
            return 0
        gen = self._prefetch_gen
        sg, rr = self._sg, self._rr
        new_sg = sg.dirty_log[self._shipped_sg :]
        new_rr = rr.dirty_log[self._shipped_rr :]
        if not new_sg and not new_rr:
            return 0
        s_cap, r_cap = sg.cap, rr.cap
        sig = (
            s_cap + r_cap + self._u_cap,
            r_cap,
            self._last_sig[2],  # N: node_epoch match implies the same pad
            self._last_sig[3],  # Q: content rows never reshape the queue axis
            sg.epoch,
            rr.epoch,
            self._u_cap,
            self._node_epoch,
            self._price_epoch,
        )
        if sig != self._last_sig:
            return 0
        i_sing = np.unique(np.asarray(new_sg, np.int64))
        rr_d = np.unique(np.asarray(new_rr, np.int64))
        rr_cols, ev_cols = self._run_content_cols(rr_d, s_cap, None)
        ok = devcache.scatter_content(
            sig=sig,
            seq=self._bundle_seq,
            ev_base=s_cap,
            sg_idx=i_sing,
            sg_cols=self._single_content_cols(i_sing, None),
            rr_idx=rr_d,
            rr_cols=rr_cols,
            ev_cols=ev_cols,
        )
        if not ok or gen != self._prefetch_gen:
            # gen moved: invalidate_prefetch() ran while the scatter was in
            # flight (device loss mid-prefetch) -- the devcache was replaced
            # or reset, so these rows must STAY in the next bundle's payload.
            return 0
        # Race harness (ARMADA_TSAN=1): marking rows shipped is only sound
        # under the generation the scatter began under -- if the guard above
        # ever regresses, this records the stale write instead of letting it
        # silently drop rows from the next bundle.
        _tsan_check_gen("builder.prefetch_mark", gen, self._prefetch_gen)
        self._shipped_sg = len(sg.dirty_log)
        self._shipped_rr = len(rr.dirty_log)
        return int(i_sing.shape[0] + rr_d.shape[0])

    def invalidate_prefetch(self) -> None:
        """Explicit device-loss invalidation (core/watchdog reset hooks):
        forget that any dirty rows were shipped -- they re-enter the next
        bundle's payload (harmless superset: the reset device cache
        full-uploads anyway) -- and disarm prefetching until a new bundle
        establishes a device state to scatter against.  The gen bump
        defeats the in-flight-prefetch race (see prefetch_content)."""
        self._last_sig = None
        self._shipped_sg = 0
        self._shipped_rr = 0
        self._prefetch_gen += 1

    def assemble_delta(
        self,
        *,
        global_tokens=None,
        queue_tokens=None,
        queue_penalty: Optional[Mapping] = None,
    ):
        with _trace().span("assemble", pool=self.pool):
            return self._assemble_delta(
                global_tokens=global_tokens,
                queue_tokens=queue_tokens,
                queue_penalty=queue_penalty,
            )

    def _assemble_delta(
        self,
        *,
        global_tokens=None,
        queue_tokens=None,
        queue_penalty: Optional[Mapping] = None,
    ):
        """One cycle's device update on the slot-stable slab layout.

        Returns (DeltaBundle, HostContext).  Feed the bundle to a
        slab.DeviceDeltaCache for a device-resident SchedulingProblem kept
        current by scatter (O(deltas) upload per cycle -- the point: the
        dense layout assemble() emits shifts positionally every cycle, so
        ~85% of the 1M-row job tensors would re-upload).
        bundle.materialize() builds the equivalent full host problem (first
        upload / fallback / tests; must be called before further builder
        mutations).

        Candidate order, demand and outcomes are identical to assemble() --
        only the gang/run axis layout differs (stable slots + absent holes
        vs packed positions).  Away-mode stays on assemble().  Market pools
        ride the same slots: order is per-cycle anyway (gq permutation via
        _market_perm), per-slot prices are scattered with the dirty rows,
        and a price-table MOVE bumps a sig epoch so the device cache falls
        back to one full upload.  tests/test_slab_delta.py pins both the
        outcome equivalence and scatter==materialize bit-equality."""
        from armada_tpu_torch.models.slab import DeltaBundle

        if self._retype_needed:
            self._retype_nodes()
        cfg = self.config
        R = self.R
        qbucket = min(cfg.shape_bucket, 256)
        nbucket = _node_bucket(cfg.shape_bucket)
        Qreal = len(self.queue_names)
        Nreal = len(self.node_ids)
        N = _pad(Nreal, nbucket)
        nc = self._node_cache
        if nc is None or nc["key"] != (self._node_epoch, N):
            nc = self._build_node_tensors(N, Nreal)
            self._node_cache = nc

        jt, rt = self.jobs, self.runs
        sg, rr = self._sg, self._rr

        prices = self._prices()  # market: per-cycle (queue, band) bid table
        if prices is not None and (
            self._last_prices is None
            or self._last_prices.shape != prices.shape
            or not np.array_equal(self._last_prices, prices)
        ):
            self._price_epoch += 1
            self._last_prices = prices

        # --- singles: live rows, (queue, order-key) table order ---------------
        rows = jt.live_rows()
        mask_known = np.ones(rows.shape[0], bool)
        if Qreal and not self.queue_known.all():
            mask_known = self.queue_known[jt.qi[rows]]
        rows_known = rows[mask_known]
        idx_known = np.flatnonzero(mask_known)
        if prices is not None:
            perm = self._market_perm(jt, rows_known, prices)
            rows_known = rows_known[perm]
            idx_known = idx_known[perm]
        sq = jt.qi[rows_known].astype(np.int64)
        counts_s = np.bincount(sq, minlength=Qreal)
        starts_s = np.zeros((max(1, Qreal),), np.int64)
        if Qreal:
            starts_s[1:Qreal] = np.cumsum(counts_s)[:-1]
        rank_s = np.arange(rows_known.shape[0], dtype=np.int64) - starts_s[sq]

        # --- units merged into the per-queue order (same as assemble()) -------
        units, unit_members, unit_ubans = self._gang_units(prices)
        if units:
            unit_qi = np.array([u["qi"] for u in units], np.int64)
            unit_vrank = np.array([u["rank"] for u in units], np.int64)
            shift = np.zeros(rows_known.shape[0], np.int64)
            units_before = np.zeros(len(units), np.int64)
            for q in np.unique(unit_qi):
                in_q = np.flatnonzero(unit_qi == q)
                order_q = in_q[np.argsort(unit_vrank[in_q], kind="stable")]
                units_before[order_q] = np.arange(in_q.shape[0])
                ur = np.sort(unit_vrank[in_q])
                sel = sq == q
                shift[sel] = np.searchsorted(ur, rank_s[sel], "right")
            merged_rank_s = rank_s + shift
            merged_rank_u = unit_vrank + units_before
        else:
            merged_rank_s = rank_s
            merged_rank_u = np.zeros((0,), np.int64)

        L = cfg.max_queue_lookback
        keep_s = merged_rank_s < L
        rows_kept = rows_known[keep_s]
        sq_kept = sq[keep_s]
        merged_rank_kept = merged_rank_s[keep_s]
        kept_units: list[tuple] = []
        if units:
            cut_tags = {
                units[i]["tag"]
                for i in range(len(units))
                if units[i]["tag"] and merged_rank_u[i] >= L
            }
            for i, u in enumerate(units):
                if merged_rank_u[i] >= L or (u["tag"] and u["tag"] in cut_tags):
                    continue
                kept_units.append((u, merged_rank_u[i], unit_members[i], unit_ubans[i]))

        # --- singles participation flips -> slab validity + demand ------------
        slots_live = jt.slot[rows].astype(np.int64)
        valid_flags = np.zeros(rows.shape[0], bool)
        valid_flags[idx_known[keep_s]] = True
        cur_valid = sg.valid[slots_live]
        flip_on = slots_live[valid_flags & ~cur_valid]
        flip_off = slots_live[~valid_flags & cur_valid]
        for flips, sign in ((flip_on, 1.0), (flip_off, -1.0)):
            if flips.size:
                np.add.at(
                    self._demand_sg,
                    (sg.queue[flips].astype(np.int64), sg.pc[flips].astype(np.int64)),
                    sign * sg.req[flips].astype(np.float64),
                )
        sg.set_valid(flip_on, True)
        sg.set_valid(flip_off, False)

        # --- runs participation flips (queue/node filters) --------------------
        run_rows = rt.live_rows()
        rvalid = np.ones(run_rows.shape[0], bool)
        if Qreal and not self.queue_known.all():
            rvalid &= self.queue_known[rt.qi[run_rows]]
        if Nreal and not self.node_present.all():
            rvalid &= self.node_present[rt.node[run_rows]]
        rslots = rt.slot[run_rows].astype(np.int64)
        cur_rvalid = rr.valid[rslots]
        rflip_on = rslots[rvalid & ~cur_rvalid]
        rflip_off = rslots[~rvalid & cur_rvalid]
        for flips, sign in ((rflip_on, 1.0), (rflip_off, -1.0)):
            if flips.size:
                np.add.at(
                    self._demand_run,
                    (rr.queue[flips].astype(np.int64), rr.pc[flips].astype(np.int64)),
                    sign * rr.req[flips].astype(np.float64),
                )
        rr.set_valid(rflip_on, True)
        rr.set_valid(rflip_off, False)

        # evictee candidates: preemptible valid runs, table order
        ev_mask = rt.preempt[run_rows] & rvalid
        ev_rows = run_rows[ev_mask]
        if prices is not None:
            ev_rows = ev_rows[self._market_perm(rt, ev_rows, prices)]
        evq = rt.qi[ev_rows].astype(np.int64)

        # --- region layout -----------------------------------------------------
        # Zero-size axes break the kernel's gathers (legacy pads to >=1
        # bucket); grow empty slabs to their first bucket up front.
        if sg.cap == 0:
            sg._grow(1)
        if rr.cap == 0:
            rr._grow(1)
        s_cap = sg.cap
        r_cap = rr.cap
        u_n = len(kept_units)
        if u_n > self._u_cap:
            # geometric like the slabs: u_cap feeds G and the bundle sig, so
            # every change forces a full upload -- gang-heavy bursts must
            # not cross a pad per cycle
            self._u_cap = max(_pad(u_n, 64), _pad(int(self._u_cap * 1.5), 64))
        u_cap = self._u_cap
        u_base = s_cap + r_cap
        G = s_cap + r_cap + u_cap
        if self._g_ids.shape[0] != G:
            new_ids = np.zeros((G,), _ID_DTYPE)
            n_keep = min(self._g_ids.shape[0], s_cap)
            new_ids[:n_keep] = self._g_ids[:n_keep]
            self._g_ids = new_ids

        # --- units region content (rebuilt wholesale; small) ------------------
        uc = {
            "g_req": np.zeros((u_cap, R), np.float32),
            "g_card": np.zeros((u_cap,), np.int32),
            "g_level": np.zeros((u_cap,), np.int32),
            "g_queue": np.zeros((u_cap,), np.int32),
            "g_key": np.full((u_cap,), -1, np.int32),
            "g_pc": np.zeros((u_cap,), np.int32),
            "g_run": np.full((u_cap,), -1, np.int32),
            "g_valid": np.zeros((u_cap,), bool),
            "g_absent": np.ones((u_cap,), bool),
            "g_price": np.zeros((u_cap,), np.float32),
            "g_spot_price": np.zeros((u_cap,), np.float32),
            "g_ban_row": np.zeros((u_cap,), np.int32),
        }
        ban_rows: list[np.ndarray] = []
        members_over: dict[int, list] = {}
        group_of: dict[int, str] = {}
        demand_u = np.zeros((max(1, Qreal), len(self.pc_names), R), np.float64)
        for i, (u, _, members, uban) in enumerate(kept_units):
            uc["g_req"][i] = u["req"]
            uc["g_card"][i] = u["card"]
            uc["g_level"][i] = u["level"]
            uc["g_queue"][i] = u["qi"]
            uc["g_key"][i] = u["key"]
            uc["g_pc"][i] = u["pc"]
            uc["g_valid"][i] = not u["dead"]
            uc["g_absent"][i] = False
            uc["g_price"][i] = u["price"]
            uc["g_spot_price"][i] = u["spot"]
            members_over[u_base + i] = list(members)
            if u["tag"]:
                group_of[u_base + i] = u["tag"]
            demand_u[u["qi"], u["pc"]] += u["req"].astype(np.float64) * u["card"]
            bans = set()
            for jid in members:
                bans.update(self.banned.get(jid, ()))
            if not uban and not bans:
                continue
            row = np.zeros((N,), bool)
            for ni in uban or ():
                row[ni] = True
            for nid in bans:
                ni = self.node_index.get(nid)
                if ni is not None:
                    row[ni] = True
            if row.any():
                ban_rows.append(row)
                uc["g_ban_row"][i] = len(ban_rows)
        # monotone + geometric (like the slabs): BR feeds the problem shape,
        # so per-cycle swings in retry-banned gang counts must not recompile
        need_br = _pad(len(ban_rows) + 1, 8) if ban_rows else 1
        if need_br > self._br_cap:
            self._br_cap = max(need_br, _pad(int(self._br_cap * 1.5), 8))
        BR = self._br_cap
        ban_mask = np.zeros((BR, N), bool)
        for i, row in enumerate(ban_rows):
            ban_mask[i + 1] = row

        # --- final candidate order: sorted merge on slot ids ------------------
        key_s = (sq_kept << 32) | merged_rank_kept
        seq_s = jt.slot[rows_kept].astype(np.int32)
        if kept_units:
            key_u = np.array(
                [(int(u["qi"]) << 32) | int(mr) for (u, mr, _, _) in kept_units],
                np.int64,
            )
            order_u = np.argsort(key_u, kind="stable")
            key_u = key_u[order_u]
            seq_u = (u_base + order_u).astype(np.int32)
            pos = np.searchsorted(key_s, key_u)
            queued_seq = np.insert(seq_s, pos, seq_u)
            queued_q = np.insert(
                sq_kept,
                pos,
                np.array([u["qi"] for (u, _, _, _) in kept_units], np.int64)[order_u],
            )
        else:
            queued_seq = seq_s
            queued_q = sq_kept

        ev_seq = (s_cap + rt.slot[ev_rows].astype(np.int64)).astype(np.int32)
        pos_e = np.searchsorted(queued_q, evq, "left")
        gq_real = np.insert(queued_seq, pos_e, ev_seq)
        gq_q = np.insert(queued_q, pos_e, evq)
        nreal_candidates = gq_real.shape[0]

        Q = _pad(Qreal, qbucket)
        q_len64 = np.bincount(gq_q, minlength=Q)
        q_start = np.zeros((Q,), np.int32)
        q_start[1:] = np.cumsum(q_len64)[:-1].astype(np.int32)
        q_len = q_len64.astype(np.int32)
        gq_gang = np.zeros((G,), np.int32)
        gq_gang[:nreal_candidates] = gq_real

        # --- demand -> constrained shares (assemble()'s exact math) -----------
        C = len(self.pc_names)
        total_pool = nc["total_pool"]
        total_pool64 = nc["total_pool64"]
        drf_mult = nc["drf_mult"]
        pc_queue_cap = nc["pc_queue_cap"]
        q_weight = np.zeros((Q,), np.float32)
        q_weight[:Qreal] = self.queue_weight
        q_cds = np.zeros((Q,), np.float32)
        q_penalty = np.zeros((Q, R), np.float32)
        if queue_penalty:
            for qname, atoms in queue_penalty.items():
                qi = self.queue_by_name.get(qname)
                if qi is not None:
                    q_penalty[qi] = self.factory.ceil_units(atoms).astype(np.float32)
        q_demand_raw = [0.0] * Qreal
        if Qreal and R:
            demand_by_pc = (
                self._demand_sg[:Qreal] + self._demand_run[:Qreal] + demand_u[:Qreal]
            )
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = np.maximum(total_pool, 1e-9)
                raw = demand_by_pc.sum(axis=1)
                capped = np.minimum(demand_by_pc, pc_queue_cap[None]).sum(axis=1)
                capped = np.minimum(capped, total_pool.astype(np.float64)[None])
                frac = np.where(total_pool[None] > 0, capped / denom[None], 0.0)
                rawfrac = np.where(total_pool[None] > 0, raw / denom[None], 0.0)
            q_cds[:Qreal] = np.maximum(0.0, (frac * drf_mult[None]).max(axis=1))
            q_demand_raw = [
                float(v)
                for v in np.maximum(0.0, (rawfrac * drf_mult[None]).max(axis=1))
            ]

        # --- burst caps -------------------------------------------------------
        burst_cfg = cfg.maximum_scheduling_burst or 2**31 - 1
        if global_tokens is not None:
            burst_cfg = max(0, min(burst_cfg, int(global_tokens)))
        perq_cfg = cfg.maximum_per_queue_scheduling_burst or 2**31 - 1
        perq_burst = np.full((Q,), 2**31 - 1, np.int32)
        for qname, qi in self.queue_by_name.items():
            cap = perq_cfg
            if queue_tokens is not None and qname in queue_tokens:
                cap = max(0, min(cap, int(queue_tokens[qname])))
            perq_burst[qi] = min(cap, 2**31 - 1)

        max_card = max((int(u["card"]) for (u, _, _, _) in kept_units), default=1)
        if max_card > 10_000:
            raise ValueError(f"gang cardinality {max_card} exceeds the supported 10k")
        W = max(1, min(max_card, N))
        S_slots = max(1, min(max(nreal_candidates, 1), burst_cfg))

        # --- dirty extraction -------------------------------------------------
        # Two views of each dirty log: ALL dirtied slots (the gq splice and
        # any order accounting must treat a prefetched slot as moved), and
        # the PAYLOAD suffix -- rows not already shipped mid-cycle by
        # prefetch_content.  A slot both prefetched and re-dirtied later
        # appears in the suffix and re-ships (content wins by last write).
        sg_log = (
            np.asarray(sg.dirty_log, np.int64)
            if sg.dirty_log
            else np.zeros((0,), np.int64)
        )
        sg_dirty_all = np.unique(sg_log)
        sg_dirty = (
            np.unique(sg_log[self._shipped_sg :])
            if self._shipped_sg
            else sg_dirty_all
        )
        sg.dirty_log.clear()
        self._shipped_sg = 0
        unit_dirty = np.arange(u_base, u_base + max(u_n, self._u_prev_n), dtype=np.int64)
        self._u_prev_n = u_n
        sg_idx = np.concatenate([sg_dirty, unit_dirty])
        rr_log = (
            np.asarray(rr.dirty_log, np.int64)
            if rr.dirty_log
            else np.zeros((0,), np.int64)
        )
        rr_dirty_all = np.unique(rr_log)
        rr_dirty = (
            np.unique(rr_log[self._shipped_rr :])
            if self._shipped_rr
            else rr_dirty_all
        )
        rr.dirty_log.clear()
        self._shipped_rr = 0

        # --- gq splice: rebuild the order vector ON DEVICE from last cycle's
        # (slab.DeltaBundle.gq_splice) instead of re-uploading 4MB.  Sound
        # exactly when the SURVIVING candidates' relative order is unchanged
        # (steady state: departures + arrivals, order carried by the stable
        # tables); verified against our own previous vector -- the device's
        # copy matches it whenever the cache takes the delta path
        # (seq-consecutive + same sig), and any fallback re-uploads whole.
        # Slots dirtied THIS cycle never count as survivors: a slot released
        # by a scheduled job and re-allocated to a fresh submit keeps its id
        # but moves position (remove old + insert new is always sound).
        gq_splice = None
        prev_gq, L0 = self._prev_gq, self._prev_gq_real
        L1 = int(nreal_candidates)
        if prev_gq is not None and prev_gq.shape[0] == G:
            dirty_slot = np.zeros((G,), bool)
            # ALL dirtied slots, prefetched or not: a prefetched slot's
            # content is on device but its ORDER position may have moved
            # (release + re-alloc keeps the id), so it must not count as a
            # splice survivor.
            dirty_slot[sg_dirty_all[sg_dirty_all < G]] = True
            dirty_slot[unit_dirty[unit_dirty < G]] = True
            ev_dirty = s_cap + rr_dirty_all
            dirty_slot[ev_dirty[ev_dirty < G]] = True  # evictee projection
            prev_real = prev_gq[:L0]
            in_new = np.zeros((G,), bool)
            in_new[gq_real] = True
            in_prev = np.zeros((G,), bool)
            in_prev[prev_real] = True
            surv = in_new & in_prev & ~dirty_slot
            dep = ~surv[prev_real]  # departed/moved, prev positions
            arr = ~surv[gq_real]  # arrived/moved, final positions
            kept_prev = prev_real[~dep]
            new_minus = gq_real[~arr]
            if kept_prev.shape[0] == new_minus.shape[0] and np.array_equal(
                kept_prev, new_minus
            ):
                rem = np.flatnonzero(dep)
                ins = np.flatnonzero(arr)
                vals = gq_real[ins]
                # padded-tail zeros shift with the real-region length
                if L1 > L0:  # fewer tail zeros: drop from the prev tail
                    rem = np.concatenate([rem, np.arange(G - (L1 - L0), G)])
                elif L0 > L1:  # more tail zeros: insert at the final tail
                    ins = np.concatenate([ins, np.arange(G - (L0 - L1), G)])
                    vals = np.concatenate(
                        [vals, np.zeros((L0 - L1,), vals.dtype)]
                    )
                # a big splice costs more than the 4MB it saves
                if rem.shape[0] + ins.shape[0] <= max(4096, G // 8):
                    gq_splice = (
                        rem.astype(np.int32),
                        ins.astype(np.int32),
                        vals.astype(np.int32),
                    )
        # gq_gang is freshly allocated per cycle and never mutated after
        # this point: keep the reference, no 4MB copy
        self._prev_gq = gq_gang
        self._prev_gq_real = L1

        is_unit = sg_idx >= u_base
        i_sing = sg_idx[~is_unit]
        i_unit = sg_idx[is_unit] - u_base
        k = sg_idx.shape[0]

        def sg_field(name, sing_vals):
            out = np.zeros((k,) + sing_vals.shape[1:], uc[name].dtype)
            out[~is_unit] = sing_vals
            out[is_unit] = uc[name][i_unit]
            return out

        sc = self._single_content_cols(i_sing, prices)
        sg_cols = {name: sg_field(name, vals) for name, vals in sc.items()}
        rr_cols, ev_cols = self._run_content_cols(rr_dirty, s_cap, prices)
        type_bias, key_type_row, compat_pre_type = self._type_tables()

        fulls = {
            # omitted when the splice carries the order (a few KB vs 4MB)
            **({} if gq_splice is not None else {"gq_gang": gq_gang}),
            "q_start": q_start,
            "q_len": q_len,
            "q_weight": self._stable("q_weight", q_weight),
            "q_cds": q_cds,
            "q_penalty": self._stable("q_penalty", q_penalty),
            "compat": self._compat_matrix(),
            "type_bias": type_bias,
            "key_type_row": key_type_row,
            "compat_pre_type": compat_pre_type,
            "total_pool": total_pool,
            "drf_mult": drf_mult,
            "inv_scale": nc["inv_scale"],
            "round_cap": nc["round_cap"],
            "pc_queue_cap": pc_queue_cap.astype(np.float32)
            if pc_queue_cap.dtype != np.float32
            else pc_queue_cap,
            "protected_fraction": self._stable(
                "protected_fraction",
                np.float32(cfg.protected_fraction_of_fair_share),
            ),
            "global_burst": self._stable(
                "global_burst", np.int32(min(burst_cfg, 2**31 - 1))
            ),
            "perq_burst": self._stable("perq_burst", perq_burst),
            "node_axes": nc["node_axes"],
            "float_total": nc["float_total"],
            "market": self._stable("market", np.bool_(self.market)),
            "spot_cutoff": self._stable("spot_cutoff", np.asarray(self.spot_cutoff)),
            "ban_mask": self._stable("ban_mask", ban_mask),
            "node_total": nc["node_total"],
            "node_type": nc["node_type"],
            "node_ok": nc["node_ok"],
        }

        def materialize():
            """Full host problem equal to what the scatter stream maintains
            (called on first upload / fallback; also the test oracle).  Must
            run before further builder mutations."""
            if prices is not None:
                slot_price = np.concatenate(
                    [
                        prices[
                            sg.queue.astype(np.int64), sg.band.astype(np.int64)
                        ],
                        prices[
                            rr.queue.astype(np.int64), rr.band.astype(np.int64)
                        ],
                        uc["g_price"],
                    ]
                )
                slot_spot = np.concatenate(
                    [
                        slot_price[: s_cap + r_cap],
                        uc["g_spot_price"],
                    ]
                )
            else:
                slot_price = np.zeros((G,), np.float32)
                slot_spot = slot_price
            g_valid_full = np.concatenate(
                [sg.valid, rr.valid & rr.preempt, uc["g_valid"]]
            )
            g_absent_full = np.concatenate(
                [~sg.valid, ~(rr.valid & rr.preempt), uc["g_absent"]]
            )
            run_gang_full = np.where(
                rr.valid & rr.preempt,
                (s_cap + np.arange(r_cap)).astype(np.int32),
                np.int32(-1),
            )
            return SchedulingProblem(
                node_total=nc["node_total"],
                node_type=nc["node_type"],
                node_ok=nc["node_ok"],
                run_req=rr.req.copy(),
                run_node=rr.node.copy(),
                run_level=rr.level.copy(),
                run_queue=rr.queue.copy(),
                run_pc=rr.pc.copy(),
                run_preemptible=rr.preempt.copy(),
                run_gang=run_gang_full,
                run_valid=rr.valid.copy(),
                g_req=np.concatenate([sg.req, rr.req, uc["g_req"]]),
                g_card=np.concatenate(
                    [
                        np.ones((s_cap,), np.int32),
                        np.ones((r_cap,), np.int32),
                        uc["g_card"],
                    ]
                ),
                g_level=np.concatenate([sg.level, rr.level, uc["g_level"]]),
                g_queue=np.concatenate([sg.queue, rr.queue, uc["g_queue"]]),
                g_key=np.concatenate(
                    [sg.key, np.full((r_cap,), -1, np.int32), uc["g_key"]]
                ),
                g_pc=np.concatenate([sg.pc, rr.pc, uc["g_pc"]]),
                g_order=np.zeros((G,), np.int32),
                g_run=np.concatenate(
                    [
                        np.full((s_cap,), -1, np.int32),
                        np.arange(r_cap, dtype=np.int32),
                        uc["g_run"],
                    ]
                ),
                g_valid=g_valid_full,
                g_absent=g_absent_full,
                g_price=slot_price,
                g_spot_price=slot_spot,
                gq_gang=gq_gang,
                q_start=q_start,
                q_len=q_len,
                q_weight=fulls["q_weight"],
                q_cds=q_cds,
                q_penalty=fulls["q_penalty"],
                compat=fulls["compat"],
                total_pool=total_pool,
                drf_mult=drf_mult,
                inv_scale=nc["inv_scale"],
                round_cap=nc["round_cap"],
                pc_queue_cap=fulls["pc_queue_cap"],
                protected_fraction=fulls["protected_fraction"],
                global_burst=fulls["global_burst"],
                perq_burst=fulls["perq_burst"],
                node_axes=nc["node_axes"],
                float_total=nc["float_total"],
                market=fulls["market"],
                spot_cutoff=fulls["spot_cutoff"],
                ban_mask=fulls["ban_mask"],
                g_ban_row=np.concatenate(
                    [
                        np.zeros((s_cap,), np.int32),
                        np.zeros((r_cap,), np.int32),
                        uc["g_ban_row"],
                    ]
                ),
                type_bias=fulls["type_bias"],
                key_type_row=fulls["key_type_row"],
                compat_pre_type=fulls["compat_pre_type"],
            )

        sig = (
            G,
            r_cap,
            N,
            Q,
            sg.epoch,
            rr.epoch,
            u_cap,
            self._node_epoch,
            # market: a price move re-prices every slot at once; ride the
            # full-upload fallback instead of dirtying the whole slab
            self._price_epoch,
        )
        seq = self._bundle_seq
        self._bundle_seq += 1
        self._last_sig = sig
        bundle = DeltaBundle(
            sig=sig,
            seq=seq,
            materialize=materialize,
            ev_base=s_cap,
            sg_idx=sg_idx,
            sg_cols=sg_cols,
            rr_idx=rr_dirty,
            rr_cols=rr_cols,
            ev_cols=ev_cols,
            fulls=fulls,
            gq_splice=gq_splice,
        )

        class _SparseGroups:
            __slots__ = ("_d",)

            def __init__(self, d):
                self._d = d

            def __getitem__(self, i):
                return self._d.get(i, "")

        ctx = HostContext(
            config=cfg,
            pool=self.pool,
            queue_names=list(self.queue_names),
            node_ids=list(self.node_ids),
            gang_members=None,
            gang_group=_SparseGroups(group_of),
            run_job_ids=None,
            num_real_nodes=Nreal,
            num_real_queues=Qreal,
            num_real_gangs=G,
            num_real_runs=r_cap,
            ladder=self.ladder,
            pc_names=list(self.pc_names),
            max_slots=S_slots,
            slot_width=W,
            type_names=[nt.hw_type for nt in self.ntidx.types],
            q_demand_raw=q_demand_raw,
            pool_total_atoms={
                name: int(round(float(total_pool64[i]) * self.factory.resolutions[i]))
                for i, name in enumerate(self.factory.names)
                if total_pool64[i]
            },
            # Copy-on-write snapshots: a mutation landing between assemble
            # and decode (slot reuse after remove) must not corrupt decode's
            # ids, but eagerly copying [G] ids cost ~30ms of every assemble;
            # now the first post-assemble id write copies instead.
            gang_ids_vec=self._share_g_ids(),
            gang_members_over=members_over,
            run_ids_vec=rr.share_ids(),
            # slab run axis IS the slot axis; lazy like the dense path (the
            # mapping reads slot-stable state, and the production flow
            # materializes within the decode window, before apply_outcome
            # mutates the tables)
            running_gangs=lambda: self._running_gang_ctx_groups(
                lambda row: (
                    int(s)
                    if rr.valid[(s := int(self.runs.slot[row]))]
                    else None
                )
            ),
        )
        return bundle, ctx

    # ---------------------------------------------------- gang slow path ----

    def _gang_units(self, prices=None):
        """Per-cycle Python for the complex residue: gang grouping,
        uniformity domains, joint hopeless check, banned singles -- the same
        decisions build_problem makes (problem.py queued-gang loop), derived
        against the live node/run tables.  Equivalence is pinned by
        tests/test_incremental.py."""
        if not self.gang_jobs:
            return [], [], []
        from armada_tpu_torch.core.keys import class_signature
        from armada_tpu_torch.models.problem import (
            _GangFitContext,
            _job_sort_key,
            _joint_capacity_ok,
            _uniform_domain_ban,
        )

        cfg = self.config
        # node_specs retains tombstones for removed nodes; mask their totals
        # to zero and their ok bit off so uniformity-domain picks and the
        # joint hopeless-capacity check see only live nodes (build_problem
        # constructs its fit context from the snapshot alone).
        fitctx = _GangFitContext(
            self.node_specs,
            self.node_total * self.node_present[:, None],
            self.node_index,
            self.factory,
            np.array(
                [
                    0.0 if name in set(cfg.floating_resource_names()) else 1.0
                    for name in self.factory.names
                ],
                np.float64,
            ),
        )
        fitctx.ok &= self.node_present
        run_rows = self.runs.live_rows()
        fitctx.set_running_usage(
            self.runs.req[run_rows],
            self.runs.node[run_rows],
            self.node_present[self.runs.node[run_rows]],
        )

        by_gang: dict[tuple, list[JobSpec]] = {}
        banned_singles: list[JobSpec] = []
        for spec in self.gang_jobs.values():
            qi = self.queue_by_name.get(spec.queue)
            if qi is None or not self.queue_known[qi]:
                continue
            if spec.gang_id:
                by_gang.setdefault((qi, spec.gang_id), []).append(spec)
            else:
                banned_singles.append(spec)

        units, members_out, ubans_out = [], [], []

        def add_unit(qi, lead_pc, lead, grp, key, tag, uban, dead):
            req = (
                self.factory.ceil_units(lead.resources.atoms).astype(np.float32)
                if lead.resources is not None
                else np.zeros((self.R,), np.float32)
            )
            # f32-canonical, like the [Q,B] table and the kernel's g_price
            # (build_problem rounds identically)
            price = (
                float(np.float32(self.bid_price_of(lead)))
                if self.bid_price_of
                else 0.0
            )
            spot = (
                price
                if len(grp) == 1
                else min(
                    float(np.float32(self.bid_price_of(m)))
                    if self.bid_price_of
                    else 0.0
                    for m in grp
                )
            )
            units.append(
                {
                    "qi": qi,
                    "rank": (
                        self._virtual_rank_market(qi, price, lead, prices)
                        if prices is not None
                        else self._virtual_rank(qi, lead_pc.priority, lead)
                    ),
                    "req": req,
                    "card": len(grp),
                    "level": self.level_of_priority[lead_pc.priority],
                    "pc": self.pc_index[lead_pc.name],
                    "key": key,
                    "price": price,
                    "spot": spot,
                    "tag": tag,
                    "dead": dead,
                    # market tie-break among same-rank units: the full
                    # (-price, sub, id) comparator (build_problem sorts its
                    # units list by unit_key; the merge below orders
                    # same-vrank units by list position)
                    "_sub": lead.submit_time,
                    "_id": lead.id,
                }
            )
            members_out.append([m.id for m in grp])
            ubans_out.append(uban or set())

        for spec in sorted(banned_singles, key=lambda s: s.id):
            pc = cfg.priority_class(spec.priority_class)
            key = self.kidx.key_of(
                spec,
                cfg.node_id_label,
                banned_nodes=self.banned.get(spec.id, ()),
            )
            add_unit(
                self.queue_by_name[spec.queue], pc, spec, [spec], key, "", None, False
            )

        for (qi, gang_id), members in sorted(by_gang.items()):
            gang_bans = (
                tuple(
                    sorted(set().union(*(self.banned.get(m.id, ()) for m in members)))
                )
                if self.banned
                else ()
            )
            label = members[0].gang_node_uniformity_label
            uniformity = ("", "")
            uban = None
            if label:
                prov: dict = {}
                for m in members:
                    prov.setdefault(
                        class_signature(m, cfg.node_id_label), []
                    ).append(m)
                classes = [(grp[0], len(grp)) for grp in prov.values()]
                if len(classes) == 1:
                    classes = [
                        (
                            members[0],
                            max(len(members), members[0].gang_cardinality or 1),
                        )
                    ]
                # Partially-running gang: re-queued members must rejoin the
                # running siblings' domain (problem.py pinned_values).  The
                # run table is id-keyed, so callers register running gang
                # membership via note_running_gang.
                pinned_values = set()
                for sib_id in self._running_gang_members.get((qi, gang_id), ()):
                    row = self.runs._locate(sib_id.encode())
                    if row is not None:
                        ni = int(self.runs.node[row])
                        # a sibling stranded on a REMOVED node pins nothing:
                        # build_problem drops that run before pinned_values
                        if not self.node_present[ni]:
                            continue
                        v = self.node_specs[ni].labels.get(label)
                        if v is not None:
                            pinned_values.add(v)
                if len(pinned_values) == 1:
                    chosen = next(iter(pinned_values))
                    allowed = {
                        int(i)
                        for i in fitctx.domains(label).get(
                            chosen, np.zeros(0, np.int64)
                        )
                    }
                    uban = set(range(fitctx.num_real)) - allowed
                else:
                    uban, chosen = _uniform_domain_ban(
                        fitctx, label, classes, gang_bans, cfg.node_id_label
                    )
                uniformity = (label, chosen)
            keys = {
                self.kidx.key_of(m, cfg.node_id_label, gang_bans, uniformity)
                for m in members
            }
            if len(keys) > 1:
                by_key: dict[int, list] = {}
                for m in members:
                    by_key.setdefault(
                        self.kidx.key_of(m, cfg.node_id_label, gang_bans, uniformity),
                        [],
                    ).append(m)
                groups = list(by_key.items())
            else:
                groups = [(next(iter(keys)), members)]
            tag = f"{qi}:{gang_id}" if len(groups) > 1 else ""
            dead = False
            if len(groups) > 1:
                class_info = []
                for _, grp in groups:
                    glead = grp[0]
                    usable = fitctx.ok & fitctx.static_fit(glead, cfg.node_id_label)
                    if uban:
                        usable = usable.copy()
                        usable[np.asarray(sorted(uban), np.int64)] = False
                    req_units = (
                        self.factory.ceil_units(glead.resources.atoms).astype(
                            np.float64
                        )
                        if glead.resources is not None
                        else np.zeros((self.R,), np.float64)
                    )
                    cap = fitctx.capacity(req_units, len(grp))
                    if int(cap[usable].sum()) < len(grp):
                        dead = True
                        break
                    class_info.append(
                        (usable, fitctx.frac_capacity(req_units), len(grp))
                    )
                if not dead:
                    dead = not _joint_capacity_ok(class_info)
            for grp_key, grp in groups:
                lead = min(
                    grp,
                    key=lambda m: _job_sort_key(
                        cfg.priority_class(m.priority_class).priority, m
                    ),
                )
                pc = cfg.priority_class(lead.priority_class)
                add_unit(qi, pc, lead, grp, grp_key, tag, uban, dead)
        if self.market and len(units) > 1:
            # List position breaks same-vrank ties in the assemble merge;
            # market mode needs that order to be the unit_key order.
            order = sorted(
                range(len(units)),
                key=lambda i: (
                    units[i]["qi"],
                    -units[i]["price"],
                    units[i]["_sub"],
                    units[i]["_id"],
                ),
            )
            units = [units[i] for i in order]
            members_out = [members_out[i] for i in order]
            ubans_out = [ubans_out[i] for i in order]
        return units, members_out, ubans_out

    # Running gang membership for the uniformity pin: maintained by lease()
    # callers via note_running_gang / forget_running_gang (the run table is
    # id-keyed and knows nothing of gangs).
    @property
    def _running_gang_members(self) -> dict:
        store = getattr(self, "_rgm", None)
        if store is None:
            store = {}
            self._rgm = store
        return store

    def _running_gang_ctx_groups(self, run_index_of) -> dict:
        """HostContext.running_gangs for this assemble: tag -> run indices of
        each running gang's preemptible members (problem.py's evictee-loop
        grouping; drives the partial-preemption cascade in
        run_round_on_device).  `run_index_of(row) -> Optional[int]` maps a
        runs-table row to the problem's run axis (position for the dense
        assemble, slot for the slab path)."""
        groups: dict = {}
        rt = self.runs
        for (qi, gang_id), members in self._running_gang_members.items():
            if len(members) < 2:
                continue
            ris = []
            for jid in sorted(members):
                row = rt._locate(jid.encode())
                if row is None or not rt.preempt[row]:
                    continue
                idx = run_index_of(row)
                if idx is not None:
                    ris.append(int(idx))
            if len(ris) > 1:
                groups[f"{qi}/{gang_id}"] = tuple(ris)
        return groups

    def note_running_gang(self, queue: str, gang_id: str, job_id: str) -> None:
        qi = self.queue_by_name.get(queue)
        if qi is not None:
            self._running_gang_members.setdefault((qi, gang_id), set()).add(job_id)

    def forget_running_gang(self, queue: str, gang_id: str, job_id: str) -> None:
        qi = self.queue_by_name.get(queue)
        if qi is not None:
            members = self._running_gang_members.get((qi, gang_id))
            if members:
                members.discard(job_id)
                if not members:
                    self._running_gang_members.pop((qi, gang_id), None)

    def _virtual_rank_market(
        self, qi: int, price: float, lead: JobSpec, prices: np.ndarray
    ) -> int:
        """Market-order rank of a slow-path unit among the queue's live
        fast-table rows: the count of singles whose (-price, sub, id) key
        strictly precedes the unit's.  Bands are contiguous in the stored
        (qi, band, sub, id) order within each table region (base + overlay),
        so this is O(bands) binary searches per region."""
        jt = self.jobs
        # The table is f32; a raw-f64 probe (e.g. 4.7) would never equal its
        # own band's entry and mis-rank the unit (parity: f32
        # score arithmetic, raw f64 flips near-ties).
        price = float(np.float32(price))
        count = 0
        for rlo, rhi in ((0, jt.sorted_n), (jt.sorted_n, jt.n)):
            if rlo == rhi:
                continue
            qcol = jt.qi[rlo:rhi]
            qv = qcol.dtype.type(qi)
            q_lo = rlo + int(np.searchsorted(qcol, qv, "left"))
            q_hi = rlo + int(np.searchsorted(qcol, qv, "right"))
            if q_lo == q_hi:
                continue
            band_col = jt.band[q_lo:q_hi]
            for bi in range(len(self.bands)):
                b_lo = q_lo + int(np.searchsorted(band_col, np.int32(bi), "left"))
                b_hi = q_lo + int(np.searchsorted(band_col, np.int32(bi), "right"))
                if b_lo == b_hi:
                    continue
                p = float(prices[qi, bi])
                if p > price:
                    count += int(jt.alive[b_lo:b_hi].sum())
                elif p == price:
                    lo, hi = b_lo, b_hi
                    for col, v in (
                        (jt.sub, lead.submit_time),
                        (jt.ids, lead.id.encode()),
                    ):
                        a = col[lo:hi]
                        v = a.dtype.type(v)  # dtype mismatch copies the column
                        lo, hi = lo + int(np.searchsorted(a, v, "left")), lo + int(
                            np.searchsorted(a, v, "right")
                        )
                    count += int(jt.alive[b_lo:lo].sum())
        return count

    def _virtual_rank(self, qi: int, pc_priority: int, lead: JobSpec) -> int:
        """Rank of a slow-path unit among the queue's live fast-table rows:
        where it would sit in the sorted order (summed over base + overlay)."""
        return self.jobs.rank_of_key(
            (qi, -pc_priority, lead.priority, lead.submit_time, lead.id.encode())
        )


class DeviceProblemCache:
    """Uploads a SchedulingProblem to `device`, reusing device buffers for
    fields whose host array OBJECT is unchanged since the last cycle (the
    builder hands back cached objects for node/pool tensors and compat, so
    steady-state cycles only re-upload the job-axis tensors that changed).
    The legacy full-upload path, kept for A/B against the slab deltas."""

    def __init__(self, device="cuda"):
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "passes device='cpu'"
            )
        self._prev: dict = {}

    def put(self, problem: SchedulingProblem) -> SchedulingProblem:
        import torch

        out = []
        for name, arr in zip(problem._fields, problem):
            prev = self._prev.get(name)
            if prev is not None and prev[0] is arr:
                out.append(prev[1])
            else:
                dev = torch.tensor(np.asarray(arr), device=self.device)
                self._prev[name] = (arr, dev)
                out.append(dev)
        return SchedulingProblem(*out)


class _BandProbe:
    """Minimal stand-in with the fields bid_price_of reads (queue,
    price_band)."""

    __slots__ = ("queue", "price_band")

    def __init__(self, queue: str, price_band: str):
        self.queue = queue
        self.price_band = price_band
