"""Poison-record isolation: bisecting dead-letter quarantine for ingest.

A malformed or bug-triggering record in the event log used to wedge its
consumer forever: the ingestion retry loop (pipeline.py / shards.py) is
retry-forever by design, so one poison record stalled every record behind
it while the lag grew without bound.  This module is the escalation path
that bounded retries (core/backoff.Backoff max_attempts) hand over to:

* ``isolate_batch`` re-reads the failing batch RAW (log.read_raw + the
  shards.py framing mirror), classifies every record with a PURE probe
  (decode -> convert -> render; all side-effect-free, so bisection is
  sound), and walks each partition in order: maximal runs of good records
  commit normally, a deterministic per-record failure is quarantined into
  the ``dead_letters`` table WITH the cursor advance IN THE SAME
  TRANSACTION (the r11/r19 cursor-fence discipline: a crash either sees
  the record dead-lettered and skipped, or neither).
* If EVERY record fails the pure probe (and there is more than one), or
  the store itself refuses an EMPTY transaction, the fault is
  ENVIRONMENTAL (a broken converter build, a down database) -- nothing is
  quarantined and the caller keeps its retry-forever behavior.  Mass
  quarantine on a systemic fault would advance cursors past good data.
* ``'$control-plane'`` records are NEVER auto-skipped: a poison control
  record halts that consumer loudly (ControlPoisonHalt, recorded in the
  process-global registry, surfaced via /healthz and metrics) and waits
  for an operator verdict -- ``armadactl dlq discard`` approves the skip,
  after which the next isolation pass quarantines it and moves on.
  Control records mediate executor membership and sweeps; silently
  dropping one desynchronizes the fleet.

Replay re-publishes the quarantined RAW bytes to the original partition
(``armadactl dlq replay``); every view re-consumes them idempotently
(INSERT OR IGNORE / monotonic marks -- the exactly-once design's crash
replay is the same path), so a replay after a code fix restores the state
a never-poisoned run would have reached.

The ``convert_record`` fault site models a poison record for drills: a
plain one-shot fault would succeed on retry and never exercise this path,
so the first fire LATCHES the triggering batch's first raw payload as
sticky poison -- every later conversion of that payload raises
deterministically until ``reset_poison()``.
"""

from __future__ import annotations

import base64
import logging
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.core import faults
from armada_tpu_torch.events import schema as pb

log = logging.getLogger(__name__)


class PoisonRecordError(RuntimeError):
    """A record that fails deterministically in a pure ingest stage."""


class ControlPoisonHalt(RuntimeError):
    """A '$control-plane' record failed its probe: never auto-skipped."""


# --- sticky poison drill (ARMADA_FAULT=convert_record) -----------------------

_poison_lock = make_lock("dlq.poison")
_POISON: set[bytes] = set()


def reset_poison() -> None:
    """Clear the sticky latch (tests/drills)."""
    with _poison_lock:
        _POISON.clear()


def poison_armed() -> bool:
    """Cheap outer gate for the convert-path hooks: True only while the
    drill is armed or a payload is already latched."""
    return bool(_POISON) or faults.armed("convert_record")


def poison_check(payloads) -> None:
    """Raise PoisonRecordError if any payload is latched poison; on the
    one-shot ``convert_record`` fire, latch the FIRST payload and raise.
    Callers gate on ``poison_armed()`` so the production cost is one
    falsy check."""
    payloads = [bytes(p) for p in payloads]
    if _POISON:
        with _poison_lock:
            hit = any(p in _POISON for p in payloads)
        if hit:
            raise PoisonRecordError("sticky poison record (convert_record drill)")
    mode = faults.active("convert_record")
    if mode is None:
        return
    if mode == "exit":
        os._exit(137)
    if payloads:
        with _poison_lock:
            _POISON.add(payloads[0])
    raise PoisonRecordError(
        "injected fault at 'convert_record' (payload latched as sticky poison)"
    )


# --- dead-letter table (shared by all three view stores) ---------------------

# `record_offset`, not `offset`: OFFSET is a reserved word in PostgreSQL and
# the DDL/DML below run through sqladapter's mechanical dialect translation.
DLQ_TABLE_SQL = """
CREATE TABLE IF NOT EXISTS dead_letters (
    consumer TEXT NOT NULL,
    partition INTEGER NOT NULL,
    record_offset INTEGER NOT NULL,
    rec_key BLOB NOT NULL,
    payload BLOB NOT NULL,
    stage TEXT NOT NULL,
    error TEXT NOT NULL,
    created_ns INTEGER NOT NULL,
    status TEXT NOT NULL DEFAULT 'dead',
    PRIMARY KEY (consumer, partition, record_offset)
)
"""

DLQ_COLUMNS = (
    "consumer",
    "partition",
    "record_offset",
    "rec_key",
    "payload",
    "stage",
    "error",
    "created_ns",
    "status",
)

# INSERT OR IGNORE keyed on (consumer, partition, record_offset): a crash in
# the ingest_ack window replays the isolation walk, and the replayed insert
# must not double-dead-letter (same discipline as the jobs/runs upserts).
_DLQ_INSERT = (
    f"INSERT OR IGNORE INTO dead_letters ({', '.join(DLQ_COLUMNS)}) "
    f"VALUES ({', '.join('?' * len(DLQ_COLUMNS))})"
)

_CURSOR_UPSERT = (
    "INSERT INTO consumer_positions(consumer, partition, position) "
    "VALUES (?, ?, ?) ON CONFLICT(consumer, partition) "
    "DO UPDATE SET position = excluded.position"
)


class DeadLetter(NamedTuple):
    partition: int
    record_offset: int
    rec_key: bytes
    payload: bytes
    stage: str
    error: str
    created_ns: int


def commit_dead_letters(conn, lock, rows, consumer, next_positions) -> None:
    """The ONE dead-letter commit: quarantine rows AND the cursor advance in
    the same transaction (lint rule dlq-cursor-same-txn pins that a cursor
    never advances past a poison record outside this shape).  Shared by all
    three view stores' ``store_dead_letters`` methods."""
    with lock:
        cur = conn.cursor()
        try:
            cur.executemany(
                _DLQ_INSERT,
                [
                    (
                        consumer,
                        r.partition,
                        r.record_offset,
                        r.rec_key,
                        r.payload,
                        r.stage,
                        r.error,
                        r.created_ns,
                        "dead",
                    )
                    for r in rows
                ],
            )
            for part, pos in (next_positions or {}).items():
                cur.execute(_CURSOR_UPSERT, (consumer, part, pos))
            conn.commit()
        except BaseException:
            conn.rollback()
            raise


_LIST_COLS = (
    "consumer, partition, record_offset, stage, error, created_ns, status, "
    "LENGTH(payload)"
)


def list_rows(conn, lock, consumer=None, status=None) -> list[dict]:
    """Quarantined rows WITHOUT payload bytes (the armadactl listing)."""
    sql = f"SELECT {_LIST_COLS} FROM dead_letters"
    clauses, params = [], []
    if consumer is not None:
        clauses.append("consumer = ?")
        params.append(consumer)
    if status is not None:
        clauses.append("status = ?")
        params.append(status)
    if clauses:
        sql += " WHERE " + " AND ".join(clauses)
    sql += " ORDER BY consumer, partition, record_offset"
    with lock:
        cur = conn.cursor()
        rows = cur.execute(sql, params).fetchall()
    return [
        {
            "consumer": r[0],
            "partition": int(r[1]),
            "record_offset": int(r[2]),
            "stage": r[3],
            "error": r[4],
            "created_ns": int(r[5]),
            "status": r[6],
            "payload_bytes": int(r[7]),
        }
        for r in rows
    ]


def get_row(conn, lock, consumer, partition, record_offset) -> Optional[dict]:
    """One full row, payload and key included (the armadactl show verb)."""
    with lock:
        cur = conn.cursor()
        rows = cur.execute(
            f"SELECT {', '.join(DLQ_COLUMNS)} FROM dead_letters "
            "WHERE consumer = ? AND partition = ? AND record_offset = ?",
            (consumer, int(partition), int(record_offset)),
        ).fetchall()
    if not rows:
        return None
    r = rows[0]
    return {
        "consumer": r[0],
        "partition": int(r[1]),
        "record_offset": int(r[2]),
        "rec_key": bytes(r[3]),
        "payload": bytes(r[4]),
        "stage": r[5],
        "error": r[6],
        "created_ns": int(r[7]),
        "status": r[8],
    }


def mark_rows(conn, lock, status, consumer, partition=None, record_offset=None) -> int:
    """Set status on matching rows; returns the match count."""
    sql = "UPDATE dead_letters SET status = ? WHERE consumer = ?"
    params: list = [status, consumer]
    if partition is not None:
        sql += " AND partition = ?"
        params.append(int(partition))
    if record_offset is not None:
        sql += " AND record_offset = ?"
        params.append(int(record_offset))
    with lock:
        cur = conn.cursor()
        try:
            cur.execute(sql, params)
            n = cur.rowcount
            conn.commit()
        except BaseException:
            conn.rollback()
            raise
    return int(n)


# --- process-global registry (counters, control halts, skip verdicts) --------


class DlqRegistry:
    """Process-global poison bookkeeping (the watchdog-supervisor pattern):
    dead-letter and batch-retry counters feed prometheus, control-plane
    halts wait here for the operator verdict that ``armadactl dlq
    discard`` records."""

    def __init__(self):
        self._lock = make_lock("dlq.registry")
        self._dead: dict[tuple[str, int], int] = {}
        self._retries: dict[str, int] = {}
        self._halts: dict[str, dict] = {}
        self._skips: set[tuple[str, int, int]] = set()

    def note_batch_retry(self, consumer: str) -> None:
        with self._lock:
            self._retries[consumer] = self._retries.get(consumer, 0) + 1

    def note_dead_letter(self, consumer: str, partition: int, n: int = 1) -> None:
        with self._lock:
            key = (consumer, int(partition))
            self._dead[key] = self._dead.get(key, 0) + n

    def note_control_halt(
        self, consumer: str, partition: int, offset: int, stage: str, error: str
    ) -> None:
        with self._lock:
            self._halts[consumer] = {
                "partition": int(partition),
                "record_offset": int(offset),
                "stage": stage,
                "error": error,
                "since_ns": time.time_ns(),
            }

    def clear_control_halt(self, consumer: str) -> None:
        with self._lock:
            self._halts.pop(consumer, None)

    def control_halts(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._halts.items()}

    def approve_control_skip(self, consumer: str, partition: int, offset: int) -> None:
        with self._lock:
            self._skips.add((consumer, int(partition), int(offset)))

    def skip_approved(self, consumer: str, partition: int, offset: int) -> bool:
        with self._lock:
            return (consumer, int(partition), int(offset)) in self._skips

    def consume_skip(self, consumer: str, partition: int, offset: int) -> None:
        with self._lock:
            self._skips.discard((consumer, int(partition), int(offset)))

    def dead_counts(self) -> dict[tuple[str, int], int]:
        with self._lock:
            return dict(self._dead)

    def retry_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._retries)

    def snapshot(self) -> dict:
        """The /healthz ``dlq`` block."""
        with self._lock:
            by_consumer: dict[str, int] = {}
            by_partition: dict[str, dict[str, int]] = {}
            for (consumer, part), n in self._dead.items():
                by_consumer[consumer] = by_consumer.get(consumer, 0) + n
                by_partition.setdefault(consumer, {})[str(part)] = n
            return {
                "dead_letters_total": sum(self._dead.values()),
                "dead_letters": dict(sorted(by_consumer.items())),
                "dead_letters_by_partition": {
                    c: dict(sorted(parts.items()))
                    for c, parts in sorted(by_partition.items())
                },
                "batch_retries": dict(sorted(self._retries.items())),
                "control_halts": {k: dict(v) for k, v in self._halts.items()},
            }


_registry: Optional[DlqRegistry] = None
_registry_lock = make_lock("dlq.registry.global")


def registry() -> DlqRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = DlqRegistry()
        return _registry


def reset_registry() -> DlqRegistry:
    """Fresh process-global registry (tests/drills)."""
    global _registry
    with _registry_lock:
        _registry = DlqRegistry()
        return _registry


# --- the isolation engine ----------------------------------------------------


class IsolationOutcome(NamedTuple):
    applied_sequences: int
    applied_events: int
    dead: int
    environmental: bool
    halted: bool
    new_positions: dict[int, int]

    @property
    def progressed(self) -> bool:
        return self.applied_sequences > 0 or self.dead > 0


class _StageError(Exception):
    def __init__(self, stage: str, cause: BaseException):
        super().__init__(f"{stage}: {cause!r}")
        self.stage = stage
        self.cause = cause


def _make_probe(converter, renderer) -> Callable[[list[bytes]], None]:
    """The pure classification probe: decode -> convert -> render, each
    stage tagged.  All three are side-effect-free functions of the
    payload bytes, which is what makes bisection over subsets sound."""

    def probe(payloads: list[bytes]) -> None:
        try:
            poison_check(payloads)
        except Exception as exc:
            raise _StageError("convert", exc)
        try:
            seqs = [pb.EventSequence.FromString(p) for p in payloads]
        except Exception as exc:
            raise _StageError("decode", exc)
        try:
            ops = converter(seqs)
        except Exception as exc:
            raise _StageError("convert", exc)
        if renderer is not None:
            try:
                renderer(ops)
            except Exception as exc:
                raise _StageError("render", exc)

    return probe


def _bisect_failures(payloads, probe, base=0, out=None) -> dict[int, _StageError]:
    """Indexes of payloads that fail `probe`, found by recursive halving:
    O(f log n) probe calls for f failures instead of n."""
    out = {} if out is None else out
    if not payloads:
        return out
    try:
        probe(payloads)
        return out
    except _StageError as err:
        if len(payloads) == 1:
            out[base] = err
            return out
    mid = len(payloads) // 2
    _bisect_failures(payloads[:mid], probe, base, out)
    _bisect_failures(payloads[mid:], probe, base + mid, out)
    return out


def isolate_batch(
    *,
    log_,
    sink,
    converter,
    consumer: str,
    partitions: Sequence[int],
    positions: dict[int, int],
    renderer=None,
    stop_at_control: bool = False,
    max_bytes: int = 1 << 22,
    reg: Optional[DlqRegistry] = None,
) -> IsolationOutcome:
    """Re-read the lagging records raw, classify, and either commit good
    runs / quarantine poison (advancing cursors) or report the fault as
    environmental.  ``stop_at_control`` is the sharded mode: a HEALTHY
    control record parks the walk so the normal barrier path handles it
    (serial mode converts control records inline like production does).

    Returns committed cursor advances in ``new_positions``; the caller
    acks them into its in-memory consumer exactly like a stored batch.
    """
    # Lazy import: shards.py owns the ONE Python framing mirror and itself
    # imports this module from function scope.
    from armada_tpu_torch.ingest.shards import _CONTROL_KEY, _frame_records

    reg = reg if reg is not None else registry()
    per_part: dict[int, list[tuple[int, bytes, bytes, int]]] = {}
    for part in sorted(partitions):
        start = positions[part]
        # read_raw raises OSError on mid-log corruption -- that is disk
        # damage (eventlog.cc's loud-halt class), never a poison record;
        # let it propagate to the retry loop.
        buf, _next = log_.read_raw(part, start, max_bytes=max_bytes)
        if not buf:
            continue
        recs = []
        off = start
        for key, payload, next_off in _frame_records(buf, start):
            recs.append((off, key, payload, next_off))
            off = next_off
        per_part[part] = recs
    total = sum(len(r) for r in per_part.values())
    if total == 0:
        return IsolationOutcome(0, 0, 0, False, False, {})

    probe = _make_probe(converter, renderer)
    failures: dict[tuple[int, int], _StageError] = {}
    for part, recs in per_part.items():
        payloads = [r[2] for r in recs]
        for idx, err in _bisect_failures(payloads, probe).items():
            failures[(part, recs[idx][0])] = err

    # Every record failing a PURE stage is systemic (a broken converter
    # build fails everything; a poison record fails alone) -- except a
    # single-record batch, where there is nothing to contrast against and
    # a deterministic pure-stage failure IS the poison signature.
    if len(failures) == total and total > 1:
        err = next(iter(failures.values()))
        log.error(
            "dlq[%s]: every record (%d) fails the %s stage -- classifying "
            "as environmental, nothing quarantined: %s",
            consumer,
            total,
            err.stage,
            err,
        )
        return IsolationOutcome(0, 0, 0, True, False, {})

    applied_seqs = applied_events = dead = 0
    new_positions: dict[int, int] = {}
    halted = False

    def _store_run(part: int, run: list) -> None:
        """Commit a run of probe-good records; a store failure here is
        classified live: an empty transaction failing too means the store
        is down (environmental), otherwise fall back to per-record stores
        and quarantine the specific op that the store rejects."""
        nonlocal applied_seqs, applied_events, dead
        seqs = [pb.EventSequence.FromString(p) for _off, _k, p, _n in run]
        cursor = {part: run[-1][3]}
        try:
            sink.store(converter(seqs), consumer=consumer, next_positions=cursor)
        except Exception as store_exc:
            try:
                sink.store([], consumer=consumer, next_positions={})
            except Exception:
                raise _Environmental() from store_exc
            for (off, key, payload, next_off), seq in zip(run, seqs):
                try:
                    sink.store(
                        converter([seq]),
                        consumer=consumer,
                        next_positions={part: next_off},
                    )
                except Exception as exc:  # noqa: BLE001 - per-record verdict
                    try:
                        sink.store([], consumer=consumer, next_positions={})
                    except Exception:
                        # The store died mid-fallback: stop quarantining --
                        # everything from this record on replays later.
                        raise _Environmental() from exc
                    row = DeadLetter(
                        part, off, key, payload, "store", repr(exc), time.time_ns()
                    )
                    sink.store_dead_letters(
                        [row], consumer=consumer, next_positions={part: next_off}
                    )
                    faults.check("ingest_ack")
                    reg.note_dead_letter(consumer, part)
                    dead += 1
                else:
                    applied_seqs += 1
                    applied_events += len(seq.events)
            new_positions[part] = run[-1][3]
            return
        faults.check("ingest_ack")
        applied_seqs += len(seqs)
        applied_events += sum(len(s.events) for s in seqs)
        new_positions[part] = run[-1][3]

    def _quarantine(part: int, off: int, key: bytes, payload: bytes, next_off: int,
                    stage: str, error: str) -> None:
        nonlocal dead
        row = DeadLetter(part, off, key, payload, stage, error, time.time_ns())
        sink.store_dead_letters(
            [row], consumer=consumer, next_positions={part: next_off}
        )
        # Same crash window as the normal store->ack seam: a kill here
        # replays the walk, the INSERT OR IGNORE and idempotent cursor
        # upsert make the replay a no-op.
        faults.check("ingest_ack")
        reg.note_dead_letter(consumer, part)
        dead += 1
        log.warning(
            "dlq[%s]: quarantined poison record p%d@%d (stage=%s): %s",
            consumer, part, off, stage, error,
        )

    try:
        for part in sorted(per_part):
            recs = per_part[part]
            run: list = []
            for off, key, payload, next_off in recs:
                failed = (part, off) in failures
                if key == _CONTROL_KEY:
                    if run:
                        _store_run(part, run)
                        run = []
                    if failed:
                        err = failures[(part, off)]
                        if reg.skip_approved(consumer, part, off):
                            _quarantine(
                                part, off, key, payload, next_off,
                                "control", str(err),
                            )
                            reg.consume_skip(consumer, part, off)
                            reg.clear_control_halt(consumer)
                            continue
                        reg.note_control_halt(
                            consumer, part, off, err.stage, str(err)
                        )
                        log.error(
                            "dlq[%s]: POISON '$control-plane' record p%d@%d "
                            "-- never auto-skipped; halting this consumer "
                            "until an operator verdict (armadactl dlq "
                            "discard %s:%d:%d): %s",
                            consumer, part, off, consumer, part, off, err,
                        )
                        halted = True
                        break
                    if stop_at_control:
                        break  # the shard's barrier path owns it
                    run.append((off, key, payload, next_off))
                    continue
                if failed:
                    if run:
                        _store_run(part, run)
                        run = []
                    err = failures[(part, off)]
                    _quarantine(
                        part, off, key, payload, next_off, err.stage, str(err)
                    )
                    continue
                run.append((off, key, payload, next_off))
            if run:
                _store_run(part, run)
    except _Environmental as env:
        log.error(
            "dlq[%s]: store refuses even an empty transaction -- "
            "environmental, keeping retry-forever: %r",
            consumer,
            env.__cause__,
        )
        return IsolationOutcome(
            applied_seqs, applied_events, dead, True, halted, new_positions
        )
    return IsolationOutcome(
        applied_seqs, applied_events, dead, False, halted, new_positions
    )


class _Environmental(Exception):
    """Internal: the store probe failed -- abort the walk, keep retrying."""


# --- operator surface (armadactl dlq ...) ------------------------------------


def parse_selector(sel: str) -> tuple[Optional[str], Optional[int], Optional[int]]:
    """'consumer[:partition[:offset]]' -> parts; '' selects everything."""
    if not sel:
        return None, None, None
    parts = sel.split(":")
    consumer = parts[0] or None
    partition = int(parts[1]) if len(parts) > 1 and parts[1] != "" else None
    offset = int(parts[2]) if len(parts) > 2 and parts[2] != "" else None
    return consumer, partition, offset


class DlqAdmin:
    """The control-plane hooks behind armadactl dlq list/show/replay/discard
    (rpc ExecutorAdmin verbs).  Plane-local by design, like checkpoints: a
    dead letter is one replica's quarantine artifact."""

    def __init__(self, log_, stores: dict[str, object]):
        self._log = log_
        self._stores = stores

    def _store_for(self, consumer: str):
        store = self._stores.get(consumer)
        if store is None:
            raise KeyError(
                f"unknown dlq consumer {consumer!r} "
                f"(have: {sorted(self._stores)})"
            )
        return store

    def status(self) -> dict:
        out = registry().snapshot()
        per_store = {}
        for name, store in sorted(self._stores.items()):
            try:
                rows = store.list_dead_letters(consumer=name)
            except Exception as exc:  # noqa: BLE001 - one broken store
                per_store[name] = {"error": str(exc)}  # must not hide others
                continue
            per_store[name] = {
                "dead": sum(1 for r in rows if r["status"] == "dead"),
                "replayed": sum(1 for r in rows if r["status"] == "replayed"),
                "discarded": sum(1 for r in rows if r["status"] == "discarded"),
            }
        out["stores"] = per_store
        return out

    def list(self, selector: str = "") -> list[dict]:
        consumer, partition, offset = parse_selector(selector)
        names = [consumer] if consumer else sorted(self._stores)
        out = []
        for name in names:
            rows = self._store_for(name).list_dead_letters(consumer=name)
            for r in rows:
                if partition is not None and r["partition"] != partition:
                    continue
                if offset is not None and r["record_offset"] != offset:
                    continue
                out.append(r)
        return out

    def show(self, selector: str) -> dict:
        consumer, partition, offset = parse_selector(selector)
        if consumer is None or partition is None or offset is None:
            raise ValueError("show needs a full consumer:partition:offset selector")
        row = self._store_for(consumer).get_dead_letter(consumer, partition, offset)
        if row is None:
            raise KeyError(f"no dead letter at {selector!r}")
        row = dict(row)
        row["rec_key"] = base64.b64encode(row["rec_key"]).decode()
        row["payload"] = base64.b64encode(row["payload"]).decode()
        return row

    def replay(self, selector: str = "") -> dict:
        """Re-publish matching 'dead' rows' RAW bytes to their original
        partitions and mark them replayed.  The same original record
        quarantined by several views appends ONCE (grouped by partition +
        offset); every view then re-consumes it idempotently."""
        consumer, partition, offset = parse_selector(selector)
        names = [consumer] if consumer else sorted(self._stores)
        groups: dict[tuple[int, int], dict] = {}
        members: dict[tuple[int, int], list[str]] = {}
        for name in names:
            store = self._store_for(name)
            for r in store.list_dead_letters(consumer=name, status="dead"):
                if partition is not None and r["partition"] != partition:
                    continue
                if offset is not None and r["record_offset"] != offset:
                    continue
                key = (r["partition"], r["record_offset"])
                if key not in groups:
                    groups[key] = store.get_dead_letter(
                        name, r["partition"], r["record_offset"]
                    )
                members.setdefault(key, []).append(name)
        replayed = 0
        for (part, off), row in sorted(groups.items()):
            self._log.append(part, row["rec_key"], row["payload"])
            replayed += 1
            for name in members[(part, off)]:
                self._store_for(name).mark_dead_letter(
                    name, part, off, "replayed"
                )
        if replayed:
            self._log.flush()
        return {"replayed": replayed, "rows_marked": sum(len(m) for m in members.values())}

    def discard(self, selector: str) -> dict:
        """Either approve a pending control-plane skip (the halt verdict)
        or mark quarantined rows discarded."""
        consumer, partition, offset = parse_selector(selector)
        if consumer is None:
            raise ValueError("discard needs at least a consumer selector")
        reg = registry()
        halt = reg.control_halts().get(consumer)
        if (
            halt is not None
            and (partition is None or halt["partition"] == partition)
            and (offset is None or halt["record_offset"] == offset)
        ):
            reg.approve_control_skip(
                consumer, halt["partition"], halt["record_offset"]
            )
            return {
                "control_skip_approved": True,
                "consumer": consumer,
                "partition": halt["partition"],
                "record_offset": halt["record_offset"],
            }
        store = self._store_for(consumer)
        n = store.mark_dead_letter(consumer, partition, offset, "discarded")
        return {"control_skip_approved": False, "rows_marked": n}
