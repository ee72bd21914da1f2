"""The scheduler database: materialization of the event log.

Equivalent of the reference's scheduler Postgres schema + access layer
(internal/scheduler/database/migrations/001_initialize_schema.up.sql: tables
jobs, runs, markers, job_run_errors; job_repository.go FetchJobUpdates): rows
carry a monotonic `serial` bumped on every write, so the scheduler's syncState
fetches increments with `serial > last_seen` (scheduler.go:386).

Exactly-once materialization: `SchedulerDb.store` applies a batch of
DbOperations AND the consumer's new log positions in one transaction --
replaying after a crash resumes from the committed position, so no event is
applied twice (the reference gets the same from Postgres txns keyed on Pulsar
message ids, SURVEY.md section 5 checkpoint/resume).

Backends: embedded SQLite by default (`path` = filename or ":memory:"), or
an external PostgreSQL when `path` is a `postgres://` URL -- the reference's
deployment shape (pgx against migrations 001-023).  The PG path rides the
self-contained wire driver in ingest/pgwire.py; statements are written in the
SQLite dialect and mechanically translated (`?` -> `$n`, `INSERT OR IGNORE`
-> `ON CONFLICT DO NOTHING`, INTEGER -> BIGINT / BLOB -> BYTEA in DDL), and
the conformance suite runs the whole SchedulerDb surface against a
wire-accurate fake server (ingest/fakepg.py) plus, when `ARMADA_PG_DSN` is
set, a real Postgres.

The port's copy runs on SQLite only: a postgres:// URL raises
NotImplementedError from the port's `sqladapter.PgAdapter` until the wire
driver and the fake server are ported (the next slice).  Spec blobs are
the port's `events.schema` JobSpec bytes, equal to protobuf's.
"""

from __future__ import annotations

import sqlite3
from itertools import repeat as _repeat
from typing import Iterable, NamedTuple, Optional

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.ingest import dbops as ops

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
  job_id TEXT PRIMARY KEY,
  queue TEXT NOT NULL,
  jobset TEXT NOT NULL,
  priority INTEGER NOT NULL DEFAULT 0,
  submitted_ns INTEGER NOT NULL DEFAULT 0,
  queued INTEGER NOT NULL DEFAULT 1,
  queued_version INTEGER NOT NULL DEFAULT 0,
  validated INTEGER NOT NULL DEFAULT 0,
  pools TEXT NOT NULL DEFAULT '',
  cancel_requested INTEGER NOT NULL DEFAULT 0,
  cancel_by_jobset_requested INTEGER NOT NULL DEFAULT 0,
  preempt_requested INTEGER NOT NULL DEFAULT 0,
  cancelled INTEGER NOT NULL DEFAULT 0,
  succeeded INTEGER NOT NULL DEFAULT 0,
  failed INTEGER NOT NULL DEFAULT 0,
  spec BLOB NOT NULL,
  serial INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_jobs_serial ON jobs(serial);
CREATE INDEX IF NOT EXISTS idx_jobs_jobset ON jobs(queue, jobset);

CREATE TABLE IF NOT EXISTS runs (
  run_id TEXT PRIMARY KEY,
  job_id TEXT NOT NULL,
  created_ns INTEGER NOT NULL DEFAULT 0,
  executor TEXT NOT NULL DEFAULT '',
  node_id TEXT NOT NULL DEFAULT '',
  node_name TEXT NOT NULL DEFAULT '',
  pool TEXT NOT NULL DEFAULT '',
  scheduled_at_priority INTEGER,
  pool_scheduled_away INTEGER NOT NULL DEFAULT 0,
  leased INTEGER NOT NULL DEFAULT 1,
  pending INTEGER NOT NULL DEFAULT 0,
  running INTEGER NOT NULL DEFAULT 0,
  succeeded INTEGER NOT NULL DEFAULT 0,
  failed INTEGER NOT NULL DEFAULT 0,
  cancelled INTEGER NOT NULL DEFAULT 0,
  preempted INTEGER NOT NULL DEFAULT 0,
  returned INTEGER NOT NULL DEFAULT 0,
  run_attempted INTEGER NOT NULL DEFAULT 0,
  preempt_requested INTEGER NOT NULL DEFAULT 0,
  running_ns INTEGER NOT NULL DEFAULT 0,
  serial INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_runs_serial ON runs(serial);
CREATE INDEX IF NOT EXISTS idx_runs_job ON runs(job_id);

CREATE TABLE IF NOT EXISTS job_run_errors (
  run_id TEXT NOT NULL,
  job_id TEXT NOT NULL,
  reason TEXT NOT NULL,
  message TEXT NOT NULL,
  terminal INTEGER NOT NULL DEFAULT 0
);

CREATE TABLE IF NOT EXISTS markers (
  group_id TEXT NOT NULL,
  partition INTEGER NOT NULL,
  created_ns INTEGER NOT NULL DEFAULT 0,
  PRIMARY KEY (group_id, partition)
);

CREATE TABLE IF NOT EXISTS executors (
  executor_id TEXT PRIMARY KEY,
  snapshot BLOB NOT NULL,
  last_updated_ns INTEGER NOT NULL
);

-- Operator cordon state, materialized from "$control-plane" events (the
-- reference's executor_settings table, scheduleringester dbops.go) -- NEVER
-- written directly: replaying the log rebuilds it on any replica.
CREATE TABLE IF NOT EXISTS executor_settings (
  executor_id TEXT PRIMARY KEY,
  cordoned INTEGER NOT NULL DEFAULT 0,
  cordon_reason TEXT NOT NULL DEFAULT '',
  set_by_user TEXT NOT NULL DEFAULT ''
);

CREATE TABLE IF NOT EXISTS consumer_positions (
  consumer TEXT NOT NULL,
  partition INTEGER NOT NULL,
  position INTEGER NOT NULL,
  PRIMARY KEY (consumer, partition)
);

CREATE TABLE IF NOT EXISTS serials (
  name TEXT PRIMARY KEY,
  value INTEGER NOT NULL
);

CREATE TABLE IF NOT EXISTS job_dedup (
  dedup_key TEXT PRIMARY KEY,
  job_id TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS queues (
  name TEXT PRIMARY KEY,
  weight REAL NOT NULL DEFAULT 1.0,
  cordoned INTEGER NOT NULL DEFAULT 0,
  owners TEXT NOT NULL DEFAULT '[]',
  groups_json TEXT NOT NULL DEFAULT '[]',
  labels_json TEXT NOT NULL DEFAULT '{}'
);

-- Poison-record quarantine (ingest/dlq.py): raw bytes + provenance of
-- records the ingest plane isolated after bounded retries.  Quarantine
-- rows commit IN THE SAME TRANSACTION as the cursor advance that skips
-- them (dlq.commit_dead_letters).  record_offset, not offset: reserved
-- word in PostgreSQL.
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
);
"""

JOBS_COLUMNS = (
    "job_id", "queue", "jobset", "priority", "submitted_ns", "queued",
    "queued_version", "validated", "pools", "cancel_requested",
    "cancel_by_jobset_requested", "preempt_requested", "cancelled",
    "succeeded", "failed", "spec",
)
RUNS_COLUMNS = (
    "run_id", "job_id", "created_ns", "executor", "node_id", "node_name",
    "pool", "scheduled_at_priority", "pool_scheduled_away", "leased",
)

# Full column lists per table, in a FIXED order, for the checkpoint
# subsystem's export/restore (scheduler/checkpoint.py).  Explicit columns
# (never SELECT *) so a snapshot's row tuples stay stable across dialects
# and future column additions append rather than silently reorder.
# consumer_positions dumps FIRST: under the partition-parallel ingest plane
# an external-PG snapshot is not one locked read -- per-statement visibility
# means later tables can be NEWER than earlier ones.  Dumping the fence
# before the data it fences makes the skew direction safe (data newer than
# the fence replays idempotently; a fence newer than the data would skip
# events the dump never captured).
SNAPSHOT_TABLES: dict[str, tuple[str, ...]] = {
    "consumer_positions": ("consumer", "partition", "position"),
    "jobs": JOBS_COLUMNS + ("serial",),
    "runs": (
        "run_id", "job_id", "created_ns", "executor", "node_id", "node_name",
        "pool", "scheduled_at_priority", "pool_scheduled_away", "leased",
        "pending", "running", "succeeded", "failed", "cancelled", "preempted",
        "returned", "run_attempted", "preempt_requested", "running_ns",
        "serial",
    ),
    "job_run_errors": ("run_id", "job_id", "reason", "message", "terminal"),
    "markers": ("group_id", "partition", "created_ns"),
    "executors": ("executor_id", "snapshot", "last_updated_ns"),
    "executor_settings": (
        "executor_id", "cordoned", "cordon_reason", "set_by_user",
    ),
    "serials": ("name", "value"),
    "job_dedup": ("dedup_key", "job_id"),
    "queues": (
        "name", "weight", "cordoned", "owners", "groups_json", "labels_json",
    ),
    # After consumer_positions in dump order (it sits above), so a dead
    # letter landing mid-dump is on the replay side of the fence.
    "dead_letters": (
        "consumer", "partition", "record_offset", "rec_key", "payload",
        "stage", "error", "created_ns", "status",
    ),
}


# Statement translation + the sqlite3.Connection-alike over the wire driver
# live in ingest/sqladapter.py, shared with the lookout store.
from armada_tpu_torch.ingest.sqladapter import (  # noqa: E402
    PgAdapter as _PgAdapter,
    is_postgres_url,
)


class SerialAllocator:
    """Globally-ordered serial allocation across the shard files of ONE
    sharded store (ingest/storeunion.py).

    The scheduler's incremental fetch is a single int cursor per domain
    (`serial > last_seen`, advanced to the max serial seen) -- sound against
    one writer because serial allocation and commit serialize under the same
    store lock.  Shard files commit CONCURRENTLY, so two invariants must be
    re-established process-side:

      * uniqueness/order: one shared counter hands out serials across all
        shards (each shard records its own allocations in its local
        `serials` table, so a reopen re-seeds the counter from the max
        across shards);
      * read safety: a shard can commit serial 101 while serial 100 is
        still in another shard's open transaction -- a reader that advances
        its cursor to 101 would then silently skip 100 forever.  The
        allocator tracks in-flight (allocated, not yet committed) serials
        per domain and exposes `horizon()` = the largest serial S such that
        no serial <= S is still in flight; union reads clamp
        `serial <= horizon` so the max-advance cursor contract survives.

    A discarded (rolled-back) serial is a permanent gap: it is removed from
    the in-flight set and never appears in any shard, so the horizon passes
    it and replayed batches allocate fresh serials.
    """

    _DOMAINS = ("jobs", "runs")

    def __init__(self):
        self._lock = make_lock("schedulerdb.serial_alloc")
        self._next = {d: 1 for d in self._DOMAINS}
        self._inflight: dict[str, set[int]] = {d: set() for d in self._DOMAINS}

    def seed(self, name: str, value: int) -> None:
        """Raise the counter past a persisted high-water mark (shard open /
        snapshot restore).  Never lowers it."""
        with self._lock:
            nxt = self._next.setdefault(name, 1)
            if value + 1 > nxt:
                self._next[name] = value + 1

    def allocate(self, name: str) -> int:
        with self._lock:
            v = self._next.setdefault(name, 1)
            self._next[name] = v + 1
            self._inflight.setdefault(name, set()).add(v)
            return v

    def committed(self, serials: Iterable[tuple[str, int]]) -> None:
        with self._lock:
            for name, v in serials:
                self._inflight.get(name, set()).discard(v)

    # A rolled-back serial leaves a permanent gap; same bookkeeping.
    discarded = committed

    def horizon(self, name: str) -> int:
        """Largest serial safe to advance a fetch cursor past: every serial
        <= horizon is either committed in some shard or a permanent gap."""
        with self._lock:
            infl = self._inflight.get(name)
            if infl:
                return min(infl) - 1
            return self._next.get(name, 1) - 1


# --- op rendering (round 18) -------------------------------------------------
# A DbOperation rendered to (SQL, parameter rows) with the serial's insertion
# point parameterized -- serials are allocated inside the store transaction,
# so a plan is a PURE function of the op.  One renderer serves both paths:
# `_apply` renders inline (the serial pipeline), and the partition-parallel
# shard workers (ingest/shards.py) render in a converter SUBPROCESS and ship
# the picklable plan back, leaving only serial allocation + execution on the
# store thread.  Ops whose membership resolves against the live tables
# (Preempt/CancelOnExecutor/OnQueue) are NOT renderable and return None --
# the caller falls back to the in-transaction `_apply` path.


class PlanStmt(NamedTuple):
    domain: Optional[str]  # serials-table counter to allocate, or None
    sql: str
    # `many` statements carry COLUMNAR params: a TUPLE of per-column lists
    # (one pass at render, one zip at execute -- the serial splices in as an
    # itertools.repeat column instead of per-row tuple surgery, and the
    # subprocess pipe packs/unpacks them without a transpose).  A LIST of
    # row tuples is still accepted for compatibility.  Non-`many`
    # statements carry one params tuple.
    params: object
    serial_pos: int  # column index where the allocated serial slots in
    many: bool


_SQL_INSERT_JOBS = (
    f"INSERT OR IGNORE INTO jobs ({', '.join(JOBS_COLUMNS)}, serial) "
    f"VALUES ({', '.join('?' for _ in JOBS_COLUMNS)}, ?)"
)
_SQL_INSERT_RUNS = (
    f"INSERT OR IGNORE INTO runs ({', '.join(RUNS_COLUMNS)}, serial) "
    f"VALUES ({', '.join('?' for _ in RUNS_COLUMNS)}, ?)"
)

# job-flag ops: op type -> (flag column, extra SET clause)
_JOB_FLAG_OPS = {
    ops.MarkJobsCancelRequested: ("cancel_requested", ""),
    ops.MarkJobsCancelled: ("cancelled", ", queued = 0"),
    ops.MarkJobsSucceeded: ("succeeded", ", queued = 0"),
    ops.MarkJobsFailed: ("failed", ", queued = 0"),
}
_RUN_FLAG_OPS = {
    ops.MarkRunsPending: "pending",
    ops.MarkRunsSucceeded: "succeeded",
    ops.MarkRunsFailed: "failed",
    ops.MarkRunsPreempted: "preempted",
    ops.MarkRunsReturned: "returned",
    ops.MarkRunsPreemptRequested: "preempt_requested",
}


def render_op(op: ops.DbOperation) -> Optional[list[PlanStmt]]:
    """Render one op, or None when it needs the live tables to resolve."""
    t = type(op)
    if t is ops.InsertJobs:
        rows = list(op.jobs.values())
        return [
            PlanStmt(
                "jobs",
                _SQL_INSERT_JOBS,
                tuple(
                    [row.get(c, d) for row in rows]
                    for c, d in _JOBS_COL_DEFAULTS
                ),
                len(JOBS_COLUMNS),
                True,
            )
        ]
    if t is ops.InsertRuns:
        rows = list(op.runs.values())
        return [
            PlanStmt(
                "runs",
                _SQL_INSERT_RUNS,
                tuple(
                    [row.get(c, d) for row in rows]
                    for c, d in _RUNS_COL_DEFAULTS
                ),
                len(RUNS_COLUMNS),
                True,
            )
        ]
    if t in _JOB_FLAG_OPS:
        flag, extra = _JOB_FLAG_OPS[t]
        return [
            PlanStmt(
                "jobs",
                f"UPDATE jobs SET {flag} = 1{extra}, serial = ? WHERE job_id = ?",
                (list(op.job_ids),),
                0,
                True,
            )
        ]
    if t in _RUN_FLAG_OPS:
        flag = _RUN_FLAG_OPS[t]
        run_attempted = ", run_attempted = 1" if flag == "succeeded" else ""
        return [
            PlanStmt(
                "runs",
                f"UPDATE runs SET {flag} = 1{run_attempted}, serial = ? "
                "WHERE run_id = ?",
                (list(op.runs),),
                0,
                True,
            )
        ]
    if t is ops.MarkRunsRunning:
        # Record when the run started (short-job penalty window); keep the
        # earliest timestamp on replay.
        rids = list(op.runs)
        return [
            PlanStmt(
                "runs",
                "UPDATE runs SET running = 1, run_attempted = 1, serial = ?, "
                "running_ns = CASE WHEN running_ns > 0 THEN running_ns ELSE ? END "
                "WHERE run_id = ?",
                ([int(op.times.get(rid, 0)) for rid in rids], rids),
                0,
                True,
            )
        ]
    if t is ops.MarkJobsValidated:
        return [
            PlanStmt(
                "jobs",
                "UPDATE jobs SET validated = 1, pools = ?, serial = ? "
                "WHERE job_id = ?",
                (
                    [",".join(p) for p in op.pools_by_job.values()],
                    list(op.pools_by_job),
                ),
                1,
                True,
            )
        ]
    if t is ops.UpdateJobPriorities:
        return [
            PlanStmt(
                "jobs",
                "UPDATE jobs SET priority = ?, serial = ? WHERE job_id = ?",
                (list(op.priority_by_job.values()), list(op.priority_by_job)),
                1,
                True,
            )
        ]
    if t is ops.UpdateJobQueuedState:
        versions = [v for (_q, v) in op.state_by_job.values()]
        return [
            PlanStmt(
                "jobs",
                "UPDATE jobs SET queued = ?, queued_version = ?, serial = ? "
                "WHERE job_id = ? AND queued_version < ?",
                (
                    [int(q) for (q, _v) in op.state_by_job.values()],
                    versions,
                    list(op.state_by_job),
                    versions,
                ),
                2,
                True,
            )
        ]
    if t is ops.MarkJobSetCancelRequested:
        conds = []
        if op.cancel_queued:
            conds.append("queued = 1")
        if op.cancel_leased:
            conds.append("queued = 0")
        # FALSE, not 0: an integer literal in boolean context is a
        # SQLite-ism PG rejects (42804); FALSE parses on both.
        state_cond = f"({' OR '.join(conds)})" if conds else "FALSE"
        return [
            PlanStmt(
                "jobs",
                "UPDATE jobs SET cancel_by_jobset_requested = 1, "
                f"serial = ? WHERE queue = ? AND jobset = ? AND {state_cond} "
                "AND cancelled = 0 AND succeeded = 0 AND failed = 0",
                (op.queue, op.jobset),
                0,
                False,
            )
        ]
    if t is ops.MarkJobsPreemptRequested:
        # Mark active runs AND persist the request on the job row: if no
        # run exists yet (job still queued, or the lease materializes
        # later), the scheduler acts on the job flag instead of silently
        # dropping the request.
        ids = list(op.job_ids)
        return [
            PlanStmt(
                "runs",
                "UPDATE runs SET preempt_requested = 1, serial = ? "
                "WHERE job_id = ? AND succeeded = 0 AND failed = 0 "
                "AND cancelled = 0 AND preempted = 0 AND returned = 0",
                (ids,),
                0,
                True,
            ),
            PlanStmt(
                "jobs",
                "UPDATE jobs SET preempt_requested = 1, serial = ? "
                "WHERE job_id = ? AND cancelled = 0 AND succeeded = 0 AND failed = 0",
                (list(ids),),
                0,
                True,
            ),
        ]
    if t is ops.UpdateJobSetPriority:
        return [
            PlanStmt(
                "jobs",
                "UPDATE jobs SET priority = ?, serial = ? "
                "WHERE queue = ? AND jobset = ? "
                "AND cancelled = 0 AND succeeded = 0 AND failed = 0",
                (op.priority, op.queue, op.jobset),
                1,
                False,
            )
        ]
    if t is ops.InsertJobRunErrors:
        return [
            PlanStmt(
                None,
                "INSERT OR IGNORE INTO job_run_errors "
                "(run_id, job_id, reason, message, terminal) "
                "VALUES (?, ?, ?, ?, ?)",
                [
                    (rid, op.job_by_run.get(rid, ""), reason, message, int(terminal))
                    for rid, errs in op.errors.items()
                    for (reason, message, terminal) in errs
                ],
                -1,
                True,
            )
        ]
    if t is ops.InsertPartitionMarker:
        return [
            PlanStmt(
                None,
                "INSERT OR IGNORE INTO markers (group_id, partition, created_ns) "
                "VALUES (?, ?, ?)",
                (op.group_id, op.partition, op.created_ns),
                -1,
                False,
            )
        ]
    if t is ops.UpsertQueues:
        import json as _json

        return [
            PlanStmt(
                None,
                "INSERT INTO queues (name, weight, cordoned, owners, "
                "groups_json, labels_json) VALUES (?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(name) DO UPDATE SET "
                "weight = excluded.weight, cordoned = excluded.cordoned, "
                "owners = excluded.owners, "
                "groups_json = excluded.groups_json, "
                "labels_json = excluded.labels_json",
                [
                    (
                        name,
                        float(q.get("weight", 1.0)),
                        int(q.get("cordoned", False)),
                        _json.dumps(q.get("owners", [])),
                        _json.dumps(q.get("groups", [])),
                        _json.dumps(q.get("labels", {})),
                    )
                    for name, q in op.queues_by_name.items()
                ],
                -1,
                True,
            )
        ]
    if t is ops.DeleteQueues:
        return [
            PlanStmt(
                None,
                "DELETE FROM queues WHERE name = ?",
                [(n,) for n in op.names],
                -1,
                True,
            )
        ]
    if t is ops.UpsertExecutorSettings:
        return [
            PlanStmt(
                None,
                "INSERT INTO executor_settings "
                "(executor_id, cordoned, cordon_reason, set_by_user) "
                "VALUES (?, ?, ?, ?) ON CONFLICT(executor_id) DO UPDATE SET "
                "cordoned = excluded.cordoned, "
                "cordon_reason = excluded.cordon_reason, "
                "set_by_user = excluded.set_by_user",
                [
                    (
                        name,
                        int(s.get("cordoned", False)),
                        s.get("cordon_reason", ""),
                        s.get("set_by_user", ""),
                    )
                    for name, s in op.settings_by_name.items()
                ],
                -1,
                True,
            )
        ]
    if t is ops.DeleteExecutorSettings:
        return [
            PlanStmt(
                None,
                "DELETE FROM executor_settings WHERE executor_id = ?",
                [(n,) for n in op.names],
                -1,
                True,
            )
        ]
    return None


def render_scheduler_ops(
    batch_ops: Iterable[ops.DbOperation],
) -> Optional[list[PlanStmt]]:
    """Render a whole converted batch, or None if ANY op needs the live
    tables (the shard worker then ships the raw ops and the store thread
    applies them in-transaction)."""
    plan: list[PlanStmt] = []
    for op in batch_ops:
        rendered = render_op(op)
        if rendered is None:
            return None
        plan.extend(rendered)
    return plan


class SchedulerDb:
    """Scheduler state store + ingestion sink (SQLite file / :memory:, or
    external PostgreSQL via a postgres:// URL)."""

    def __init__(
        self,
        path: str = ":memory:",
        serial_allocator: Optional[SerialAllocator] = None,
        pg_schema: Optional[str] = None,
    ):
        self._path = path
        self._dialect = "pg" if is_postgres_url(path) else "sqlite"
        if self._dialect == "pg":
            # pg_schema pins this store's tables into a per-shard schema
            # (ingest/storeunion.py); the session SQL replays on every
            # reconnect so a dropped session never falls back to public.
            session_sql = ()
            if pg_schema:
                session_sql = (
                    f"CREATE SCHEMA IF NOT EXISTS {pg_schema}",
                    f"SET search_path TO {pg_schema}",
                )
            self._conn = _PgAdapter(path, session_sql=session_sql)
        else:
            if pg_schema:
                raise ValueError("pg_schema requires a postgres:// URL")
            # 512 cached prepared statements (default 128): the store's own
            # ~30 texts plus the power-of-two IN buckets of every read shape
            # must all stay resident across batches for executemany reuse.
            self._conn = sqlite3.connect(
                path, check_same_thread=False, cached_statements=512
            )
            self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._migrate()
        # Close the migration transaction (the dedup DELETE opens one);
        # PRAGMA synchronous refuses to run inside a transaction.
        self._conn.commit()
        if self._dialect == "sqlite":
            self._conn.execute("PRAGMA journal_mode=WAL")
            # Bulk-ingest batches write tens of thousands of WAL pages; the
            # 1000-page autocheckpoint default forces main-db rewrites MID
            # TRANSACTION (measured r18: 1.43s -> 0.86s on a 90k-event
            # batch with the checkpoint deferred past the batch).
            self._conn.execute("PRAGMA wal_autocheckpoint=10000")
            self._conn.execute("PRAGMA cache_size=-65536")
            # NORMAL, not FULL: this store is a materialized VIEW of the
            # fsynced event log -- a torn WAL tail after an OS crash rolls
            # data and cursor back TOGETHER (one txn) and the log replays
            # the difference idempotently, so per-commit fsyncs buy nothing
            # but latency here.  WAL+NORMAL still guarantees no corruption.
            self._conn.execute("PRAGMA synchronous=NORMAL")
            # Read index/btree pages via mmap instead of pread: this host's
            # syscall cost dominates page reads during UPDATE lookups.
            self._conn.execute("PRAGMA mmap_size=268435456")
        self._conn.commit()
        # tsan-instrumented (round 18): the partition-parallel ingest plane
        # makes this the multi-writer choke point -- every shard's store leg
        # serializes here, and the race harness must see the ordering.
        self._lock = make_lock("schedulerdb.store")
        # Sharded-store serial discipline (round 19): when this store is one
        # shard file of a ShardedSchedulerDb, serials come from the shared
        # allocator (globally ordered across shards) and this store's local
        # `serials` rows record its own high-water mark for reopen seeding.
        self._alloc = serial_allocator
        self._txn_serials: list[tuple[str, int]] = []
        if serial_allocator is not None:
            for name, value in self._query("SELECT name, value FROM serials"):
                serial_allocator.seed(str(name), int(value))

    def _table_columns(self, table: str) -> set[str]:
        if self._dialect == "sqlite":
            return {
                r["name"]
                for r in self._conn.execute(
                    f"PRAGMA table_info({table})"
                ).fetchall()
            }
        return self._conn.table_columns(table)

    def _migrate(self) -> None:
        """Columns added after a table existed: CREATE TABLE IF NOT EXISTS is
        a no-op then, so patch the schema in place (the reference's numbered
        migrations, database/migrations/)."""
        itype = "INTEGER" if self._dialect == "sqlite" else "BIGINT"
        if "preempt_requested" not in self._table_columns("jobs"):
            self._conn.execute(
                f"ALTER TABLE jobs ADD COLUMN preempt_requested {itype} NOT NULL DEFAULT 0"
            )
        if "running_ns" not in self._table_columns("runs"):
            self._conn.execute(
                f"ALTER TABLE runs ADD COLUMN running_ns {itype} NOT NULL DEFAULT 0"
            )
        # Identity index so error inserts are replay-idempotent like every
        # other sink write: a restore-plus-suffix-replay (round 18's
        # fence-first snapshot under per-shard PG commits) must not
        # duplicate a run's error rows.  Pre-existing duplicates from old
        # crash replays are collapsed first (SQLite); if creation still
        # fails (a PG store with duplicates), the INSERT OR IGNORE simply
        # has no conflict target -- the pre-round-18 behavior.
        try:
            if self._dialect == "sqlite":
                have_index = self._conn.execute(
                    "SELECT 1 FROM sqlite_master WHERE type = 'index' "
                    "AND name = 'idx_jre_identity'"
                ).fetchone()
                if not have_index:
                    # Only a pre-index store can hold duplicates; with the
                    # index in place this O(table) scan never reruns.
                    self._conn.execute(
                        "DELETE FROM job_run_errors WHERE rowid NOT IN ("
                        "SELECT MIN(rowid) FROM job_run_errors "
                        "GROUP BY run_id, reason, message, terminal)"
                    )
            self._conn.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS idx_jre_identity "
                "ON job_run_errors(run_id, reason, message, terminal)"
            )
        except Exception:  # noqa: BLE001 - degraded (no dedup), never bricked
            pass

    def close(self) -> None:
        self._conn.close()

    # --- serials ------------------------------------------------------------

    def _next_serial(self, cur: sqlite3.Cursor, name: str) -> int:
        if self._alloc is not None:
            # Shard-file mode: the shared allocator orders serials across
            # every shard of the store; this shard's own allocations are
            # monotonic, so a plain last-write upsert records the local
            # high-water mark (reopen seeds the allocator from it).
            serial = self._alloc.allocate(name)
            self._txn_serials.append((name, serial))
            cur.execute(
                "INSERT INTO serials(name, value) VALUES (?, ?) "
                "ON CONFLICT(name) DO UPDATE SET value = excluded.value",
                (name, serial),
            )
            return serial
        cur.execute(
            "INSERT INTO serials(name, value) VALUES (?, 1) "
            "ON CONFLICT(name) DO UPDATE SET value = value + 1",
            (name,),
        )
        row = cur.execute("SELECT value FROM serials WHERE name = ?", (name,)).fetchone()
        return int(row[0])

    def _serials_settled(self, committed: bool) -> None:
        """Tell the shared allocator this transaction's serials landed (or
        became permanent gaps).  The window between the DB commit and this
        call only HOLDS BACK the union read horizon -- safe direction."""
        if self._alloc is not None and self._txn_serials:
            if committed:
                self._alloc.committed(self._txn_serials)
            else:
                self._alloc.discarded(self._txn_serials)
            self._txn_serials = []

    # --- ingestion sink -----------------------------------------------------

    def _lock_serial_rows(self, cur: sqlite3.Cursor) -> None:
        """Touch BOTH serial-counter rows in a fixed order at transaction
        start.  Concurrent shard transactions on external PG otherwise
        acquire the two row locks in batch-dependent order (a jobs-first
        insert batch vs a runs-first lifecycle batch) and deadlock; the
        embedded single-connection path is unaffected but pays the same
        two no-op statements for one code path."""
        for name in ("jobs", "runs"):
            cur.execute(
                "INSERT INTO serials(name, value) VALUES (?, 0) "
                "ON CONFLICT(name) DO UPDATE SET value = value",
                (name,),
            )

    def store(
        self,
        batch_ops: Iterable[ops.DbOperation],
        consumer: str = "scheduler",
        next_positions: Optional[dict[int, int]] = None,
    ) -> None:
        """Apply ops + advance the consumer position in ONE transaction."""
        with self._lock:
            cur = self._conn.cursor()
            try:
                self._lock_serial_rows(cur)
                for op in batch_ops:
                    self._apply(cur, op)
                for part, pos in (next_positions or {}).items():
                    cur.execute(
                        "INSERT INTO consumer_positions(consumer, partition, position) "
                        "VALUES (?, ?, ?) ON CONFLICT(consumer, partition) "
                        "DO UPDATE SET position = excluded.position",
                        (consumer, part, pos),
                    )
                self._conn.commit()
                self._serials_settled(committed=True)
            except BaseException:
                self._conn.rollback()
                self._serials_settled(committed=False)
                raise

    def _query(self, sql: str, params=()) -> list[sqlite3.Row]:
        """Locked read: same-connection reads must not observe another
        thread's uncommitted (potentially rolled-back) transaction."""
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    # --- checkpoint export/restore (scheduler/checkpoint.py) ----------------

    def export_snapshot(self) -> dict[str, list[tuple]]:
        """A consistent dump of every materialized table as plain tuples in
        SNAPSHOT_TABLES order.  Taken under the store lock, so it sits on a
        batch boundary of the exactly-once ingestion sink: the dumped
        consumer_positions rows ARE the eventlog fence the rest of the dump
        reflects -- restoring the dump and replaying the log from those
        positions reproduces exactly the post-suffix state."""
        with self._lock:
            out: dict[str, list[tuple]] = {}
            for table, cols in SNAPSHOT_TABLES.items():
                rows = self._conn.execute(
                    f"SELECT {', '.join(cols)} FROM {table}"
                ).fetchall()
                out[table] = [
                    tuple(row[i] for i in range(len(cols))) for row in rows
                ]
            return out

    def restore_snapshot(self, dump: dict[str, list[tuple]]) -> None:
        """Replace all materialized state with `dump` in ONE transaction: a
        failure mid-restore rolls back to the pre-restore state, never to a
        half-loaded store."""
        with self._lock:
            cur = self._conn.cursor()
            try:
                for table, cols in SNAPSHOT_TABLES.items():
                    cur.execute(f"DELETE FROM {table}")
                    rows = dump.get(table, [])
                    if rows:
                        qs = ", ".join("?" for _ in cols)
                        cur.executemany(
                            f"INSERT INTO {table} ({', '.join(cols)}) "
                            f"VALUES ({qs})",
                            rows,
                        )
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
            if self._alloc is not None:
                # A restored serials table may sit past the allocator's
                # counter (snapshot from a longer-lived plane); re-seed so
                # fresh allocations stay globally monotonic.
                for row in cur.execute("SELECT name, value FROM serials"):
                    self._alloc.seed(str(row[0]), int(row[1]))

    def positions(self, consumer: str = "scheduler") -> dict[int, int]:
        rows = self._query(
            "SELECT partition, position FROM consumer_positions WHERE consumer = ?",
            (consumer,),
        )
        return {int(r["partition"]): int(r["position"]) for r in rows}

    # --- dead-letter quarantine (ingest/dlq.py) -----------------------------

    def store_dead_letters(
        self,
        rows,
        consumer: str = "scheduler",
        next_positions: Optional[dict[int, int]] = None,
    ) -> None:
        """Quarantine poison records + advance the cursor past them in ONE
        transaction (the store/store_plan exactly-once shape)."""
        from armada_tpu_torch.ingest import dlq

        dlq.commit_dead_letters(
            self._conn, self._lock, rows, consumer, next_positions
        )

    def list_dead_letters(self, consumer=None, status=None) -> list[dict]:
        from armada_tpu_torch.ingest import dlq

        return dlq.list_rows(self._conn, self._lock, consumer, status)

    def get_dead_letter(self, consumer, partition, record_offset):
        from armada_tpu_torch.ingest import dlq

        return dlq.get_row(
            self._conn, self._lock, consumer, partition, record_offset
        )

    def mark_dead_letter(
        self, consumer, partition=None, record_offset=None, status="dead"
    ) -> int:
        from armada_tpu_torch.ingest import dlq

        return dlq.mark_rows(
            self._conn, self._lock, status, consumer, partition, record_offset
        )

    # --- op application -----------------------------------------------------

    def _execute_plan(self, cur: sqlite3.Cursor, plan: list[PlanStmt]) -> None:
        """Run rendered statements, allocating serials in-transaction.
        Serials ride as bound parameters, never interpolated literals: the
        statement TEXT stays constant across batches, so the PG adapter's
        translate cache (and sqlite3's statement cache) actually hit.
        Columnar `many` params stream through ONE zip -- the serial joins as
        a repeat() column instead of per-row tuple slicing (the r19
        one-pass packing; ~6% of the single-writer leg)."""
        lazy_rows = self._dialect == "sqlite"  # pgwire chunks via len()
        for st in plan:
            serial = (
                self._next_serial(cur, st.domain)
                if st.domain is not None
                else None
            )
            pos = st.serial_pos
            if not st.many:
                p = st.params
                if serial is not None:
                    p = p[:pos] + (serial,) + p[pos:]
                cur.execute(st.sql, p)
                continue
            params = st.params
            if isinstance(params, tuple):  # columnar: per-column sequences
                if serial is None:
                    rows = zip(*params)
                else:
                    n = len(params[0]) if params else 0
                    rows = zip(
                        *params[:pos], _repeat(serial, n), *params[pos:]
                    )
                cur.executemany(st.sql, rows if lazy_rows else list(rows))
            elif serial is None:
                cur.executemany(st.sql, params)
            else:
                cur.executemany(
                    st.sql, [r[:pos] + (serial,) + r[pos:] for r in params]
                )

    def store_plan(
        self,
        plan: list[PlanStmt],
        consumer: str = "scheduler",
        next_positions: Optional[dict[int, int]] = None,
    ) -> None:
        """Apply a pre-rendered plan (render_scheduler_ops, typically built
        in a shard's converter subprocess) + the consumer position in ONE
        transaction -- the exactly-once shape of `store`, minus the
        render-side CPU on this thread."""
        with self._lock:
            cur = self._conn.cursor()
            try:
                self._lock_serial_rows(cur)
                self._execute_plan(cur, plan)
                for part, pos in (next_positions or {}).items():
                    cur.execute(
                        "INSERT INTO consumer_positions(consumer, partition, position) "
                        "VALUES (?, ?, ?) ON CONFLICT(consumer, partition) "
                        "DO UPDATE SET position = excluded.position",
                        (consumer, part, pos),
                    )
                self._conn.commit()
                self._serials_settled(committed=True)
            except BaseException:
                self._conn.rollback()
                self._serials_settled(committed=False)
                raise

    # Shipped to shard converter subprocesses by dotted name
    # (ingest/shards.py): must stay a module-level function.
    plan_renderer = staticmethod(render_scheduler_ops)

    # Sharded stores own their shard sinks for the store's lifetime (the
    # pipeline must not close them in stop()); the plain store's PG sinks
    # are per-pipeline throwaways.
    shard_sinks_owned_by_store = False

    def shard_sink(
        self, shard_index: int = 0, num_shards: int = 1
    ) -> "SchedulerDb":
        """The store leg for ONE shard of the partition-parallel ingest
        plane.  External PG: a dedicated wire connection, so shard store
        transactions pipeline server-side instead of queueing on one
        socket.  Embedded SQLite: the shared connection (same file, same
        write lock -- a second connection only adds busy-retry churn);
        the tsan-guarded store lock serializes shard commits.  The plain
        store ignores (shard_index, num_shards) -- every shard funnels into
        the one writer; ShardedSchedulerDb routes shard k to store file
        k % width (ingest/storeunion.py)."""
        if self._dialect == "pg":
            return SchedulerDb(self._path)
        return self

    def _apply(self, cur: sqlite3.Cursor, op: ops.DbOperation) -> None:
        plan = render_op(op)
        if plan is not None:
            self._execute_plan(cur, plan)
        elif isinstance(op, (ops.PreemptOnExecutor, ops.CancelOnExecutor)):
            # Membership resolves at apply time against the runs table
            # (reference schedulerdb.go:411-431 SelectJobsByExecutorAndQueues
            # + PC filter on the parsed scheduling info).
            # spec blobs only load when a PC filter needs them: an unfiltered
            # mass action on a 1M-job queue must not materialize 1M blobs
            # inside the ingestion transaction.
            spec_col = ", j.spec" if op.priority_classes else ""
            where = (
                f"SELECT DISTINCT j.job_id{spec_col} FROM jobs j "
                "JOIN runs r ON r.job_id = j.job_id "
                "WHERE r.executor = ? AND r.succeeded = 0 AND r.failed = 0 "
                "  AND r.cancelled = 0 AND r.preempted = 0 AND r.returned = 0 "
                "  AND j.cancelled = 0 AND j.succeeded = 0 AND j.failed = 0"
            )
            params: list = [op.executor]
            if op.queues:
                where += f" AND j.queue IN ({','.join('?' * len(op.queues))})"
                params.extend(op.queues)
            job_ids = self._filter_by_priority_class(
                cur.execute(where, params).fetchall(), op.priority_classes
            )
            if isinstance(op, ops.PreemptOnExecutor):
                self._apply(cur, ops.MarkJobsPreemptRequested(job_ids=job_ids))
            else:
                self._apply(
                    cur, ops.MarkJobsCancelRequested(job_ids=job_ids)
                )
        elif isinstance(op, (ops.PreemptOnQueue, ops.CancelOnQueue)):
            spec_col = ", spec" if op.priority_classes else ""
            where = (
                f"SELECT job_id{spec_col} FROM jobs "
                "WHERE queue = ? AND cancelled = 0 AND succeeded = 0 "
                "AND failed = 0"
            )
            params = [op.queue]
            if isinstance(op, ops.PreemptOnQueue):
                where += " AND queued = 0"  # only leased/running can preempt
            elif op.job_states:
                conds = []
                if "queued" in op.job_states:
                    conds.append("queued = 1")
                if "leased" in op.job_states:
                    conds.append("queued = 0")
                # FALSE: boolean-context literal valid on both dialects
                where += f" AND ({' OR '.join(conds) or 'FALSE'})"
            job_ids = self._filter_by_priority_class(
                cur.execute(where, params).fetchall(), op.priority_classes
            )
            if isinstance(op, ops.PreemptOnQueue):
                self._apply(cur, ops.MarkJobsPreemptRequested(job_ids=job_ids))
            else:
                self._apply(
                    cur, ops.MarkJobsCancelRequested(job_ids=job_ids)
                )
        else:
            raise TypeError(f"unknown DbOperation: {type(op).__name__}")

    @staticmethod
    def _filter_by_priority_class(rows, priority_classes) -> set[str]:
        if not priority_classes:
            return {row[0] for row in rows}
        from armada_tpu_torch.events import schema as _pb

        allowed = set(priority_classes)
        out = set()
        for job_id, spec_blob in rows:
            spec = _pb.JobSpec.FromString(spec_blob)
            if spec.priority_class in allowed:
                out.add(job_id)
        return out

    # --- scheduler-side reads (job_repository.go) ---------------------------

    def fetch_job_updates(
        self, jobs_serial: int, runs_serial: int
    ) -> tuple[list[sqlite3.Row], list[sqlite3.Row]]:
        """Incremental fetch: all rows whose serial advanced past the cursor
        (job_repository.go FetchJobUpdates)."""
        jobs = self._query(
            "SELECT * FROM jobs WHERE serial > ? ORDER BY serial", (jobs_serial,)
        )
        runs = self._query(
            "SELECT * FROM runs WHERE serial > ? ORDER BY serial", (runs_serial,)
        )
        return jobs, runs

    def max_serials(self) -> tuple[int, int]:
        rows = dict(self._query("SELECT name, value FROM serials"))
        return int(rows.get("jobs", 0)), int(rows.get("runs", 0))

    def has_marker(self, group_id: str, num_partitions: int) -> bool:
        n = self._query(
            "SELECT COUNT(*) FROM markers WHERE group_id = ?", (group_id,)
        )[0][0]
        return int(n) >= num_partitions

    def run_errors(self, run_id: str) -> list[sqlite3.Row]:
        return self._query(
            "SELECT * FROM job_run_errors WHERE run_id = ?", (run_id,)
        )

    # --- executor api reads (internal/scheduler/api.go:88-122) --------------

    def leases_for_executor(self, executor_id: str, limit: int = 10_000) -> list[sqlite3.Row]:
        """Non-terminal runs assigned to `executor_id`, with their job's spec
        (FetchJobRunLeases, database/query/query.sql)."""
        return self._query(
            "SELECT r.run_id, r.job_id, r.node_id, r.node_name, r.pool, "
            "       r.scheduled_at_priority, r.preempt_requested, "
            "       j.queue, j.jobset, j.spec "
            "FROM runs r JOIN jobs j ON j.job_id = r.job_id "
            "WHERE r.executor = ? AND r.succeeded = 0 AND r.failed = 0 "
            "  AND r.cancelled = 0 AND r.preempted = 0 AND r.returned = 0 "
            "  AND j.cancelled = 0 AND j.succeeded = 0 AND j.failed = 0 "
            "ORDER BY r.serial LIMIT ?",
            (executor_id, limit),
        )

    # IN lists chunked well under the wire protocol's uint16 parameter
    # limit (pgwire Bind) and SQLite's host-parameter cap.
    _IN_CHUNK = 8192

    def _in_query(self, sql_template: str, values: list) -> list:
        """Run `sql_template` (with an `{qs}` placeholder list) over `values`
        in chunks.  Each chunk is PADDED to a power-of-two bucket by
        repeating its last value -- duplicates are no-ops inside IN, and
        bucketing keeps the distinct statement texts (and the PG adapter's
        translate cache) bounded at ~14 per query shape instead of one per
        list size ever seen."""
        out: list = []
        for lo in range(0, len(values), self._IN_CHUNK):
            chunk = list(values[lo : lo + self._IN_CHUNK])
            size = 1
            while size < len(chunk):
                size *= 2
            chunk.extend([chunk[-1]] * (size - len(chunk)))
            qs = ",".join("?" * size)
            out.extend(self._query(sql_template.format(qs=qs), chunk))
        return out

    def inactive_runs(self, run_ids: Iterable[str]) -> set[str]:
        """Of `run_ids`, those the scheduler no longer considers active: the
        run or its job is terminal, or the run is unknown (FindInactiveRuns)."""
        run_ids = list(run_ids)
        if not run_ids:
            return set()
        rows = self._in_query(
            "SELECT r.run_id FROM runs r JOIN jobs j ON j.job_id = r.job_id "
            "WHERE r.run_id IN ({qs}) "
            "  AND r.succeeded = 0 AND r.failed = 0 AND r.cancelled = 0 "
            "  AND r.preempted = 0 AND r.returned = 0 "
            "  AND j.cancelled = 0 AND j.succeeded = 0 AND j.failed = 0",
            run_ids,
        )
        active = {r["run_id"] for r in rows}
        return set(run_ids) - active

    def preempt_requested_runs(self, executor_id: str) -> list[str]:
        """Runs of this executor with a pending preemption request
        (api.go: runs to preempt are streamed to the executor)."""
        rows = self._query(
            "SELECT run_id FROM runs WHERE executor = ? AND preempt_requested = 1 "
            "AND succeeded = 0 AND failed = 0 AND cancelled = 0 AND preempted = 0 "
            "AND returned = 0",
            (executor_id,),
        )
        return [r["run_id"] for r in rows]

    # --- dedup kv (reference: server deduplication via PG kv) ---------------

    def lookup_dedup(self, keys: list[str]) -> dict[str, str]:
        if not keys:
            return {}
        rows = self._in_query(
            "SELECT dedup_key, job_id FROM job_dedup WHERE dedup_key IN ({qs})",
            keys,
        )
        return {r["dedup_key"]: r["job_id"] for r in rows}

    def store_dedup(self, mapping: dict[str, str]) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR IGNORE INTO job_dedup (dedup_key, job_id) VALUES (?, ?)",
                list(mapping.items()),
            )
            self._conn.commit()

    # --- queues (internal/server/queue/queue_repository.go:32-50) -----------

    def upsert_queue(
        self,
        name: str,
        weight: float = 1.0,
        cordoned: bool = False,
        owners: Optional[list] = None,
        groups: Optional[list] = None,
        labels: Optional[dict] = None,
    ) -> None:
        import json as _json

        with self._lock:
            self._conn.execute(
                "INSERT INTO queues (name, weight, cordoned, owners, groups_json, labels_json) "
                "VALUES (?, ?, ?, ?, ?, ?) ON CONFLICT(name) DO UPDATE SET "
                "weight = excluded.weight, cordoned = excluded.cordoned, "
                "owners = excluded.owners, groups_json = excluded.groups_json, "
                "labels_json = excluded.labels_json",
                (
                    name,
                    weight,
                    int(cordoned),
                    _json.dumps(owners or []),
                    _json.dumps(groups or []),
                    _json.dumps(labels or {}),
                ),
            )
            self._conn.commit()

    def delete_queue(self, name: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM queues WHERE name = ?", (name,))
            self._conn.commit()

    def get_queue(self, name: str) -> Optional[sqlite3.Row]:
        rows = self._query("SELECT * FROM queues WHERE name = ?", (name,))
        return rows[0] if rows else None

    def list_queues(self) -> list[sqlite3.Row]:
        return self._query("SELECT * FROM queues ORDER BY name")

    # --- executor snapshots (executor_repository.go) ------------------------

    def upsert_executor(self, executor_id: str, snapshot: bytes, now_ns: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO executors (executor_id, snapshot, last_updated_ns) "
                "VALUES (?, ?, ?) ON CONFLICT(executor_id) DO UPDATE SET "
                "snapshot = excluded.snapshot, last_updated_ns = excluded.last_updated_ns",
                (executor_id, snapshot, now_ns),
            )
            self._conn.commit()

    def executors(self) -> list[sqlite3.Row]:
        return self._query("SELECT * FROM executors")

    def executor_settings(self) -> dict[str, dict]:
        """Operator cordon state by executor id (scheduling_algo.go:250
        GetExecutorSettings) -- replayed from control-plane events."""
        return {
            row["executor_id"]: {
                "cordoned": bool(row["cordoned"]),
                "cordon_reason": row["cordon_reason"],
                "set_by_user": row["set_by_user"],
            }
            for row in self._query("SELECT * FROM executor_settings")
        }


# Per-column insert defaults, resolved ONCE at import: the old per-call
# default lookup rebuilt its dict literal on every field of every row
# (480k dict constructions per 30k-job batch -- ~40% of store's Python time).
_JOB_DEFAULTS = {
    "priority": 0, "submitted_ns": 0, "queued": 1, "queued_version": 0,
    "validated": 0, "pools": "", "cancel_requested": 0,
    "cancel_by_jobset_requested": 0, "preempt_requested": 0,
    "cancelled": 0, "succeeded": 0,
    "failed": 0, "spec": b"",
}
_RUN_DEFAULTS = {
    "created_ns": 0, "scheduled_at_priority": None,
    "pool_scheduled_away": 0, "leased": 1,
}


def _job_default(col: str):
    return _JOB_DEFAULTS.get(col, "")


def _run_default(col: str):
    return _RUN_DEFAULTS.get(col, "")


# (column, default) pairs in insert order, for the render-side row builders.
_JOBS_COL_DEFAULTS = tuple((c, _job_default(c)) for c in JOBS_COLUMNS)
_RUNS_COL_DEFAULTS = tuple((c, _run_default(c)) for c in RUNS_COLUMNS)
