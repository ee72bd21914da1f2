"""JobDb: the in-memory job store with single-writer transactions.

The port's copy of the JAX package's jobdb/jobdb.py, with plain
threading locks in place of its lock-order checker (analysis/tsan).

Equivalent of the reference's jobdb (internal/scheduler/jobdb/jobdb.go:67-84,
305-324): jobs indexed by id, run id and gang key, plus a per-queue ordered
set of queued jobs iterated in scheduling order; WriteTxn buffers updates that
become visible only on Commit (single writer, enforced by a lock held for the
txn's lifetime); Txn.Assert checks cross-index invariants (jobdb.go:387).

Concurrency model: one writer at a time; readers read committed state.  A
write txn's uncommitted changes are visible only through that txn (overlay
reads), and Abort discards them -- the property the scheduler cycle depends on
(scheduler.go cycle: schedule against a txn, publish, then commit).  Point
reads are lock-free; iteration methods materialize a consistent snapshot under
a short state lock also taken by commit, so readers never observe a
half-applied commit.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

try:
    from sortedcontainers import SortedKeyList
except ImportError:  # not in every toolchain; same-semantics local subset
    from armada_tpu_torch.jobdb._sortedlist import SortedKeyList

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.ordering import scheduling_order_key
from armada_tpu_torch.jobdb.job import Job, JobRun


def _order_key(config: SchedulingConfig) -> Callable[[Job], tuple]:
    def key(job: Job) -> tuple:
        pc = job.priority_class(config)
        return scheduling_order_key(pc.priority, job.priority, job.submitted_ns, job.id)

    return key


def market_order_key(bid_price_of: Callable[[Job], float]) -> Callable[[Job], tuple]:
    """Market scheduling order (jobdb/comparison.go MarketJobPriorityComparer):
    higher bid price first, then earlier submission."""

    def key(job: Job) -> tuple:
        return (-bid_price_of(job), job.submitted_ns, job.id)

    return key


def gang_key(job: Job) -> Optional[tuple[str, str]]:
    return (job.queue, job.spec.gang_id) if job.spec.gang_id else None


class JobDb:
    def __init__(
        self,
        config: Optional[SchedulingConfig] = None,
        order_key: Optional[Callable[[Job], tuple]] = None,
    ):
        """`order_key` overrides the queued-job ordering (e.g. market_order_key
        for price-ordered pools, jobdb/comparison.go MarketJobPriorityComparer)."""
        from armada_tpu_torch.core.config import default_scheduling_config

        self.config = config or default_scheduling_config()
        self._jobs: dict[str, Job] = {}
        self._job_by_run: dict[str, str] = {}
        self._by_gang: dict[tuple[str, str], set[str]] = {}
        self._queued: dict[str, SortedKeyList] = {}
        self._unvalidated: set[str] = set()
        self._order = order_key or _order_key(self.config)
        self._writer = threading.Lock()
        # Guards in-place index mutation during _apply against concurrent
        # reader iteration (readers snapshot under this lock).
        self._state = threading.Lock()
        # Commit subscribers: fn(upserts: dict[str, Job], deletes: set[str]),
        # called after each committed txn -- the delta feed for the
        # incremental problem builder (scheduler/incremental_algo.py), the
        # analog of the reference's scheduler keeping its jobDb between
        # cycles (scheduler.go:240-246).  Callbacks run under the writer
        # lock; they must not open txns.  Abort subscribers fire when a txn
        # with buffered changes is discarded: anyone who peeked at the
        # overlay (the feed does, at schedule time) must resynchronize from
        # committed state.
        self._subscribers: list = []
        self._abort_subscribers: list = []

    def subscribe(self, fn) -> None:
        self._subscribers.append(fn)

    def subscribe_abort(self, fn) -> None:
        self._abort_subscribers.append(fn)

    # --- transactions -------------------------------------------------------

    def read_txn(self) -> "ReadTxn":
        return ReadTxn(self)

    def write_txn(self) -> "WriteTxn":
        self._writer.acquire()
        return WriteTxn(self)

    # --- committed-state accessors (used by txns) ---------------------------

    def _get(self, job_id: str) -> Optional[Job]:
        return self._jobs.get(job_id)

    def _apply(self, upserts: dict[str, Job], deletes: set[str]) -> None:
        """Apply a txn's buffered changes to the committed indexes.

        The ordering key (which resolves priority classes, the only thing
        that can raise here) was already evaluated per job by
        WriteTxn.upsert, and Jobs are immutable -- so by the time a commit
        reaches this point nothing can fail mid-mutation, and re-validating
        a 1k-upsert batch would just re-pay a third of the commit's cost.
        """
        with self._state:
            for job_id in deletes:
                old = self._jobs.pop(job_id, None)
                if old is not None:
                    self._deindex(old)
            for job_id, job in upserts.items():
                old = self._jobs.get(job_id)
                if old is not None:
                    self._deindex(old)
                self._jobs[job_id] = job
                self._index(job)
        for fn in self._subscribers:
            fn(upserts, deletes)

    def _index(self, job: Job) -> None:
        for run in job.runs:
            self._job_by_run[run.id] = job.id
        gk = gang_key(job)
        if gk is not None:
            self._by_gang.setdefault(gk, set()).add(job.id)
        if job.queued:
            self._queued.setdefault(
                job.queue, SortedKeyList(key=self._order)
            ).add(job)
        if not job.validated and not job.in_terminal_state():
            self._unvalidated.add(job.id)

    def _deindex(self, job: Job) -> None:
        for run in job.runs:
            self._job_by_run.pop(run.id, None)
        gk = gang_key(job)
        if gk is not None:
            ids = self._by_gang.get(gk)
            if ids is not None:
                ids.discard(job.id)
                if not ids:
                    del self._by_gang[gk]
        if job.queued:
            queued = self._queued.get(job.queue)
            if queued is not None:
                queued.discard(job)
        self._unvalidated.discard(job.id)


class ReadTxn:
    """Reads committed state.  Kept as an object (rather than bare db methods)
    so read and write paths share one accessor interface."""

    def __init__(self, db: JobDb):
        self._db = db

    def get(self, job_id: str) -> Optional[Job]:
        return self._db._get(job_id)

    def get_by_run_id(self, run_id: str) -> Optional[Job]:
        # Two-step read: must not interleave with _apply's deindex/reindex.
        with self._db._state:
            job_id = self._db._job_by_run.get(run_id)
            return self._db._get(job_id) if job_id else None

    def gang_jobs(self, queue: str, gang_id: str) -> list[Job]:
        with self._db._state:
            ids = sorted(self._db._by_gang.get((queue, gang_id), set()))
            return [self._db._jobs[i] for i in ids]

    def queued_jobs(self, queue: str) -> list[Job]:
        """Queued jobs of a queue in scheduling order (jobdb.go QueuedJobs:703).

        Returns a snapshot list: safe against concurrent commits.
        """
        with self._db._state:
            return list(self._db._queued.get(queue, ()))

    def unvalidated_jobs(self) -> list[Job]:
        with self._db._state:
            return [self._db._jobs[i] for i in sorted(self._db._unvalidated)]

    def queues_with_queued_jobs(self) -> list[str]:
        with self._db._state:
            return sorted(q for q, s in self._db._queued.items() if len(s) > 0)

    def all_jobs(self) -> list[Job]:
        with self._db._state:
            return list(self._db._jobs.values())

    def __len__(self) -> int:
        return len(self._db._jobs)


class WriteTxn(ReadTxn):
    """Buffered single-writer transaction: reads see the overlay; Commit
    publishes atomically; Abort discards.  Mirrors jobdb.Txn (jobdb.go:305-324)."""

    def __init__(self, db: JobDb):
        super().__init__(db)
        self._upserts: dict[str, Job] = {}
        self._deletes: set[str] = set()
        self._touched_cache: Optional[set[str]] = None
        self._done = False

    # --- overlay reads ------------------------------------------------------

    def get(self, job_id: str) -> Optional[Job]:
        if job_id in self._deletes:
            return None
        if job_id in self._upserts:
            return self._upserts[job_id]
        return self._db._get(job_id)

    def get_by_run_id(self, run_id: str) -> Optional[Job]:
        for job in self._upserts.values():
            if any(r.id == run_id for r in job.runs):
                return job
        job = super().get_by_run_id(run_id)
        if job is None or job.id in self._deletes:
            return None
        return self.get(job.id)

    def gang_jobs(self, queue: str, gang_id: str) -> list[Job]:
        ids = set(self._db._by_gang.get((queue, gang_id), set()))
        for job in self._upserts.values():
            if gang_key(job) == (queue, gang_id):
                ids.add(job.id)
        ids -= self._deletes
        return [j for i in sorted(ids) if (j := self.get(i)) is not None]

    def _touched_queues(self) -> set[str]:
        """Queues whose committed queued-index the overlay could alter.
        Cached; invalidated by upsert/delete."""
        if self._touched_cache is not None:
            return self._touched_cache
        queues: set[str] = set()
        for job_id, job in self._upserts.items():
            queues.add(job.queue)
            old = self._db._get(job_id)
            if old is not None:
                queues.add(old.queue)
        for job_id in self._deletes:
            old = self._db._get(job_id)
            if old is not None:
                queues.add(old.queue)
        self._touched_cache = queues
        return queues

    def queued_jobs(self, queue: str) -> list[Job]:
        if queue not in self._touched_queues():
            return super().queued_jobs(queue)
        # Merge the committed ordered set with the overlay.
        touched = set(self._upserts) | self._deletes
        merged = SortedKeyList(key=self._db._order)
        for job in super().queued_jobs(queue):
            if job.id not in touched:
                merged.add(job)
        for job in self._upserts.values():
            if job.queue == queue and job.queued:
                merged.add(job)
        return list(merged)

    def _queue_has_queued(self, queue: str) -> bool:
        """Emptiness check without materializing the overlay merge."""
        touched = set(self._upserts) | self._deletes
        for job in self._upserts.values():
            if job.queue == queue and job.queued:
                return True
        return any(
            job.id not in touched for job in super().queued_jobs(queue)
        )

    def queues_with_queued_jobs(self) -> list[str]:
        queues = set(super().queues_with_queued_jobs())
        for job in self._upserts.values():
            if job.queued:
                queues.add(job.queue)
        touched = self._touched_queues()
        # Only queues the overlay touches can have become empty; others keep
        # their committed answer.
        return sorted(
            q for q in queues if q not in touched or self._queue_has_queued(q)
        )

    def unvalidated_jobs(self) -> list[Job]:
        ids = set(self._db._unvalidated)
        for job in self._upserts.values():
            if not job.validated and not job.in_terminal_state():
                ids.add(job.id)
            else:
                ids.discard(job.id)
        ids -= self._deletes
        return [j for i in sorted(ids) if (j := self.get(i)) is not None]

    def all_jobs(self) -> list[Job]:
        out = [
            job
            for job_id, job in self._db._jobs.items()
            if job_id not in self._deletes and job_id not in self._upserts
        ]
        out.extend(self._upserts.values())
        return out

    def __len__(self) -> int:
        n = len(self._db._jobs)
        n -= len(self._deletes & set(self._db._jobs))
        n += len(set(self._upserts) - set(self._db._jobs))
        return n

    # --- writes -------------------------------------------------------------

    def upsert(self, jobs: "Job | Iterable[Job]") -> None:
        self._check_active()
        if isinstance(jobs, Job):
            jobs = [jobs]
        self._touched_cache = None
        for job in jobs:
            self._db._order(job)  # fail fast on unknown priority class
            self._deletes.discard(job.id)
            self._upserts[job.id] = job

    def delete(self, job_ids: "str | Iterable[str]") -> None:
        self._check_active()
        if isinstance(job_ids, str):
            job_ids = [job_ids]
        self._touched_cache = None
        for job_id in job_ids:
            self._upserts.pop(job_id, None)
            self._deletes.add(job_id)

    def commit(self) -> None:
        self._check_active()
        try:
            self._db._apply(self._upserts, self._deletes)
        except BaseException:
            # Pre-validation failed: committed state is untouched; release the
            # writer so the failure can't deadlock the next txn.
            self._finish()
            raise
        self._finish()

    def abort(self) -> None:
        if not self._done:
            had_changes = bool(self._upserts or self._deletes)
            self._finish()
            if had_changes:
                for fn in self._db._abort_subscribers:
                    fn()

    def _finish(self) -> None:
        self._done = True
        self._upserts = {}
        self._deletes = set()
        self._db._writer.release()

    def _check_active(self) -> None:
        if self._done:
            raise ValueError("transaction already committed or aborted")

    def __enter__(self) -> "WriteTxn":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if not self._done:
            if exc_type is None:
                self.commit()
            else:
                self.abort()

    # --- invariants (jobdb.Txn.Assert, jobdb.go:387) ------------------------

    def assert_invariants(self) -> None:
        """Raise AssertionError on cross-field/index inconsistencies."""
        for job in self.all_jobs():
            state = (
                f"job {job.id}: queued={job.queued} "
                f"terminal={job.in_terminal_state()} runs={len(job.runs)}"
            )
            if job.queued and job.in_terminal_state():
                raise AssertionError(f"{state}: queued but terminal")
            if job.queued and job.has_active_run():
                raise AssertionError(f"{state}: queued with active run")
            if job.succeeded and not any(r.succeeded for r in job.runs):
                raise AssertionError(f"{state}: succeeded without succeeded run")
            run_ids = [r.id for r in job.runs]
            if len(run_ids) != len(set(run_ids)):
                raise AssertionError(f"{state}: duplicate run ids")
            for run in job.runs:
                if run.job_id != job.id:
                    raise AssertionError(
                        f"{state}: run {run.id} claims job {run.job_id}"
                    )
