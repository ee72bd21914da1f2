"""Typed database operations with merge + reorder legality.

Equivalent of the reference's scheduleringester DbOperation set
(internal/scheduleringester/dbops.go:125-200): each event batch is converted
to a minimal sequence of bulk operations.  Appending an op to a batch first
tries to MERGE it into an existing op of the same type (dbops.go Merge:224+),
else moves it as early as possible past ops it is independent of
(CanBeAppliedBefore:425+), so one ingestion round issues few, large SQL
statements regardless of how interleaved the events were.

Independence rule: two ops commute iff they touch disjoint job-id sets (a
jobset-wide op touches a synthetic "queue/jobset" token covering all its
jobs, so nothing jumps over it for that jobset).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DbOperation:
    """Base: subclasses define the touched job tokens and merge rules."""

    def tokens(self) -> set[str]:
        """Job ids (or 'queue/jobset' wildcard tokens) this op affects."""
        raise NotImplementedError

    def merge(self, other: "DbOperation") -> bool:
        """Absorb `other` into self if same-shaped; True on success."""
        return False

    def can_be_applied_before(self, other: "DbOperation") -> bool:
        """True if self commutes with `other` (disjoint touched sets).

        Wildcard jobset tokens conflict with every job of that jobset; since
        we can't know membership here, any shared wildcard OR any shared
        jobset prefix blocks reordering.
        """
        mine, theirs = self.tokens(), other.tokens()
        if mine & theirs:
            return False
        my_wild = {t for t in mine if t.startswith("*")}
        their_wild = {t for t in theirs if t.startswith("*")}
        if my_wild or their_wild:
            # Conservative: a wildcard op never commutes within its jobset;
            # lacking membership info, block reordering entirely.
            return False
        return True


@dataclasses.dataclass
class InsertJobs(DbOperation):
    # job_id -> row dict (see schedulerdb.JOBS_COLUMNS)
    jobs: dict[str, dict]

    def tokens(self) -> set[str]:
        return set(self.jobs)

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, InsertJobs):
            self.jobs.update(other.jobs)
            return True
        return False


@dataclasses.dataclass
class InsertRuns(DbOperation):
    # run_id -> row dict (job_id, executor, node_id, ...)
    runs: dict[str, dict]

    def tokens(self) -> set[str]:
        return {r["job_id"] for r in self.runs.values()}

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, InsertRuns):
            self.runs.update(other.runs)
            return True
        return False


@dataclasses.dataclass
class _JobIdSetOp(DbOperation):
    """An op that marks a set of job ids."""

    job_ids: set[str]

    def tokens(self) -> set[str]:
        return set(self.job_ids)

    def merge(self, other: DbOperation) -> bool:
        if type(other) is type(self):
            self.job_ids |= other.job_ids
            return True
        return False


class MarkJobsCancelRequested(_JobIdSetOp):
    pass


class MarkJobsCancelled(_JobIdSetOp):
    pass


class MarkJobsSucceeded(_JobIdSetOp):
    pass


class MarkJobsFailed(_JobIdSetOp):
    pass


@dataclasses.dataclass
class MarkJobsValidated(DbOperation):
    # job_id -> pools
    pools_by_job: dict[str, tuple[str, ...]]

    def tokens(self) -> set[str]:
        return set(self.pools_by_job)

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, MarkJobsValidated):
            self.pools_by_job.update(other.pools_by_job)
            return True
        return False


@dataclasses.dataclass
class UpdateJobPriorities(DbOperation):
    # job_id -> new priority
    priority_by_job: dict[str, int]

    def tokens(self) -> set[str]:
        return set(self.priority_by_job)

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, UpdateJobPriorities):
            self.priority_by_job.update(other.priority_by_job)
            return True
        return False


@dataclasses.dataclass
class UpdateJobQueuedState(DbOperation):
    # job_id -> (queued, queued_version); applied only if version is newer
    # (out-of-order requeue/lease protection, dbops.go UpdateJobQueuedState).
    state_by_job: dict[str, tuple[bool, int]]

    def tokens(self) -> set[str]:
        return set(self.state_by_job)

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, UpdateJobQueuedState):
            for job_id, (queued, version) in other.state_by_job.items():
                cur = self.state_by_job.get(job_id)
                if cur is None or version >= cur[1]:
                    self.state_by_job[job_id] = (queued, version)
            return True
        return False


@dataclasses.dataclass
class _RunIdSetOp(DbOperation):
    """An op that marks a set of run ids; tokens are their job ids."""

    # run_id -> job_id
    runs: dict[str, str]

    def tokens(self) -> set[str]:
        return set(self.runs.values())

    def merge(self, other: DbOperation) -> bool:
        if type(other) is type(self):
            self.runs.update(other.runs)
            return True
        return False


class MarkRunsPending(_RunIdSetOp):
    pass


@dataclasses.dataclass
class MarkRunsRunning(_RunIdSetOp):
    # run_id -> event time ns: records running_ns for the short-job penalty
    # window (short_job_penalty.go RunningTime).
    times: dict = dataclasses.field(default_factory=dict)

    def merge(self, other: DbOperation) -> bool:
        if type(other) is type(self):
            self.runs.update(other.runs)
            self.times.update(other.times)
            return True
        return False


class MarkRunsSucceeded(_RunIdSetOp):
    pass


class MarkRunsFailed(_RunIdSetOp):
    pass


class MarkRunsPreempted(_RunIdSetOp):
    pass


class MarkRunsReturned(_RunIdSetOp):
    pass


class MarkRunsPreemptRequested(_RunIdSetOp):
    pass


@dataclasses.dataclass
class MarkJobSetCancelRequested(DbOperation):
    """Jobset-wide op: touches every (unknown) job of the jobset."""

    queue: str
    jobset: str
    # Restrict to queued and/or leased jobs (CancelJobSet.states).
    cancel_queued: bool = True
    cancel_leased: bool = True

    def tokens(self) -> set[str]:
        return {f"*{self.queue}/{self.jobset}"}

    def merge(self, other: DbOperation) -> bool:
        if (
            isinstance(other, MarkJobSetCancelRequested)
            and (other.queue, other.jobset) == (self.queue, self.jobset)
        ):
            self.cancel_queued |= other.cancel_queued
            self.cancel_leased |= other.cancel_leased
            return True
        return False


@dataclasses.dataclass
class MarkJobsPreemptRequested(_JobIdSetOp):
    """Request preemption of the jobs' active runs (the server's PreemptJobs
    path, internal/server/submit/submit.go PreemptJobs:202)."""


@dataclasses.dataclass
class UpdateJobSetPriority(DbOperation):
    """Jobset-wide reprioritisation (ReprioritizeJobs on a whole jobset,
    submit.go ReprioritizeJobs:251)."""

    queue: str
    jobset: str
    priority: int

    def tokens(self) -> set[str]:
        return {f"*{self.queue}/{self.jobset}"}

    def merge(self, other: DbOperation) -> bool:
        if (
            isinstance(other, UpdateJobSetPriority)
            and (other.queue, other.jobset) == (self.queue, self.jobset)
        ):
            self.priority = other.priority  # last write wins
            return True
        return False


@dataclasses.dataclass
class InsertJobRunErrors(DbOperation):
    # run_id -> list of (reason, message, terminal)
    errors: dict[str, list[tuple[str, str, bool]]]
    job_by_run: dict[str, str] = dataclasses.field(default_factory=dict)

    def tokens(self) -> set[str]:
        return set(self.job_by_run.values())

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, InsertJobRunErrors):
            for run_id, errs in other.errors.items():
                self.errors.setdefault(run_id, []).extend(errs)
            self.job_by_run.update(other.job_by_run)
            return True
        return False


@dataclasses.dataclass
class InsertPartitionMarker(DbOperation):
    group_id: str
    partition: int
    created_ns: int = 0

    def tokens(self) -> set[str]:
        return {f"*marker/{self.group_id}/{self.partition}"}


# ---- control-plane ops (scheduleringester dbops.go:67-80,366-370,540-553) ---
# Operator actions from the "$control-plane" stream.  All carry a wildcard
# token: they may touch jobs whose membership is only known at apply time, so
# they never commute past other ops (CanBeAppliedBefore conservatism).


@dataclasses.dataclass
class UpsertQueues(DbOperation):
    # name -> {"weight", "cordoned", "owners", "groups", "labels"}
    queues_by_name: dict[str, dict]

    def tokens(self) -> set[str]:
        return {f"*queue-config/{n}" for n in self.queues_by_name}

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, UpsertQueues):
            self.queues_by_name.update(other.queues_by_name)
            return True
        return False


@dataclasses.dataclass
class DeleteQueues(DbOperation):
    names: set[str]

    def tokens(self) -> set[str]:
        return {f"*queue-config/{n}" for n in self.names}

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, DeleteQueues):
            self.names |= other.names
            return True
        return False


@dataclasses.dataclass
class UpsertExecutorSettings(DbOperation):
    # name -> {"cordoned": bool, "cordon_reason": str, "set_by_user": str}
    settings_by_name: dict[str, dict]

    def tokens(self) -> set[str]:
        return {f"*executor-settings/{n}" for n in self.settings_by_name}

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, UpsertExecutorSettings):
            self.settings_by_name.update(other.settings_by_name)
            return True
        return False


@dataclasses.dataclass
class DeleteExecutorSettings(DbOperation):
    names: set[str]

    def tokens(self) -> set[str]:
        return {f"*executor-settings/{n}" for n in self.names}

    def merge(self, other: DbOperation) -> bool:
        if isinstance(other, DeleteExecutorSettings):
            self.names |= other.names
            return True
        return False


@dataclasses.dataclass
class _ExecutorScopedJobOp(DbOperation):
    """Preempt/cancel every matching job on an executor (membership resolved
    at apply time against the runs table, schedulerdb.go:411-431)."""

    executor: str
    queues: tuple[str, ...] = ()  # empty = all
    priority_classes: tuple[str, ...] = ()  # empty = all

    def tokens(self) -> set[str]:
        return {f"*executor-jobs/{self.executor}"}


class PreemptOnExecutor(_ExecutorScopedJobOp):
    pass


class CancelOnExecutor(_ExecutorScopedJobOp):
    pass


@dataclasses.dataclass
class _QueueScopedJobOp(DbOperation):
    """Preempt/cancel every matching job of a queue."""

    queue: str
    priority_classes: tuple[str, ...] = ()
    # "queued" / "leased"; empty = both (CancelOnQueue.jobStates)
    job_states: tuple[str, ...] = ()

    def tokens(self) -> set[str]:
        return {f"*queue-jobs/{self.queue}"}


class PreemptOnQueue(_QueueScopedJobOp):
    pass


class CancelOnQueue(_QueueScopedJobOp):
    pass


def append_db_operation(ops: list[DbOperation], op: DbOperation) -> None:
    """Append with merge-past-commuting-ops (dbops.go AppendDbOperation):
    scan from the tail, merging into the first same-shaped op reachable
    without crossing a non-commuting op; if none, append at the end (an op
    never moves unless it merges -- order stays stable).

    One-shot compatibility surface; batch conversion goes through
    :func:`merge_ops`, which carries the token cache across appends (an
    op's token set is re-derived here on every conflict check, which is
    O(batch) per append against a merged mega-op)."""
    for i in range(len(ops) - 1, -1, -1):
        if ops[i].merge(op):
            return
        if not op.can_be_applied_before(ops[i]):
            break
    ops.append(op)


def _disjoint(a: set, b: set) -> bool:
    # isdisjoint iterates its ARGUMENT: always hand it the smaller side, so
    # a one-job op checked against a 100k-job merged op costs O(1), not
    # O(batch).
    return a.isdisjoint(b) if len(a) <= len(b) else b.isdisjoint(a)


def merge_ops(sequences_ops: list[DbOperation]) -> list[DbOperation]:
    """Fold a converted batch into few, large ops (same semantics as
    repeated :func:`append_db_operation`, measured-linear instead of
    quadratic): the merged token set of every op in `out` is maintained
    INCREMENTALLY -- every merge() implementation is additive (set/dict
    union), so merged tokens = union of absorbed tokens -- instead of
    re-derived via tokens() on each conflict check, which made a 10k-
    sequence batch cost 250M string ops (78s) before round 18."""
    out: list[DbOperation] = []
    toks: list[set[str]] = []  # cached merged token set per out[i]
    wild: list[bool] = []  # cached "has wildcard token" per out[i]
    for op in sequences_ops:
        new_tokens = op.tokens()
        new_wild = any(t.startswith("*") for t in new_tokens)
        placed = False
        for i in range(len(out) - 1, -1, -1):
            if out[i].merge(op):
                toks[i] |= new_tokens
                wild[i] = wild[i] or new_wild
                placed = True
                break
            # can_be_applied_before, against the cache: any shared token or
            # any wildcard on either side blocks reordering.
            if new_wild or wild[i] or not _disjoint(new_tokens, toks[i]):
                break
        if not placed:
            out.append(op)
            toks.append(set(new_tokens))
            wild.append(new_wild)
    return out
