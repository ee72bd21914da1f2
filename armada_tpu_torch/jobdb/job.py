"""Job and JobRun value types: immutable, copy-on-update.

Equivalent of the reference's jobdb.Job / jobdb.JobRun (jobdb/job.go,
jobdb/job_run.go): frozen dataclasses whose `with_*` methods return updated
copies, so a JobDb transaction can never corrupt concurrent readers
(the reference's immutability discipline, jobdb/jobdb.go:67).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec


@dataclasses.dataclass(frozen=True)
class JobRun:
    """One attempt to execute a job on a node (jobdb/job_run.go).

    Phase flags are monotonic: leased -> pending -> running -> terminal
    (succeeded / failed / cancelled / preempted / returned).
    """

    id: str
    job_id: str
    created_ns: int = 0
    executor: str = ""
    node_id: str = ""
    node_name: str = ""
    pool: str = ""
    scheduled_at_priority: Optional[int] = None
    pool_scheduled_away: bool = False
    leased: bool = True
    pending: bool = False
    running: bool = False
    preempt_requested: bool = False
    succeeded: bool = False
    failed: bool = False
    cancelled: bool = False
    preempted: bool = False
    # Run returned to the queue (e.g. lease expiry / retryable failure).
    returned: bool = False
    # Executor reported it actually started the pod (counts toward attempts).
    run_attempted: bool = False
    # When the run started RUNNING (job_run.go RunningTime); 0 = never ran.
    # Feeds the short-job penalty window (short_job_penalty.go:46-52).
    running_ns: int = 0

    def in_terminal_state(self) -> bool:
        return (
            self.succeeded
            or self.failed
            or self.cancelled
            or self.preempted
            or self.returned
        )

    def _with(self, **kw) -> "JobRun":
        return dataclasses.replace(self, **kw)

    def with_pending(self) -> "JobRun":
        return self._with(pending=True)

    def with_running(self, node_name: str = "", running_ns: int = 0) -> "JobRun":
        return self._with(
            running=True,
            node_name=node_name or self.node_name,
            running_ns=running_ns or self.running_ns,
        )

    def with_succeeded(self) -> "JobRun":
        return self._with(succeeded=True, running=False)

    def with_failed(self) -> "JobRun":
        return self._with(failed=True, running=False)

    def with_cancelled(self) -> "JobRun":
        return self._with(cancelled=True, running=False)

    def with_preempted(self) -> "JobRun":
        return self._with(preempted=True, running=False)

    def with_returned(self, run_attempted: bool) -> "JobRun":
        return self._with(returned=True, run_attempted=run_attempted, running=False)

    def with_preempt_requested(self) -> "JobRun":
        return self._with(preempt_requested=True)


@dataclasses.dataclass(frozen=True)
class Job:
    """A job and its full lifecycle state (jobdb/job.go).

    `spec` is the immutable scheduling shape; everything else is state the
    scheduler evolves via events.  `priority` is the *current* queue priority
    (reprioritisation updates it); `requested_priority` tracks a pending
    reprioritisation not yet acknowledged by the scheduler round.
    """

    spec: JobSpec
    # priority / submitted default from the spec (None sentinel) so the jobdb
    # ordering and the scheduling-problem builder can never disagree about a
    # freshly-ingested job.
    priority: Optional[int] = None
    requested_priority: Optional[int] = None
    submitted_ns: Optional[int] = None
    queued: bool = True
    # Bumped every time the job moves queued <-> leased; lets out-of-order
    # ingestion detect stale requeue messages (jobdb JobRequeued
    # update_sequence_number).
    queued_version: int = 0
    validated: bool = False
    pools: tuple[str, ...] = ()
    cancel_requested: bool = False
    cancel_by_jobset_requested: bool = False
    # Operator requested preemption (persists even before a run exists).
    preempt_requested: bool = False
    cancelled: bool = False
    succeeded: bool = False
    failed: bool = False
    runs: tuple[JobRun, ...] = ()

    def __post_init__(self):
        if self.priority is None:
            object.__setattr__(self, "priority", self.spec.priority)
        if self.requested_priority is None:
            object.__setattr__(self, "requested_priority", self.priority)
        if self.submitted_ns is None:
            object.__setattr__(self, "submitted_ns", int(self.spec.submit_time * 1e9))

    # --- identity / convenience --------------------------------------------

    @property
    def id(self) -> str:
        return self.spec.id

    @property
    def queue(self) -> str:
        return self.spec.queue

    @property
    def jobset(self) -> str:
        return self.spec.jobset

    def priority_class(self, config: SchedulingConfig) -> PriorityClass:
        return config.priority_class(self.spec.priority_class)

    @property
    def latest_run(self) -> Optional[JobRun]:
        return self.runs[-1] if self.runs else None

    def run_by_id(self, run_id: str) -> Optional[JobRun]:
        for run in self.runs:
            if run.id == run_id:
                return run
        return None

    def num_attempts(self) -> int:
        return sum(1 for r in self.runs if r.run_attempted)

    def anti_affinity_nodes(self) -> tuple[str, ...]:
        """Node ids a retry must avoid: every node where an ATTEMPTED run died
        (failed or returned) -- the retry anti-affinity set the reference
        injects as node exclusions (scheduler.go:522-568)."""
        return tuple(
            {
                r.node_id
                for r in self.runs
                if r.run_attempted and (r.failed or r.returned) and r.node_id
            }
        )

    # --- state predicates ---------------------------------------------------

    def in_terminal_state(self) -> bool:
        return self.cancelled or self.succeeded or self.failed

    def has_active_run(self) -> bool:
        run = self.latest_run
        return run is not None and not run.in_terminal_state()

    # --- updates (always return a copy) ------------------------------------

    def _with(self, **kw) -> "Job":
        return dataclasses.replace(self, **kw)

    def with_priority(self, priority: int) -> "Job":
        return self._with(priority=priority, requested_priority=priority)

    def with_requested_priority(self, priority: int) -> "Job":
        return self._with(requested_priority=priority)

    def with_validated(self, pools: tuple[str, ...]) -> "Job":
        return self._with(validated=True, pools=pools)

    def with_queued(self, queued: bool) -> "Job":
        return self._with(
            queued=queued, queued_version=self.queued_version + 1
        )

    def with_cancel_requested(self) -> "Job":
        return self._with(cancel_requested=True)

    def with_cancel_by_jobset_requested(self) -> "Job":
        return self._with(cancel_by_jobset_requested=True)

    def with_preempt_requested(self) -> "Job":
        return self._with(preempt_requested=True)

    def with_cancelled(self) -> "Job":
        return self._with(cancelled=True, queued=False)

    def with_succeeded(self) -> "Job":
        return self._with(succeeded=True, queued=False)

    def with_failed(self) -> "Job":
        return self._with(failed=True, queued=False)

    def with_new_run(self, run: JobRun) -> "Job":
        if run.job_id != self.id:
            raise ValueError(f"run {run.id} belongs to {run.job_id}, not {self.id}")
        return self._with(
            runs=self.runs + (run,), queued=False,
            queued_version=self.queued_version + 1,
        )

    def with_updated_run(self, run: JobRun) -> "Job":
        runs = tuple(run if r.id == run.id else r for r in self.runs)
        if all(r.id != run.id for r in runs):
            raise ValueError(f"job {self.id} has no run {run.id}")
        return self._with(runs=runs)
