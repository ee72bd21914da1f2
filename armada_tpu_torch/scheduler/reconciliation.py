"""Reconciling scheduler-DB rows into the JobDb.

Equivalent of the reference's jobdb reconciliation (internal/scheduler/jobdb/
reconciliation.go, driven from scheduler.go syncState:386): job rows update
job-level fields (authoritative for everything they carry, guarded by
queued_version so stale requeue rows can't regress a newer local lease), run
rows update/insert runs on their job; jobs whose DB row is terminal are deleted
from the JobDb -- the decision events that made them terminal have round-tripped
through the ingestion path, so nothing references them again.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.resources import ResourceListFactory
from armada_tpu_torch.events import schema as pb
from armada_tpu_torch.events.convert import job_spec_from_proto
from armada_tpu_torch.jobdb.job import Job, JobRun
from armada_tpu_torch.jobdb.jobdb import WriteTxn

# Run flags that only ever go false -> true (monotonic lifecycle flags); the
# remaining fields are identity/placement facts where the first non-empty
# value wins.
_RUN_FLAGS = (
    "leased",
    "pending",
    "running",
    "preempt_requested",
    "succeeded",
    "failed",
    "cancelled",
    "preempted",
    "returned",
    "run_attempted",
)


def job_from_row(row, factory: ResourceListFactory) -> Job:
    spec_pb = pb.JobSpec.FromString(row["spec"])
    spec = job_spec_from_proto(
        row["job_id"],
        row["queue"],
        row["jobset"],
        spec_pb,
        factory,
        submit_time=row["submitted_ns"] / 1e9,
    )
    pools = tuple(p for p in row["pools"].split(",") if p)
    return Job(
        spec=spec,
        priority=int(row["priority"]),
        submitted_ns=int(row["submitted_ns"]),
        queued=bool(row["queued"]),
        queued_version=int(row["queued_version"]),
        validated=bool(row["validated"]),
        pools=pools,
        cancel_requested=bool(row["cancel_requested"]),
        cancel_by_jobset_requested=bool(row["cancel_by_jobset_requested"]),
        preempt_requested=bool(row["preempt_requested"]),
        cancelled=bool(row["cancelled"]),
        succeeded=bool(row["succeeded"]),
        failed=bool(row["failed"]),
    )


def run_from_row(row) -> JobRun:
    return JobRun(
        id=row["run_id"],
        job_id=row["job_id"],
        created_ns=int(row["created_ns"]),
        executor=row["executor"],
        node_id=row["node_id"],
        node_name=row["node_name"] or row["node_id"],
        pool=row["pool"],
        scheduled_at_priority=(
            int(row["scheduled_at_priority"])
            if row["scheduled_at_priority"] is not None
            else None
        ),
        pool_scheduled_away=bool(row["pool_scheduled_away"]),
        leased=bool(row["leased"]),
        pending=bool(row["pending"]),
        running=bool(row["running"]),
        preempt_requested=bool(row["preempt_requested"]),
        succeeded=bool(row["succeeded"]),
        failed=bool(row["failed"]),
        cancelled=bool(row["cancelled"]),
        preempted=bool(row["preempted"]),
        returned=bool(row["returned"]),
        run_attempted=bool(row["run_attempted"]),
        running_ns=int(row["running_ns"]) if "running_ns" in row.keys() else 0,
    )


def _merge_job(existing: Optional[Job], row, factory: ResourceListFactory) -> Job:
    """DB job row is authoritative for job-level fields; existing runs are kept.

    queued/queued_version use the version guard: a stale row (e.g. an old
    requeue materialized after the scheduler already leased the job again) must
    not flip the job back to queued (jobdb JobRequeued update_sequence_number).
    """
    fresh = job_from_row(row, factory)
    if existing is None:
        return fresh
    queued, version = fresh.queued, fresh.queued_version
    if existing.queued_version > version:
        queued, version = existing.queued, existing.queued_version
    return Job(
        spec=fresh.spec,
        priority=fresh.priority,
        requested_priority=fresh.priority,
        submitted_ns=fresh.submitted_ns,
        queued=queued,
        queued_version=version,
        validated=fresh.validated or existing.validated,
        pools=fresh.pools or existing.pools,
        cancel_requested=fresh.cancel_requested or existing.cancel_requested,
        cancel_by_jobset_requested=(
            fresh.cancel_by_jobset_requested or existing.cancel_by_jobset_requested
        ),
        preempt_requested=fresh.preempt_requested or existing.preempt_requested,
        cancelled=fresh.cancelled or existing.cancelled,
        succeeded=fresh.succeeded or existing.succeeded,
        failed=fresh.failed or existing.failed,
        runs=existing.runs,
    )


def _merge_run(existing: Optional[JobRun], fresh: JobRun) -> JobRun:
    """Lifecycle flags are monotonic; OR them so replayed rows can't regress."""
    if existing is None:
        return fresh
    kw = {}
    for f in dataclasses.fields(JobRun):
        a, b = getattr(existing, f.name), getattr(fresh, f.name)
        if f.name in _RUN_FLAGS:
            kw[f.name] = a or b
        else:
            kw[f.name] = b if b not in (None, "", 0, False) else a
    return JobRun(**kw)


def apply_rows(
    txn: WriteTxn,
    job_rows: Iterable,
    run_rows: Iterable,
    config: SchedulingConfig,
    retained_terminal: Optional[set] = None,
) -> list[str]:
    """Apply fetched rows to the txn; returns ids of jobs that changed.

    retained_terminal (a set, mutated): when given, DB-terminal jobs are kept
    in the JobDb (queued=False) and their ids recorded, instead of being
    deleted -- the short-job penalty needs to see recently finished jobs
    (scheduler.go:436-447); the Scheduler's sweep deletes exactly the recorded
    ids once the penalty window lapses.  Only DB-terminal jobs are eligible:
    locally-terminal jobs whose events have not round-tripped must never be
    deleted early (or a later row for them would resurrect a zombie)."""
    factory = config.resource_list_factory()
    touched: list[str] = []

    for row in job_rows:
        job_id = row["job_id"]
        if row["cancelled"] or row["succeeded"] or row["failed"]:
            # Terminal in the DB: state round-tripped; drop from the JobDb
            # (the reference deletes persisted-terminal jobs, scheduler.go:414-441)
            # unless the short-job penalty wants it kept around.
            existing = txn.get(job_id)
            if retained_terminal is not None:
                merged = _merge_job(existing, row, factory)
                # Never let a version-guarded stale queued flag resurrect a
                # terminal job into the queued index.
                txn.upsert(dataclasses.replace(merged, queued=False))
                retained_terminal.add(job_id)
            elif existing is not None:
                txn.delete(job_id)
            touched.append(job_id)
            continue
        existing = txn.get(job_id)
        txn.upsert(_merge_job(existing, row, factory))
        touched.append(job_id)

    for row in run_rows:
        job = txn.get(row["job_id"])
        if job is None:
            continue  # job terminal/unknown; late run row is irrelevant
        fresh = run_from_row(row)
        existing = job.run_by_id(fresh.id)
        merged = _merge_run(existing, fresh)
        if existing is None:
            # Insert without with_new_run: reconciliation must not bump
            # queued_version (that bump belongs to the scheduler's own lease
            # path); derived queued state is fixed up below.
            job = dataclasses.replace(job, runs=job.runs + (merged,))
        else:
            job = job.with_updated_run(merged)
        txn.upsert(job)
        touched.append(job.id)

    return sorted(set(touched))
