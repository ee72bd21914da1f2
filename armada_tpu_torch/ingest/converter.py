"""EventSequence -> DbOperation conversion for the scheduler database.

Equivalent of the reference's scheduleringester InstructionConverter
(internal/scheduleringester/instructions.go:57-140): each event type maps to
one typed bulk op; the batch is then compacted via merge/reorder
(dbops.merge_ops) before hitting SQLite.
"""

from __future__ import annotations

from typing import Iterable

from armada_tpu_torch.events import schema as pb
from armada_tpu_torch.ingest import dbops as ops


def convert_sequences(
    sequences: Iterable[pb.EventSequence],
) -> list[ops.DbOperation]:
    raw: list[ops.DbOperation] = []
    for seq in sequences:
        for ev in seq.events:
            result = _convert_event(seq, ev)
            if result is None:
                continue
            if isinstance(result, list):
                raw.extend(result)
            else:
                raw.append(result)
    return ops.merge_ops(raw)


def _convert_event(seq: pb.EventSequence, ev: pb.Event):
    """Returns one DbOperation, a list of them, or None (event irrelevant to
    the scheduler DB)."""
    kind = ev.WhichOneof("event")
    if kind == "submit_job":
        e = ev.submit_job
        return ops.InsertJobs(
            jobs={
                e.job_id: {
                    "job_id": e.job_id,
                    "queue": seq.queue,
                    "jobset": seq.jobset,
                    "priority": int(e.spec.priority),
                    "submitted_ns": int(ev.created_ns),
                    # deterministic: map-field entry order is otherwise
                    # process-dependent, and the partition-parallel plane
                    # converts in WORKER processes -- the stored blob must
                    # be byte-identical to the serial pipeline's
                    # (test_ingest_shards pins materialized bit-equality)
                    "spec": e.spec.SerializeToString(deterministic=True),
                }
            }
        )
    if kind == "job_validated":
        e = ev.job_validated
        return ops.MarkJobsValidated(pools_by_job={e.job_id: tuple(e.pools)})
    if kind == "reprioritise_job":
        e = ev.reprioritise_job
        return ops.UpdateJobPriorities(priority_by_job={e.job_id: int(e.priority)})
    if kind == "reprioritised_job":
        e = ev.reprioritised_job
        return ops.UpdateJobPriorities(priority_by_job={e.job_id: int(e.priority)})
    if kind == "cancel_job":
        return ops.MarkJobsCancelRequested(job_ids={ev.cancel_job.job_id})
    if kind == "cancel_job_set":
        e = ev.cancel_job_set
        states = set(e.states)
        return ops.MarkJobSetCancelRequested(
            queue=seq.queue,
            jobset=seq.jobset,
            cancel_queued=not states or "queued" in states,
            cancel_leased=not states or "leased" in states,
        )
    if kind == "cancelled_job":
        return ops.MarkJobsCancelled(job_ids={ev.cancelled_job.job_id})
    if kind == "job_succeeded":
        return ops.MarkJobsSucceeded(job_ids={ev.job_succeeded.job_id})
    if kind == "job_errors":
        e = ev.job_errors
        if any(err.terminal for err in e.errors):
            return ops.MarkJobsFailed(job_ids={e.job_id})
        return None
    if kind == "job_requeued":
        e = ev.job_requeued
        return ops.UpdateJobQueuedState(
            state_by_job={e.job_id: (True, int(e.update_sequence_number))}
        )
    if kind == "preempt_job":
        return ops.MarkJobsPreemptRequested(job_ids={ev.preempt_job.job_id})
    # control-plane events (the "$control-plane" stream; reference
    # scheduleringester ControlPlaneEventsInstructionConverter)
    if kind == "queue_upsert":
        e = ev.queue_upsert
        return ops.UpsertQueues(
            queues_by_name={
                e.name: {
                    "weight": float(e.weight),
                    "cordoned": bool(e.cordoned),
                    "owners": list(e.owners),
                    "groups": list(e.groups),
                    "labels": dict(e.labels),
                }
            }
        )
    if kind == "queue_delete":
        return ops.DeleteQueues(names={ev.queue_delete.name})
    if kind == "executor_settings_upsert":
        e = ev.executor_settings_upsert
        return ops.UpsertExecutorSettings(
            settings_by_name={
                e.name: {
                    "cordoned": bool(e.cordoned),
                    "cordon_reason": e.cordon_reason,
                    "set_by_user": e.set_by_user,
                }
            }
        )
    if kind == "executor_settings_delete":
        return ops.DeleteExecutorSettings(
            names={ev.executor_settings_delete.name}
        )
    if kind == "preempt_on_executor":
        e = ev.preempt_on_executor
        return ops.PreemptOnExecutor(
            executor=e.name,
            queues=tuple(e.queues),
            priority_classes=tuple(e.priority_classes),
        )
    if kind == "cancel_on_executor":
        e = ev.cancel_on_executor
        return ops.CancelOnExecutor(
            executor=e.name,
            queues=tuple(e.queues),
            priority_classes=tuple(e.priority_classes),
        )
    if kind == "preempt_on_queue":
        e = ev.preempt_on_queue
        return ops.PreemptOnQueue(
            queue=e.name, priority_classes=tuple(e.priority_classes)
        )
    if kind == "cancel_on_queue":
        e = ev.cancel_on_queue
        return ops.CancelOnQueue(
            queue=e.name,
            priority_classes=tuple(e.priority_classes),
            job_states=tuple(e.job_states),
        )
    if kind == "reprioritise_job_set":
        return ops.UpdateJobSetPriority(
            queue=seq.queue,
            jobset=seq.jobset,
            priority=int(ev.reprioritise_job_set.priority),
        )
    if kind == "job_run_leased":
        e = ev.job_run_leased
        return [
            ops.InsertRuns(
                runs={
                    e.run_id: {
                        "run_id": e.run_id,
                        "job_id": e.job_id,
                        "created_ns": int(ev.created_ns),
                        "executor": e.executor_id,
                        "node_id": e.node_id,
                        "pool": e.pool,
                        "scheduled_at_priority": int(e.scheduled_at_priority),
                        "pool_scheduled_away": int(e.pool_scheduled_away),
                    }
                }
            ),
            # The lease flips the job to not-queued at the event's sequence
            # number (reference: instructions.go:225-228).
            ops.UpdateJobQueuedState(
                state_by_job={
                    e.job_id: (False, int(e.update_sequence_number))
                }
            ),
        ]
    if kind == "job_run_assigned":
        e = ev.job_run_assigned
        return ops.MarkRunsPending(runs={e.run_id: e.job_id})
    if kind == "job_run_running":
        e = ev.job_run_running
        return ops.MarkRunsRunning(
            runs={e.run_id: e.job_id}, times={e.run_id: int(ev.created_ns)}
        )
    if kind == "job_run_succeeded":
        e = ev.job_run_succeeded
        return ops.MarkRunsSucceeded(runs={e.run_id: e.job_id})
    if kind == "job_run_errors":
        e = ev.job_run_errors
        out = ops.InsertJobRunErrors(
            errors={
                e.run_id: [
                    (err.reason, err.message, err.terminal) for err in e.errors
                ]
            },
            job_by_run={e.run_id: e.job_id},
        )
        if any(err.terminal for err in e.errors):
            # A terminal run error also fails the run (instructions.go
            # handleJobRunErrors).
            return [out, ops.MarkRunsFailed(runs={e.run_id: e.job_id})]
        if any(err.lease_returned for err in e.errors):
            # Lease returned: run over, job may retry (MarkRunsReturned).
            return [out, ops.MarkRunsReturned(runs={e.run_id: e.job_id})]
        return out
    if kind == "job_run_preempted":
        e = ev.job_run_preempted
        return ops.MarkRunsPreempted(runs={e.run_id: e.job_id})
    if kind == "job_run_preemption_requested":
        e = ev.job_run_preemption_requested
        return ops.MarkRunsPreemptRequested(runs={e.run_id: e.job_id})
    if kind == "job_run_cancelled":
        e = ev.job_run_cancelled
        return ops.MarkRunsFailed(runs={e.run_id: e.job_id})
    if kind == "partition_marker":
        e = ev.partition_marker
        return ops.InsertPartitionMarker(
            group_id=e.group_id, partition=int(e.partition),
            created_ns=int(ev.created_ns),
        )
    return None
