"""The ONE scheduling-order key, shared by every component that sorts jobs.

Queue-internal scheduling order (reference jobdb/comparison.go
JobPriorityComparer): higher priority-class priority first, then lower job
priority value, then earlier submission, then id as the final tiebreak.  Both
the JobDb queued index and the scheduling-problem builder call this, so they
can never drift.

Callers must pass the job's CURRENT priority (reprioritisation updates
jobdb.Job.priority; a stale spec.priority would order differently).
"""

from __future__ import annotations


def scheduling_order_key(
    pc_priority: int, priority: int, submitted: "int | float", job_id: str
) -> tuple:
    return (-pc_priority, priority, submitted, job_id)
