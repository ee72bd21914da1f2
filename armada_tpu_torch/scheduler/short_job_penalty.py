"""Short-job penalty: recently-exited short jobs keep charging their queue.

Equivalent of the reference's ShortJobPenalty (internal/scheduler/scheduling/
short_job_penalty.go:1-53): a job that exits sooner than the pool's cutoff
after it started RUNNING is treated, for DRF cost purposes, as if it were
still holding its resources until the cutoff passes.  This stops queues from
churning streams of instant-exit jobs to stay under their fair share.

Two integration points mirror the reference:
- JobDb retention: terminal jobs are kept in the JobDb while the penalty
  applies (scheduler.go:436-447 skips deleting them), so the scheduling algo
  can still see them.  Unlike the reference (which only re-examines changed
  jobs and so never deletes a retained job that stops changing), the
  scheduler sweeps retained jobs each cycle and deletes them once the window
  lapses.
- Cost: each queue's candidate-ordering DRF cost includes the penalty
  (queue_scheduler.go:514-515 GetAllocationInclShortJobPenalty); fair shares,
  caps and the eviction protected-share check do NOT (pqs.go:146-157 uses
  GetAllocation).
"""

from __future__ import annotations

from typing import Mapping

from armada_tpu_torch.jobdb.job import Job


class ShortJobPenalty:
    """Pool-keyed penalty window (short_job_penalty.go ShouldApplyPenalty)."""

    def __init__(self, cutoffs_by_pool_s: Mapping[str, float]):
        self._cutoff_ns = {
            pool: int(sec * 1e9)
            for pool, sec in cutoffs_by_pool_s.items()
            if sec > 0
        }

    @property
    def enabled(self) -> bool:
        return bool(self._cutoff_ns)

    def applies(self, job: Job, now_ns: int) -> bool:
        """True while `job` should keep charging its queue (terminal, started
        recently, not preempted -- short_job_penalty.go:29-52)."""
        if not self._cutoff_ns or not job.in_terminal_state():
            return False
        run = job.latest_run
        if run is None or run.preempted or run.preempt_requested:
            return False
        if run.running_ns <= 0:
            return False
        cutoff = self._cutoff_ns.get(run.pool or "default", 0)
        return now_ns - run.running_ns < cutoff
