"""The scheduler main loop: sync -> transition -> schedule -> publish -> commit.

Equivalent of the reference's Scheduler (internal/scheduler/scheduler.go:33-41
docstring, Run:142, cycle:246).  Each cycle:

  1. syncState: incremental fetch from the scheduler DB (rows whose serial
     advanced) reconciled into the JobDb txn (scheduler.go syncState:386).
  2. Leader check: followers commit the synced state and stop (scheduler.go:263).
  3. generateUpdateMessages: derive state-transition events from what the DB
     told us -- cancellations, run success/failure, retries/requeues,
     validation (scheduler.go:698, submitCheck:1011).
  4. expireJobsIfNecessary: executors past their heartbeat timeout lose their
     active runs; the jobs are returned and requeued (scheduler.go:929).
  5. schedulingAlgo.Schedule: the round over every pool on the algo's
     device (the replaceable interface, scheduling_algo.go:36-41).
  6. eventsFromSchedulerResult: leases + preemptions as events
     (scheduler.go:570).
  7. Re-validate leadership (token fencing), publish every event sequence to
     the log, commit the JobDb txn (scheduler.go:355,375).

If publish fails (or leadership was lost) the txn aborts: no decision leaks
into local state that is not also in the log -- the log stays the source of
truth, and the next cycle re-derives everything from the DB.

The port's copy runs the JAX package's cycle over the port's algo: a
`FairSchedulingAlgo` built for the card schedules on the card, one built
with device="cpu" runs the kernels' plain versions. The optional observers
are not ported yet: `metrics=`, `reports=` and `checkpointer=` (the JAX
package's scheduler/metrics.py, reports.py and checkpoint.py) raise
NotImplementedError when given, and come in the next slice of the port
with what only they use (the checkpoint trigger and the durability block
of /healthz).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Sequence

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.logging import get_logger
from armada_tpu_torch.core.pipeline import pipeline_enabled, prefetch_worthwhile
from armada_tpu_torch.events import schema as pb
from armada_tpu_torch.eventlog.publisher import Publisher, wait_for_markers
from armada_tpu_torch.ingest.schedulerdb import SchedulerDb
from armada_tpu_torch.jobdb.job import Job, JobRun
from armada_tpu_torch.jobdb.jobdb import JobDb, WriteTxn
from armada_tpu_torch.scheduler.algo import FairSchedulingAlgo, SchedulerResult
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
from armada_tpu_torch.scheduler.leader import LeaderController, LeaderToken
from armada_tpu_torch.scheduler.quarantine import NodeQuarantine
from armada_tpu_torch.scheduler.reconciliation import apply_rows
from armada_tpu_torch.scheduler.short_job_penalty import ShortJobPenalty
from armada_tpu_torch.scheduler.submitcheck import SubmitChecker

MAX_RETRIES_EXCEEDED = "maxRetriesExceeded"
PREEMPTED_REASON = "preempted"
LEASE_EXPIRED = "leaseExpired"

_log = get_logger(__name__)


@dataclasses.dataclass
class CycleResult:
    """What one cycle did (inputs to metrics + tests)."""

    leader: bool = False
    scheduled: bool = False
    synced_jobs: list = dataclasses.field(default_factory=list)
    published: list = dataclasses.field(default_factory=list)  # EventSequences
    scheduler_result: Optional[SchedulerResult] = None

    def events_by_kind(self) -> dict:
        out: dict = {}
        for seq in self.published:
            for ev in seq.events:
                kind = ev.WhichOneof("event")
                out[kind] = out.get(kind, 0) + 1
        return out


class _SequenceBuilder:
    """Accumulates events grouped per (queue, jobset) EventSequence."""

    def __init__(self):
        self._seqs: dict[tuple[str, str], pb.EventSequence] = {}

    def add(self, queue: str, jobset: str, event: pb.Event) -> None:
        key = (queue, jobset)
        seq = self._seqs.get(key)
        if seq is None:
            seq = pb.EventSequence(queue=queue, jobset=jobset)
            self._seqs[key] = seq
        seq.events.append(event)

    def build(self) -> list[pb.EventSequence]:
        return [s for s in self._seqs.values() if len(s.events)]


class Scheduler:
    """The scheduling service main loop (scheduler.go:142)."""

    def __init__(
        self,
        db: SchedulerDb,
        jobdb: JobDb,
        algo: FairSchedulingAlgo,
        publisher: Publisher,
        leader: LeaderController,
        config: Optional[SchedulingConfig] = None,
        clock: Callable[[], float] = time.time,
        metrics=None,
        reports=None,
        ingest_step: Optional[Callable[[], int]] = None,
        checkpointer=None,
    ):
        """ingest_step: drives an in-process ingestion pipeline during marker
        fencing (deployments with background ingester threads leave it None).
        metrics, reports, checkpointer: not ported yet; each must be None."""
        for hook, value, module in (("metrics", metrics, "metrics.py"),
                                    ("reports", reports, "reports.py"),
                                    ("checkpointer", checkpointer, "checkpoint.py")):
            if value is not None:
                raise NotImplementedError(
                    f"Scheduler({hook}=): the JAX package's scheduler/{module} comes in "
                    "the next slice of the port")
        self.db = db
        self.jobdb = jobdb
        self.algo = algo
        self.publisher = publisher
        self.leader = leader
        self.config = config or jobdb.config
        self._clock = clock
        self.submit_checker = SubmitChecker(self.config)
        self.short_job_penalty = ShortJobPenalty(
            self.config.short_job_penalty_cutoffs()
        )
        self.node_quarantine = NodeQuarantine(
            failure_threshold=self.config.node_quarantine_failure_threshold,
            window_s=self.config.node_quarantine_window_s,
            cooldown_s=self.config.node_quarantine_cooldown_s,
        )
        self.ingest_step = ingest_step
        # Incremental-fetch cursors (scheduler.go jobsSerial/runsSerial:79-81).
        self._jobs_serial = 0
        self._runs_serial = 0
        self._was_leader = False
        # Terminal jobs kept in the JobDb for the short-job penalty window
        # (scheduler.go:436-447); swept in sync_state once the window lapses.
        self._retained_terminal: set = set()

    def now_ns(self) -> int:
        return int(self._clock() * 1e9)

    # --- state sync (scheduler.go syncState:386) ----------------------------

    def sync_state(self, txn: WriteTxn) -> list[str]:
        job_rows, run_rows = self.db.fetch_job_updates(
            self._jobs_serial, self._runs_serial
        )
        touched = apply_rows(
            txn,
            job_rows,
            run_rows,
            self.config,
            retained_terminal=(
                self._retained_terminal if self.short_job_penalty.enabled else None
            ),
        )
        if job_rows:
            self._jobs_serial = max(r["serial"] for r in job_rows)
        if run_rows:
            self._runs_serial = max(r["serial"] for r in run_rows)
        if self._retained_terminal:
            # Sweep ONLY the jobs retained from DB-terminal rows, once their
            # penalty window lapses (scheduler.go:436-447 retains; the
            # lapse-side delete is ours -- the reference only re-examines
            # changed jobs and so leaks these).  O(retained), and never
            # touches locally-terminal jobs still awaiting their round-trip.
            now_ns = self.now_ns()
            for job_id in list(self._retained_terminal):
                job = txn.get(job_id)
                if job is None or not self.short_job_penalty.applies(job, now_ns):
                    if job is not None:
                        txn.delete(job_id)
                    self._retained_terminal.discard(job_id)
        return touched

    # --- recovery fencing (scheduler.go ensureDbUpToDate:1120) --------------

    def ensure_db_up_to_date(
        self,
        ingest_step: Optional[Callable[[], int]] = None,
        timeout_s: float = 30.0,
        poll_interval_s: float = 0.05,
    ) -> None:
        """Publish a marker to every partition and wait until the ingestion
        path has materialized all of them: after this, the DB reflects every
        event published before our leadership began.  `ingest_step` (if given)
        drives an in-process ingestion pipeline between polls."""
        group = self.publisher.publish_markers()
        deadline = time.monotonic() + timeout_s
        num_parts = self.publisher._log.num_partitions
        while True:
            if ingest_step is not None:
                ingest_step()
            if self.db.has_marker(group, num_parts):
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"marker group {group} not materialized within {timeout_s}s"
                )
            time.sleep(poll_interval_s)

    # --- executors ----------------------------------------------------------

    def _executors(self) -> list[ExecutorSnapshot]:
        factory = self.config.resource_list_factory()
        # Operator cordon state overlays the snapshots (the reference reads
        # executor_settings separately and filters cordoned executors,
        # scheduling_algo.go:250,779-791); it is event-sourced via the
        # "$control-plane" stream, so every replica converges by replay.
        settings = self.db.executor_settings()
        out = []
        for row in self.db.executors():
            snap = ExecutorSnapshot.from_json(row["snapshot"], factory)
            s = settings.get(snap.id)
            if s is not None and s["cordoned"] and not snap.cordoned:
                snap = dataclasses.replace(snap, cordoned=True)
            out.append(snap)
        return out

    # --- the cycle (scheduler.go cycle:246) ---------------------------------

    def cycle(self, schedule: bool = True) -> CycleResult:
        from armada_tpu_torch.core.logging import log_context

        start = time.monotonic()
        self._cycle_seq = getattr(self, "_cycle_seq", 0) + 1
        # Context fields ride every log line this cycle emits, in any
        # component (armadacontext parity, armada_context.go).
        from armada_tpu_torch.core.watchdog import supervisor as _supervisor

        sup0 = _supervisor()
        fallbacks0 = sup0.snapshot()["fallbacks"]
        degraded0 = sup0.degraded
        from armada_tpu_torch.ops.trace import recorder as _trace_recorder

        with log_context(cycle=self._cycle_seq, scheduling=schedule):
            # Cycle trace root (ops/trace.py): every span the cycle's
            # components open -- feed apply, assemble, slab scatters, the
            # round's kernel/fetch/failover, publish -- lands under this
            # tree; the ring keeps the last N for armadactl trace/healthz.
            with _trace_recorder().cycle(
                "scheduler_cycle",
                kind="cycle",
                seq=self._cycle_seq,
                scheduling=schedule,
            ):
                result = self._cycle(schedule)
        duration = time.monotonic() - start
        # A cycle counts as degraded if it RAN degraded at any point:
        # degraded BEFORE (a promotion can land mid-cycle while the round
        # still runs on the CPU failover), a fallback DURING (the fallback
        # delta -- a drill-speed re-probe can promote back before the
        # failed-over round even returns), or degraded AFTER.  Post-cycle
        # state alone misfiles exactly the cycles the failover window
        # exists to measure.
        sup = _supervisor()
        degraded = (
            degraded0
            or sup.degraded
            or sup.snapshot()["fallbacks"] > fallbacks0
        )
        self._observe_slo(result, duration, degraded)
        return result

    @staticmethod
    def _slo():
        from armada_tpu_torch.scheduler.slo import recorder

        return recorder()

    def _observe_slo(
        self, result: CycleResult, duration_s: float, degraded: bool = False
    ) -> None:
        """Feed the streaming SLO layer (scheduler/slo.py): cycle latency
        (scheduling cycles only; reconcile ticks are a different
        distribution), ingest->visible lag for tracked submits that became
        visible this cycle, TTFL for first leases, and forget jobs that
        terminated without ever leasing (cancel-before-lease, validation
        failure) so the tracking maps stay bounded."""
        rec = self._slo()
        if result.scheduled:
            rec.observe_cycle(duration_s, degraded=degraded)
            # Per-pool round latency (round 17): one cycle number spanning
            # all pools hides a slow tenant -- each PoolStats carries its
            # own round seconds + the per-round fallback-delta degraded
            # flag (scheduler/algo.py), recorded into per-pool histograms.
            sched_pools = getattr(result.scheduler_result, "pools", None)
            if sched_pools:
                for ps in sched_pools:
                    if ps.round_s:
                        rec.observe_pool_round(
                            ps.pool, ps.round_s, degraded=ps.degraded
                        )
        if result.synced_jobs:
            rec.note_visible(result.synced_jobs)
        sched = result.scheduler_result
        if sched is not None and sched.scheduled:
            rec.note_leased([job.id for job, _run in sched.scheduled])
        if rec.pending_lease_count() and result.published:
            ended = [
                getattr(getattr(ev, kind), "job_id", "")
                for seq in result.published
                for ev in seq.events
                for kind in (ev.WhichOneof("event"),)
                if kind in ("cancelled_job", "job_errors")
            ]
            if ended:
                rec.forget([jid for jid in ended if jid])

    def _cycle(self, schedule: bool = True) -> CycleResult:
        from armada_tpu_torch.ops.trace import recorder as _trace

        trace = _trace()
        result = CycleResult()
        # Fetch cursors only advance with a COMMITTED txn: an aborted cycle
        # must re-fetch the same rows next time or their transitions are lost.
        cursors0 = (self._jobs_serial, self._runs_serial)
        txn = self.jobdb.write_txn()
        try:
            with trace.span("sync_state"):
                touched = self.sync_state(txn)
            result.synced_jobs = touched

            token: LeaderToken = self.leader.get_token()
            result.leader = token.leader
            if not token.leader:
                self._was_leader = False
                txn.commit()
                return result
            # Epoch fence: the publisher rejects publishes stamped with an
            # older generation than the election record's current one, so a
            # deposed leader's in-flight cycle cannot append after a
            # successor was elected -- even between our validate_token and
            # the actual append (eventlog/publisher.py set_epoch).
            set_epoch = getattr(self.publisher, "set_epoch", None)
            if set_epoch is not None:
                set_epoch(token.generation)
            if not self._was_leader:
                # Crash drill: die mid-promotion (after winning the
                # election, before the recovery fence completes).  The
                # cycle's except rewinds cursors and aborts the txn;
                # _was_leader stays False, so the next cycle re-runs the
                # whole promotion -- promotion must be idempotent.
                from armada_tpu_torch.core import faults

                faults.check("leader_promote")
                # Leadership acquired (first cycle or follower -> leader):
                # replay everything already published -- possibly by the
                # previous leader -- before taking decisions
                # (scheduler.go:169-181, ensureDbUpToDate:1120), and treat
                # EVERY job as touched so transitions ingested while we were
                # not leader still generate their update messages (the
                # reference's updateAll on leadership change).
                self.ensure_db_up_to_date(ingest_step=self.ingest_step)
                self.sync_state(txn)
                touched = sorted({j.id for j in txn.all_jobs()})
                result.synced_jobs = touched
            self._was_leader = True

            builder = _SequenceBuilder()
            now_ns = self.now_ns()

            # Refresh the submit checker's fleet BEFORE the update messages:
            # the requeue anti-affinity gate (_fail_or_requeue) consults it.
            with trace.span("transitions", touched=len(touched)):
                self._refresh_checker_fleet(now_ns)
                self._generate_update_messages(txn, touched, builder, now_ns)
                self._validate_jobs(txn, builder, now_ns)
                self._expire_executor_jobs(txn, builder, now_ns)

            if schedule:
                quarantined = self.node_quarantine.quarantined(now_ns)
                executors = self._executors()
                with trace.span("schedule"):
                    sched = self.algo.schedule(
                        txn,
                        executors,
                        now_ns,
                        quarantined_nodes=quarantined,
                    )
                result.scheduler_result = sched
                result.scheduled = True
                self._events_from_scheduler_result(sched, builder, now_ns)
                if self.config.publish_metric_events:
                    self._metric_events(sched, builder, now_ns)

            sequences = builder.build()
            if sequences:
                # Fencing: never publish with stale authority (scheduler.go:355).
                if not self.leader.validate_token(token):
                    txn.abort()
                    self._jobs_serial, self._runs_serial = cursors0
                    # Leadership lost: the next acquisition must re-fence.
                    self._was_leader = False
                    result.leader = False
                    return result
                with trace.span(
                    "event_publish",
                    sequences=len(sequences),
                    events=sum(len(s.events) for s in sequences),
                ):
                    self.publisher.publish(sequences)
            result.published = sequences

            if self.config.enable_assertions:
                txn.assert_invariants()
            with trace.span("commit"):
                txn.commit()
            feed = getattr(self.algo, "feed", None)
            if (
                schedule
                and feed is not None
                and pipeline_enabled()
                and prefetch_worthwhile(feed.device)
            ):
                # Shadow-pipeline stage (b): the commit's subscriber fire
                # just applied this cycle's decisions to the builders; start
                # their slab upload NOW so the transfer overlaps the
                # inter-cycle idle and the next cycle's sync instead of
                # serializing inside the next device apply.  Best-effort:
                # the txn is COMMITTED -- a device error here must not
                # reach the except below, whose cursor rewind assumes the
                # cycle did not commit (the rows ride the next bundle).
                try:
                    feed.prefetch_content()
                except Exception:
                    _log.warning("content prefetch failed", exc_info=True)
            return result
        except BaseException:
            txn.abort()
            self._jobs_serial, self._runs_serial = cursors0
            raise

    # --- job state transitions (scheduler.go generateUpdateMessages:698) ----

    def _generate_update_messages(
        self,
        txn: WriteTxn,
        touched: Iterable[str],
        builder: _SequenceBuilder,
        now_ns: int,
    ) -> None:
        for job_id in touched:
            job = txn.get(job_id)
            if job is None or job.in_terminal_state():
                continue

            # Cancellation requested (by job or jobset).
            if job.cancel_requested or job.cancel_by_jobset_requested:
                run = job.latest_run
                if run is not None and not run.in_terminal_state():
                    builder.add(
                        job.queue,
                        job.jobset,
                        pb.Event(
                            created_ns=now_ns,
                            job_run_cancelled=pb.JobRunCancelled(
                                job_id=job.id, run_id=run.id
                            ),
                        ),
                    )
                    job = job.with_updated_run(run.with_cancelled())
                builder.add(
                    job.queue,
                    job.jobset,
                    pb.Event(
                        created_ns=now_ns,
                        cancelled_job=pb.CancelledJob(job_id=job.id),
                    ),
                )
                txn.upsert(job.with_cancelled())
                continue

            run = job.latest_run

            # Operator-requested preemption (persisted on the job row so a
            # request that arrives before the lease materializes still acts).
            if job.preempt_requested:
                if run is None or run.in_terminal_state():
                    if job.queued or run is None:
                        # Preempted before it ever started: cancel it.
                        builder.add(
                            job.queue,
                            job.jobset,
                            pb.Event(
                                created_ns=now_ns,
                                cancelled_job=pb.CancelledJob(
                                    job_id=job.id, reason=PREEMPTED_REASON
                                ),
                            ),
                        )
                        txn.upsert(job.with_cancelled())
                        continue
                elif not run.preempt_requested:
                    # Ask the executor to stop the run; its report closes the loop.
                    builder.add(
                        job.queue,
                        job.jobset,
                        pb.Event(
                            created_ns=now_ns,
                            job_run_preemption_requested=pb.JobRunPreemptionRequested(
                                job_id=job.id, run_id=run.id, reason=PREEMPTED_REASON
                            ),
                        ),
                    )
                    job = job.with_updated_run(run.with_preempt_requested())
                    txn.upsert(job)
                    run = job.latest_run

            if run is None:
                continue

            if run.succeeded and not job.succeeded:
                builder.add(
                    job.queue,
                    job.jobset,
                    pb.Event(
                        created_ns=now_ns,
                        job_succeeded=pb.JobSucceeded(job_id=job.id),
                    ),
                )
                txn.upsert(job.with_succeeded())
            elif run.preempted:
                # Executor-confirmed preemption terminates the job
                # (scheduler.go: preempted runs fail their job).
                builder.add(
                    job.queue,
                    job.jobset,
                    pb.Event(
                        created_ns=now_ns,
                        job_errors=pb.JobErrors(
                            job_id=job.id,
                            errors=[
                                pb.Error(
                                    reason=PREEMPTED_REASON,
                                    message=f"run {run.id} preempted",
                                    terminal=True,
                                    node=run.node_name,
                                )
                            ],
                        ),
                    ),
                )
                txn.upsert(job.with_failed())
            elif run.failed and not run.returned:
                self.node_quarantine.record_failure(run.node_id, now_ns)
                # A failed run means a terminal error was reported
                # (instructions.go handleJobRunErrors): the job fails with it.
                builder.add(
                    job.queue,
                    job.jobset,
                    pb.Event(
                        created_ns=now_ns,
                        job_errors=pb.JobErrors(
                            job_id=job.id,
                            errors=[
                                pb.Error(
                                    reason="runFailed",
                                    message=f"run {run.id} failed on {run.node_name}",
                                    terminal=True,
                                    node=run.node_name,
                                )
                            ],
                        ),
                    ),
                )
                txn.upsert(job.with_failed())
            elif run.returned and not job.queued:
                # Returned leases count whether or not the pod started: a
                # stuck-PENDING return (podStuckPending) is the clearest
                # broken-node signal and never sets run_attempted.
                self.node_quarantine.record_failure(run.node_id, now_ns)
                self._fail_or_requeue(
                    txn,
                    job,
                    builder,
                    now_ns,
                    reason="runReturned",
                    message=f"run {run.id} returned by {run.executor}",
                )

    def _fail_or_requeue(
        self,
        txn: WriteTxn,
        job: Job,
        builder: _SequenceBuilder,
        now_ns: int,
        reason: str,
        message: str,
    ) -> None:
        """Requeue up to max_retries attempted runs, else fail terminally
        (scheduler.go:473-568 retry logic)."""
        requeue = job.num_attempts() <= self.config.max_retries and not (
            job.cancel_requested or job.cancel_by_jobset_requested
        )
        bans = job.anti_affinity_nodes() if requeue else ()
        if bans and self.submit_checker.have_executors:
            # A retry must avoid every node where an attempt died; if that
            # leaves nowhere it can run, fail it now instead of requeueing it
            # to starve forever (scheduler.go:826-840
            # addNodeAntiAffinitiesForAttemptedRunsIfSchedulable).  Validated
            # pools override the requested ones, exactly as the algo offers
            # them (algo.py): the gate must judge the pools the job will
            # actually be scheduled into.
            spec = dataclasses.replace(
                job.spec,
                priority=job.priority,
                pools=job.pools or job.spec.pools,
            )
            if not self.submit_checker.check_gang([spec], banned_nodes=bans).ok:
                requeue = False
                message = (
                    f"job was attempted {job.num_attempts()} times and has been "
                    "tried once on all nodes it can run on - "
                    "this job will no longer be retried"
                ) + f" ({message})"
        if requeue:
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_requeued=pb.JobRequeued(
                        job_id=job.id,
                        update_sequence_number=job.queued_version + 1,
                    ),
                ),
            )
            txn.upsert(job.with_queued(True))
        else:
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_errors=pb.JobErrors(
                        job_id=job.id,
                        errors=[
                            pb.Error(
                                reason=MAX_RETRIES_EXCEEDED,
                                message=message,
                                terminal=True,
                            )
                        ],
                    ),
                ),
            )
            txn.upsert(job.with_failed())

    # --- metric events (pkg/metricevents; cycle_metrics.go:637-671) ---------

    METRICS_QUEUE = "armada-metrics"
    METRICS_JOBSET = "cycle-metrics"

    def _metric_events(
        self, sched, builder: "_SequenceBuilder", now_ns: int
    ) -> None:
        """One CycleMetrics event per pool onto the log under the reserved
        ("armada-metrics", "cycle-metrics") stream: the reference's
        metric-events topic, watchable via the ordinary Event API.  The
        published totals are the round's OWN fairness denominator (node +
        floating capacity, RoundOutcome.pool_totals) -- every share in the
        event is a fraction of exactly these numbers."""
        for stats in sched.pools:
            alloc = pb.Resources(milli=dict(stats.outcome.pool_totals))
            qm = [
                pb.QueueCycleMetrics(
                    queue=qname,
                    actual_share=qs.get("actual_share", 0.0),
                    demand=qs.get("demand_share_raw", 0.0),
                    constrained_demand=qs.get("demand_share", 0.0),
                    fair_share=qs.get("fair_share", 0.0),
                    adjusted_fair_share=qs.get("adjusted_fair_share", 0.0),
                    short_job_penalty=qs.get("short_job_penalty", 0.0),
                )
                for qname, qs in stats.outcome.queue_stats.items()
            ]
            builder.add(
                self.METRICS_QUEUE,
                self.METRICS_JOBSET,
                pb.Event(
                    created_ns=now_ns,
                    cycle_metrics=pb.CycleMetrics(
                        pool=stats.pool,
                        queue_metrics=qm,
                        allocatable_resources=alloc,
                        spot_price=stats.outcome.spot_price or 0.0,
                        cycle_time_ns=now_ns,
                    ),
                ),
            )

    # --- validation (scheduler.go submitCheck:1011, submitcheck.go Check:181)

    def _refresh_checker_fleet(self, now_ns: int) -> None:
        """Update the SubmitChecker's fleet snapshot for this cycle.  Same
        staleness filter as the scheduling algo: a dead executor's snapshot
        must not vouch for (or block) a job's schedulability."""
        timeout_ns = int(self.config.executor_timeout_s * 1e9)
        live = [
            ex
            for ex in self._executors()
            if now_ns - ex.last_update_ns <= timeout_ns
        ]
        self.submit_checker.update_executors(live)

    def _validate_jobs(
        self, txn: WriteTxn, builder: _SequenceBuilder, now_ns: int
    ) -> None:
        unvalidated = txn.unvalidated_jobs()
        if not unvalidated:
            return
        if not self.submit_checker.have_executors:
            # No fleet yet: defer -- nothing can be judged unschedulable
            # against zero executors, and nothing can lease anyway.
            return

        # Gangs validate atomically (one check per gang, like the reference
        # checking whole gangs against mini NodeDbs).
        gangs: dict = {}
        for job in unvalidated:
            key = (job.queue, job.spec.gang_id) if job.spec.gang_id else (job.id, "")
            gangs.setdefault(key, []).append(job)

        for members in gangs.values():
            specs = [
                dataclasses.replace(j.spec, priority=j.priority) for j in members
            ]
            result = self.submit_checker.check_gang(specs)
            if result.ok:
                for job in members:
                    builder.add(
                        job.queue,
                        job.jobset,
                        pb.Event(
                            created_ns=now_ns,
                            job_validated=pb.JobValidated(
                                job_id=job.id, pools=result.pools
                            ),
                        ),
                    )
                    txn.upsert(job.with_validated(result.pools))
            else:
                for job in members:
                    builder.add(
                        job.queue,
                        job.jobset,
                        pb.Event(
                            created_ns=now_ns,
                            job_errors=pb.JobErrors(
                                job_id=job.id,
                                errors=[
                                    pb.Error(
                                        reason="unschedulable",
                                        message=result.reason,
                                        terminal=True,
                                    )
                                ],
                            ),
                        ),
                    )
                    txn.upsert(job.with_failed())

    # --- executor expiry (scheduler.go expireJobsIfNecessary:929) -----------

    def _expire_executor_jobs(
        self, txn: WriteTxn, builder: _SequenceBuilder, now_ns: int
    ) -> None:
        timeout_ns = int(self.config.executor_timeout_s * 1e9)
        stale = {
            ex.id
            for ex in self._executors()
            if now_ns - ex.last_update_ns > timeout_ns
        }
        if not stale:
            return
        for job in txn.all_jobs():
            run = job.latest_run
            if (
                job.in_terminal_state()
                or run is None
                or run.in_terminal_state()
                or run.executor not in stale
            ):
                continue
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_run_errors=pb.JobRunErrors(
                        job_id=job.id,
                        run_id=run.id,
                        errors=[
                            pb.Error(
                                reason=LEASE_EXPIRED,
                                message=f"executor {run.executor} stopped heartbeating",
                                terminal=False,
                                lease_returned=True,
                            )
                        ],
                    ),
                ),
            )
            job = job.with_updated_run(run.with_returned(run_attempted=run.running))
            txn.upsert(job)
            self._fail_or_requeue(
                txn,
                job,
                builder,
                now_ns,
                reason=LEASE_EXPIRED,
                message=f"executor {run.executor} lost",
            )

    # --- decision events (scheduler.go eventsFromSchedulerResult:570) -------

    def _events_from_scheduler_result(
        self, sched: SchedulerResult, builder: _SequenceBuilder, now_ns: int
    ) -> None:
        for job, run in sched.scheduled:
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_run_leased=pb.JobRunLeased(
                        job_id=job.id,
                        run_id=run.id,
                        executor_id=run.executor,
                        node_id=run.node_id,
                        pool=run.pool,
                        scheduled_at_priority=run.scheduled_at_priority or 0,
                        pool_scheduled_away=run.pool_scheduled_away,
                        update_sequence_number=job.queued_version,
                    ),
                ),
            )
        for job, run in sched.preempted:
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_run_preempted=pb.JobRunPreempted(
                        job_id=job.id, run_id=run.id, reason=PREEMPTED_REASON
                    ),
                ),
            )
            builder.add(
                job.queue,
                job.jobset,
                pb.Event(
                    created_ns=now_ns,
                    job_errors=pb.JobErrors(
                        job_id=job.id,
                        errors=[
                            pb.Error(
                                reason=PREEMPTED_REASON,
                                message=f"run {run.id} preempted by the scheduler",
                                terminal=True,
                            )
                        ],
                    ),
                ),
            )

    # --- service loop (scheduler.go Run:142) --------------------------------

    def run(
        self,
        stop,
        cycle_interval_s: float = 1.0,
        schedule_interval_s: float = 10.0,
    ) -> None:
        """Tick cycles until `stop` (a threading.Event) is set: a full
        scheduling round every schedule_interval, cheap reconcile cycles in
        between (cyclePeriod/schedulePeriod, config/scheduler/config.yaml:1-3).

        A failed cycle must not kill the loop: the cycle already aborted its
        txn and rewound its fetch cursors (no partial commit), so the next
        attempt re-derives everything -- a transient publish/DB failure
        costs retries with bounded jittered backoff, not the service (the
        reference's Run keeps cycling on cycle errors, scheduler.go:142).
        KeyboardInterrupt/SystemExit still propagate."""
        from armada_tpu_torch.core.backoff import Backoff

        backoff = Backoff(base_s=max(cycle_interval_s, 0.05), cap_s=30.0)
        last_schedule = 0.0
        while not stop.is_set():
            start = self._clock()
            do_schedule = start - last_schedule >= schedule_interval_s
            try:
                self.cycle(schedule=do_schedule)
            except Exception:  # noqa: BLE001 - the loop must survive
                delay = backoff.next_delay()
                _log.exception(
                    "scheduler cycle failed (attempt %d); retrying in %.2fs",
                    backoff.attempts,
                    delay,
                )
                # last_schedule stays: a failed scheduling cycle retries
                # scheduling at the next tick, not a schedule_interval later.
                stop.wait(delay)
                continue
            backoff.reset()
            if do_schedule:
                last_schedule = start
            elapsed = self._clock() - start
            stop.wait(max(0.0, cycle_interval_s - elapsed))
