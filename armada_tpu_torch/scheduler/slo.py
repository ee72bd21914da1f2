"""Streaming SLO layer: the latency distributions a standing load is judged by.

Production schedulers are evaluated by tail latency under sustained arrival
processes (Gavel arXiv:2008.09213, Synergy arXiv:2110.06073), not one-shot
placement cost.  This module keeps the three serving-path distributions as
log-bucketed O(1)-record histograms (ops/metrics.LogHistogram):

  cycle_latency_s         wall time of a scheduling cycle (split by device
                          backend state: healthy vs the CPU-failover window,
                          so chaos-under-load reads degradation as a latency
                          DELTA, not a pass/fail drill)
  time_to_first_lease_s   submit accepted -> first lease decision published,
                          end-to-end through ingest + eventlog + the round
  ingest_visible_lag_s    submit accepted -> the job's row first visible to
                          the scheduler's sync_state (the ingestion path's
                          contribution to TTFL)

All timestamps are :func:`ops.metrics.mono_now` -- monotonic, same-process
(serve IS one process; the sidecar exposes only its own cycle histograms).
Wall clocks are banned here by armada-lint's ``slo-wallclock`` rule: they
skew and step, and a latency histogram fed from them is fiction.

The recorder is a process-global singleton (like core/watchdog.supervisor):
SubmitServer notes accepted job ids, the Scheduler notes visibility and
leases, every reader (/healthz, SchedulerMetrics, the sidecar stats JSON,
bench/soak) snapshots the same instance.  Recording costs two dict ops per
job and one histogram record per cycle; tracking maps are bounded
(``track_cap``) so a reader that never leases cannot grow memory without
bound -- overflow is counted, never silent.
"""

from __future__ import annotations

from typing import Iterable, Optional

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.ops.metrics import LogHistogram, MetricsRegistry, mono_now

# A job submitted but untracked because the map was full: counted so a soak
# reading 0 dropped jobs can trust it (the harness asserts this stays 0).
DEFAULT_TRACK_CAP = 2_000_000


class SLORecorder:
    def __init__(self, track_cap: int = DEFAULT_TRACK_CAP):
        self.registry = MetricsRegistry("slo")
        self.cycle = self.registry.histogram("cycle_latency_s")
        self.cycle_degraded = self.registry.histogram("cycle_latency_degraded_s")
        self.ttfl = self.registry.histogram("time_to_first_lease_s")
        self.ingest_lag = self.registry.histogram("ingest_visible_lag_s")
        # RTO: crash (or kill) -> the restarted plane's first completed
        # scheduling cycle.  Fed by the crash drills (loadgen/soak kill leg,
        # chaos_cycle --crash) and by serve restarts that restore from a
        # checkpoint -- recovery time is an SLO distribution, not a
        # pass/fail drill.
        self.restart = self.registry.histogram("restart_recovery_s")
        self.submitted = self.registry.counter("jobs_submitted")
        self.leased = self.registry.counter("jobs_first_leased")
        self.track_overflow = self.registry.counter("tracking_overflow")
        self.track_cap = track_cap
        # job id -> submit mono time; _await_visible drains into ingest_lag
        # on first sync visibility, _await_lease into ttfl on first lease.
        self._await_visible: dict[str, float] = {}
        self._await_lease: dict[str, float] = {}
        # Per-pool ROUND latency (round 17): one cycle latency spanning all
        # pools hides a slow tenant behind its neighbours -- each pool's
        # round (dispatch through apply) records into its own histogram,
        # with the fallback-delta degraded-attribution rule applied PER
        # POOL (the pool whose round paid the failover window files as
        # degraded, not the whole cycle).  Bounded like the tracking maps:
        # past the cap new pools count into track_overflow, never silently.
        self._pool_rounds: dict[str, LogHistogram] = {}
        self._pool_degraded: dict[str, int] = {}
        self.pool_cap = 512
        self._lock = make_lock("slo.recorder")

    # ---------------------------------------------------------- writers ----

    def note_submitted(self, job_ids: Iterable[str], t: Optional[float] = None) -> None:
        """Submit accepted (SubmitServer, after the publish succeeded)."""
        t0 = mono_now() if t is None else t
        with self._lock:
            n = 0
            for jid in job_ids:
                n += 1
                if len(self._await_lease) >= self.track_cap:
                    self.track_overflow.inc()
                    continue
                self._await_visible[jid] = t0
                self._await_lease[jid] = t0
            self.submitted.inc(n)

    def note_visible(self, job_ids: Iterable[str]) -> None:
        """Rows applied by the scheduler's sync_state this cycle."""
        if not self._await_visible:
            return
        t1 = mono_now()
        with self._lock:
            for jid in job_ids:
                t0 = self._await_visible.pop(jid, None)
                if t0 is not None:
                    self.ingest_lag.record(t1 - t0)

    def note_leased(self, job_ids: Iterable[str]) -> None:
        """First lease decisions published for these jobs this cycle."""
        if not self._await_lease:
            return
        t1 = mono_now()
        with self._lock:
            for jid in job_ids:
                t0 = self._await_lease.pop(jid, None)
                if t0 is not None:
                    self.ttfl.record(t1 - t0)
                    self.leased.inc()

    def forget(self, job_ids: Iterable[str]) -> None:
        """Jobs that terminated without ever leasing (cancel before lease,
        validation failure): stop waiting for them."""
        with self._lock:
            for jid in job_ids:
                self._await_visible.pop(jid, None)
                self._await_lease.pop(jid, None)

    def observe_restart(self, duration_s: float) -> None:
        """One crash-to-serving recovery (RTO sample)."""
        self.restart.record(duration_s)

    def observe_cycle(self, duration_s: float, degraded: Optional[bool] = None) -> None:
        """One scheduling cycle's wall time.  ``degraded`` defaults to the
        device supervisor's current state so the failover window separates
        out without the caller threading it through."""
        if degraded is None:
            from armada_tpu_torch.core.watchdog import supervisor

            degraded = supervisor().degraded
        (self.cycle_degraded if degraded else self.cycle).record(duration_s)

    def observe_pool_round(
        self, pool: str, duration_s: float, degraded: bool = False
    ) -> None:
        """One pool's scheduling-round wall time within a cycle (fed from
        SchedulerResult.pools by Scheduler._observe_slo and the sidecar)."""
        with self._lock:
            h = self._pool_rounds.get(pool)
            if h is None:
                if len(self._pool_rounds) >= self.pool_cap:
                    self.track_overflow.inc()
                    return
                h = self._pool_rounds[pool] = LogHistogram(
                    name=f"pool_round_s.{pool}"
                )
            if degraded:
                self._pool_degraded[pool] = (
                    self._pool_degraded.get(pool, 0) + 1
                )
        h.record(duration_s)

    # ---------------------------------------------------------- readers ----

    def pending_lease_count(self) -> int:
        return len(self._await_lease)

    def snapshot(self) -> dict:
        """The /healthz / sidecar / bench JSON block."""
        snap = self.registry.snapshot()
        snap["awaiting_first_lease"] = len(self._await_lease)
        with self._lock:
            pools = {
                pool: {
                    **h.snapshot(),
                    "degraded_rounds": self._pool_degraded.get(pool, 0),
                }
                for pool, h in self._pool_rounds.items()
            }
        if pools:
            snap["pools"] = pools
        return snap

    def reset(self) -> None:
        with self._lock:
            self._await_visible.clear()
            self._await_lease.clear()
            self._pool_rounds.clear()
            self._pool_degraded.clear()
        self.registry.reset()


_recorder: Optional[SLORecorder] = None
_recorder_lock = make_lock("slo.global")


def recorder() -> SLORecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = SLORecorder()
        return _recorder


def reset_recorder() -> SLORecorder:
    """Fresh process-global recorder (soak runs + tests)."""
    global _recorder
    with _recorder_lock:
        _recorder = SLORecorder()
        return _recorder
