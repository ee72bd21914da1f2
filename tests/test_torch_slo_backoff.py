"""The port's bounded backoff (core/backoff.py) and streaming SLO recorder
(scheduler/slo.py).

The twins of the backoff cases of tests/test_faults.py and tests/test_dlq.py
and of the SLO-recorder cases of tests/test_slo_metrics.py (its metrics
exporter and /healthz cases come with the next slice of the port), run
against the port's modules.
"""

from __future__ import annotations

from armada_tpu_torch.core.backoff import Backoff
from armada_tpu_torch.ops.metrics import mono_now
from armada_tpu_torch.scheduler.slo import SLORecorder, recorder, reset_recorder


def test_backoff_bounded_and_jittered():
    bo = Backoff(base_s=0.1, cap_s=1.0, floor_s=0.01)
    delays = [bo.next_delay() for _ in range(20)]
    assert all(0.01 <= d <= 1.0 for d in delays)
    assert bo.attempts == 20
    # the schedule's CEILING grows then caps; jitter keeps draws below it
    assert max(delays[10:]) <= 1.0
    bo.reset()
    assert bo.attempts == 0
    assert bo.next_delay() <= 0.1
    # a sustained outage reaches four-digit attempts: 2.0**n must not
    # overflow (it did at ~1024, killing the retry loop it was pacing)
    bo.attempts = 5000
    assert 0.01 <= bo.next_delay() <= 1.0


def test_backoff_schedule_exact_with_seeded_rng():
    """The schedule is AWS full jitter: delay_n = uniform(0, min(cap,
    base*2^n)) with a floor -- pinned draw-for-draw against a twin RNG."""
    import random

    bo = Backoff(base_s=0.2, cap_s=3.0, floor_s=0.05, rng=random.Random(7))
    twin = random.Random(7)
    for n in range(12):
        ceiling = min(3.0, 0.2 * (2.0**n))
        assert bo.next_delay() == max(0.05, twin.uniform(0.0, ceiling))
    # floor clamps to base: floor_s > base_s must not invert the schedule
    assert Backoff(base_s=0.1, floor_s=0.5).floor_s == 0.1
    # FULL jitter: post-cap draws still vary (lockstep retry is the bug
    # this class exists to prevent)
    bo2 = Backoff(base_s=1.0, cap_s=64.0, floor_s=0.0, rng=random.Random(3))
    bo2.attempts = 10
    assert len({bo2.next_delay() for _ in range(8)}) > 1


def test_backoff_max_attempts_bounds_and_reset():
    b = Backoff(base_s=0.01, cap_s=0.02, floor_s=0.001, max_attempts=3)
    assert not b.exhausted()
    for _ in range(3):
        assert not b.exhausted()
        d = b.next_delay()
        assert 0.0 < d <= 0.02
    assert b.exhausted()
    # exhausted is a report, not a gate: further draws stay legal
    b.next_delay()
    assert b.exhausted()
    b.reset()
    assert not b.exhausted()
    # the unbounded default (every pre-existing call site) never exhausts
    u = Backoff(base_s=0.001, cap_s=0.001, floor_s=0.0001)
    for _ in range(50):
        u.next_delay()
    assert not u.exhausted()


def test_backoff_deadline_measured_from_first_draw():
    b = Backoff(base_s=0.001, cap_s=0.001, floor_s=0.0001, deadline_s=3600.0)
    assert not b.exhausted()
    b.next_delay()
    assert not b.exhausted()  # the hour has not elapsed
    d = Backoff(base_s=0.001, cap_s=0.001, floor_s=0.0001, deadline_s=0.0)
    assert not d.exhausted()  # clock starts at the FIRST post-reset draw
    d.next_delay()
    assert d.exhausted()
    d.reset()
    assert not d.exhausted()


def test_slo_recorder_ttfl_and_ingest_lag_flow():
    rec = SLORecorder()
    t0 = mono_now() - 0.5  # submitted half a second ago
    rec.note_submitted(["j1", "j2", "j3"], t=t0)
    assert rec.snapshot()["jobs_submitted"] == 3
    rec.note_visible(["j1", "j2", "unknown"])
    snap = rec.snapshot()
    assert snap["ingest_visible_lag_s"]["count"] == 2
    assert snap["ingest_visible_lag_s"]["min_s"] >= 0.5
    rec.note_leased(["j1"])
    rec.note_leased(["j1"])  # second lease of the same job: no double count
    snap = rec.snapshot()
    assert snap["time_to_first_lease_s"]["count"] == 1
    assert snap["jobs_first_leased"] == 1
    # j2 cancelled before leasing; j3 terminal: both leave the maps
    rec.forget(["j2", "j3"])
    assert rec.pending_lease_count() == 0


def test_slo_recorder_tracking_is_bounded():
    rec = SLORecorder(track_cap=2)
    rec.note_submitted(["a", "b", "c", "d"])
    assert rec.pending_lease_count() == 2
    assert rec.snapshot()["tracking_overflow"] == 2
    assert rec.snapshot()["jobs_submitted"] == 4


def test_slo_recorder_cycle_split_by_degradation():
    rec = SLORecorder()
    rec.observe_cycle(0.1, degraded=False)
    rec.observe_cycle(2.0, degraded=True)
    snap = rec.snapshot()
    assert snap["cycle_latency_s"]["count"] == 1
    assert snap["cycle_latency_degraded_s"]["count"] == 1


def test_global_recorder_reset():
    reset_recorder()
    r1 = recorder()
    r1.note_submitted(["x"])
    assert recorder() is r1
    r2 = reset_recorder()
    assert r2 is not r1
    assert r2.pending_lease_count() == 0


def test_slo_per_pool_round_histograms():
    """Round 17: per-pool round latency rides its own histograms (the
    slow-tenant signal), with the degraded-attribution rule applied per
    ROUND; snapshot exposes them under "pools", reset clears them."""
    rec = SLORecorder()
    rec.observe_pool_round("gpu", 0.2)
    rec.observe_pool_round("gpu", 0.4, degraded=True)
    rec.observe_pool_round("cpu", 0.05)
    snap = rec.snapshot()
    assert snap["pools"]["gpu"]["count"] == 2
    assert snap["pools"]["gpu"]["degraded_rounds"] == 1
    assert snap["pools"]["cpu"]["degraded_rounds"] == 0
    assert snap["pools"]["cpu"]["p50_s"] <= snap["pools"]["gpu"]["p50_s"]
    rec.reset()
    assert "pools" not in rec.snapshot()
