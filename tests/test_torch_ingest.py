"""The port's scheduler ingestion: dbops merge/reorder, converter, pipeline
exactly-once.

The twins of tests/test_ingest.py against armada_tpu_torch.ingest, and the
two packages' ingesters held against each other: the same event sequences
ingested into a JAX `SchedulerDb` and a port `SchedulerDb` give equal rows
in every table (spec blobs included) and equal cursor positions.
"""

import pytest

from armada_tpu_torch.eventlog import EventLog, Publisher
from armada_tpu_torch.events import schema as pb
from armada_tpu_torch.ingest import (
    SchedulerDb,
    convert_sequences,
    scheduler_ingestion_pipeline,
)
from armada_tpu_torch.ingest import dbops as ops


def seq(queue="q", jobset="js", events=()):
    return pb.EventSequence(queue=queue, jobset=jobset, events=list(events))


def submit(job_id, priority=0):
    return pb.Event(
        created_ns=1,
        submit_job=pb.SubmitJob(job_id=job_id, spec=pb.JobSpec(priority=priority)),
    )


# --- dbops ------------------------------------------------------------------


def test_same_type_ops_merge():
    merged = ops.merge_ops(
        [
            ops.MarkJobsSucceeded(job_ids={"a"}),
            ops.MarkJobsSucceeded(job_ids={"b"}),
        ]
    )
    assert len(merged) == 1
    assert merged[0].job_ids == {"a", "b"}


def test_independent_ops_hoist_past_each_other():
    # succeeded(a), cancel(b), succeeded(c): the second succeeded op touches
    # only c, commutes with cancel(b), and merges into the first.
    merged = ops.merge_ops(
        [
            ops.MarkJobsSucceeded(job_ids={"a"}),
            ops.MarkJobsCancelRequested(job_ids={"b"}),
            ops.MarkJobsSucceeded(job_ids={"c"}),
        ]
    )
    assert len(merged) == 2
    assert merged[0].job_ids == {"a", "c"}


def test_conflicting_ops_do_not_reorder():
    # cancel(a) then succeeded(a) must stay ordered; a later succeeded(a)
    # cannot hoist past cancel(a).
    merged = ops.merge_ops(
        [
            ops.MarkJobsSucceeded(job_ids={"x"}),
            ops.MarkJobsCancelRequested(job_ids={"a"}),
            ops.MarkJobsSucceeded(job_ids={"a"}),
        ]
    )
    assert len(merged) == 3
    assert isinstance(merged[1], ops.MarkJobsCancelRequested)


def test_jobset_wildcard_blocks_reordering():
    merged = ops.merge_ops(
        [
            ops.MarkJobsSucceeded(job_ids={"a"}),
            ops.MarkJobSetCancelRequested(queue="q", jobset="js"),
            ops.MarkJobsSucceeded(job_ids={"b"}),
        ]
    )
    assert len(merged) == 3  # nothing crosses the jobset-wide op


def test_queued_state_merge_keeps_newest_version():
    op1 = ops.UpdateJobQueuedState(state_by_job={"j": (False, 3)})
    op1.merge(ops.UpdateJobQueuedState(state_by_job={"j": (True, 2)}))
    assert op1.state_by_job["j"] == (False, 3)  # stale version ignored
    op1.merge(ops.UpdateJobQueuedState(state_by_job={"j": (True, 4)}))
    assert op1.state_by_job["j"] == (True, 4)


# --- converter --------------------------------------------------------------


def test_convert_submit_and_lifecycle():
    events = [
        submit("j1", priority=3),
        pb.Event(job_validated=pb.JobValidated(job_id="j1", pools=["default"])),
        pb.Event(
            job_run_leased=pb.JobRunLeased(
                job_id="j1", run_id="r1", executor_id="e1", node_id="n1",
                pool="default", scheduled_at_priority=1000,
            )
        ),
        pb.Event(job_run_running=pb.JobRunRunning(job_id="j1", run_id="r1")),
        pb.Event(job_run_succeeded=pb.JobRunSucceeded(job_id="j1", run_id="r1")),
        pb.Event(job_succeeded=pb.JobSucceeded(job_id="j1")),
    ]
    out = convert_sequences([seq(events=events)])
    kinds = [type(o).__name__ for o in out]
    assert "InsertJobs" in kinds and "InsertRuns" in kinds
    assert "MarkRunsSucceeded" in kinds and "MarkJobsSucceeded" in kinds


def test_convert_terminal_run_error_also_fails_run():
    events = [
        pb.Event(
            job_run_errors=pb.JobRunErrors(
                job_id="j1", run_id="r1",
                errors=[pb.Error(reason="oom", message="killed", terminal=True)],
            )
        )
    ]
    out = convert_sequences([seq(events=events)])
    kinds = {type(o).__name__ for o in out}
    assert kinds == {"InsertJobRunErrors", "MarkRunsFailed"}


# --- schedulerdb + pipeline -------------------------------------------------


def test_store_and_fetch_updates():
    db = SchedulerDb()
    db.store(convert_sequences([seq(events=[submit("j1"), submit("j2")])]))
    jobs, runs = db.fetch_job_updates(0, 0)
    assert {r["job_id"] for r in jobs} == {"j1", "j2"}
    assert runs == []
    js, rs = db.max_serials()
    # Incremental: no new rows past the cursor.
    jobs2, _ = db.fetch_job_updates(js, rs)
    assert jobs2 == []
    # A lifecycle update bumps the serial past the cursor.
    db.store(
        convert_sequences(
            [seq(events=[pb.Event(job_succeeded=pb.JobSucceeded(job_id="j1"))])]
        )
    )
    jobs3, _ = db.fetch_job_updates(js, rs)
    assert [r["job_id"] for r in jobs3] == ["j1"]
    assert jobs3[0]["succeeded"] == 1 and jobs3[0]["queued"] == 0


def test_jobset_cancel_only_touches_jobset():
    db = SchedulerDb()
    db.store(
        convert_sequences(
            [
                seq(jobset="js-a", events=[submit("a1"), submit("a2")]),
                seq(jobset="js-b", events=[submit("b1")]),
            ]
        )
    )
    db.store(
        convert_sequences(
            [seq(jobset="js-a", events=[pb.Event(cancel_job_set=pb.CancelJobSet())])]
        )
    )
    jobs, _ = db.fetch_job_updates(0, 0)
    flags = {r["job_id"]: r["cancel_by_jobset_requested"] for r in jobs}
    assert flags == {"a1": 1, "a2": 1, "b1": 0}


def test_pipeline_end_to_end_and_restart_resume(tmp_path):
    log_dir = str(tmp_path / "log")
    db_path = str(tmp_path / "scheduler.db")
    with EventLog(log_dir, num_partitions=2) as log:
        publisher = Publisher(log)
        publisher.publish([seq(events=[submit("j1")])])
        db = SchedulerDb(db_path)
        pipeline = scheduler_ingestion_pipeline(log, db)
        assert pipeline.run_until_caught_up() == 1
        jobs, _ = db.fetch_job_updates(0, 0)
        assert [r["job_id"] for r in jobs] == ["j1"]
        # Re-running applies nothing new (positions persisted).
        assert pipeline.run_until_caught_up() == 0
        db.close()
        # Simulate restart: fresh pipeline from stored positions must not
        # re-apply j1 but must pick up a new event.
        publisher.publish([seq(events=[submit("j2")])])
        db2 = SchedulerDb(db_path)
        pipeline2 = scheduler_ingestion_pipeline(log, db2)
        assert pipeline2.run_until_caught_up() == 1
        jobs, _ = db2.fetch_job_updates(0, 0)
        assert {r["job_id"] for r in jobs} == {"j1", "j2"}
        db2.close()


def test_marker_roundtrip_through_pipeline(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=3) as log:
        publisher = Publisher(log)
        group = publisher.publish_markers()
        db = SchedulerDb()
        pipeline = scheduler_ingestion_pipeline(log, db)
        pipeline.run_until_caught_up()
        assert db.has_marker(group, num_partitions=3)
        assert not db.has_marker("other-group", num_partitions=3)


def test_duplicate_submit_is_idempotent():
    db = SchedulerDb()
    batch = convert_sequences([seq(events=[submit("j1")])])
    db.store(batch)
    db.store(batch)  # replay (at-least-once delivery)
    jobs, _ = db.fetch_job_updates(0, 0)
    assert len(jobs) == 1


# --- the two packages' ingesters against each other --------------------------


def _lifecycle(P, conv, T, factory, rng):
    """The same sequences, in one package's schema module: every event kind
    the scheduler ingester converts, over jobs with full specs."""
    seqs = []
    for i in range(60):
        q, js = f"q{i % 3}", f"js{i % 4}"
        spec = T.JobSpec(
            id=f"job-{i}", queue=q, jobset=js, priority=int(rng.integers(0, 5)),
            resources=factory.from_mapping({"cpu": str(int(rng.integers(1, 9))), "memory": "2Gi"}),
            node_selector={"zone": "a"} if i % 2 else {}, labels={"i": str(i)},
            gang_id=f"g{i // 3}" if i % 5 == 0 else "", pools=("p1",) if i % 3 else (),
            services=(T.ServiceSpec(type="NodePort", ports=(80, 8080)),) if i % 7 == 0 else (),
        )
        ev = [P.Event(created_ns=i, submit_job=P.SubmitJob(
            job_id=spec.id, spec=conv.job_spec_to_proto(spec), client_id=f"c{i}" if i % 2 else ""))]
        ev.append(P.Event(created_ns=i, job_validated=P.JobValidated(job_id=spec.id, pools=["p1"])))
        run = f"run-{i}"
        if i % 3:
            ev.append(P.Event(created_ns=i, job_run_leased=P.JobRunLeased(
                job_id=spec.id, run_id=run, executor_id=f"ex{i % 2}", node_id=f"n{i % 5}",
                pool="p1", scheduled_at_priority=i % 4, update_sequence_number=1)))
            ev.append(P.Event(created_ns=i, job_run_running=P.JobRunRunning(
                job_id=spec.id, run_id=run, node_id=f"n{i % 5}")))
        kind = i % 6
        if kind == 1:
            ev.append(P.Event(created_ns=i, job_run_succeeded=P.JobRunSucceeded(job_id=spec.id, run_id=run)))
            ev.append(P.Event(created_ns=i, job_succeeded=P.JobSucceeded(job_id=spec.id)))
        elif kind == 2:
            ev.append(P.Event(created_ns=i, job_run_errors=P.JobRunErrors(
                job_id=spec.id, run_id=run, errors=[P.Error(reason="podLost", lease_returned=True)])))
            ev.append(P.Event(created_ns=i, job_requeued=P.JobRequeued(job_id=spec.id, update_sequence_number=2)))
        elif kind == 4:
            ev.append(P.Event(created_ns=i, job_run_errors=P.JobRunErrors(
                job_id=spec.id, run_id=run, errors=[P.Error(reason="oom", terminal=True, node="n1")])))
            ev.append(P.Event(created_ns=i, job_errors=P.JobErrors(
                job_id=spec.id, errors=[P.Error(reason="oom", terminal=True)])))
        elif kind == 5:
            ev.append(P.Event(created_ns=i, job_run_preemption_requested=P.JobRunPreemptionRequested(
                job_id=spec.id, run_id=run)))
            ev.append(P.Event(created_ns=i, job_run_preempted=P.JobRunPreempted(job_id=spec.id, run_id=run)))
        elif i % 12 == 0:
            ev.append(P.Event(created_ns=i, reprioritise_job=P.ReprioritiseJob(job_id=spec.id, priority=9)))
            ev.append(P.Event(created_ns=i, cancel_job=P.CancelJob(job_id=spec.id, reason="user")))
            ev.append(P.Event(created_ns=i, cancelled_job=P.CancelledJob(job_id=spec.id)))
        else:
            ev.append(P.Event(created_ns=i, preempt_job=P.PreemptJob(job_id=spec.id)))
        seqs.append(P.EventSequence(queue=q, jobset=js, user_id="u", events=ev))
    seqs.append(P.EventSequence(queue="q1", jobset="js1", events=[
        P.Event(created_ns=99, reprioritise_job_set=P.ReprioritiseJobSet(priority=3)),
        P.Event(created_ns=99, cancel_job_set=P.CancelJobSet(reason="all", states=["queued"]))]))
    seqs.append(P.EventSequence(queue="", jobset="$control-plane", events=[
        P.Event(created_ns=100, queue_upsert=P.QueueUpsert(name="q9", weight=2.0, labels={"a": "b"})),
        P.Event(created_ns=100, executor_settings_upsert=P.ExecutorSettingsUpsert(
            name="ex1", cordoned=True, cordon_reason="maint", set_by_user="ops")),
        P.Event(created_ns=100, cancel_on_queue=P.CancelOnQueue(name="q2", job_states=["queued"])),
        P.Event(created_ns=100, preempt_on_executor=P.PreemptOnExecutor(name="ex0")),
    ]))
    return seqs


def _rows(db) -> dict:
    conn = db._conn
    out = {}
    for (t,) in conn.execute("SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name"):
        out[t] = [tuple(r) for r in conn.execute(f"SELECT * FROM {t} ORDER BY rowid")]
    return out


def test_same_sequences_give_equal_rows_in_both_packages(tmp_path):
    import numpy as np

    import armada_tpu.core.config as jc
    import armada_tpu.core.types as jt
    import armada_tpu.events.convert as jconv
    import armada_tpu.ingest as jing
    from armada_tpu.eventlog import EventLog as JLog, Publisher as JPub
    from armada_tpu.events import events_pb2 as jpb

    import armada_tpu_torch.core.config as tc
    import armada_tpu_torch.core.types as tt
    import armada_tpu_torch.events.convert as tconv
    import armada_tpu_torch.ingest as ting

    rows, positions = [], []
    for name, P, conv, T, cfg, Log, Pub, ing in (
        ("jax", jpb, jconv, jt, jc, JLog, JPub, jing),
        ("port", pb, tconv, tt, tc, EventLog, Publisher, ting),
    ):
        factory = cfg.SchedulingConfig().resource_list_factory()
        seqs = _lifecycle(P, conv, T, factory, np.random.default_rng(11))
        log = Log(str(tmp_path / name), num_partitions=3)
        pub = Pub(log, clock=lambda: 5.0, max_events_per_message=4)
        half = len(seqs) // 2
        pub.publish(seqs[:half])
        db = ing.SchedulerDb(str(tmp_path / f"{name}.sqlite"))
        ing.scheduler_ingestion_pipeline(log, db).run_until_caught_up()
        pub.publish(seqs[half:])
        pub.publish_markers(group_id="m" * 32)
        ing.scheduler_ingestion_pipeline(log, db).run_until_caught_up()
        rows.append(_rows(db))
        positions.append(db.positions("scheduler"))
        db.close()
        log.close()
    jax_rows, port_rows = rows
    assert jax_rows.keys() == port_rows.keys()
    assert len(jax_rows["jobs"]) == 60 and jax_rows["markers"]
    for table in jax_rows:
        assert port_rows[table] == jax_rows[table], table
    assert positions[0] == positions[1] and len(positions[0]) == 3
