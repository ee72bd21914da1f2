"""The scheduler service's cycle, held against the JAX package on the CPU.

A twin of the `World` of tests/test_scheduler_service.py is built in each
package -- an event log, a scheduler DB fed by the ingestion pipeline, a
JobDb, the algo (the port's with device="cpu", so its kernels' plain
versions run) and the `Scheduler` -- and the same scenario drives both.
Run ids come from a counter in both, both read the same fake clock, and
marker group ids (uuid4) are stripped before rows are compared. After every
cycle and its ingest the published sequences (their deterministic bytes),
every table of the scheduler DB and every job of the JobDb must be equal.

The scenario's seven cycles cover submit, validation (a gang too big for
the fleet fails it), lease and success; a queued and a leased cancellation
and a jobset cancellation; both preempt requests (on a queued job, which
cancels it, and on a leased one, which the executor confirms); a terminal
run error and a retryable one; executor expiry with requeue; a gang leased
all or nothing; a follower that syncs but does not publish; leadership
regained (the marker fence); and a restart that resumes from the DB.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
from types import SimpleNamespace

import pytest


class FakeClock:
    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _package(prefix: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    port = prefix == "armada_tpu_torch"
    return SimpleNamespace(
        port=port,
        config=m("core.config"),
        types=m("core.types"),
        eventlog=m("eventlog"),
        publisher=m("eventlog.publisher"),
        pb=m("events.schema") if port else m("events.events_pb2"),
        convert=m("events.convert"),
        converter=m("ingest.converter"),
        pipeline=m("ingest.pipeline"),
        schedulerdb=m("ingest.schedulerdb"),
        jobdb=m("jobdb.jobdb"),
        scheduler=m("scheduler"),
        incremental=m("scheduler.incremental_algo"),
        leader=m("scheduler.leader"),
    )


class World:
    """One in-process control plane of one package: log + db + ingester +
    scheduler (the World of tests/test_scheduler_service.py)."""

    def __init__(self, P: SimpleNamespace, tmp_path, incremental: bool):
        self.P = P
        self.pb = P.pb
        self.config = P.config.SchedulingConfig(
            shape_bucket=32, enable_assertions=True, incremental_problem_build=incremental
        )
        self.clock = FakeClock()
        self.log = P.eventlog.EventLog(str(tmp_path / "log"), num_partitions=2)
        self.db = P.schedulerdb.SchedulerDb(":memory:")
        self.publisher = P.publisher.Publisher(self.log, clock=self.clock)
        self.pipeline = P.pipeline.IngestionPipeline(
            self.log, self.db, P.converter.convert_sequences, consumer_name="scheduler"
        )
        self.factory = self.config.resource_list_factory()
        counter = itertools.count()
        self.run_ids = lambda: f"run-{next(counter):04d}"
        self.scheduler = self._scheduler()

    def _scheduler(self):
        P = self.P
        dev = {"device": "cpu"} if P.port else {}
        self.jobdb = P.jobdb.JobDb(self.config)
        feed = None
        if self.config.incremental_problem_build:
            feed = P.incremental.IncrementalProblemFeed(self.config, **dev)
            feed.attach(self.jobdb)
        algo = P.scheduler.FairSchedulingAlgo(
            self.config,
            queues=lambda: [P.types.Queue("q1"), P.types.Queue("q2")],
            clock_ns=lambda: int(self.clock() * 1e9),
            run_id_factory=self.run_ids,
            feed=feed,
            **dev,
        )
        return P.scheduler.Scheduler(
            self.db, self.jobdb, algo, self.publisher,
            P.scheduler.StandaloneLeaderController(), self.config,
            clock=self.clock, ingest_step=self.pipeline.run_until_caught_up,
        )

    def restart(self) -> None:
        """A new JobDb, algo and scheduler over the same DB and log."""
        self.scheduler = self._scheduler()

    def ingest(self):
        return self.pipeline.run_until_caught_up()

    def now_ns(self) -> int:
        return int(self.clock() * 1e9)

    def publish(self, queue, jobset, **event):
        pb = self.pb
        self.publisher.publish([pb.EventSequence(
            queue=queue, jobset=jobset, events=[pb.Event(created_ns=self.now_ns(), **event)],
        )])

    def submit(self, job_id, queue="q1", jobset="js1", cpu="1", mem="1", **kw):
        spec = self.P.types.JobSpec(
            id=job_id, queue=queue, jobset=jobset,
            resources=self.factory.from_mapping({"cpu": cpu, "memory": mem}), **kw,
        )
        self.publish(queue, jobset, submit_job=self.pb.SubmitJob(
            job_id=job_id, spec=self.P.convert.job_spec_to_proto(spec)))

    def add_executor(self, ex_id, num_nodes, cpu="8", mem="64"):
        T = self.P.types
        nodes = tuple(
            T.NodeSpec(id=f"{ex_id}-n{i}", pool="default", executor=ex_id,
                       total_resources=self.factory.from_mapping({"cpu": cpu, "memory": mem}))
            for i in range(num_nodes)
        )
        snap = self.P.scheduler.ExecutorSnapshot(
            id=ex_id, pool="default", nodes=nodes, last_update_ns=self.now_ns())
        self.db.upsert_executor(ex_id, snap.to_json(), snap.last_update_ns)

    def heartbeat(self, ex_id):
        row = {r["executor_id"]: r for r in self.db.executors()}[ex_id]
        snap = self.P.scheduler.ExecutorSnapshot.from_json(row["snapshot"], self.factory)
        snap = dataclasses.replace(snap, last_update_ns=self.now_ns())
        self.db.upsert_executor(ex_id, snap.to_json(), snap.last_update_ns)

    def report(self, job_id, kind, **fields):
        job = self.jobdb.read_txn().get(job_id)
        self.publish(job.queue, job.jobset, **{kind: getattr(self.pb, _CLASS[kind])(
            job_id=job_id, run_id=job.latest_run.id, **fields)})

    # --- what is compared --------------------------------------------------

    def rows(self) -> dict:
        conn = self.db._conn
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name")]
        out = {}
        for t in tables:
            cur = conn.execute(f"SELECT * FROM {t} ORDER BY rowid")
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, tuple(r))) for r in cur.fetchall()]
            if t == "markers":
                for r in rows:
                    r["group_id"] = ""
            out[t] = rows
        return out

    def jobs(self) -> dict:
        out = {}
        for job in self.jobdb.read_txn().all_jobs():
            d = {f.name: getattr(job, f.name) for f in dataclasses.fields(job)
                 if f.name not in ("spec", "runs")}
            d["runs"] = [dataclasses.astuple(r) for r in job.runs]
            d["active_runs"] = sum(not r.in_terminal_state() for r in job.runs)
            d["spec"] = (job.spec.id, job.spec.queue, job.spec.jobset, job.spec.submit_time,
                         self.P.convert.job_spec_to_proto(job.spec)
                         .SerializeToString(deterministic=True))
            out[job.id] = d
        return out

    def close(self) -> None:
        self.db.close()
        self.log.close()


_CLASS = {
    "job_run_running": "JobRunRunning",
    "job_run_succeeded": "JobRunSucceeded",
    "job_run_errors": "JobRunErrors",
    "job_run_preempted": "JobRunPreempted",
}


class _Follower:
    def __init__(self, P):
        self.P = P

    def get_token(self):
        return self.P.leader.LeaderToken(leader=False)

    def validate_token(self, token):
        return False


CYCLES = ("sync", "lease", "reports", "expiry", "follower", "regain", "restart")


def scenario(w: World) -> list:
    """Drive one world through CYCLES; a snapshot after each cycle."""
    pb = w.pb
    snaps = []

    def cycle(name):
        res = w.scheduler.cycle()
        w.ingest()
        snaps.append(dict(
            name=name, leader=res.leader, scheduled=res.scheduled,
            synced=sorted(res.synced_jobs),
            published=[s.SerializeToString(deterministic=True) for s in res.published],
            kinds=res.events_by_kind(), rows=w.rows(), jobs=w.jobs(),
        ))
        assert name == CYCLES[len(snaps) - 1]

    # 1. Submits before any executor: synced, validation deferred.
    for i in range(4):
        w.submit(f"j{i}", queue="q1", jobset="js1")
    for i in range(3):
        w.submit(f"k{i}", queue="q2", jobset="js2", cpu="2")
    for i in range(3):
        w.submit(f"b{i}", queue="q1", jobset="batch")
    for i in range(3):
        w.submit(f"g{i}", queue="q2", jobset="gang", gang_id="g1", gang_cardinality=3,
                 cpu="4", mem="4")
    for i in range(2):  # no node holds 12 cpu: fails validation
        w.submit(f"big{i}", queue="q2", jobset="gang", gang_id="g2", gang_cardinality=2,
                 cpu="12", mem="4")
    for i in range(3):  # more than the fleet holds: some wait queued
        w.submit(f"h{i}", queue="q1", jobset="hogs", cpu="8", mem="8")
    w.submit("jq", queue="q1", jobset="js1")
    w.submit("jpq", queue="q2", jobset="js2")
    w.ingest()
    cycle("sync")

    # 2. A queued cancellation and a preempt request on a queued job; the
    # executors arrive: validation and leases.
    w.publish("q1", "js1", cancel_job=pb.CancelJob(job_id="jq", reason="user"))
    w.publish("q2", "js2", preempt_job=pb.PreemptJob(job_id="jpq", reason="ops"))
    w.add_executor("ex1", num_nodes=3)
    w.add_executor("ex2", num_nodes=2)
    w.ingest()
    cycle("lease")

    # 3. The executors report; a leased cancellation, a jobset cancellation
    # and a preempt request on a leased job.
    leased = sorted(j.id for j in w.jobdb.read_txn().all_jobs()
                    if j.latest_run is not None and not j.latest_run.in_terminal_state())
    for job_id in leased:
        job = w.jobdb.read_txn().get(job_id)
        w.report(job_id, "job_run_running", node_id=job.latest_run.node_id)
    # Roles go to leased singletons outside the gang and the batch jobset.
    done, failed, retried, cancelled, preempted = [
        j for j in leased if j[0] in "jkh"][:5]
    w.report(done, "job_run_succeeded")
    w.report(failed, "job_run_errors",
             errors=[pb.Error(reason="oom", message="killed", terminal=True)])
    w.report(retried, "job_run_errors", errors=[pb.Error(
        reason="podLost", message="returned", terminal=False, lease_returned=True)])
    job = w.jobdb.read_txn().get(cancelled)
    w.publish(job.queue, job.jobset, cancel_job=pb.CancelJob(job_id=cancelled))
    w.publish("q1", "batch", cancel_job_set=pb.CancelJobSet(reason="all"))
    job = w.jobdb.read_txn().get(preempted)
    w.publish(job.queue, job.jobset, preempt_job=pb.PreemptJob(job_id=preempted))
    w.ingest()
    cycle("reports")

    # 4. The executor confirms the preemption; ex2 stops heartbeating past
    # the timeout: its runs expire and their jobs requeue.
    w.report(preempted, "job_run_preempted", reason="preempted")
    w.clock.advance(w.config.executor_timeout_s + 10)
    w.heartbeat("ex1")
    w.ingest()
    cycle("expiry")

    # 5. A follower syncs a new submit but publishes nothing.
    w.scheduler.leader = _Follower(w.P)
    w.submit("f0", queue="q2", jobset="js2")
    w.ingest()
    cycle("follower")

    # 6. Leadership regained (the marker fence re-runs); ex2 is back.
    w.scheduler.leader = w.P.scheduler.StandaloneLeaderController()
    w.clock.advance(5)
    w.heartbeat("ex1")
    w.heartbeat("ex2")
    w.ingest()
    cycle("regain")

    # 7. A restart resumes from the DB without leasing twice.
    w.restart()
    w.submit("r0", queue="q1", jobset="js1")
    w.ingest()
    cycle("restart")
    return snaps


@pytest.fixture(scope="module", params=["legacy", "incremental"])
def twin(request, tmp_path_factory):
    out = []
    for prefix in ("armada_tpu", "armada_tpu_torch"):
        w = World(_package(prefix), tmp_path_factory.mktemp(prefix), request.param == "incremental")
        try:
            out.append(scenario(w))
        finally:
            w.close()
    return out


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_publishes_what_the_jax_package_publishes(twin, cycle):
    jax_snap, port_snap = (s[CYCLES.index(cycle)] for s in twin)
    for key in ("leader", "scheduled", "synced", "kinds", "published"):
        assert port_snap[key] == jax_snap[key], key


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_leaves_equal_db_rows(twin, cycle):
    jax_rows, port_rows = (s[CYCLES.index(cycle)]["rows"] for s in twin)
    assert port_rows.keys() == jax_rows.keys()
    for table in jax_rows:
        assert port_rows[table] == jax_rows[table], table


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_leaves_equal_jobdb_states(twin, cycle):
    jax_jobs, port_jobs = (s[CYCLES.index(cycle)]["jobs"] for s in twin)
    assert port_jobs.keys() == jax_jobs.keys()
    for job_id in jax_jobs:
        assert port_jobs[job_id] == jax_jobs[job_id], job_id


def test_scenario_covers_the_lifecycle(twin):
    """The scenario reached every behaviour it names (in the port's run;
    the tests above hold the JAX package's to the same)."""
    snaps = {s["name"]: s for s in twin[1]}
    assert snaps["sync"]["kinds"] == {} and "j0" in snaps["sync"]["synced"]
    lease = snaps["lease"]["kinds"]
    assert lease["job_validated"] and lease["job_run_leased"] and lease["cancelled_job"] == 2
    assert lease["job_errors"] == 2  # the gang too big for any node
    gang = [j for j, d in snaps["lease"]["jobs"].items() if j.startswith("g")]
    assert all(snaps["lease"]["jobs"][j]["runs"] for j in gang)
    queued = [d for d in snaps["lease"]["jobs"].values() if d["queued"] and d["validated"]]
    assert queued, "some job must wait for capacity"
    reports = snaps["reports"]["kinds"]
    assert reports["job_succeeded"] == 1 and reports["job_run_cancelled"] >= 2
    assert reports["job_errors"] == 1 and reports["job_requeued"] == 1
    expiry = snaps["expiry"]["kinds"]
    assert expiry["job_run_errors"] >= 1 and expiry["job_requeued"] >= 1
    assert expiry["job_errors"] == 1  # the confirmed preemption
    follower = snaps["follower"]
    assert not follower["leader"] and follower["published"] == [] and "f0" in follower["jobs"]
    regain = snaps["regain"]
    assert regain["leader"] and regain["kinds"].get("job_run_leased")
    assert any(r["partition"] == 1 for r in regain["rows"]["markers"])
    restart = snaps["restart"]
    assert restart["kinds"].get("job_validated") == 1
    assert max(d["active_runs"] for d in restart["jobs"].values()) == 1


def test_service_refuses_what_the_port_does_not_hold_yet(tmp_path):
    """Without a card the algo refuses to run unless given device="cpu";
    the unported observers and the Postgres scheduler DB raise
    NotImplementedError."""
    import torch

    P = _package("armada_tpu_torch")
    config = P.config.SchedulingConfig(shape_bucket=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            P.scheduler.FairSchedulingAlgo(config, queues=lambda: [], clock_ns=lambda: 0)
    w = World(P, tmp_path, incremental=False)
    try:
        for hook in ("metrics", "reports", "checkpointer"):
            with pytest.raises(NotImplementedError, match="next slice"):
                P.scheduler.Scheduler(w.db, w.jobdb, w.scheduler.algo, w.publisher,
                                      P.scheduler.StandaloneLeaderController(), w.config,
                                      **{hook: object()})
        with pytest.raises(NotImplementedError, match="next slice"):
            P.schedulerdb.SchedulerDb("postgres://localhost/armada")
    finally:
        w.close()


@pytest.mark.parametrize("local", [False, True], ids=["sortedcontainers", "local"])
def test_jobdb_commit_orders_queues_as_the_jax_package(local, monkeypatch):
    """A commit adds its queued jobs to each queue's ordered set in one
    update (the port's bulk index; with either sorted list) in the order
    the JAX package's one-by-one adds give, across several commits."""
    import numpy as np

    import armada_tpu.core.config as jc
    import armada_tpu.core.types as jt
    import armada_tpu.jobdb.job as jj
    import armada_tpu.jobdb.jobdb as jdb_mod
    import armada_tpu_torch.core.config as tc
    import armada_tpu_torch.core.types as tt
    import armada_tpu_torch.jobdb.job as tj
    import armada_tpu_torch.jobdb.jobdb as tdb_mod
    from armada_tpu_torch.jobdb import _sortedlist

    if local:
        monkeypatch.setattr(tdb_mod, "SortedKeyList", _sortedlist.SortedKeyList)
        monkeypatch.setattr(_sortedlist, "_LOAD", 16)

    def orders(C, T, J, D):
        cfg = C.SchedulingConfig()
        f = cfg.resource_list_factory()
        rng = np.random.default_rng(3)
        db = D.JobDb(cfg)
        out = []
        for batch in (300, 5, 40, 700):
            txn = db.write_txn()
            for i in range(batch):
                spec = T.JobSpec(id=f"j{rng.integers(0, 2000):05d}", queue=f"q{rng.integers(0, 3)}",
                                 priority=int(rng.integers(0, 4)),
                                 submit_time=float(rng.integers(0, 50)),
                                 resources=f.from_mapping({"cpu": "1"}))
                txn.upsert(J.Job(spec=spec, queued=bool(rng.random() < 0.8), validated=True))
            for _ in range(20):
                txn.delete(f"j{rng.integers(0, 2000):05d}")
            txn.commit()
            read = db.read_txn()
            out.append({q: [j.id for j in read.queued_jobs(q)] for q in ("q0", "q1", "q2")})
        return out

    assert orders(tc, tt, tj, tdb_mod) == orders(jc, jt, jj, jdb_mod)
