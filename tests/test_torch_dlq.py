"""The port's poison-record isolation (armada_tpu_torch/ingest/dlq.py).

The twins of tests/test_dlq.py's cases that need neither the partitioned
ingester, the metrics exporter nor the control plane (those come with the
next slice of the port), run against the port's modules:

- bisection quarantines EXACTLY the deterministic poison record (stage
  tagged decode/convert/render) while every environmental shape
  (all-records-fail, store-down) keeps retry-forever;
- the DLQ insert and the cursor advance share one store transaction: an
  ingest_ack crash between quarantine and ack neither loses the record
  nor double-dead-letters it;
- a poison '$control-plane' record is NEVER auto-skipped -- the consumer
  halts loudly until the operator verdict (discard approves the skip);
- the serial pipeline drains PAST a poison record, and `dlq replay` + a
  suffix drain restores bit-equality with a never-poisoned run.

The bounded Backoff cases are in tests/test_torch_slo_backoff.py.
"""

from __future__ import annotations

import os
import time

import pytest

from armada_tpu_torch.core.backoff import Backoff
from armada_tpu_torch.eventlog.log import EventLog
from armada_tpu_torch.eventlog.publisher import Publisher
from armada_tpu_torch.events import schema as pb
from armada_tpu_torch.ingest import dlq
from armada_tpu_torch.ingest.converter import convert_sequences
from armada_tpu_torch.ingest.schedulerdb import SNAPSHOT_TABLES, SchedulerDb

CONSUMER = "scheduler"


@pytest.fixture(autouse=True)
def _clean_dlq_state():
    saved = {
        k: os.environ.get(k)
        for k in ("ARMADA_FAULT", "ARMADA_INGEST_RETRIES")
    }
    dlq.reset_poison()
    dlq.reset_registry()
    yield
    dlq.reset_poison()
    dlq.reset_registry()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _seq(jid: str, queue: str = "q1", jobset: str = "js1") -> pb.EventSequence:
    return pb.EventSequence(
        queue=queue,
        jobset=jobset,
        events=[
            pb.Event(
                created_ns=1,
                submit_job=pb.SubmitJob(job_id=jid, spec=pb.JobSpec()),
            )
        ],
    )


def _publish(log, n: int, prefix: str = "job") -> list[str]:
    pub = Publisher(log)
    ids = [f"{prefix}-{i:04d}" for i in range(n)]
    for i, jid in enumerate(ids):
        pub.publish([_seq(jid, queue=f"q{i % 3}", jobset=f"js{i % 2}")])
    return ids


def _poisoning_converter(bad_ids):
    """convert_sequences, but deterministically refuses specific job ids
    (the poison signature: a pure function of the payload bytes)."""

    def conv(seqs):
        for s in seqs:
            for ev in s.events:
                if ev.HasField("submit_job") and ev.submit_job.job_id in bad_ids:
                    raise ValueError(f"poison {ev.submit_job.job_id}")
        return convert_sequences(seqs)

    return conv


def _isolate(log, sink, converter, *, renderer=None, stop_at_control=False):
    positions = {p: 0 for p in range(log.num_partitions)}
    positions.update(sink.positions(CONSUMER))
    return dlq.isolate_batch(
        log_=log,
        sink=sink,
        converter=converter,
        consumer=CONSUMER,
        partitions=list(range(log.num_partitions)),
        positions=positions,
        renderer=renderer,
        stop_at_control=stop_at_control,
    )


def _job_ids(db) -> set:
    return {r[0] for r in db.export_snapshot().get("jobs", [])}


def _caught_up(db, log) -> bool:
    pos = db.positions(CONSUMER)
    return all(
        pos.get(p, 0) >= log.end_offset(p) for p in range(log.num_partitions)
    )


# ---------------------------------------------------------------------------
# classification: poison vs environmental, stage attribution


def test_bisection_quarantines_exactly_the_poison_record(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2)
    ids = _publish(log, 8)
    db = SchedulerDb(str(tmp_path / "db.sqlite"))
    out = _isolate(log, db, _poisoning_converter({ids[3]}))
    assert not out.environmental and not out.halted
    assert out.dead == 1
    assert out.applied_sequences == 7
    assert _caught_up(db, log)  # the cursor is PAST the poison record
    assert _job_ids(db) == set(ids) - {ids[3]}
    rows = db.list_dead_letters(consumer=CONSUMER, status="dead")
    assert len(rows) == 1
    assert rows[0]["stage"] == "convert"
    full = db.get_dead_letter(
        CONSUMER, rows[0]["partition"], rows[0]["record_offset"]
    )
    assert ids[3].encode() in full["payload"]  # raw bytes preserved
    log.close()


def test_decode_stage_garbage_payload(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 2)
    log.append(0, b"k", b"\xff\xfenot-a-proto")
    log.flush()
    ids += _publish(log, 2, prefix="tail")
    db = SchedulerDb(str(tmp_path / "db.sqlite"))
    out = _isolate(log, db, convert_sequences)
    assert out.dead == 1 and out.applied_sequences == 4
    rows = db.list_dead_letters(consumer=CONSUMER)
    assert rows[0]["stage"] == "decode"
    assert _caught_up(db, log)
    log.close()


def test_render_stage_poison_with_fake_sink(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 4)

    class FakeSink:
        def __init__(self):
            self.stored: list = []
            self.dead: list = []
            self.pos: dict = {}

        def store(self, ops, consumer=None, next_positions=None):
            self.stored.extend(ops)
            self.pos.update(next_positions or {})

        def store_dead_letters(self, rows, consumer=None, next_positions=None):
            self.dead.extend(rows)
            self.pos.update(next_positions or {})

        def positions(self, consumer=None):
            return dict(self.pos)

    def renderer(seqs):
        for s in seqs:
            for ev in s.events:
                if ev.submit_job.job_id == ids[2]:
                    raise RuntimeError("render chokes")

    sink = FakeSink()
    out = dlq.isolate_batch(
        log_=log,
        sink=sink,
        converter=lambda seqs: seqs,  # identity: the renderer probes seqs
        consumer=CONSUMER,
        partitions=[0],
        positions={0: 0},
        renderer=renderer,
    )
    assert out.dead == 1
    assert sink.dead[0].stage == "render"
    assert len(sink.stored) == 3
    log.close()


def test_all_records_failing_is_environmental(tmp_path):
    """A broken converter build fails everything: nothing quarantined,
    retry-forever preserved."""
    log = EventLog(str(tmp_path / "log"), num_partitions=2)
    _publish(log, 6)
    db = SchedulerDb(str(tmp_path / "db.sqlite"))

    def broken(seqs):
        raise RuntimeError("bad build")

    out = _isolate(log, db, broken)
    assert out.environmental
    assert out.dead == 0 and out.applied_sequences == 0
    assert not out.new_positions
    assert db.list_dead_letters(consumer=CONSUMER) == []
    log.close()


def test_single_record_batch_poison_has_no_contrast(tmp_path):
    """total == 1: a deterministic pure-stage failure IS the poison
    signature (there is nothing to contrast against)."""
    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 1)
    db = SchedulerDb(str(tmp_path / "db.sqlite"))
    out = _isolate(log, db, _poisoning_converter(set(ids)))
    assert out.dead == 1 and not out.environmental
    assert _caught_up(db, log)
    log.close()


def test_store_down_is_environmental(tmp_path):
    """A store refusing even an empty transaction is environmental: abort
    the walk, quarantine nothing, keep retrying."""
    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    _publish(log, 4)
    db = SchedulerDb(str(tmp_path / "db.sqlite"))

    class DownSink:
        def store(self, ops, consumer=None, next_positions=None):
            raise ConnectionError("db down")

        def store_dead_letters(self, rows, consumer=None, next_positions=None):
            raise ConnectionError("db down")

        def positions(self, consumer=None):
            return {}

    out = dlq.isolate_batch(
        log_=log,
        sink=DownSink(),
        converter=convert_sequences,
        consumer=CONSUMER,
        partitions=[0],
        positions={0: 0},
    )
    assert out.environmental
    assert out.dead == 0
    log.close()


# ---------------------------------------------------------------------------
# the same-transaction contract (r11/r19 cursor-fence discipline)


def test_ingest_ack_crash_no_double_dead_letter_no_lost_record(tmp_path):
    """A crash between the quarantine txn and the in-memory ack replays
    the walk: INSERT OR IGNORE + the idempotent cursor upsert make the
    replay a no-op -- exactly one DLQ row, no record lost or re-applied."""
    from armada_tpu_torch.core.faults import FaultInjected

    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 6)
    db = SchedulerDb(str(tmp_path / "db.sqlite"))
    # after_n=1: the first ingest_ack check fires after the good-prefix
    # run commits; the SECOND lands exactly between the quarantine txn
    # and the in-memory ack -- the crash window under test
    os.environ["ARMADA_FAULT"] = "ingest_ack:raise:1"
    with pytest.raises(FaultInjected):
        _isolate(log, db, _poisoning_converter({ids[2]}))
    os.environ.pop("ARMADA_FAULT", None)
    # the quarantine COMMITTED before the crash: row and cursor are fenced
    rows = db.list_dead_letters(consumer=CONSUMER, status="dead")
    assert len(rows) == 1
    # the retry loop re-runs isolation from committed positions
    out = _isolate(log, db, _poisoning_converter({ids[2]}))
    assert not out.environmental
    assert _caught_up(db, log)
    rows = db.list_dead_letters(consumer=CONSUMER, status="dead")
    assert len(rows) == 1, "double dead-letter after crash replay"
    assert _job_ids(db) == set(ids) - {ids[2]}, "lost or duplicated record"
    log.close()


# ---------------------------------------------------------------------------
# control-plane records: never auto-skipped


def test_poison_control_record_halts_until_operator_verdict(tmp_path):
    from armada_tpu_torch.ingest.shards import _CONTROL_KEY

    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 2)
    log.append(0, _CONTROL_KEY, b"\xff\xfegarbage-control")
    log.flush()
    tail = _publish(log, 2, prefix="tail")
    db = SchedulerDb(str(tmp_path / "db.sqlite"))

    out = _isolate(log, db, convert_sequences)
    assert out.halted and not out.environmental
    assert out.dead == 0, "a control record must NEVER be auto-skipped"
    assert out.applied_sequences == 2  # the prefix before the halt commits
    halts = dlq.registry().control_halts()
    assert CONSUMER in halts
    part, off = halts[CONSUMER]["partition"], halts[CONSUMER]["record_offset"]
    # the cursor parks BEFORE the poison control record
    assert db.positions(CONSUMER)[part] <= off

    # re-running without a verdict stays halted (loud, no progress)
    out2 = _isolate(log, db, convert_sequences)
    assert out2.halted and out2.dead == 0

    # the operator verdict: discard approves the skip, the record
    # quarantines on the next pass and the consumer drains to the end
    admin = dlq.DlqAdmin(log, {CONSUMER: db})
    verdict = admin.discard(f"{CONSUMER}:{part}:{off}")
    assert verdict.get("control_skip_approved")
    out3 = _isolate(log, db, convert_sequences)
    assert out3.dead == 1 and not out3.halted
    assert _caught_up(db, log)
    assert dlq.registry().control_halts() == {}
    assert _job_ids(db) == set(ids) | set(tail)
    log.close()


def test_healthy_control_record_parks_sharded_walk(tmp_path):
    """stop_at_control=True (the sharded mode): a HEALTHY control record
    ends isolation so the barrier path keeps its ordering."""
    from armada_tpu_torch.ingest.shards import _CONTROL_KEY

    log = EventLog(str(tmp_path / "log"), num_partitions=1)
    ids = _publish(log, 2)
    log.append(0, _CONTROL_KEY, _seq("ctl-0000").SerializeToString())
    log.flush()
    _publish(log, 2, prefix="tail")
    db = SchedulerDb(str(tmp_path / "db.sqlite"))
    out = _isolate(log, db, convert_sequences, stop_at_control=True)
    assert not out.halted
    assert out.applied_sequences == 2  # parked at the control record
    assert _job_ids(db) == set(ids)
    log.close()


# ---------------------------------------------------------------------------
# the serving pipelines: wedge-proof drain + operator replay round-trip


def _materialized(db) -> dict:
    """Bit-equality surface: dead_letters excluded (the poisoned arm
    carries 'replayed' rows), consumer_positions excluded (replay appends
    the raw record, so the cursor ends further), serials scrubbed."""
    snap = db.export_snapshot()
    out = {}
    for table, cols in SNAPSHOT_TABLES.items():
        if table in ("serials", "dead_letters", "consumer_positions"):
            continue
        rows = snap.get(table, [])
        if "serial" in cols:
            i = cols.index("serial")
            rows = [r[:i] + r[i + 1 :] for r in rows]
        out[table] = sorted(rows)
    return out


def _drain_with_poison_then_replay(tmp_path):
    from armada_tpu_torch.core import faults

    log = EventLog(str(tmp_path / "log"), num_partitions=4)
    _publish(log, 24)

    clean = SchedulerDb(str(tmp_path / "clean.sqlite"))
    from armada_tpu_torch.ingest.pipeline import IngestionPipeline

    IngestionPipeline(log, clean, convert_sequences, CONSUMER).run_until_caught_up()
    want = _materialized(clean)

    db = SchedulerDb(str(tmp_path / "poisoned.sqlite"))
    os.environ["ARMADA_INGEST_RETRIES"] = "2"
    os.environ["ARMADA_FAULT"] = "convert_record:raise"
    faults.reset_counters()
    pipe = IngestionPipeline(
        log, db, convert_sequences, CONSUMER, poll_interval=0.02
    )
    pipe.start()
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not _caught_up(db, log):
            time.sleep(0.02)
        # wedge-proof: bounded retries escalated to bisection and the
        # pipeline drained PAST the poison record
        assert _caught_up(db, log), "pipeline wedged on the poison record"
        dead = db.list_dead_letters(consumer=CONSUMER, status="dead")
        assert len(dead) >= 1

        # operator fix: disarm, clear the latch, replay the raw bytes
        os.environ.pop("ARMADA_FAULT", None)
        dlq.reset_poison()
        rep = dlq.DlqAdmin(log, {CONSUMER: db}).replay(CONSUMER)
        assert rep["replayed"] >= 1
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not _caught_up(db, log):
            time.sleep(0.02)
        assert _caught_up(db, log)
    finally:
        pipe.stop()
    assert _materialized(db) == want
    assert all(
        r["status"] == "replayed"
        for r in db.list_dead_letters(consumer=CONSUMER)
    )
    log.close()


def test_serial_pipeline_drains_past_poison_and_replay_restores(tmp_path):
    _drain_with_poison_then_replay(tmp_path)


def test_registry_snapshot():
    reg = dlq.registry()
    reg.note_dead_letter("scheduler", 2)
    reg.note_dead_letter("scheduler", 2)
    reg.note_dead_letter("lookout", 0)
    reg.note_batch_retry("scheduler")
    snap = reg.snapshot()
    assert snap["dead_letters_total"] == 3
    assert snap["dead_letters_by_partition"]["scheduler"]["2"] == 2
    assert snap["batch_retries"]["scheduler"] == 1
