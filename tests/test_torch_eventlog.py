"""The port's event log + publisher/consumer: durability, ordering, fencing.

The twins of tests/test_eventlog.py against armada_tpu_torch.eventlog (its
own copy of eventlog.cc, built with g++ at first use), and the two
packages' logs held against each other: each reads a log directory that
the other wrote, with equal positions, keys and payloads.
"""

import os

import pytest

from armada_tpu_torch.eventlog import (
    Consumer,
    EventLog,
    Publisher,
    jobset_key,
    partition_for_key,
    wait_for_markers,
)
from armada_tpu_torch.events import schema as pb


def submit_seq(queue, jobset, job_ids):
    return pb.EventSequence(
        queue=queue,
        jobset=jobset,
        events=[
            pb.Event(submit_job=pb.SubmitJob(job_id=j, spec=pb.JobSpec()))
            for j in job_ids
        ],
    )


def test_append_read_roundtrip(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=2) as log:
        o1 = log.append(0, b"k1", b"hello")
        o2 = log.append(0, b"k2", b"world")
        assert o2 > o1
        msgs = log.read(0, 0)
        assert [(m.key, m.payload) for m in msgs] == [(b"k1", b"hello"), (b"k2", b"world")]
        assert msgs[0].offset == o1 and msgs[1].offset == o2
        # Reading from the second record's offset skips the first.
        assert [m.payload for m in log.read(0, o2)] == [b"world"]
        assert log.read(1, 0) == []


def test_persistence_across_reopen(tmp_path):
    path = str(tmp_path / "log")
    with EventLog(path, num_partitions=1) as log:
        log.append(0, b"k", b"v1")
        log.append(0, b"k", b"v2")
        log.flush()
        end = log.end_offset(0)
    with EventLog(path, num_partitions=1) as log:
        assert log.end_offset(0) == end
        assert [m.payload for m in log.read(0, 0)] == [b"v1", b"v2"]


def test_torn_tail_truncated_on_reopen(tmp_path):
    path = str(tmp_path / "log")
    with EventLog(path, num_partitions=1) as log:
        log.append(0, b"k", b"complete")
        log.flush()
        good_end = log.end_offset(0)
    # Simulate a crash mid-write: garbage partial record at the tail.
    with open(os.path.join(path, "p0.log"), "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")
    with EventLog(path, num_partitions=1) as log:
        assert log.end_offset(0) == good_end
        assert [m.payload for m in log.read(0, 0)] == [b"complete"]
        # And appends continue cleanly after recovery.
        log.append(0, b"k", b"after")
        assert [m.payload for m in log.read(0, 0)] == [b"complete", b"after"]


def test_publisher_routes_by_jobset_and_chunks(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=4) as log:
        publisher = Publisher(log, max_events_per_message=10)
        seq = submit_seq("q1", "js1", [f"j{i}" for i in range(25)])
        refs = publisher.publish([seq])
        # 25 events at <=10/message -> 3 chunks, all on the jobset's partition.
        part = partition_for_key(jobset_key("q1", "js1"), 4)
        assert len(refs) == 3
        assert all(r.partition == part for r in refs)
        msgs = log.read(part, 0)
        sizes = [len(pb.EventSequence.FromString(m.payload).events) for m in msgs]
        assert sizes == [10, 10, 5]
        # Chunks preserve job order.
        ids = [
            e.submit_job.job_id
            for m in msgs
            for e in pb.EventSequence.FromString(m.payload).events
        ]
        assert ids == [f"j{i}" for i in range(25)]


def test_consumer_positions_and_ack(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=2) as log:
        publisher = Publisher(log)
        publisher.publish([submit_seq("qa", "js-a", ["a1"])])
        publisher.publish([submit_seq("qb", "js-b", ["b1"])])
        consumer = Consumer(log)
        batch = consumer.poll()
        got = {e.submit_job.job_id for s in batch.sequences for e in s.events}
        assert got == {"a1", "b1"}
        # Without ack, poll returns the same data (at-least-once).
        again = consumer.poll()
        assert {e.submit_job.job_id for s in again.sequences for e in s.events} == got
        consumer.ack(batch.next_positions)
        assert consumer.poll().sequences == []
        assert consumer.caught_up()
        # New data resumes from the stored positions.
        publisher.publish([submit_seq("qa", "js-a", ["a2"])])
        batch2 = consumer.poll()
        assert [
            e.submit_job.job_id for s in batch2.sequences for e in s.events
        ] == ["a2"]


def test_marker_fencing(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=3) as log:
        publisher = Publisher(log)
        publisher.publish([submit_seq("q", "js", ["before"])])
        group = publisher.publish_markers()
        publisher.publish([submit_seq("q", "js2", ["after"])])
        fenced = wait_for_markers({}, log, group)
        assert set(fenced) == {0, 1, 2}
        # Everything before the fence is at offsets < fenced position.
        consumer = Consumer(log)
        batch = consumer.poll()
        for msg, seq in zip(batch.messages, batch.sequences):
            for ev in seq.events:
                if ev.WhichOneof("event") == "submit_job":
                    if ev.submit_job.job_id == "before":
                        assert msg.offset < fenced[msg.partition]


def test_missing_marker_raises(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=1) as log:
        Publisher(log).publish([submit_seq("q", "js", ["x"])])
        with pytest.raises(TimeoutError):
            wait_for_markers({}, log, "no-such-group", timeout=0.1)


def test_partition_count_is_pinned(tmp_path):
    path = str(tmp_path / "log")
    with EventLog(path, num_partitions=4) as log:
        log.append(3, b"k", b"v")
    with pytest.raises(ValueError, match="4 partitions"):
        EventLog(path, num_partitions=2)


def test_oversized_record_read_grows_buffer(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=1) as log:
        big = b"x" * (1 << 16)
        log.append(0, b"k", big)
        msgs = log.read(0, 0, max_bytes=64)  # far smaller than the record
        assert len(msgs) == 1 and msgs[0].payload == big


def test_corrupt_body_detected(tmp_path):
    path = str(tmp_path / "log")
    with EventLog(path, num_partitions=1) as log:
        log.append(0, b"k", b"payload-one")
        log.append(0, b"k", b"payload-two")
        log.flush()
    # Flip a byte inside the first record's payload (below the recovered end).
    fpath = os.path.join(path, "p0.log")
    with open(fpath, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    # Reopen: MID-LOG corruption (more data after the bad record) is disk
    # damage, not crash residue -- silently truncating would vanish acked
    # records, so the open fails loudly instead (operator restores from a
    # replica or checkpoint).
    with pytest.raises(OSError, match="failed to open"):
        EventLog(path, num_partitions=1)


def test_torn_final_record_truncated_at_byte_boundary(tmp_path):
    """A crash mid-append tears the FINAL record at an arbitrary byte
    boundary; reopen must truncate exactly it and keep every prior record
    (the round-21 distinction: torn tail repairs, mid-log damage halts)."""
    path = str(tmp_path / "log")
    with EventLog(path, num_partitions=1) as log:
        log.append(0, b"k", b"first-record")
        good_end = log.end_offset(0)
        log.append(0, b"k", b"second-record-that-tears")
        torn_end = log.end_offset(0)
        log.flush()
    fpath = os.path.join(path, "p0.log")
    # Cut inside the last record's payload: the header is intact and sane,
    # but the declared extent runs past EOF.
    with open(fpath, "r+b") as f:
        f.truncate(torn_end - 7)
    with EventLog(path, num_partitions=1) as log:
        assert log.end_offset(0) == good_end
        assert [m.payload for m in log.read(0, 0)] == [b"first-record"]
        log.append(0, b"k", b"after-repair")
        assert [m.payload for m in log.read(0, 0)] == [
            b"first-record",
            b"after-repair",
        ]
    # A cut that leaves the full length but scrambles the final record's
    # trailing CRC bytes is the same crash shape (unordered sector loss):
    # still a tail repair, not a halt.
    with EventLog(path, num_partitions=1) as log:
        log.append(0, b"k", b"crc-torn")
        end = log.end_offset(0)
        log.flush()
    with open(fpath, "r+b") as f:
        f.seek(end - 2)
        f.write(b"\x00\x00")
    with EventLog(path, num_partitions=1) as log:
        assert [m.payload for m in log.read(0, 0)] == [
            b"first-record",
            b"after-repair",
        ]


def test_publish_does_not_mutate_input(tmp_path):
    with EventLog(str(tmp_path / "log"), num_partitions=1) as log:
        seq = submit_seq("q", "js", ["j1"])
        Publisher(log).publish([seq])
        assert seq.events[0].created_ns == 0  # caller's proto untouched
        stored = pb.EventSequence.FromString(log.read(0, 0)[0].payload)
        assert stored.events[0].created_ns > 0


# --- the two packages' logs against each other ------------------------------


def _sequences(P, n=40):
    """The same varied sequences in one package's schema module."""
    out = []
    for i in range(n):
        events = [P.Event(created_ns=i, submit_job=P.SubmitJob(
            job_id=f"job-{i}", spec=P.JobSpec(priority=i - 20, pools=["a"] * (i % 3))))]
        if i % 4 == 0:
            events.append(P.Event(created_ns=i, job_run_errors=P.JobRunErrors(
                job_id=f"job-{i}", run_id=f"run-{i}",
                errors=[P.Error(reason="x", terminal=bool(i % 8))])))
        if i % 7 == 0:
            events.append(P.Event(cancel_job_set=P.CancelJobSet(reason="r", states=["queued"])))
        out.append(P.EventSequence(queue=f"q{i % 3}", jobset=f"js{i % 5}", user_id="u",
                                   events=events))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_log_the_other_wrote(tmp_path, writer):
    import armada_tpu.eventlog as jel
    from armada_tpu.events import events_pb2 as jpb

    import armada_tpu_torch.eventlog as tel

    (W, Wpb), (R, Rpb) = ((jel, jpb), (tel, pb)) if writer == "jax" else ((tel, pb), (jel, jpb))
    path = str(tmp_path / "log")
    with W.EventLog(path, num_partitions=3) as log:
        publisher = W.Publisher(log, clock=lambda: 1000.0, max_events_per_message=2)
        refs = publisher.publish(_sequences(Wpb))
        publisher.publish_markers(group_id="g" * 32)
        log.append(1, b"raw-key", b"raw-payload")
        log.flush()
        written = [list(log.iter_from(p, 0)) for p in range(3)]
        ends = [log.end_offset(p) for p in range(3)]
    assert len(refs) > 40
    with R.EventLog(path) as log:  # adopts the persisted partition count
        assert log.num_partitions == 3
        assert [log.end_offset(p) for p in range(3)] == ends
        read = [list(log.iter_from(p, 0)) for p in range(3)]
        assert [[tuple(m) for m in ms] for ms in read] == [[tuple(m) for m in ms] for ms in written]
        consumer = R.Consumer(log, partitions=[0, 2])
        batch = consumer.poll()
        for seq, msg in zip(batch.sequences, batch.messages):
            assert seq.SerializeToString() == msg.payload
            assert seq == Rpb.EventSequence.FromString(msg.payload)
        assert R.partition_for_key(R.jobset_key("q1", "js3"), 3) == W.partition_for_key(
            W.jobset_key("q1", "js3"), 3)
        # The reader appends after the writer's records; the writer's package
        # reads them back.
        R.Publisher(log, clock=lambda: 2000.0).publish(_sequences(Rpb, 3))
        ends2 = [log.end_offset(p) for p in range(3)]
    with W.EventLog(path, num_partitions=3) as log:
        assert [log.end_offset(p) for p in range(3)] == ends2
        tail = [m for p in range(3) for m in log.iter_from(p, ends[p])]
        assert sorted(Wpb.EventSequence.FromString(m.payload).events[0].submit_job.job_id
                      for m in tail) == ["job-0", "job-1", "job-2"]


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compiler failure raises with its output: no Python fallback."""
    from armada_tpu_torch.eventlog import log as elog

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'no such compiler today' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(elog, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(elog, "_lib", None)
    with pytest.raises(RuntimeError, match="no such compiler today"):
        EventLog(str(tmp_path / "log"), num_partitions=1)
