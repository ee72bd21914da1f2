"""Publisher / Consumer over the native event log.

Equivalent surface to the reference's Pulsar plumbing:
  * `Publisher.publish` routes an EventSequence to a partition by hash of its
    (queue, jobset) key, chunking big sequences by max-events-per-message
    (internal/common/pulsarutils jobsetevents key routing + chunking,
    internal/scheduler/publisher.go:25-60).
  * `Publisher.publish_markers` writes one PartitionMarker to EVERY partition;
    a consumer that has seen all markers of a group knows it is read-fenced up
    to the publish point (publisher.go PublishMarkers:30-33,
    scheduler.go ensureDbUpToDate:1120).
  * `Consumer` tracks a per-partition position (byte offset); callers persist
    positions as their high-water mark (each materialized view's
    checkpoint/resume story, SURVEY.md section 5).
"""

from __future__ import annotations

import time
import uuid
import zlib
from typing import Callable, Iterable, NamedTuple, Optional, Sequence

from armada_tpu_torch.eventlog.log import EventLog, Message
from armada_tpu_torch.events import schema as pb


MARKER_KEY = b"\x00marker"


def jobset_key(queue: str, jobset: str) -> bytes:
    return f"{queue}/{jobset}".encode()


def partition_for_key(key: bytes, num_partitions: int) -> int:
    # Stable across processes (unlike hash()), cheap, uniform enough.
    return zlib.crc32(key) % num_partitions


class PublishedRef(NamedTuple):
    partition: int
    offset: int


class NotLeader(RuntimeError):
    """Publish rejected: this replica's log is a replica, not the log of
    record (cross-host HA).  Carries the leader's advertised address; the
    gRPC layer maps it to the retryable UNAVAILABLE."""

    def __init__(self, leader_address: str = ""):
        super().__init__(
            "not the leader"
            + (f"; leader at {leader_address}" if leader_address else "")
        )
        self.leader_address = leader_address


class DeposedEpoch(NotLeader):
    """Publish rejected by the epoch fence: the election record has moved
    past the generation this process last led at -- a successor exists, so
    appending here would fork the log its replicator is about to become a
    follower of.  Subclasses NotLeader so transports keep answering the
    retryable UNAVAILABLE."""

    def __init__(self, held: int, current: int):
        super().__init__()
        self.args = (
            f"deposed: publishing at epoch {held} but the election record "
            f"is at {current}",
        )
        self.held = held
        self.current = current


class Publisher:
    """Routes EventSequences to log partitions; the only write path to the log."""

    def __init__(
        self,
        log: EventLog,
        max_events_per_message: int = 1000,
        clock: Callable[[], float] = time.time,
    ):
        self._log = log
        self._max_events = max_events_per_message
        self._clock = clock
        # Replicated deployments (serve --replicate-log): () -> None (may
        # write) | leader address (must not).  Checked on EVERY publish --
        # this is the single choke point, so a follower's ExecutorApi /
        # ExecutorAdmin / queue-CRUD handlers can never append locally and
        # fork the log their replicator is tailing.
        self.write_gate = None
        # Epoch fence (elected deployments): `epoch_source` peeks the
        # election record's monotonic generation; `set_epoch` records the
        # generation this process last held leadership at (the scheduler
        # stamps it every leader cycle).  A publish whose held epoch is
        # older than the record's current one is from a DEPOSED leader --
        # rejected even if the write_gate's cached leadership view has not
        # caught up yet.  Both the address gate and the epoch fence sit on
        # this one choke point every append path shares.
        self.epoch_source = None
        self._epoch: Optional[int] = None
        # Publish wakeups (round 18): consumers register a callback fired
        # AFTER the batch is durably appended+fsynced, with the set of
        # partitions touched -- the ingestion pipelines' replacement for
        # their fixed idle poll (a shard sleeps until its partitions have
        # data, and wakes the instant they do).  Callbacks must be cheap and
        # non-raising; a slow hook would sit on every publish path.
        self._wakeups: list[Callable[[set], None]] = []

    def add_wakeup(self, hook: Callable[[set], None]) -> None:
        """Register a post-publish hook: hook(partitions_touched)."""
        self._wakeups.append(hook)

    def remove_wakeup(self, hook: Callable[[set], None]) -> None:
        try:
            self._wakeups.remove(hook)
        except ValueError:
            pass

    def _fire_wakeups(self, partitions: set) -> None:
        for hook in self._wakeups:
            try:
                hook(partitions)
            except Exception:  # noqa: BLE001 - a broken consumer must not
                pass  # fail the publish (the data is already durable)

    def set_epoch(self, generation: int) -> None:
        """Record the election generation this process currently leads at."""
        self._epoch = int(generation)

    def _check_fences(self) -> None:
        if self.write_gate is not None:
            leader = self.write_gate()
            if leader is not None:
                raise NotLeader(leader)
        if self.epoch_source is not None and self._epoch is not None:
            current = int(self.epoch_source())
            if current > self._epoch:
                raise DeposedEpoch(self._epoch, current)

    def publish(self, sequences: Iterable[pb.EventSequence]) -> list[PublishedRef]:
        """Append sequences (chunked) to their jobset partitions, then fsync."""
        self._check_fences()
        # Fault drill (core/faults): BEFORE any append, so an injected
        # publish failure is all-or-nothing -- the scheduler's
        # abort-on-publish-failure discipline (txn abort + cursor rewind)
        # is what the drill exercises, not partial-append recovery.
        from armada_tpu_torch.core import faults

        faults.check("eventlog_publish")
        refs: list[PublishedRef] = []
        for seq in sequences:
            key = jobset_key(seq.queue, seq.jobset)
            part = partition_for_key(key, self._log.num_partitions)
            now_ns = int(self._clock() * 1e9)
            # Stamp timestamps on a copy: the caller's proto stays untouched
            # (it may be retained for retries/comparison).
            stamped = pb.EventSequence()
            stamped.CopyFrom(seq)
            for ev in stamped.events:
                if ev.created_ns == 0:
                    ev.created_ns = now_ns
            for chunk in self._chunks(stamped):
                off = self._log.append(part, key, chunk.SerializeToString())
                refs.append(PublishedRef(part, off))
        self._log.flush()
        if refs:
            self._fire_wakeups({r.partition for r in refs})
        return refs

    def publish_markers(self, group_id: Optional[str] = None) -> str:
        """Write one PartitionMarker to every partition; returns the group id."""
        self._check_fences()  # markers are appends too: same fences
        group_id = group_id or uuid.uuid4().hex
        now_ns = int(self._clock() * 1e9)
        for part in range(self._log.num_partitions):
            seq = pb.EventSequence(
                queue="",
                jobset="",
                events=[
                    pb.Event(
                        created_ns=now_ns,
                        partition_marker=pb.PartitionMarker(
                            group_id=group_id, partition=part
                        ),
                    )
                ],
            )
            self._log.append(part, MARKER_KEY, seq.SerializeToString())
        self._log.flush()
        self._fire_wakeups(set(range(self._log.num_partitions)))
        return group_id

    def _chunks(self, seq: pb.EventSequence) -> Iterable[pb.EventSequence]:
        if len(seq.events) <= self._max_events:
            yield seq
            return
        for i in range(0, len(seq.events), self._max_events):
            chunk = pb.EventSequence(
                queue=seq.queue,
                jobset=seq.jobset,
                user_id=seq.user_id,
                groups=seq.groups,
            )
            chunk.events.extend(seq.events[i : i + self._max_events])
            yield chunk


class ConsumedBatch(NamedTuple):
    sequences: list[pb.EventSequence]
    # Positions to persist AFTER the batch is durably applied (ack semantics).
    next_positions: dict[int, int]
    messages: list[Message]


class Consumer:
    """A positioned reader over all partitions.

    `poll` returns decoded sequences plus the positions that become the new
    high-water mark once the caller has stored the batch -- the at-least-once
    consume -> convert -> store -> ack shape of the reference's
    IngestionPipeline (internal/common/ingest/ingestion_pipeline.go:40-79).
    """

    def __init__(
        self,
        log: EventLog,
        positions: Optional[dict[int, int]] = None,
        partitions: Optional[Sequence[int]] = None,
    ):
        """`partitions`: restrict this consumer to a subset of the log's
        partitions (a shard of the partition-parallel ingestion plane,
        ingest/shards.py); None = all of them (the serial pipeline)."""
        self._log = log
        self.partitions: tuple[int, ...] = tuple(
            range(log.num_partitions) if partitions is None else partitions
        )
        self.positions: dict[int, int] = {p: 0 for p in self.partitions}
        if positions:
            self.positions.update(
                {p: v for p, v in positions.items() if p in self.positions}
            )

    def poll(self, max_bytes_per_partition: int = 1 << 22) -> ConsumedBatch:
        sequences: list[pb.EventSequence] = []
        messages: list[Message] = []
        next_positions = dict(self.positions)
        for part in self.partitions:
            batch = self._log.read(
                part, self.positions[part], max_bytes=max_bytes_per_partition
            )
            for msg in batch:
                sequences.append(pb.EventSequence.FromString(msg.payload))
                messages.append(msg)
            if batch:
                next_positions[part] = batch[-1].next_offset
        return ConsumedBatch(sequences, next_positions, messages)

    def ack(self, next_positions: dict[int, int]) -> None:
        self.positions.update(next_positions)

    def caught_up(self) -> bool:
        return all(
            self.positions[p] >= self._log.end_offset(p)
            for p in self.partitions
        )


def wait_for_markers(
    consumer_positions: dict[int, int],
    log: EventLog,
    group_id: str,
    timeout: float = 10.0,
    poll_interval: float = 0.05,
) -> dict[int, int]:
    """Scan forward from `consumer_positions` until the marker of `group_id` is
    found in every partition, polling (up to `timeout`) for markers that are
    still in flight; returns positions just past each marker.  Used by a
    recovering scheduler to fence its reads (scheduler.go:1120)."""
    fenced: dict[int, int] = {}
    scan_from = {
        part: consumer_positions.get(part, 0) for part in range(log.num_partitions)
    }
    deadline = time.monotonic() + timeout
    while True:
        for part in range(log.num_partitions):
            if part in fenced:
                continue
            for msg in log.iter_from(part, scan_from[part]):
                # Markers carry a distinguished key, so the (possibly huge)
                # event backlog is skipped without proto-decoding it.
                if msg.key == MARKER_KEY:
                    seq = pb.EventSequence.FromString(msg.payload)
                    if any(
                        ev.WhichOneof("event") == "partition_marker"
                        and ev.partition_marker.group_id == group_id
                        for ev in seq.events
                    ):
                        fenced[part] = msg.next_offset
                        break
                scan_from[part] = msg.next_offset
        if len(fenced) == log.num_partitions:
            return fenced
        if time.monotonic() >= deadline:
            missing = sorted(set(scan_from) - set(fenced))
            raise TimeoutError(
                f"marker {group_id} not found in partitions {missing} "
                f"within {timeout}s"
            )
        time.sleep(poll_interval)
