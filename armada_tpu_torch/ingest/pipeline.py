"""Generic ingestion pipeline: consume -> convert -> store -> ack.

Equivalent of the reference's ingest.IngestionPipeline generics
(internal/common/ingest/ingestion_pipeline.go:40-79), reused by all three
ingesters there (scheduler PG / lookout PG / Redis events).  Here the sink
stores data AND the consumer position in one transaction (see SchedulerDb),
so a crash between store and ack cannot double-apply.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Protocol

from armada_tpu_torch.eventlog import Consumer, EventLog
from armada_tpu_torch.events import schema as pb


class Sink(Protocol):
    def store(self, batch_ops, consumer: str, next_positions: dict[int, int]) -> None:
        ...


def ingest_retries(default: int = 3) -> Optional[int]:
    """Full-batch retries before the loop escalates to poison isolation
    (ingest/dlq.py).  ARMADA_INGEST_RETRIES overrides; <= 0 = unbounded,
    the pre-round-21 wedge-prone behavior kept as an escape hatch."""
    try:
        n = int(os.environ.get("ARMADA_INGEST_RETRIES", default))
    except ValueError:
        return default
    return None if n <= 0 else n


class IngestionPipeline:
    """Polls the event log, converts batches, stores them transactionally.

    `converter(sequences) -> batch` produces whatever the sink stores (DbOps
    for the scheduler DB, rows for lookout, stream entries for the event API).
    """

    def __init__(
        self,
        log: EventLog,
        sink: Sink,
        converter: Callable[[list[pb.EventSequence]], object],
        consumer_name: str,
        start_positions: dict[int, int] | None = None,
        poll_interval: float = 0.05,
    ):
        self.consumer_name = consumer_name
        self._log = log
        self._consumer = Consumer(log, positions=start_positions)
        self._sink = sink
        self._converter = converter
        self._poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Publisher wakeup (Publisher.add_wakeup -> notify): the idle loop
        # sleeps on this instead of burning the fixed poll interval; the
        # interval remains the fallback for writers that bypass the
        # publisher (the log replicator on follower replicas).
        self._wakeup = threading.Event()
        self._abandoned = 0
        from armada_tpu_torch.ingest.stats import RateEstimator

        self._rate = RateEstimator()
        self._total_events = 0
        self._total_sequences = 0
        # One stable bound-method object: the stats registry unregisters by
        # identity, and `self.snapshot` creates a fresh object per access.
        self._stats_snapshot = self.snapshot

    def notify(self, partitions: set) -> None:
        """Publisher-side wakeup hook (any partition: one consumer)."""
        self._wakeup.set()

    def run_once(self) -> int:
        """One consume->convert->store->ack round; returns #sequences applied."""
        from armada_tpu_torch.core import faults

        batch = self._consumer.poll()
        if not batch.sequences:
            return 0
        # Poison drill hook (ARMADA_FAULT=convert_record): armed-only -- the
        # production cost is one falsy check.
        from armada_tpu_torch.ingest import dlq

        if dlq.poison_armed():
            dlq.poison_check([m.payload for m in batch.messages])
        converted = self._converter(batch.sequences)
        self._sink.store(
            converted,
            consumer=self.consumer_name,
            next_positions=batch.next_positions,
        )
        # Crash drill: die between the batch's transactional commit (data +
        # cursor advance together) and the in-memory ack.  Exactly-once must
        # hold EITHER WAY: a restarted pipeline resumes from the store's
        # committed positions, and a surviving in-process consumer that
        # re-polls the same batch re-stores it idempotently (INSERT OR
        # IGNORE / monotonic marks) with the same cursor values.
        faults.check("ingest_ack")
        self._consumer.ack(batch.next_positions)
        self._total_sequences += len(batch.sequences)
        n_events = sum(len(s.events) for s in batch.sequences)
        self._total_events += n_events
        self._rate.record(n_events)
        return len(batch.sequences)

    def run_until_caught_up(self, max_rounds: int = 1_000_000) -> int:
        total = 0
        for _ in range(max_rounds):
            n = self.run_once()
            total += n
            if n == 0 and self._consumer.caught_up():
                return total
        return total

    # --- background service mode -------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("pipeline already started")
        from armada_tpu_torch.ingest.stats import registry as stats_registry

        # A FRESH stop event per start, captured by the loop: an abandoned
        # (timed-out) thread from a previous start keeps observing ITS
        # event -- still set -- and exits when it unwedges, instead of
        # being resurrected by this clear.
        self._stop = threading.Event()
        stats_registry().register(self.consumer_name, self._stats_snapshot)
        self._thread = threading.Thread(
            target=self._loop,
            args=(self._stop,),
            daemon=True,
            name=f"ingest-{self.consumer_name}",
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Bounded join (the watchdog's abandon discipline): a store wedged
        on a dead database must not block SIGTERM drain forever -- log the
        abandon and let the daemon thread die with the process.  Positions
        were not acked, so nothing is lost either way."""
        from armada_tpu_torch.core.logging import get_logger
        from armada_tpu_torch.ingest.stats import registry as stats_registry

        self._stop.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=max(0.0, timeout_s))
            if self._thread.is_alive():
                self._abandoned += 1
                get_logger(__name__).warning(
                    "ingestion pipeline %s did not stop within %.1fs; "
                    "abandoning the thread",
                    self.consumer_name,
                    timeout_s,
                )
            self._thread = None
        stats_registry().unregister(self.consumer_name, self._stats_snapshot)

    def alive(self) -> bool:
        """True while the background loop is running (feeds health checks)."""
        return self._thread is not None and self._thread.is_alive()

    def snapshot(self) -> dict:
        """The /healthz `ingest` block entry for this consumer (the serial
        shape of PartitionedIngestionPipeline.snapshot)."""
        lag = {
            p: max(0, self._log.end_offset(p) - self._consumer.positions[p])
            for p in self._consumer.partitions
        }
        return {
            "shards": 1,
            "alive": self.alive() if self._thread is not None else None,
            "offload": False,
            "events_per_s": round(self._rate.value(), 1),
            "total_events": self._total_events,
            "total_sequences": self._total_sequences,
            "lag_bytes": {str(p): v for p, v in sorted(lag.items())},
            "lag_total": sum(lag.values()),
            "abandoned_threads": self._abandoned,
        }

    def _loop(self, stop: threading.Event) -> None:
        from armada_tpu_torch.core.logging import get_logger, log_context

        with log_context(consumer=self.consumer_name):
            self._loop_inner(get_logger(__name__), stop)

    def _loop_inner(self, log, stop: threading.Event) -> None:
        from armada_tpu_torch.core.backoff import Backoff
        from armada_tpu_torch.ingest import dlq

        # Jittered exponential backoff on batch failures (a restarting
        # external DB would otherwise see every pipeline retry in lockstep
        # at the same instant); positions were not acked, so the batch
        # replays exactly-once when the store recovers.  The schedule is
        # BOUNDED: exhaustion escalates to poison isolation (ingest/dlq.py)
        # instead of wedging behind one bad record forever; isolation
        # itself preserves retry-forever for environmental faults.
        backoff = Backoff(
            base_s=self._poll_interval,
            cap_s=5.0,
            max_attempts=ingest_retries(),
        )
        while not stop.is_set():
            try:
                n = self.run_once()
                backoff.reset()
            except Exception:  # noqa: BLE001 - service thread must survive
                if stop.is_set():
                    break  # teardown (a closing sink), not a failure
                dlq.registry().note_batch_retry(self.consumer_name)
                delay = backoff.next_delay()
                log.exception(
                    "ingestion pipeline %s: batch failed (attempt %d); "
                    "retrying in %.2fs",
                    self.consumer_name,
                    backoff.attempts,
                    delay,
                )
                if backoff.exhausted():
                    progressed = self._isolate(log)
                    backoff.reset()
                    if progressed:
                        continue
                stop.wait(delay)
                continue
            if n == 0:
                # Idle: sleep on the publish wakeup with the poll interval
                # as the fallback (replicated followers append without the
                # publisher, so the timeout still bounds their lag).
                self._wakeup.wait(self._poll_interval)
                self._wakeup.clear()

    def _isolate(self, log) -> bool:
        """Bounded retries exhausted: hand the stuck batch to the poison
        isolation engine.  Returns True when it made progress (stored good
        runs and/or quarantined poison) -- the loop then resumes without
        the backoff sleep.  A sink without a dead-letter surface keeps the
        plain retry-forever loop."""
        from armada_tpu_torch.ingest import dlq

        if not hasattr(self._sink, "store_dead_letters"):
            return False
        try:
            out = dlq.isolate_batch(
                log_=self._log,
                sink=self._sink,
                converter=self._converter,
                consumer=self.consumer_name,
                partitions=self._consumer.partitions,
                positions=dict(self._consumer.positions),
            )
        except Exception:  # noqa: BLE001 - isolation is best-effort;
            log.exception(  # the retry loop survives either way
                "ingestion pipeline %s: poison isolation failed; "
                "keeping plain retries",
                self.consumer_name,
            )
            return False
        if out.new_positions:
            self._consumer.ack(out.new_positions)
        if out.applied_sequences:
            self._total_sequences += out.applied_sequences
            self._total_events += out.applied_events
            self._rate.record(out.applied_events)
        return out.progressed
