"""Ingest-plane observability: per-consumer events/s + per-partition lag.

A process-global registry (the watchdog-supervisor / slo-recorder pattern):
each running ingestion pipeline -- serial or partition-parallel -- registers
an adapter; /healthz embeds the snapshot as its `ingest` block and
SchedulerMetrics mirrors it to prometheus
(armada_ingest_lag_bytes{consumer,partition},
armada_ingest_events_per_second{consumer}) with stale-label removal.

The rate is a decayed-impulse estimator (the Unix load-average shape): each
applied batch adds n/tau and the whole estimate decays exp(-dt/tau), so the
value converges to the true arrival rate without keeping per-event
timestamps.  All clocks are monotonic (ops/metrics.mono_now).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.ops.metrics import mono_now

log = logging.getLogger(__name__)


class RateEstimator:
    """Exponentially-decayed event rate (events/second)."""

    def __init__(self, tau_s: float = 30.0):
        self.tau_s = tau_s
        self._rate = 0.0
        self._last = mono_now()
        self._lock = make_lock("ingest.rate")

    def record(self, n: int) -> None:
        now = mono_now()
        with self._lock:
            dt = max(0.0, now - self._last)
            self._rate = self._rate * math.exp(-dt / self.tau_s) + n / self.tau_s
            self._last = now

    def value(self) -> float:
        now = mono_now()
        with self._lock:
            dt = max(0.0, now - self._last)
            return self._rate * math.exp(-dt / self.tau_s)


class IngestStatsRegistry:
    """consumer name -> snapshot callable of the pipeline serving it."""

    def __init__(self):
        self._lock = make_lock("ingest.stats")
        self._sources: dict[str, Callable[[], dict]] = {}
        # Snapshot exceptions per view: counted (the metrics layer exports
        # armada_ingest_stats_errors_total{consumer}) and logged once per
        # registered view -- a broken snapshot used to be swallowed
        # entirely, so a view could misreport forever in silence.
        self._errors: dict[str, int] = {}
        self._logged: set[str] = set()

    def register(self, consumer: str, snapshot_fn: Callable[[], dict]) -> None:
        with self._lock:
            self._sources[consumer] = snapshot_fn
            # A re-registered (restarted) view gets one fresh log line if it
            # breaks again; the error count keeps accumulating.
            self._logged.discard(consumer)

    def unregister(self, consumer: str, snapshot_fn: Callable[[], dict]) -> None:
        """Remove `consumer` only if it still points at `snapshot_fn` -- a
        stopped pipeline must not evict its replacement (restart races)."""
        with self._lock:
            if self._sources.get(consumer) is snapshot_fn:
                del self._sources[consumer]

    def error_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._errors)

    def snapshot(self) -> dict:
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for consumer, fn in sources.items():
            try:
                out[consumer] = fn()
            except Exception as exc:  # noqa: BLE001 - one broken view must
                out[consumer] = {"error": str(exc)}  # not hide the others
                with self._lock:
                    self._errors[consumer] = self._errors.get(consumer, 0) + 1
                    first = consumer not in self._logged
                    self._logged.add(consumer)
                if first:
                    log.exception(
                        "ingest stats snapshot failed for view %r "
                        "(logged once per registration; "
                        "armada_ingest_stats_errors_total counts repeats)",
                        consumer,
                    )
        return out


_registry: Optional[IngestStatsRegistry] = None
_registry_lock = make_lock("ingest.stats.global")


def registry() -> IngestStatsRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = IngestStatsRegistry()
        return _registry


def reset_registry() -> IngestStatsRegistry:
    """Fresh process-global registry (tests)."""
    global _registry
    with _registry_lock:
        _registry = IngestStatsRegistry()
        return _registry
