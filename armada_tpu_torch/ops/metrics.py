"""Streaming metrics primitives: log-bucketed histograms and a small registry.

The port's copy of the JAX package's ops/metrics.py.  :class:`LogHistogram`
is O(1) per record, O(buckets) memory, mergeable and readable as JSON:
geometric buckets between ``lo`` and ``hi`` (HDR-histogram style), with
exact rank-based percentile semantics.  The cycle trace recorder
(ops/trace.py) keeps its per-stage latency distributions in them.

Clock discipline: latency math here never reads a wall clock, which skews
across hosts and steps backwards under NTP.  Every clock read goes through
:func:`mono_now`, the single named monotonic source.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from armada_tpu_torch.analysis.tsan import make_lock


def mono_now() -> float:
    """The ONE clock latency code reads: monotonic seconds, meaningful only
    as differences within this process."""
    return time.monotonic()


class LogHistogram:
    """Log-bucketed streaming histogram: O(1) record, fixed memory.

    Buckets are geometric: edges[i] = lo * growth**i for i in [0, n); a
    value lands in the first bucket whose upper edge is >= value
    (np.searchsorted(edges, v, side="left") semantics, shared verbatim with
    the numpy oracle so percentile math is EXACT, not approximately equal).
    Values <= lo fall in bucket 0, values >= hi clamp to the last bucket --
    the histogram never drops a sample, it only loses resolution at the
    extremes (true min/max are tracked exactly alongside).

    ``quantile(q)`` is rank-based: the representative (upper edge) of the
    bucket holding the ceil(q*n)-th smallest recorded sample.  Relative
    resolution is ``growth - 1`` (default 2**(1/8) ~ 9%).
    """

    __slots__ = (
        "name",
        "lo",
        "hi",
        "edges",
        "counts",
        "count",
        "total",
        "vmin",
        "vmax",
        "_lock",
    )

    def __init__(
        self,
        name: str = "",
        lo: float = 1e-4,
        hi: float = 1e4,
        growth: float = 2 ** 0.125,
    ):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        n = int(math.ceil(math.log(hi / lo) / math.log(growth))) + 1
        # Edge array is the single source of truth for bucketing: record()
        # and the test oracle both searchsorted into it, so they can never
        # disagree by a ULP the way two log/floor implementations can.
        self.edges = self.lo * np.power(float(growth), np.arange(n))
        self.edges[-1] = max(self.edges[-1], self.hi)
        self.counts = np.zeros(n, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = make_lock(f"metrics.hist.{name or 'anon'}")

    def bucket_index(self, value: float) -> int:
        """The bucket a value lands in; clamped, never out of range."""
        # lint: allow(searchsorted-dtype) -- a scalar float probe into the f64 edge array; nothing to copy
        idx = int(np.searchsorted(self.edges, value, side="left"))
        return min(idx, len(self.edges) - 1)

    def record(self, value: float) -> None:
        v = float(value)
        if v != v or v < 0:  # NaN / negative: a broken clock, not a latency
            v = 0.0
        with self._lock:
            self.counts[self.bucket_index(v)] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def merge(self, other: "LogHistogram") -> None:
        """Fold another histogram with IDENTICAL bucketing into this one."""
        if len(other.edges) != len(self.edges) or other.lo != self.lo:
            raise ValueError("histogram bucketing mismatch")
        with self._lock:
            self.counts += other.counts
            self.count += other.count
            self.total += other.total
            self.vmin = min(self.vmin, other.vmin)
            self.vmax = max(self.vmax, other.vmax)

    def quantile(self, q: float) -> Optional[float]:
        """Upper edge of the bucket holding the ceil(q*n)-th smallest sample
        (q in (0, 1]); None when empty.  q=0 answers the exact minimum."""
        with self._lock:
            if self.count == 0:
                return None
            if q <= 0.0:
                return self.vmin
            rank = min(int(math.ceil(q * self.count)), self.count)
            cum = int(np.searchsorted(np.cumsum(self.counts), rank, side="left"))
            return float(self.edges[cum])

    def snapshot(self) -> dict:
        """JSON-able summary (the /healthz / bench / sidecar shape)."""
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            mean = self.total / self.count
            snap = {
                "count": int(self.count),
                "sum_s": round(self.total, 6),
                "mean_s": round(mean, 6),
                "min_s": round(self.vmin, 6),
                "max_s": round(self.vmax, 6),
            }
        for label, q in (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            if v is not None:
                snap[label + "_s"] = round(v, 6)
        return snap

    def reset(self) -> None:
        with self._lock:
            self.counts[:] = 0
            self.count = 0
            self.total = 0.0
            self.vmin = math.inf
            self.vmax = -math.inf


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0
        self._lock = make_lock(f"metrics.counter.{name or 'anon'}")

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0

    def snapshot(self) -> int:
        return int(self.value)


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return float(self.value)


class MetricsRegistry:
    """Named gauges/counters/histograms with one JSON-able snapshot().

    Registration is get-or-create so instrumented code and its readers can
    both ask by name without an ordering contract; types are checked on
    re-registration (a counter silently shadowing a histogram would corrupt
    every reader)."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._metrics: dict[str, object] = {}
        self._lock = make_lock(f"metrics.registry.{namespace or 'anon'}")

    def _get_or_create(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def histogram(self, name: str, **kw) -> LogHistogram:
        return self._get_or_create(
            name, lambda: LogHistogram(name=name, **kw), LogHistogram
        )

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name), Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name), Gauge)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            if hasattr(m, "reset"):
                m.reset()
