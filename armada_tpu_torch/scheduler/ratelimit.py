"""Token-bucket rate limiters for scheduling throughput.

Equivalent of the reference's rate limiters (configuration
maximumSchedulingRate / maximumPerQueueSchedulingRate with bursts,
config/scheduler/config.yaml:103-107; consulted per gang in
queue_scheduler.go): tokens refill continuously at `rate`; each scheduled
job consumes one; a round's burst caps are clamped to the available tokens,
so sustained throughput converges to the configured rate while short bursts
up to the burst size pass immediately.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class TokenBucket:
    def __init__(
        self,
        rate_per_s: float,
        burst: int,
        clock: Callable[[], float] = time.time,
    ):
        """rate_per_s <= 0 or burst <= 0 disables limiting (unlimited)."""
        self.rate = rate_per_s
        self.burst = burst
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0 or self.burst <= 0

    def available(self) -> int:
        if self.unlimited:
            return 2**31 - 1
        now = self._clock()
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        return max(0, int(self._tokens))

    def consume(self, n: int) -> None:
        if not self.unlimited:
            self.available()  # refill first
            self._tokens = max(0.0, self._tokens - n)


class SchedulingRateLimiters:
    """The scheduler's global + per-queue buckets (lazily created)."""

    def __init__(
        self,
        rate_per_s: float,
        burst: int,
        per_queue_rate_per_s: float,
        per_queue_burst: int,
        clock: Callable[[], float] = time.time,
    ):
        self._clock = clock
        self.global_bucket = TokenBucket(rate_per_s, burst, clock)
        self._pq_rate = per_queue_rate_per_s
        self._pq_burst = per_queue_burst
        self._queues: dict[str, TokenBucket] = {}

    def queue_bucket(self, queue: str) -> TokenBucket:
        b = self._queues.get(queue)
        if b is None:
            b = TokenBucket(self._pq_rate, self._pq_burst, self._clock)
            self._queues[queue] = b
        return b

    def tokens(self, queues) -> tuple[Optional[int], Optional[dict]]:
        """(global_tokens, {queue: tokens}) for build_problem; None = unlimited."""
        g = None if self.global_bucket.unlimited else self.global_bucket.available()
        q = None
        if self._pq_rate > 0 and self._pq_burst > 0:
            q = {name: self.queue_bucket(name).available() for name in queues}
        return g, q

    def consume(self, scheduled_by_queue: dict) -> None:
        total = sum(scheduled_by_queue.values())
        self.global_bucket.consume(total)
        if self._pq_rate > 0 and self._pq_burst > 0:
            for queue, n in scheduled_by_queue.items():
                self.queue_bucket(queue).consume(n)
