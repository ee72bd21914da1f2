"""Bounded exponential backoff with full jitter.

Every retry loop that talks to a peer which may be DOWN (the eventlog
follower tailing a dead leader, the ingestion pipeline replaying a batch
against a restarting database, the pgwire adapter reconnecting) must not
spin hot OR retry in lockstep: fixed sleeps synchronize every waiter onto
the recovering peer at the same instant.  This is the AWS-style
full-jitter schedule -- delay_n = uniform(0, min(cap, base * 2**n)) -- with
a floor so a jittered delay never degenerates to a busy loop.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class Backoff:
    """One retry loop's schedule; not thread-safe (one loop, one instance).

    ``max_attempts`` / ``deadline_s`` bound the schedule: ``exhausted()``
    turns True once the loop has drawn ``max_attempts`` delays or has been
    retrying for ``deadline_s`` seconds (measured from the first
    ``next_delay`` after a ``reset``).  Both default to None -- unbounded,
    the behavior every pre-existing call site keeps.  A bounded loop
    decides what exhaustion MEANS (the ingest plane escalates to poison
    isolation, ingest/dlq.py); the schedule only reports it.
    """

    def __init__(
        self,
        base_s: float = 0.2,
        cap_s: float = 30.0,
        floor_s: float = 0.05,
        rng: Optional[random.Random] = None,
        max_attempts: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.floor_s = min(float(floor_s), float(base_s))
        self.attempts = 0
        self.max_attempts = max_attempts
        self.deadline_s = deadline_s
        self._started_at: Optional[float] = None
        self._rng = rng or random.Random()

    def reset(self) -> None:
        self.attempts = 0
        self._started_at = None

    def exhausted(self) -> bool:
        """True once the bounded budget is spent: ``max_attempts`` delays
        drawn, or ``deadline_s`` elapsed since the first post-reset delay.
        Always False for the default unbounded schedule."""
        if self.max_attempts is not None and self.attempts >= self.max_attempts:
            return True
        if (
            self.deadline_s is not None
            and self._started_at is not None
            and time.monotonic() - self._started_at >= self.deadline_s
        ):
            return True
        return False

    def next_delay(self) -> float:
        """The delay before the NEXT attempt; advances the attempt count.
        Callers log the delay and then sleep/wait it themselves (the log
        line must precede the wait it describes)."""
        if self._started_at is None:
            self._started_at = time.monotonic()
        # exponent clamped: 2.0**1024 overflows float, and a sustained
        # outage (a down DB for an hour) really does reach four-digit
        # attempt counts -- the cap dominates long before 2**60 anyway
        ceiling = min(self.cap_s, self.base_s * (2.0 ** min(self.attempts, 60)))
        self.attempts += 1
        return max(self.floor_s, self._rng.uniform(0.0, ceiling))
