"""Pool-parallel serving ledger: what the multi-pool cycle actually did.

One process-global scoreboard (the watchdog/SLO-recorder discipline) fed by
FairSchedulingAlgo.schedule each cycle: whether the pool-parallel path ran
or fell back to the serial per-pool order (and why it fell back matters --
certification failure is a WORKLOAD property, not a bug), how many stacked
kernel launches covered how many pools, per-pool round seconds, and the
cycle's overlap ratio (sum of per-pool round time over the pool section's
wall clock -- ~1.0 serial, > 1.0 when dispatches overlapped fetches).

The port's copy of the JAX package's scheduler/pool_serving.py, with a
plain lock.  Readers: chip_smoke.py's pools path and the tests.  Decisions
never depend on this module.
"""

from __future__ import annotations

import threading
from typing import Optional


class PoolServingStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.cycles = 0  # multi-pool cycles observed (>= 1 pool round ran)
        self.parallel_cycles = 0  # cycles that ran the dispatch/fetch split
        # pool-parallel armed but the cycle stayed serial: shared queued
        # candidates (feed.pools_independent() false), armed rate limiters,
        # or a single-pool cycle (nothing to overlap).
        self.serial_fallback_cycles = 0
        self.stacked_launches = 0  # cumulative stacked kernel launches
        self.stacked_pools = 0  # cumulative pools covered by stacks
        self.last_overlap_ratio: Optional[float] = None
        self.last_round_s: dict = {}  # pool -> seconds, last cycle each ran

    def record_cycle(
        self,
        *,
        parallel: bool,
        armed: bool,
        pool_round_s: dict,
        stacked_launches: int = 0,
        stacked_pools: int = 0,
        overlap_ratio: Optional[float] = None,
    ) -> None:
        with self._lock:
            self.cycles += 1
            if parallel:
                self.parallel_cycles += 1
            elif armed:
                self.serial_fallback_cycles += 1
            self.stacked_launches += stacked_launches
            self.stacked_pools += stacked_pools
            if overlap_ratio is not None:
                self.last_overlap_ratio = round(float(overlap_ratio), 3)
            self.last_round_s.update(
                {p: round(float(s), 6) for p, s in pool_round_s.items()}
            )
            if len(self.last_round_s) > 512:
                # pool-churn bound (the SLORecorder.pool_cap discipline):
                # late-discovered pools come and go; past the cap keep only
                # the pools this cycle actually served
                self.last_round_s = {
                    p: round(float(s), 6) for p, s in pool_round_s.items()
                }

    def snapshot(self) -> dict:
        from armada_tpu_torch.core.pipeline import pool_parallel_enabled

        with self._lock:
            return {
                "enabled": pool_parallel_enabled(),
                "cycles": self.cycles,
                "parallel_cycles": self.parallel_cycles,
                "serial_fallback_cycles": self.serial_fallback_cycles,
                "stacked_launches": self.stacked_launches,
                "stacked_pools": self.stacked_pools,
                "last_overlap_ratio": self.last_overlap_ratio,
                "last_round_s": dict(self.last_round_s),
            }


_STATS = PoolServingStats()


def pool_serving_stats() -> PoolServingStats:
    return _STATS


def reset_pool_serving_stats() -> PoolServingStats:
    """Fresh scoreboard (tests/bench)."""
    global _STATS
    _STATS = PoolServingStats()
    return _STATS
