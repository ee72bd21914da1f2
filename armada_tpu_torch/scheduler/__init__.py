"""The scheduling cycle of the port: FairSchedulingAlgo over the JobDb.

`algo.FairSchedulingAlgo.schedule(txn, executors, now_ns)` is the
per-cycle entry point: every pool's round, assembled by an
`incremental_algo.IncrementalProblemFeed` attached to the JobDb (or built
per cycle from the txn), run on the card -- serially, or pool-parallel with
shape-matched pools stacked into one launch (ARMADA_POOL_PARALLEL=1) -- and
the decisions applied back to the txn.  Market-driven pools take a bid-price
provider (`StaticBidPriceProvider`), and any pool a priority-override
provider (`StaticPriorityOverrideProvider`); their PoolStats carry the
indicative gang prices and the idealised and realised values, and
`config.optimiser_enabled` adds the optimiser's pass over stuck jobs.

Around it, the scheduler service (`scheduler.Scheduler`, the JAX package's
event-sourced main loop): each cycle syncs the scheduler DB into the JobDb,
checks leadership (`StandaloneLeaderController`,
`FileLeaseLeaderController`), derives the state-transition events, expires
lost executors, runs the algo's round on the card, publishes the decisions
to the event log and commits the txn.
"""

from armada_tpu_torch.scheduler.algo import FairSchedulingAlgo, PoolStats, SchedulerResult
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
from armada_tpu_torch.scheduler.incremental_algo import IncrementalProblemFeed
from armada_tpu_torch.scheduler.leader import (
    FileLeaseLeaderController,
    LeaderController,
    StandaloneLeaderController,
)
from armada_tpu_torch.scheduler.providers import (
    BidPriceProvider,
    NoOpProviders,
    PriorityOverrideProvider,
    StaticBidPriceProvider,
    StaticPriorityOverrideProvider,
    most_specific_bid,
)
from armada_tpu_torch.scheduler.scheduler import CycleResult, Scheduler

__all__ = [
    "BidPriceProvider",
    "CycleResult",
    "ExecutorSnapshot",
    "FairSchedulingAlgo",
    "FileLeaseLeaderController",
    "IncrementalProblemFeed",
    "LeaderController",
    "NoOpProviders",
    "PoolStats",
    "PriorityOverrideProvider",
    "Scheduler",
    "SchedulerResult",
    "StandaloneLeaderController",
    "StaticBidPriceProvider",
    "StaticPriorityOverrideProvider",
    "most_specific_bid",
]
