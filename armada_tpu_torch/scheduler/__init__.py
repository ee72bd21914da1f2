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
"""

from armada_tpu_torch.scheduler.algo import FairSchedulingAlgo, PoolStats, SchedulerResult
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
from armada_tpu_torch.scheduler.incremental_algo import IncrementalProblemFeed
from armada_tpu_torch.scheduler.providers import (
    BidPriceProvider,
    NoOpProviders,
    PriorityOverrideProvider,
    StaticBidPriceProvider,
    StaticPriorityOverrideProvider,
    most_specific_bid,
)

__all__ = [
    "BidPriceProvider",
    "ExecutorSnapshot",
    "FairSchedulingAlgo",
    "IncrementalProblemFeed",
    "NoOpProviders",
    "PoolStats",
    "PriorityOverrideProvider",
    "SchedulerResult",
    "StaticBidPriceProvider",
    "StaticPriorityOverrideProvider",
    "most_specific_bid",
]
