"""In-memory job store with single-writer transactions and invariant checks.

Equivalent of the reference's internal/scheduler/jobdb (SURVEY.md section 2.2);
the port's copy of the JAX package's jobdb, which the scheduling cycle
(armada_tpu_torch/scheduler) reads and writes.
"""

from armada_tpu_torch.jobdb.job import Job, JobRun
from armada_tpu_torch.jobdb.jobdb import JobDb, ReadTxn, WriteTxn, gang_key, market_order_key

__all__ = [
    "Job",
    "JobRun",
    "JobDb",
    "ReadTxn",
    "WriteTxn",
    "gang_key",
    "market_order_key",
]
