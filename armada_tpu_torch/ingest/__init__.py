"""Ingestion: event log -> materialized views.

Equivalent of the reference's internal/common/ingest +
internal/scheduleringester (SURVEY.md section 2.5): a generic pipeline turning
the partitioned event log into per-view databases, with typed bulk operations
and exactly-once positioning. The port holds the serial pipeline over the
sqlite scheduler DB; the partitioned ingester and the Postgres driver come
in the next slice.
"""

from armada_tpu_torch.ingest.converter import convert_sequences
from armada_tpu_torch.ingest.pipeline import IngestionPipeline
from armada_tpu_torch.ingest.schedulerdb import SchedulerDb


def scheduler_ingestion_pipeline(
    log, db: SchedulerDb, consumer_name: str = "scheduler"
) -> IngestionPipeline:
    """The scheduler ingester: events -> DbOperations -> scheduler SQLite."""
    return IngestionPipeline(
        log,
        sink=db,
        converter=convert_sequences,
        consumer_name=consumer_name,
        start_positions=db.positions(consumer_name),
    )


__all__ = [
    "IngestionPipeline",
    "SchedulerDb",
    "convert_sequences",
    "scheduler_ingestion_pipeline",
]
