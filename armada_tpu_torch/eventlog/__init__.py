"""Durable partitioned event log (native C++ store) + publisher/consumer.

The framework's Pulsar equivalent: the ordered, replayable source of truth
(SURVEY.md section 2.5; reference internal/common/pulsarutils,
internal/scheduler/publisher.go).
"""

from armada_tpu_torch.eventlog.log import EventLog, Message
from armada_tpu_torch.eventlog.publisher import (
    ConsumedBatch,
    Consumer,
    PublishedRef,
    Publisher,
    jobset_key,
    partition_for_key,
    wait_for_markers,
)

__all__ = [
    "EventLog",
    "Message",
    "Publisher",
    "Consumer",
    "ConsumedBatch",
    "PublishedRef",
    "jobset_key",
    "partition_for_key",
    "wait_for_markers",
]
