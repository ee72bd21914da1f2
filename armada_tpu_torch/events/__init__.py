"""The event schema and its conversions.

`schema` holds the message classes of events.proto (a copy of the JAX
package's file), built at import by the port's own parser and codec:
the port runs where no protobuf runtime is installed, and its bytes are
protobuf's, so each package reads what the other wrote.
"""

from armada_tpu_torch.events import schema

from armada_tpu_torch.events.convert import (
    job_spec_from_proto,
    job_spec_to_proto,
    resources_from_proto,
    resources_to_proto,
)

__all__ = [
    "job_spec_from_proto",
    "job_spec_to_proto",
    "resources_from_proto",
    "resources_to_proto",
    "schema",
]
