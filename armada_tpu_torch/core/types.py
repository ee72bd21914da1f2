"""Host-side domain objects: nodes, jobs, queues, taints/tolerations.

Equivalent surface to the reference's `internaltypes.Node` (internaltypes/node.go),
`jobdb.Job` (jobdb/job.go) scheduling-relevant fields, and `api.Queue`.  These are
plain frozen dataclasses; the scheduler never mutates them -- mirroring the
reference's immutability discipline (jobdb/jobdb.go:67, resource_list.go:23-24).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from armada_tpu_torch.core.resources import ResourceList

# Node label the executor reports hardware type under (mirrors the
# armada-tpu.io/pool label idiom) and the submit-side annotation carrying a
# job's per-type throughput map ("v5e=2.0,v4=1"; parse_node_type_scores).
NODE_TYPE_LABEL = "armada-tpu.io/node-type"
NODE_TYPE_SCORES_ANNOTATION = "armada-tpu.io/node-type-scores"


def parse_node_type_scores(text: str) -> tuple[tuple[str, float], ...]:
    """Parse the node-type-scores annotation into the canonical sorted
    ((type, throughput), ...) tuple JobSpec carries.

    Sorted so that equal maps written in different orders produce the SAME
    scheduling key (core/keys.class_signature folds the tuple verbatim).
    Raises ValueError on malformed entries -- submit validation turns that
    into a client-facing rejection.
    """
    text = (text or "").strip()
    if not text:
        return ()
    out: dict[str, float] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"node-type-scores entry {part!r}: expected <type>=<throughput>"
            )
        try:
            thr = float(val.strip())
        except ValueError:
            raise ValueError(
                f"node-type-scores entry {part!r}: throughput is not a number"
            ) from None
        if thr <= 0:
            raise ValueError(
                f"node-type-scores entry {part!r}: throughput must be > 0"
            )
        if name in out:
            raise ValueError(f"node-type-scores: duplicate type {name!r}")
        out[name] = thr
    return tuple(sorted(out.items()))


@dataclasses.dataclass(frozen=True)
class Taint:
    """Kubernetes node taint (only NoSchedule/NoExecute block scheduling)."""

    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | NoExecute | PreferNoSchedule


@dataclasses.dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty tolerates all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def taints_tolerated(taints: Sequence[Taint], tolerations: Sequence[Toleration]) -> bool:
    """True if every blocking taint is tolerated (nodematching.go:127-145)."""
    for taint in taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def selector_matches(selector: Mapping[str, str], labels: Mapping[str, str]) -> bool:
    """Node-selector match: every selector entry must equal the node label
    (nodematching.go StaticJobRequirementsMet:161-194)."""
    for k, v in selector.items():
        if labels.get(k) != v:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """A schedulable node (internaltypes/node.go).

    `running` / allocation state lives in the scheduler's state tensors, not here.
    """

    id: str
    pool: str = "default"
    executor: str = ""
    total_resources: Optional[ResourceList] = None
    taints: tuple[Taint, ...] = ()
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    unschedulable: bool = False
    # Hardware type reported by the executor (the NODE_TYPE_LABEL node label,
    # e.g. "v5e" / "v4" / "cpu"); "" = the untyped default, so existing
    # single-type worlds are unchanged.  Folds into core/keys.NodeType so the
    # static fit matrix and the kernel's per-type score tables see it.
    node_type: str = ""


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """A per-job Service the executor materialises next to the pod
    (pkg/api/submit.proto ServiceConfig: NodePort | Headless).  `name` ""
    derives one from the job id."""

    type: str = "NodePort"
    ports: tuple[int, ...] = ()
    name: str = ""


@dataclasses.dataclass(frozen=True)
class IngressSpec:
    """A per-job Ingress exposing service ports over the network
    (pkg/api/submit.proto IngressConfig; materialised like
    executor/util/kubernetes_object.go ExtractIngresses)."""

    ports: tuple[int, ...] = ()
    annotations: Mapping[str, str] = dataclasses.field(default_factory=dict)
    tls_enabled: bool = False
    cert_name: str = ""
    use_cluster_ip: bool = False


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A job as the scheduler sees it (jobdb/job.go scheduling-relevant subset).

    `priority` is the user-settable queue priority (smaller schedules first, like the
    reference's job priority); `priority_class` determines the node-contention
    priority and preemptibility.  Gang semantics via gang_id/gang_cardinality
    annotations (docs/scheduling_and_preempting_jobs.md:101-107).
    """

    id: str
    queue: str
    jobset: str = ""
    priority_class: str = ""
    priority: int = 0
    submit_time: float = 0.0
    resources: Optional[ResourceList] = None
    node_selector: Mapping[str, str] = dataclasses.field(default_factory=dict)
    tolerations: tuple[Toleration, ...] = ()
    gang_id: str = ""
    gang_cardinality: int = 1
    gang_node_uniformity_label: str = ""
    pools: tuple[str, ...] = ()  # pools the job may schedule in; empty = all
    # Price band for market-driven pools (reference: bidstore price bands).
    price_band: str = ""
    # Pod payload passthrough (submit item -> events.proto JobSpec -> the
    # cluster adapter): the scheduler itself never reads these.
    namespace: str = "default"
    annotations: Mapping[str, str] = dataclasses.field(default_factory=dict)
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # Network objects materialised with the pod (submit.proto ingress:9 /
    # services:10); the scheduler never reads these.
    services: tuple[ServiceSpec, ...] = ()
    ingress: tuple[IngressSpec, ...] = ()
    # Per-node-type effective-throughput map, sorted ((type, throughput), ...)
    # (Gavel, arXiv:2008.09213): a NONEMPTY map restricts the job to the named
    # types (absent/<=0 = infeasible there) and biases placement toward
    # higher-throughput types.  () = type-insensitive (every existing world).
    # Folds into the scheduling key -- see core/keys.SchedulingKey.type_scores.
    node_type_scores: tuple[tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class Queue:
    """A queue with a fair-share weight (pkg/api Queue; fairness.go Queue iface)."""

    name: str
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"queue {self.name}: weight must be > 0")


@dataclasses.dataclass(frozen=True)
class RunningJob:
    """A job currently bound to a node, as input to a scheduling round
    (the reference reconstructs this from jobdb runs, scheduling_algo.go:331-465)."""

    job: JobSpec
    node_id: str
    # Priority at which its resources are held (normally its PC priority).
    priority: int = 0
    # Scheduled away from its home pool: held at the lowest priority level and
    # always evictable by home jobs (scheduling_algo.go:216-283).
    away: bool = False
