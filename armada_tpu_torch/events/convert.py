"""Conversions between event protos and the host-side domain dataclasses.

Plays the role of the reference's submit/conversion (api job -> SubmitJob event,
internal/server/submit/conversion/conversions.go) and the scheduler-side
adapters (internal/scheduler/adapters) in one place: our event JobSpec IS the
scheduling shape, so conversion is direct.

The port's copy works on the message classes of `events.schema` in place of
protobuf's generated module; the conversions are the JAX package's, and
`job_spec_from_proto` reads the collection fields without making the empty
containers that reading an unset field makes.
"""

from __future__ import annotations

from typing import Mapping, Optional

from armada_tpu_torch.core.resources import ResourceList, ResourceListFactory
from armada_tpu_torch.core.types import IngressSpec, JobSpec, ServiceSpec, Toleration
from armada_tpu_torch.events import schema as pb


def resources_to_proto(rl: Optional[ResourceList]) -> pb.Resources:
    if rl is None:
        return pb.Resources()
    return pb.Resources(
        milli={name: int(a) for name, a in zip(rl.factory.names, rl.atoms) if a}
    )


def resources_from_proto(
    msg: pb.Resources, factory: ResourceListFactory
) -> ResourceList:
    rl = factory.zero()
    atoms = rl.atoms
    idx_of = factory.index_map.get
    # Key iteration + __getitem__ on the map container (every key is
    # present, so nothing is inserted).
    milli = msg.milli
    for name in milli:
        idx = idx_of(name)
        if idx is not None:
            atoms[idx] = milli[name]
    return rl


def job_spec_to_proto(job: JobSpec) -> pb.JobSpec:
    return pb.JobSpec(
        priority_class=job.priority_class,
        priority=job.priority,
        resources=resources_to_proto(job.resources),
        node_selector=dict(job.node_selector),
        tolerations=[
            pb.Toleration(key=t.key, operator=t.operator, value=t.value, effect=t.effect)
            for t in job.tolerations
        ],
        gang_id=job.gang_id,
        gang_cardinality=job.gang_cardinality,
        gang_node_uniformity_label=job.gang_node_uniformity_label,
        pools=list(job.pools),
        price_band=job.price_band,
        namespace=job.namespace,
        annotations=dict(job.annotations),
        labels=dict(job.labels),
        services=[
            pb.ServiceSpec(type=sv.type, ports=list(sv.ports), name=sv.name)
            for sv in job.services
        ],
        ingress=[
            pb.IngressSpec(
                ports=list(ig.ports),
                annotations=dict(ig.annotations),
                tls_enabled=ig.tls_enabled,
                cert_name=ig.cert_name,
                use_cluster_ip=ig.use_cluster_ip,
            )
            for ig in job.ingress
        ],
        node_type_scores=[
            pb.NodeTypeScore(node_type=t, throughput=thr)
            for t, thr in job.node_type_scores
        ],
    )


def _filled(msg, name: str):
    """The repeated or map field `name` of `msg` if it holds anything, else
    None -- without the empty container that reading an unset field makes
    (the port's schema, events/schema.py)."""
    c = msg._f.get(name)
    return c if c else None


def job_spec_from_proto(
    job_id: str,
    queue: str,
    jobset: str,
    msg: pb.JobSpec,
    factory: ResourceListFactory,
    submit_time: float = 0.0,
) -> JobSpec:
    # The collection fields are empty on the vast majority of jobs crossing
    # the sidecar boundary; guarding them skips the per-field container ->
    # dict/tuple conversion machinery (~a third of the conversion cost on
    # the per-cycle 1k-submit batch).
    selector, tolerations, pools, annotations, labels, services, ingress, scores = (
        _filled(msg, name) for name in (
            "node_selector", "tolerations", "pools", "annotations", "labels",
            "services", "ingress", "node_type_scores"))
    return JobSpec(
        id=job_id,
        queue=queue,
        jobset=jobset,
        priority_class=msg.priority_class,
        priority=int(msg.priority),
        submit_time=submit_time,
        resources=resources_from_proto(msg.resources, factory),
        node_selector=dict(selector) if selector else {},
        tolerations=tuple(
            Toleration(key=t.key, operator=t.operator or "Equal", value=t.value, effect=t.effect)
            for t in tolerations
        )
        if tolerations
        else (),
        gang_id=msg.gang_id,
        gang_cardinality=int(msg.gang_cardinality) or 1,
        gang_node_uniformity_label=msg.gang_node_uniformity_label,
        pools=tuple(pools) if pools else (),
        price_band=msg.price_band,
        namespace=msg.namespace or "default",
        annotations=dict(annotations) if annotations else {},
        labels=dict(labels) if labels else {},
        services=tuple(
            ServiceSpec(
                type=sv.type or "NodePort",
                ports=tuple(int(x) for x in sv.ports),
                name=sv.name,
            )
            for sv in services
        )
        if services
        else (),
        ingress=tuple(
            IngressSpec(
                ports=tuple(int(x) for x in ig.ports),
                annotations=dict(ig.annotations),
                tls_enabled=ig.tls_enabled,
                cert_name=ig.cert_name,
                use_cluster_ip=ig.use_cluster_ip,
            )
            for ig in ingress
        )
        if ingress
        else (),
        # sorted: the canonical order class_signature folds (the submit side
        # already sorts; replay from an older writer must agree)
        node_type_scores=tuple(
            sorted((x.node_type, float(x.throughput)) for x in scores)
        )
        if scores
        else (),
    )
