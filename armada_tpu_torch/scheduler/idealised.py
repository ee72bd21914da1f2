"""Idealised scheduled value for market-driven pools.

Equivalent of the reference's CalculateIdealisedValue (internal/scheduler/
scheduling/idealised_value.go:21-101, idealised_value_scheduler.go): re-run the
market round on a theoretical "mega node" holding ALL pool resources, with
per-round limits and static requirements (selectors/taints) disabled, then
value each queue's scheduled jobs at bid price x resource units.  Comparing to
the real round's value exposes the "expectation gap" caused by node boundaries
(idealised_value_scheduler.go:28-33).

The port's copy of the JAX package's scheduler/idealised.py.  The mega
round runs through the port's round (K-B, K-C and K-A at N = 1 node) on
`device` -- the card unless the caller passes device="cpu" -- the analogue
of the reference building a one-node NodeDb (createMegaNode).  Its gate
accumulates q_alloc in f32 as the JAX round does, so past 2^24 resolution
units on one (queue, priority class, resource) it can differ from the f64
columnar sweep (idealised_columnar.py) exactly as the JAX routes differ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob

DEFAULT_RESOURCE_UNIT = {"cpu": 1}


def value_of_jobs(
    jobs,
    bid_price_of: Callable[[JobSpec], float],
    factory,
    resource_unit: Optional[Mapping[str, "str | int"]] = None,
) -> dict:
    """{queue: Σ bid x resource-units} -- THE valuation currency
    (idealised_value.go valueFromSchedulingResult): units = max over
    resources of request/unit.  Shared by the idealised and realised value
    computations so the expectation gap always compares like with like."""
    unit = np.asarray(
        factory.from_mapping(resource_unit or DEFAULT_RESOURCE_UNIT).atoms,
        np.float64,
    )
    values: dict = {}
    for job in jobs:
        if job.resources is None:
            continue
        req = np.asarray(job.resources.atoms, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            units = np.where(unit > 0, req / np.maximum(unit, 1e-12), 0.0).max()
        values[job.queue] = values.get(job.queue, 0.0) + float(
            bid_price_of(job)
        ) * float(units)
    return values


def _strip_static_requirements(job: JobSpec) -> JobSpec:
    """StaticRequirementsIgnoringIterator: the mega node has no labels or
    taints, so selectors/tolerations are dropped (idealised_value_scheduler.go:75)."""
    if not job.node_selector and not job.tolerations:
        return job
    return dataclasses.replace(job, node_selector={}, tolerations=())


def calculate_idealised_values(
    config: SchedulingConfig,
    *,
    pool: str,
    nodes: Sequence[NodeSpec],
    queues: Sequence[Queue],
    queued_jobs: Sequence[JobSpec],
    running: Sequence[RunningJob],
    bid_price_of: Callable[[JobSpec], float],
    resource_unit: Optional[Mapping[str, "str | int"]] = None,
    device="cuda",
) -> dict:
    """{queue: idealised value}: what each queue's jobs would earn on a
    boundary-less cluster (idealised_value.go valueFromSchedulingResult).
    The mega round runs on `device`: the card unless device="cpu"."""
    from armada_tpu_torch.models import run_scheduling_round

    factory = config.resource_list_factory()
    pool_nodes = [n for n in nodes if n.pool == pool and not n.unschedulable]
    if not pool_nodes:
        return {}

    total = np.zeros((factory.num_resources,), np.float64)
    for n in pool_nodes:
        if n.total_resources is not None:
            total += np.asarray(n.total_resources.atoms, np.float64)
    mega = NodeSpec(
        id="__mega__",
        pool=pool,
        total_resources=factory.from_atoms(total.astype(np.int64)),
    )

    # Schedule on an EMPTY cluster: running jobs re-enter as candidates
    # (idealised_value.go:68-76 enqueues them into the iterators).
    candidates = [_strip_static_requirements(j) for j in queued_jobs]
    seen = {j.id for j in candidates}
    for r in running:
        if r.job.id not in seen:
            candidates.append(_strip_static_requirements(r.job))

    # Per-round limits off (idealised_value.go permissiveSchedulingConstraints
    # + noOpRateLimiter); 0 burst = unlimited in the problem builder.
    permissive = dataclasses.replace(
        config,
        maximum_resource_fraction_to_schedule={},
        maximum_scheduling_burst=0,
        maximum_per_queue_scheduling_burst=0,
    )
    outcome = run_scheduling_round(
        permissive,
        pool=pool,
        nodes=[mega],
        queues=queues,
        queued_jobs=candidates,
        running=(),
        collect_stats=False,
        bid_price_of=bid_price_of,
        device=device,
    )

    job_by_id = {j.id: j for j in candidates}
    return value_of_jobs(
        (job_by_id[jid] for jid in outcome.scheduled if jid in job_by_id),
        bid_price_of,
        factory,
        resource_unit,
    )
