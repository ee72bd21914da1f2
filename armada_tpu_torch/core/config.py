"""Scheduling configuration.

Equivalent of the reference's `internal/scheduler/configuration/types.go`
(SchedulingConfig) with defaults mirroring the reference's config/scheduler/config.yaml:70-127.
Every knob that shapes the scheduling round is here so that the round
kernel can be specialised (config values are static for a round).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from armada_tpu_torch.core.resources import ResourceListFactory


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """A priority class (configuration/types.go PriorityClass).

    `priority` is the Kubernetes-style integer priority at which the job's pods
    contend for node resources; `preemptible` gates fair-share eviction
    (preempting_queue_scheduler.go:143-157).
    """

    name: str
    priority: int
    preemptible: bool = False
    # Per-queue cap on the fraction of pool resources jobs of this PC may take
    # (constraints.go; config.yaml:91-95).  Missing resources are uncapped.
    maximum_resource_fraction_per_queue: Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass(frozen=True)
class GangDefinition:
    """A job shape whose market price is published each round
    (configuration.go:312 GangDefinition; priced by the indicative pricer)."""

    size: int = 1
    priority_class: str = ""
    resources: Mapping[str, "str | int"] = dataclasses.field(default_factory=dict)
    node_selector: Mapping[str, str] = dataclasses.field(default_factory=dict)
    tolerations: tuple = ()
    node_uniformity: str = ""

    def __hash__(self):
        return hash(
            # lint: allow(class-signature-home) -- hash of this frozen
            # CONFIG dataclass's own declared fields (a market gang
            # TEMPLATE), not a Job scheduling-class identity
            (
                self.size,
                self.priority_class,
                tuple(sorted((k, str(v)) for k, v in self.resources.items())),
                tuple(sorted(self.node_selector.items())),
                self.tolerations,
                self.node_uniformity,
            )
        )


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    name: str
    # Pools this pool may schedule "away" jobs onto (scheduling_algo.go:216-283).
    away_pools: tuple[str, ...] = ()
    # Candidate ordering by bid price instead of DRF cost
    # (experimentalMarketScheduling; market_iterator.go).
    market_driven: bool = False
    # Jobs that exit sooner than this after starting keep charging their
    # queue's DRF cost until the window passes (short_job_penalty.go;
    # configuration.go:299 ShortJobPenaltyCutoff).  0 disables.
    short_job_penalty_cutoff_s: float = 0.0
    # Scheduled-share fraction past which the crossing gang's bid sets the
    # pool spot price (MarketSchedulingConfig.SpotPriceCutoff).
    spot_price_cutoff: float = 0.9
    # Shape name -> gang definition priced each round by the indicative
    # pricer (MarketSchedulingConfig.GangsToPrice).
    gangs_to_price: tuple[tuple[str, "GangDefinition"], ...] = ()


@dataclasses.dataclass(frozen=True)
class FloatingResource:
    """A pool-level resource never bound to nodes (e.g. storage connections):
    counted in totals, fairness and constraints, but invisible to per-node fit
    (internal/scheduler/floatingresources/floating_resource_types.go,
    docs/floating_resources.md:9-19)."""

    name: str
    resolution: str = "1"
    # pool -> total quantity available in that pool.
    pools: Mapping[str, "str | int"] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class SchedulingConfig:
    """The scheduler's static configuration (configuration/types.go SchedulingConfig)."""

    # Fixed resource axis registry: (name, resolution) pairs
    # (config.yaml supportedResourceTypes:73-82).
    supported_resource_types: tuple[tuple[str, str], ...] = (
        ("memory", "1"),
        ("cpu", "1m"),
        ("ephemeral-storage", "1"),
        ("nvidia.com/gpu", "1"),
    )
    pools: tuple[PoolConfig, ...] = (PoolConfig("default"),)
    priority_classes: Mapping[str, PriorityClass] = dataclasses.field(
        default_factory=lambda: {
            "armada-default": PriorityClass(
                "armada-default",
                priority=1000,
                preemptible=False,
                maximum_resource_fraction_per_queue={"memory": 1.0, "cpu": 1.0},
            ),
            "armada-preemptible": PriorityClass(
                "armada-preemptible", priority=1000, preemptible=True
            ),
        }
    )
    default_priority_class: str = "armada-default"
    # DRF resources to consider, all multiplier 1.0 (config.yaml:108-113).
    dominant_resource_fairness_resources: tuple[str, ...] = (
        "cpu",
        "memory",
        "nvidia.com/gpu",
        "ephemeral-storage",
    )
    # Fraction of its fair share below which a queue's jobs are protected from
    # fair-share eviction (config.yaml protectedFractionOfFairShare, default 1.0).
    protected_fraction_of_fair_share: float = 1.0
    max_queue_lookback: int = 100_000
    maximum_scheduling_burst: int = 1_000
    maximum_per_queue_scheduling_burst: int = 1_000
    maximum_scheduling_rate: float = 100.0
    maximum_per_queue_scheduling_rate: float = 50.0
    # Cap on fraction of pool resources schedulable in one round (config.yaml:100-102).
    maximum_resource_fraction_to_schedule: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"memory": 1.0, "cpu": 1.0}
    )
    max_retries: int = 3
    # Node labels whose values are folded into the NodeType id; selectors on other
    # labels fall back to per-node host-side filtering (nodedb.go:84-108).
    indexed_node_labels: tuple[str, ...] = ()
    indexed_taints: tuple[str, ...] = ()
    node_id_label: str = "kubernetes.io/hostname"
    executor_timeout_s: float = 600.0
    max_unacknowledged_jobs_per_executor: int = 2500
    enable_assertions: bool = False
    # Pause scheduling while keeping state sync + event processing running
    # (config.yaml:82 disableScheduling -- operators flip it during incidents).
    disable_scheduling: bool = False
    # Cap on retained per-job scheduling reports (the reference's
    # maxJobSchedulingContextsPerExecutor, config/scheduler/config.yaml:107):
    # bounds both the report LRU and the per-cycle failed-id decode.
    max_job_scheduling_contexts_per_executor: int = 10_000
    # Assemble non-market pool problems from cycle-persistent columnar
    # builders fed by JobDb deltas (models/incremental.py) instead of
    # re-reading every Job per cycle -- the analog of the reference keeping
    # its jobDb between cycles (scheduler.go:240-246).  Required to meet the
    # <1s end-to-end round budget at 1M-job backlogs.
    incremental_problem_build: bool = False
    # Alternate candidate ordering (queue_scheduler.go Less:598-626): within
    # budget, order queues by CURRENT cost with larger gangs breaking ties
    # (reduces fragmentation, helps big gangs on); over-budget queues rank by
    # proposed cost and always behind within-budget ones.
    enable_prefer_large_job_ordering: bool = False
    # Pool-level resources never bound to nodes (floatingresources/).
    floating_resources: tuple[FloatingResource, ...] = ()
    # Base priorities for the indicative-share metric (config.yaml
    # experimentalIndicativeShare.basePriorities): per pool, the share a NEW
    # queue joining at weight 1/priority would receive, published as
    # armada_scheduler_indicative_share{pool,priority}.
    indicative_share_base_priorities: tuple[int, ...] = ()
    # Reset the job-state counter vectors this often (config.yaml:12
    # jobStateMetricsResetInterval, 12h in the reference's shipped config):
    # bounds label-series churn from high-cardinality queue labels.  0 = never.
    job_state_metrics_reset_interval_s: float = 12 * 3600.0
    # Publish per-cycle per-pool metrics to the event log (the reference's
    # metric-events Pulsar topic, pkg/metricevents): consumers subscribe to
    # the "armada-metrics" stream instead of scraping Prometheus.
    publish_metric_events: bool = False
    # Node quarantine (README.md:28 "removing nodes exhibiting high failure
    # rates"): this many attempted-run deaths on one node within the window
    # excludes it from scheduling for the cooldown.  0 disables.
    node_quarantine_failure_threshold: int = 0
    node_quarantine_window_s: float = 600.0
    node_quarantine_cooldown_s: float = 1200.0
    # Optimiser: targeted preemption for stuck jobs (optimiser/node_scheduler.go).
    optimiser_enabled: bool = False
    optimiser_max_stuck_jobs: int = 10
    optimiser_maximum_job_size_to_preempt: Optional[Mapping[str, "str | int"]] = None
    # Device-shape bucketing: round padded axis sizes up to the next multiple to
    # keep array shapes stable across rounds (no reference equivalent -- Go has no shapes).
    shape_bucket: int = 256

    def __hash__(self):
        # Mapping-typed fields are canonicalised so the config can key caches.
        return hash(
            (
                self.supported_resource_types,
                self.pools,
                tuple(sorted(self.priority_classes)),
                tuple(
                    (pc.name, pc.priority, pc.preemptible,
                     tuple(sorted(pc.maximum_resource_fraction_per_queue.items())))
                    for pc in (self.priority_classes[k] for k in sorted(self.priority_classes))
                ),
                self.default_priority_class,
                self.dominant_resource_fairness_resources,
                self.protected_fraction_of_fair_share,
                self.max_queue_lookback,
                self.maximum_scheduling_burst,
                self.maximum_per_queue_scheduling_burst,
                tuple(sorted(self.maximum_resource_fraction_to_schedule.items())),
                self.max_retries,
                self.indexed_node_labels,
                self.indexed_taints,
                self.node_id_label,
                self.shape_bucket,
                tuple(
                    (fr.name, fr.resolution, tuple(sorted(fr.pools.items())))
                    for fr in self.floating_resources
                ),
                self.optimiser_enabled,
            )
        )

    def resource_list_factory(self) -> ResourceListFactory:
        # Floating resources are requestable: they extend the resource axis.
        types = tuple(self.supported_resource_types) + tuple(
            (fr.name, fr.resolution) for fr in self.floating_resources
        )
        return ResourceListFactory.from_config(types)

    def floating_resource_names(self) -> tuple[str, ...]:
        return tuple(fr.name for fr in self.floating_resources)

    def short_job_penalty_cutoffs(self) -> dict[str, float]:
        """pool -> cutoff seconds (configuration.go GetShortJobPenaltyCutoffs)."""
        return {
            p.name: p.short_job_penalty_cutoff_s
            for p in self.pools
            if p.short_job_penalty_cutoff_s > 0
        }

    def floating_totals_for_pool(self, pool: str) -> dict[str, "str | int"]:
        """name -> quantity of each floating resource available in `pool`
        (floating_resource_types.go GetTotalAvailableForPool)."""
        return {
            fr.name: fr.pools[pool]
            for fr in self.floating_resources
            if pool in fr.pools
        }

    def priority_class(self, name: Optional[str]) -> PriorityClass:
        if not name:
            name = self.default_priority_class
        try:
            return self.priority_classes[name]
        except KeyError:
            raise ValueError(f"unknown priority class {name!r}") from None

    def drf_multipliers(self) -> dict[str, float]:
        return {name: 1.0 for name in self.dominant_resource_fairness_resources}

    def priority_ladder(self) -> tuple[int, ...]:
        """Sorted distinct PC priorities: the P axis of node allocatable tensors
        (internaltypes/node.go AllocatableByPriority)."""
        return tuple(sorted({pc.priority for pc in self.priority_classes.values()}))


def default_scheduling_config() -> SchedulingConfig:
    return SchedulingConfig()
