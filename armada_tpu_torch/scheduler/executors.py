"""Executor snapshots: what each cluster agent reports to the scheduler.

Equivalent of the reference's `schedulerobjects.Executor` (internal/scheduler/
schedulerobjects/schedulerobjects.proto:10-70) as stored by ExecutorApi
(internal/scheduler/api.go StoreExecutor) and read back by the scheduling
algorithm (scheduling_algo.go newFairSchedulingAlgoContext:201): the executor's
nodes with capacities/taints/labels, which runs it believes are active on which
node, and a heartbeat timestamp used for staleness filtering
(filterStaleExecutors, scheduling_algo.go:798).

Snapshots are JSON blobs in the scheduler DB's `executors` table: they cross
a process boundary (executor -> api -> db -> algo) but never a language
boundary, so JSON beats another proto here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional

from armada_tpu_torch.core.resources import ResourceListFactory
from armada_tpu_torch.core.types import NodeSpec, Taint


@dataclasses.dataclass(frozen=True)
class ExecutorSnapshot:
    """One executor's reported cluster state at `last_update_ns`."""

    id: str
    pool: str
    nodes: tuple[NodeSpec, ...] = ()
    # Active run id -> node id, as reported by the executor.  The scheduler
    # treats these as the executor's acknowledgement of leases.
    node_of_run: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # Runs leased to this executor but not yet acknowledged back; counted by
    # the lagging-executor filter (filterLaggingExecutors, scheduling_algo.go:816).
    unacknowledged_runs: tuple[str, ...] = ()
    last_update_ns: int = 0
    cordoned: bool = False
    # Actual per-queue resource usage of the executor's non-terminal pods
    # (atoms by fixed resource axis) -- the usage scrape the reference ships
    # in its lease requests (utilisation/cluster_utilisation.go:125
    # ResourceUsageByQueueAndPool) and surfaces as queue_resource_used.
    queue_usage: Mapping[str, tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )

    # --- serialization ------------------------------------------------------

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "id": self.id,
                "pool": self.pool,
                "nodes": [_node_to_dict(n) for n in self.nodes],
                "node_of_run": dict(self.node_of_run),
                "unacknowledged_runs": list(self.unacknowledged_runs),
                "last_update_ns": self.last_update_ns,
                "cordoned": self.cordoned,
                "queue_usage": {q: list(v) for q, v in self.queue_usage.items()},
            }
        ).encode()

    @staticmethod
    def from_json(blob: bytes, factory: ResourceListFactory) -> "ExecutorSnapshot":
        d = json.loads(blob)
        return ExecutorSnapshot(
            id=d["id"],
            pool=d["pool"],
            nodes=tuple(_node_from_dict(n, factory) for n in d["nodes"]),
            node_of_run=d.get("node_of_run", {}),
            unacknowledged_runs=tuple(d.get("unacknowledged_runs", ())),
            last_update_ns=int(d.get("last_update_ns", 0)),
            cordoned=bool(d.get("cordoned", False)),
            queue_usage={
                q: tuple(v) for q, v in d.get("queue_usage", {}).items()
            },
        )


def _node_to_dict(n: NodeSpec) -> dict:
    return {
        "id": n.id,
        "pool": n.pool,
        "executor": n.executor,
        "resources": (
            {name: int(a) for name, a in zip(n.total_resources.factory.names, n.total_resources.atoms)}
            if n.total_resources is not None
            else {}
        ),
        "taints": [[t.key, t.value, t.effect] for t in n.taints],
        "labels": dict(n.labels),
        "unschedulable": n.unschedulable,
        "node_type": n.node_type,
    }


def _node_from_dict(d: dict, factory: ResourceListFactory) -> NodeSpec:
    rl = factory.zero()
    for name, atoms in d.get("resources", {}).items():
        if name in factory.names:
            rl.atoms[factory.index_of(name)] = atoms
    return NodeSpec(
        id=d["id"],
        pool=d.get("pool", "default"),
        executor=d.get("executor", ""),
        total_resources=rl,
        taints=tuple(Taint(k, v, e) for k, v, e in d.get("taints", ())),
        labels=d.get("labels", {}),
        unschedulable=bool(d.get("unschedulable", False)),
        node_type=d.get("node_type", ""),
    )
