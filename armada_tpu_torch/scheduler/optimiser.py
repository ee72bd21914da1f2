"""Optimiser: targeted preemption to place stuck jobs.

Equivalent of the reference's optimiser rounds (internal/scheduler/scheduling/
optimiser/node_scheduler.go:19-45, wired at preempting_queue_scheduler.go:
250-272): when a job keeps failing the normal rounds, search every
statically-fitting node for the cheapest set of preemptible running jobs
whose eviction -- in "ideal order": over-fair-share queues first, newest jobs
first -- frees enough room.  The best (lowest preemption-cost) node wins; the
victims are preempted and the stuck job is scheduled in their place.

This is a rare-path repair, host-side numpy over a handful of candidate jobs
-- the hot path stays in the round kernel.  Guard rails mirror the
reference's: opt-in (enabled flag), per-victim size cap
(maximumJobSizeToPreempt), bounded stuck-job count per cycle.

The port's copy of the JAX package's scheduler/optimiser.py: host numpy,
no device work.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.keys import (
    NodeTypeIndex,
    SchedulingKeyIndex,
    static_fit_matrix,
)
from armada_tpu_torch.core.types import JobSpec, NodeSpec, RunningJob


@dataclasses.dataclass(frozen=True)
class OptimiserConfig:
    """Knobs (reference: optimiser config in SchedulingConfig)."""

    enabled: bool = False
    # Jobs larger than this (any resource) are never preempted
    # (maximumJobSizeToPreempt).
    maximum_job_size_to_preempt: Optional[Mapping[str, "str | int"]] = None
    # How many stuck gangs to attempt per cycle.
    max_stuck_jobs_per_cycle: int = 10


@dataclasses.dataclass
class OptimiserDecision:
    job_id: str
    node_id: str
    preempted_job_ids: list


class Optimiser:
    def __init__(
        self,
        config: SchedulingConfig,
        opt: Optional[OptimiserConfig] = None,
    ):
        self.config = config
        self.opt = opt or OptimiserConfig()
        self._factory = config.resource_list_factory()
        floating = set(config.floating_resource_names())
        self._node_axes = np.array(
            [0.0 if n in floating else 1.0 for n in self._factory.names]
        )

    # --- the pass -----------------------------------------------------------

    def optimise(
        self,
        stuck: Sequence[JobSpec],
        nodes: Sequence[NodeSpec],
        running: Sequence[RunningJob],
        actual_share: Mapping[str, float],
        fair_share: Mapping[str, float],
        banned_nodes: Optional[Mapping[str, Sequence[str]]] = None,
    ) -> list[OptimiserDecision]:
        """Place up to max_stuck_jobs_per_cycle stuck jobs by preempting
        over-fair-share victims; returns the decisions (caller applies them).

        `running` must reflect prior decisions; each decision consumes
        capacity, so the list is re-derived after each placement.

        banned_nodes: {job_id: node ids} retry anti-affinity -- the optimiser
        must never hand a retry back to the node it died on.
        """
        if not self.opt.enabled or not stuck:
            return []

        max_size = None
        if self.opt.maximum_job_size_to_preempt is not None:
            max_size = np.asarray(
                self._factory.from_mapping(
                    self.opt.maximum_job_size_to_preempt
                ).atoms,
                dtype=np.float64,
            )

        running_by_node: dict[str, list[RunningJob]] = {}
        for r in running:
            running_by_node.setdefault(r.node_id, []).append(r)

        # Gangs stay atomic: members place together or not at all
        # (optimiser/gang_scheduler.go).
        units: list[list[JobSpec]] = []
        by_gang: dict[tuple, list[JobSpec]] = {}
        for job in stuck:
            if job.gang_id:
                by_gang.setdefault((job.queue, job.gang_id), []).append(job)
            else:
                units.append([job])
        for (queue, gang_id), members in by_gang.items():
            if len(members) < max(m.gang_cardinality or 1 for m in members):
                continue  # partially-stuck gang: other members already run
            if any(m.gang_node_uniformity_label for m in members):
                # The per-member placement loop cannot enforce a common
                # uniformity domain; leave these to the round kernel, which
                # can (problem.py _uniform_domain_ban).
                continue
            units.append(members)

        decisions: list[OptimiserDecision] = []
        gone: set[str] = set()  # job ids preempted by earlier decisions

        for members in units[: self.opt.max_stuck_jobs_per_cycle]:
            unit_decisions: list[OptimiserDecision] = []
            unit_gone = set(gone)
            unit_running = {k: list(v) for k, v in running_by_node.items()}
            ok = True
            for job in members:
                decision = self._place_one(
                    job,
                    nodes,
                    unit_running,
                    unit_gone,
                    actual_share,
                    fair_share,
                    max_size,
                    frozenset((banned_nodes or {}).get(job.id, ())),
                )
                if decision is None:
                    ok = False
                    break
                unit_decisions.append(decision)
                unit_gone.update(decision.preempted_job_ids)
                unit_running.setdefault(decision.node_id, []).append(
                    RunningJob(job=job, node_id=decision.node_id)
                )
            if not ok:
                continue  # all-or-nothing: discard the whole unit's plan
            decisions.extend(unit_decisions)
            gone = unit_gone
            running_by_node = unit_running
        return decisions

    def _place_one(
        self,
        job: JobSpec,
        nodes: Sequence[NodeSpec],
        running_by_node: Mapping[str, list],
        gone: set,
        actual_share: Mapping[str, float],
        fair_share: Mapping[str, float],
        max_size,
        banned: frozenset = frozenset(),
    ) -> Optional[OptimiserDecision]:
        req = (
            np.asarray(job.resources.atoms, dtype=np.float64) * self._node_axes
            if job.resources is not None
            else np.zeros(self._factory.num_resources)
        )
        job_pc = self.config.priority_class(job.priority_class)

        # static fit per node (taints/selector via node types)
        ntidx = NodeTypeIndex(
            set(self.config.indexed_node_labels) | set(job.node_selector)
        )
        kidx = SchedulingKeyIndex()
        kidx.key_of(job, self.config.node_id_label)
        type_of = [ntidx.type_of(n) for n in nodes]
        compat = static_fit_matrix(kidx.keys, ntidx.types)[0]

        best: Optional[tuple[float, OptimiserDecision]] = None
        for n, tid in zip(nodes, type_of):
            if n.unschedulable or not compat[tid] or n.total_resources is None:
                continue
            if n.id in banned:
                continue
            total = np.asarray(n.total_resources.atoms, dtype=np.float64) * self._node_axes
            residents = [
                r
                for r in running_by_node.get(n.id, [])
                if r.job.id not in gone
            ]
            used = np.zeros_like(total)
            for r in residents:
                if r.job.resources is not None:
                    used += np.asarray(r.job.resources.atoms, np.float64) * self._node_axes
            free = total - used
            if np.all(req <= free):
                # fits without preemption: the normal rounds will take it
                # next cycle; not an optimiser case (cost 0 still wins).
                return OptimiserDecision(job.id, n.id, [])

            # candidate victims in ideal order (node_scheduler.go:37-44):
            # away guests first, then over-fair-share queues (most over
            # first), then newest submission first; never jobs at a higher
            # priority class, never oversized victims.
            victims = []
            for r in residents:
                r_pc = self.config.priority_class(r.job.priority_class)
                if r.away:
                    # Away guests hold resources at the away level: always
                    # evictable by home jobs, whatever their PC says.
                    pass
                elif not r_pc.preemptible or r_pc.priority > job_pc.priority:
                    continue
                r_req = (
                    np.asarray(r.job.resources.atoms, np.float64)
                    if r.job.resources is not None
                    else np.zeros_like(total)
                )
                if max_size is not None and np.any(r_req > max_size):
                    continue
                over = actual_share.get(r.job.queue, 0.0) - fair_share.get(
                    r.job.queue, 0.0
                )
                victims.append((r, r_req * self._node_axes, over))
            if not victims:
                continue
            victims.sort(
                key=lambda v: (
                    not v[0].away,  # away guests first
                    -v[2],  # most over fair share first
                    -v[0].job.submit_time,  # newest first
                    v[0].job.id,
                )
            )

            chosen, freed, cost = [], free.copy(), 0.0
            for r, r_req, over in victims:
                if np.all(req <= freed):
                    break
                chosen.append(r)
                freed = freed + r_req
                # preemption cost: preferring victims already over their
                # share (negative over = protected-ish, higher cost)
                cost += max(0.0, 1.0 - over)
            if not np.all(req <= freed):
                continue  # even preempting everything eligible won't fit
            if best is None or cost < best[0]:
                best = (
                    cost,
                    OptimiserDecision(
                        job.id, n.id, [r.job.id for r in chosen]
                    ),
                )
        return best[1] if best else None
