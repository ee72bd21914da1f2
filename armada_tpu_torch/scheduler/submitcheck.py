"""SubmitChecker: can this job/gang ever schedule anywhere?

Equivalent of the reference's SubmitChecker (internal/scheduler/
submitcheck.go:44-75,181,243): a static feasibility check run at validation
time against the current executor fleet, so jobs that can never fit are
rejected up front with a reason instead of sitting queued forever (or, worse,
tripping round-termination constraints every cycle -- a pool-sized job would
otherwise starve everything behind it).

The check per pool mirrors getSchedulingResult/constructNodeDb: for a gang of
cardinality k with per-member request r, some set of *empty* nodes whose node
type statically fits (taints/selector) must hold all k members:
sum_n floor_r(node_total_n / r) >= k over statically-fitting nodes.  Results
are cached by (scheduling key, cardinality, uniformity label) until the
executor fleet changes (the reference's LRU keyed on scheduling key,
submitcheck.go:243).

The port's copy keeps each pool's node totals and node-type ids until the
fleet changes and computes the fit of all of a pool's nodes at once, where
the JAX package loops over the nodes: the requeue gate's checks (per job,
with its banned nodes, never cached) would otherwise cost a loop over the
pool per requeued job.  The verdicts and reasons are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.keys import (
    NodeTypeIndex,
    SchedulingKeyIndex,
    class_signature,
    static_fit_matrix,
)
from armada_tpu_torch.core.types import JobSpec
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot


@dataclasses.dataclass(frozen=True)
class CheckResult:
    ok: bool
    reason: str = ""
    # pools where the gang can in principle schedule (feeds JobValidated).
    pools: tuple[str, ...] = ()


class SubmitChecker:
    """Static schedulability of gangs against the executor fleet."""

    def __init__(self, config: SchedulingConfig):
        self.config = config
        self._factory = config.resource_list_factory()
        # pool -> (node_total f64[N, R], node_labels list[dict], node_taints)
        self._pools: dict[str, list] = {}
        self._cache: dict = {}
        # per fleet: pool -> (node totals f64[N, R], node ids), and
        # (pool, indexed labels) -> (NodeTypeIndex, type id per node)
        self._arrays: dict = {}
        self._fingerprint = None
        self._have_executors = False

    # --- fleet snapshot (reference: periodic executor refresh) --------------

    def update_executors(self, executors: Sequence[ExecutorSnapshot]) -> None:
        pools: dict[str, list] = {}
        for ex in executors:
            # Cordoned executors still COUNT here: cordon is a temporary
            # scheduling gate (filterCordonedExecutors applies per round),
            # not a statement that the capacity can never fit the job -- the
            # reference's submit check has no cordon filter (submitcheck.go),
            # so draining the fleet leaves jobs queued instead of terminally
            # failing validation (pinned by test_controlplane_events).
            for n in ex.nodes:
                if n.unschedulable or n.total_resources is None:
                    continue
                pools.setdefault(n.pool, []).append(n)
        # Invalidate cached verdicts only when the fleet actually changed --
        # update_executors runs every cycle, the fleet changes rarely.
        fingerprint = tuple(
            sorted(
                (
                    pool,
                    n.id,
                    tuple(int(a) for a in n.total_resources.atoms),
                    n.taints,
                    tuple(sorted(n.labels.items())),
                    # a retyped node changes which whitelisted jobs fit; a
                    # fingerprint without it would serve stale verdicts
                    # (the round-5 lesson: ONE identity, core/keys)
                    n.node_type,
                )
                for pool, nodes in pools.items()
                for n in nodes
            )
        )
        if fingerprint != self._fingerprint:
            self._pools = pools
            self._cache = {}
            self._arrays = {}
            self._fingerprint = fingerprint
        self._have_executors = bool(executors)

    @property
    def have_executors(self) -> bool:
        return self._have_executors

    # --- the check (submitcheck.go Check:181) -------------------------------

    def check_gang(
        self, members: Sequence[JobSpec], banned_nodes: Sequence[str] = ()
    ) -> CheckResult:
        """All members share a scheduling shape (validation enforces gang
        consistency); singleton jobs are gangs of one.

        banned_nodes: node ids excluded from fit -- retry anti-affinity, used
        by the requeue gate (scheduler.go:826-840: a retried job is failed
        terminally if it cannot schedule once its attempted nodes are
        excluded)."""
        if not members:
            return CheckResult(False, "empty gang")
        lead = members[0]
        # Per-key-class member grouping: a heterogeneous gang is only
        # schedulable if EVERY class fits (the round kernel enforces gang
        # atomicity, so a never-schedulable class means the whole gang sits
        # queued forever -- exactly what this check exists to reject).
        by_sig: dict = {}
        for m in members:
            by_sig.setdefault(
                class_signature(m, self.config.node_id_label), []
            ).append(m)
        if len(by_sig) == 1:
            # Trust the declared cardinality over the members seen in this
            # batch: a partially-arrived gang must be judged at full size.
            classes = [(lead, max(len(members), lead.gang_cardinality or 1))]
        else:
            classes = [(grp[0], len(grp)) for grp in by_sig.values()]
            # Partially-arrived heterogeneous gang: unseen members have
            # unknown shapes; attribute the missing count to the first class
            # so the declared cardinality still gates feasibility.
            declared = lead.gang_cardinality or 1
            if declared > len(members):
                clead, count = classes[0]
                classes[0] = (clead, count + declared - len(members))

        banned = frozenset(banned_nodes)
        if banned:
            # Ban sets are per-job and near-unique; caching them would grow the
            # cache without bound between fleet changes (the reference bounds
            # its cache with an LRU, submitcheck.go:243).  Gate calls are rare.
            return self._check_uncached(classes, banned)
        kidx = SchedulingKeyIndex()
        key_ids = tuple(
            (
                kidx.key_of(
                    m,
                    self.config.node_id_label,
                    uniformity=(lead.gang_node_uniformity_label, ""),
                ),
                count,
            )
            for m, count in classes
        )
        cache_key = (
            tuple((kidx.keys[kid], count) for kid, count in key_ids),
            tuple(lead.pools),
        )
        cached = self._cache.get(cache_key)
        if cached is not None:
            return cached

        result = self._check_uncached(classes)
        self._cache[cache_key] = result
        return result

    def _pool_arrays(self, pool: str, labels: frozenset):
        """(node totals f64[N, R], node ids, NodeTypeIndex, type ids i64[N])
        of one pool's nodes for one set of indexed labels, kept until the
        fleet changes."""
        base = self._arrays.get(pool)
        if base is None:
            nodes = self._pools[pool]
            totals = np.array(
                [np.asarray(n.total_resources.atoms, dtype=np.float64) for n in nodes],
                dtype=np.float64,
            ).reshape(len(nodes), self._factory.num_resources)
            base = self._arrays[pool] = (totals, [n.id for n in nodes])
        typed = self._arrays.get((pool, labels))
        if typed is None:
            ntidx = NodeTypeIndex(labels)
            type_ids = np.array([ntidx.type_of(n) for n in self._pools[pool]], dtype=np.int64)
            typed = self._arrays[(pool, labels)] = (ntidx, type_ids)
        return base + typed

    def _check_uncached(
        self, classes, banned: frozenset = frozenset()
    ) -> CheckResult:
        """classes: [(lead job, member count)] -- one per key class; every
        class must fit, within one uniformity domain when the gang declares
        a uniformity label."""
        lead = classes[0][0]
        cardinality = sum(count for _, count in classes)
        # Floating resources are pool-level, not node-level: exclude them from
        # per-node fit and check them against the pool's floating totals
        # (floating_resource_types.go; the kernel applies the same split).
        floating_names = set(self.config.floating_resource_names())
        floating_axes = np.array(
            [1.0 if n in floating_names else 0.0 for n in self._factory.names]
        )
        # Pools that may host this job away from home (scheduling_algo.go:282:
        # a pool's jobs may borrow nodes from its away_pools): feasibility
        # there validates the job, but its pools stay the home ones -- only
        # the away pass may use the host pool, at away priority.
        away_hosts = {
            host
            for pc in self.config.pools
            if pc.name in lead.pools
            for host in pc.away_pools
        }
        candidate_pools = [
            p
            for p in self._pools
            if not lead.pools or p in lead.pools or p in away_hosts
        ]
        if not candidate_pools:
            return CheckResult(
                False,
                "no executor cluster provides "
                + (f"pools {list(lead.pools)}" if lead.pools else "any nodes"),
            )

        # A node-type whitelist naming ONLY types the fleet doesn't have can
        # never schedule: reject with the names, not the generic no-fit
        # reason (and never an IndexError out of the compat matrix --
        # static_fit_matrix gates by type name, so an unknown name is an
        # all-false row, which this check turns into words).
        fleet_types = {
            n.node_type
            for p in candidate_pools
            for n in self._pools[p]
        }
        for clead, _count in classes:
            named = {t for t, thr in clead.node_type_scores if thr > 0}
            if named and not (named & fleet_types):
                return CheckResult(
                    False,
                    f"node-type-scores restricts to node types "
                    f"{sorted(named)}, but no such node exists (fleet has "
                    f"{sorted(t or '(untyped)' for t in fleet_types)})",
                )

        # Per-class node-bound and floating request vectors.
        class_reqs = []
        total_float = np.zeros(self._factory.num_resources, dtype=np.float64)
        for clead, count in classes:
            creq = (
                np.asarray(clead.resources.atoms, dtype=np.float64)
                if clead.resources is not None
                else np.zeros(self._factory.num_resources)
            )
            class_reqs.append((clead, count, creq * (1.0 - floating_axes)))
            total_float += creq * floating_axes * count

        ok_pools = []
        ok_away = False
        best_reason = "does not fit on any node type"
        for pool in candidate_pools:
            if np.any(total_float) and floating_names:
                fl = self._factory.from_mapping(
                    self.config.floating_totals_for_pool(pool)
                )
                fl_total = np.asarray(fl.atoms, dtype=np.float64)
                if np.any(total_float > fl_total):
                    over = {
                        self._factory.names[i]: int(total_float[i] - fl_total[i])
                        for i in range(len(total_float))
                        if total_float[i] > fl_total[i]
                    }
                    best_reason = (
                        f"pool {pool}: floating-resource request exceeds the "
                        f"pool total by {over}"
                    )
                    continue
            nodes = self._pools[pool]
            all_selector_labels = set().union(
                *(set(c.node_selector) for c, _, _ in class_reqs)
            )
            # The nodes' totals and type ids are kept per fleet; the fit of
            # every node is computed at once (the same float operations, node
            # by node, as a loop over the nodes).
            totals, node_ids, ntidx, type_of_node = self._pool_arrays(
                pool,
                frozenset(set(self.config.indexed_node_labels) | all_selector_labels),
            )
            kidx = SchedulingKeyIndex()
            # Index compat by each class's interned key id: classes that
            # key_of dedupes (e.g. differing only in the excluded node-id
            # label) share a row instead of running the matrix off the end.
            class_key_ids = [
                kidx.key_of(clead, self.config.node_id_label)
                for clead, _, _ in class_reqs
            ]
            compat = static_fit_matrix(kidx.keys, ntidx.types)

            # Node uniformity: all members of every class must land in ONE
            # label-value domain (gang_scheduler.go NodeUniformity); count
            # per-class capacity per domain, then find a domain satisfying
            # every class.
            label = lead.gang_node_uniformity_label
            usable = np.ones(len(nodes), dtype=bool)
            if banned:
                usable &= np.array([i not in banned for i in node_ids], dtype=bool)
            if label:
                # unlabeled nodes can't host a uniformity gang
                domain_of = [n.labels.get(label) for n in nodes]
                usable &= np.array([d is not None for d in domain_of], dtype=bool)
            biggest_gap = None
            per_class_domains: list[dict] = []
            for ci, (clead, count, creq_node) in enumerate(class_reqs):
                ok = compat[class_key_ids[ci]][type_of_node] & usable
                with np.errstate(divide="ignore", invalid="ignore"):
                    per_node = np.floor(
                        np.where(
                            creq_node > 0,
                            totals / np.maximum(creq_node, 1e-9),
                            np.inf,
                        )
                    ).min(axis=1)
                # All-zero requests give inf; clip before int() (one bad
                # event on the log must not wedge the scheduler thread).
                per_node = np.minimum(per_node, float(count))
                short = ok & (per_node <= 0)
                if short.any():
                    t = totals[short]
                    gap = np.where(creq_node > t, creq_node - t, 0).min(axis=0)
                    biggest_gap = (
                        gap if biggest_gap is None else np.minimum(biggest_gap, gap)
                    )
                members_by_domain: dict = {}
                fits = np.flatnonzero(ok & (per_node > 0))
                if len(fits) and not label:
                    members_by_domain[""] = int(per_node[fits].astype(np.int64).sum())
                for i in fits if label else ():
                    domain = domain_of[i]
                    members_by_domain[domain] = members_by_domain.get(
                        domain, 0
                    ) + int(per_node[i])
                per_class_domains.append(members_by_domain)

            # A domain works iff every class's count fits in it; report the
            # best total for the reason string.
            domains = set().union(*(d.keys() for d in per_class_domains)) or {""}
            members_possible = 0
            feasible = False
            for d in domains:
                per = [
                    min(pcd.get(d, 0), count)
                    for pcd, (_, count, _) in zip(per_class_domains, class_reqs)
                ]
                members_possible = max(members_possible, sum(per))
                if all(
                    pcd.get(d, 0) >= count
                    for pcd, (_, count, _) in zip(per_class_domains, class_reqs)
                ):
                    feasible = True
                    break
            if feasible:
                if lead.pools and pool not in lead.pools:
                    ok_away = True  # fits only as an away guest
                else:
                    ok_pools.append(pool)
            elif members_possible > 0:
                best_reason = (
                    f"pool {pool}: only {members_possible} of {cardinality} "
                    "gang members fit on empty nodes"
                )
            elif biggest_gap is not None:
                over = {
                    self._factory.names[i]: int(biggest_gap[i])
                    for i in range(len(biggest_gap))
                    if biggest_gap[i] > 0
                }
                best_reason = (
                    f"pool {pool}: request exceeds every node's capacity by {over}"
                )

        if ok_pools:
            return CheckResult(True, pools=tuple(sorted(ok_pools)))
        if ok_away:
            # Feasible only away: keep the home designation; the away pass
            # picks it up (scheduling_algo.go:216-283).
            return CheckResult(True, pools=tuple(lead.pools))
        return CheckResult(False, best_reason)
