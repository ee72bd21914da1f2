"""Indicative gang pricing for market-driven pools.

Equivalent of the reference's pricer stack (internal/scheduler/scheduling/
pricer/gang_pricer.go:29-110, pricer/node_scheduler.go MinPriceNodeScheduler,
market_driven_indicative_pricer.go): given a configured gang *shape*
(GangDefinition), determine the minimum bid price at which the gang could be
scheduled against the current pool state.  Per member, each statically-fitting
node is scored by the price needed to free room -- 0 if it fits in spare
capacity, else the highest bid among the cheapest set of running jobs whose
preemption frees enough (cheapest-first eviction, node_scheduler.go:66-86) --
and the cheapest node wins; the gang's price is the max over members
(gang_pricer.go:146).  Node-uniformity labels partition the search into node
groups, lowest-cost group wins (gang_pricer.go:70-105).

This is a host-side pure read of the round state (invoking it has no side
effects, market_driven_indicative_pricer.go:51); results surface as the
armada_scheduler_indicative_price{pool,name} metrics (cycle_metrics.go:534).

The port's copy of the JAX package's scheduler/pricer.py: host numpy, no
device work.  Residents sort by (bid, job id) with Python's stable sort and
numpy's lexsort, never torch.sort (not stable by default), so ties break as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from armada_tpu_torch.core.config import GangDefinition, SchedulingConfig
from armada_tpu_torch.core.types import (
    JobSpec,
    NodeSpec,
    RunningJob,
    selector_matches,
    taints_tolerated,
)

# Canonical unschedulable reasons (market_driven_indicative_pricer.go:21-25,
# gang_pricer.go:17-20).
GANG_EXCEEDS_ALLOCATABLE = (
    "The requested gang resources exceed the available capacity for scheduling"
)
GANG_CARDINALITY_ZERO = "The gang has cardinality zero"
UNIFORMITY_NOT_INDEXED = "uniformity label is not indexed"
NO_NODES_WITH_UNIFORMITY = "no nodes with uniformity label"
DOES_NOT_FIT = "job/gang does not fit on any node"


@dataclasses.dataclass(frozen=True)
class GangPricingResult:
    """pricer.GangPricingResult: can the shape schedule, and at what price."""

    evaluated: bool
    schedulable: bool
    price: float = 0.0
    unschedulable_reason: str = ""


class IndicativeGangPricer:
    """Prices configured gang shapes against a pool's live placement state."""

    def __init__(self, config: SchedulingConfig):
        self.config = config
        self._factory = config.resource_list_factory()
        floating = set(config.floating_resource_names())
        self._node_axes = np.array(
            [0.0 if n in floating else 1.0 for n in self._factory.names]
        )

    def price_pool_gangs(
        self,
        pool: str,
        nodes: Sequence[NodeSpec],
        running: Sequence[RunningJob],
        price_of: Callable[[JobSpec], float],
    ) -> dict:
        """{shape name: GangPricingResult} for the pool's configured shapes
        (MarketDrivenIndicativePricer.Price)."""
        pool_cfg = next((p for p in self.config.pools if p.name == pool), None)
        if pool_cfg is None or not pool_cfg.gangs_to_price:
            return {}
        prepared = self._prepare(pool, nodes, running, price_of)
        out = {}
        for name, definition in pool_cfg.gangs_to_price:
            out[name] = self._price_prepared(definition, prepared)
        return out

    def _prepare(
        self,
        pool: str,
        nodes: Sequence[NodeSpec],
        running: Sequence[RunningJob],
        price_of: Callable[[JobSpec], float],
    ) -> dict:
        """Shape-independent pool state, computed once per cycle: filtered
        nodes, totals, and per-node residents as (vec matrix, bid vector)
        pairs sorted cheapest-first (bid, then job id)."""
        pool_nodes = [n for n in nodes if n.pool == pool and not n.unschedulable]
        total = np.zeros((self._factory.num_resources,), np.float64)
        by_node: dict[str, list] = {}
        for r in running:
            vec = (
                np.asarray(r.job.resources.atoms, np.float64) * self._node_axes
                if r.job.resources is not None
                else np.zeros_like(total)
            )
            by_node.setdefault(r.node_id, []).append(
                (vec, float(price_of(r.job)), r.job.id)
            )
        residents: dict[str, tuple] = {}
        for nid, rs in by_node.items():
            rs.sort(key=lambda t: (t[1], t[2]))
            residents[nid] = (
                np.stack([t[0] for t in rs]),
                np.array([t[1] for t in rs], np.float64),
            )
        for n in pool_nodes:
            if n.total_resources is not None:
                total += np.asarray(n.total_resources.atoms, np.float64)
        return {"pool_nodes": pool_nodes, "total": total, "residents": residents}

    def price_pool_gangs_columnar(
        self, pool: str, nodes: Sequence[NodeSpec], builder, price_of,
        price_table=None,
    ) -> dict:
        """price_pool_gangs with residents read straight from the incremental
        builder's post-round run columns (models/incremental.py) -- no
        RunningJob materialisation, the market cycle's O(running) Python walk
        replaced by one lexsort."""
        pool_cfg = next((p for p in self.config.pools if p.name == pool), None)
        if pool_cfg is None or not pool_cfg.gangs_to_price:
            return {}
        prepared = self._prepare_columnar(
            pool, nodes, builder, price_of, price_table
        )
        out = {}
        for name, definition in pool_cfg.gangs_to_price:
            out[name] = self._price_prepared(definition, prepared)
        return out

    def _prepare_columnar(
        self, pool: str, nodes: Sequence[NodeSpec], builder, price_of,
        price_table=None,
    ) -> dict:
        """Array residents from the builder's runs table: vec = raw atoms x
        node axes (the table's `atoms` mirror), bid = the (queue, band) price
        table, sorted (bid, id) per node exactly like _prepare."""
        pool_nodes = [n for n in nodes if n.pool == pool and not n.unschedulable]
        total = np.zeros((self._factory.num_resources,), np.float64)
        for n in pool_nodes:
            if n.total_resources is not None:
                total += np.asarray(n.total_resources.atoms, np.float64)
        rt = builder.runs
        rows = rt.live_rows()
        if rows.size:
            # deleted queues' runs stop counting (the legacy running scan's
            # known-queues filter; incremental.py set_queues)
            rows = rows[builder.queue_known[rt.qi[rows]]]
        residents: dict[str, tuple] = {}
        if rows.size:
            from armada_tpu_torch.scheduler.idealised_columnar import _band_price_table

            table = (
                price_table
                if price_table is not None
                else _band_price_table(builder, price_of)
            )
            node_i = rt.node[rows].astype(np.int64)
            bids = table[rt.qi[rows].astype(np.int64), rt.band[rows].astype(np.int64)]
            ids = rt.ids[rows]
            vecs = rt.atoms[rows].astype(np.float64) * self._node_axes[None, :]
            order = np.lexsort((ids, bids, node_i))
            node_i, bids, vecs = node_i[order], bids[order], vecs[order]
            starts = np.flatnonzero(
                np.concatenate([[True], node_i[1:] != node_i[:-1]])
            )
            bounds = np.append(starts, node_i.shape[0])
            for s, e in zip(bounds[:-1], bounds[1:]):
                nid = builder.node_ids[node_i[s]]
                residents[nid] = (vecs[s:e], bids[s:e])
        return {"pool_nodes": pool_nodes, "total": total, "residents": residents}

    def price_gang(
        self,
        definition: GangDefinition,
        pool: str,
        nodes: Sequence[NodeSpec],
        running: Sequence[RunningJob],
        price_of: Callable[[JobSpec], float],
    ) -> GangPricingResult:
        return self._price_prepared(
            definition, self._prepare(pool, nodes, running, price_of)
        )

    def _price_prepared(
        self, definition: GangDefinition, prepared: dict
    ) -> GangPricingResult:
        if definition.size <= 0:
            return GangPricingResult(True, False, 0.0, GANG_CARDINALITY_ZERO)

        req = np.asarray(
            self._factory.from_mapping(definition.resources).atoms, np.float64
        )
        req_node = req * self._node_axes
        pool_nodes = prepared["pool_nodes"]
        total = prepared["total"]
        if np.any(req_node * definition.size > total * self._node_axes):
            return GangPricingResult(True, False, 0.0, GANG_EXCEEDS_ALLOCATABLE)

        # --- uniformity grouping (gang_pricer.go:70-105,196-225) -------------
        label = definition.node_uniformity
        if label:
            indexed = set(self.config.indexed_node_labels)
            if label not in indexed:
                return GangPricingResult(True, False, 0.0, UNIFORMITY_NOT_INDEXED)
            groups: dict[str, list] = {}
            for n in pool_nodes:
                v = n.labels.get(label)
                if v is not None:
                    groups.setdefault(v, []).append(n)
            if not groups:
                return GangPricingResult(True, False, 0.0, NO_NODES_WITH_UNIFORMITY)
            node_groups = list(groups.values())
        else:
            node_groups = [pool_nodes]

        best: Optional[float] = None
        for group in node_groups:
            price = self._price_on_group(
                definition, req_node, group, prepared["residents"]
            )
            if price is not None and (best is None or price < best):
                best = price
        if best is None:
            return GangPricingResult(True, False, 0.0, DOES_NOT_FIT)
        return GangPricingResult(True, True, best, "")

    def _price_on_group(
        self,
        definition: GangDefinition,
        req_node: np.ndarray,
        group: Sequence[NodeSpec],
        residents_by_node: Mapping[str, tuple],
    ) -> Optional[float]:
        """Min price to place all members on this node group, else None
        (gang_pricer.go scheduleOnNodes:113-160).  Per member, the winner is
        the first node in group order whose spare capacity fits (free-fit
        short-circuit, gang_pricer.go:133), else the min-eviction-price node
        (strict <, so first index wins ties); cheapest-first eviction within
        a node.  State is array-based: one flat vectorized pass computes the
        initial per-node (eviction count, price) table, then each placement
        recomputes only its own node -- all arithmetic is integer-valued
        f64, so the flat sums match the legacy sequential ones exactly."""
        selector = dict(definition.node_selector)
        tolerations = tuple(definition.tolerations)
        R = req_node.shape[0]
        empty = (np.zeros((0, R), np.float64), np.zeros((0,), np.float64))
        free_l, vecs_l, bids_l = [], [], []
        for n in group:
            if n.total_resources is None:
                continue
            if not taints_tolerated(n.taints, tolerations):
                continue
            if not selector_matches(selector, n.labels):
                continue
            vecs, bids = residents_by_node.get(n.id, empty)
            free_l.append(
                np.asarray(n.total_resources.atoms, np.float64) * self._node_axes
                - vecs.sum(axis=0)
            )
            vecs_l.append(vecs)
            bids_l.append(bids)
        N = len(free_l)
        if N == 0:
            return None
        free = np.stack(free_l)  # [N, R]
        k = np.array([v.shape[0] for v in vecs_l], np.int64)
        seg = np.zeros((N + 1,), np.int64)
        np.cumsum(k, out=seg[1:])
        T = int(seg[-1])
        flat_vec = (
            np.concatenate(vecs_l, axis=0) if T else np.zeros((0, R), np.float64)
        )
        flat_bid = np.concatenate(bids_l) if T else np.zeros((0,), np.float64)
        # cumulative freed capacity within each node's cheapest-first slice
        cum = np.cumsum(flat_vec, axis=0)
        shift = np.vstack([np.zeros((1, R)), cum])[seg[:-1]]  # [N, R]
        node_of = np.repeat(np.arange(N), k)
        cumseg = cum - shift[node_of] if T else cum
        # initial per-node first-fit table
        evict = np.full((N,), -1, np.int64)
        price = np.full((N,), np.inf, np.float64)
        if T:
            fits_flat = (free[node_of] + cumseg >= req_node[None, :]).all(axis=1)
            tidx = np.flatnonzero(fits_flat)
            if tidx.size:
                pos = np.searchsorted(tidx, seg[:-1])
                first = tidx[np.minimum(pos, tidx.size - 1)]
                valid = (pos < tidx.size) & (first < seg[1:])
                evict = np.where(valid, first - seg[:-1] + 1, -1)
                price = np.where(valid, flat_bid[first], np.inf)
        freefit = (free >= req_node[None, :]).all(axis=1)
        c = np.zeros((N,), np.int64)  # evicted-so-far offsets

        gang_price = 0.0
        for _ in range(definition.size):
            ff = np.flatnonzero(freefit)
            if ff.size:
                b, best_price, best_evict = int(ff[0]), 0.0, 0
            else:
                cand = np.flatnonzero(evict >= 0)
                if cand.size == 0:
                    return None
                b = int(cand[np.argmin(price[cand])])
                best_price, best_evict = float(price[b]), int(evict[b])
            s0 = int(seg[b] + c[b])
            if best_evict:
                free[b] += flat_vec[s0 : s0 + best_evict].sum(axis=0)
                c[b] += best_evict
            free[b] -= req_node
            gang_price = max(gang_price, best_price)
            # refresh only node b
            s, e = int(seg[b] + c[b]), int(seg[b + 1])
            freefit[b] = bool((free[b] >= req_node).all())
            evict[b], price[b] = -1, np.inf
            if e > s:
                freed_b = free[b] + np.cumsum(flat_vec[s:e], axis=0)
                hit = np.flatnonzero(
                    (freed_b >= req_node[None, :]).all(axis=1)
                )
                if hit.size:
                    evict[b] = int(hit[0]) + 1
                    price[b] = float(flat_bid[s + int(hit[0])])
        return gang_price
