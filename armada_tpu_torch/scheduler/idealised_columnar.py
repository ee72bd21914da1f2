"""Idealised scheduled value straight from the incremental builder's columns.

Same quantity as scheduler/idealised.calculate_idealised_values (the
analogue of internal/scheduler/scheduling/idealised_value.go:21-101): re-run
the market round on a boundary-less "mega node" holding the pool's total
resources, static requirements stripped, per-round limits off, and value the
scheduled set at bid x resource units.  The legacy path materialises a
JobSpec per backlog entry and runs the round kernel; at 1M queued jobs that
spec walk is the only remaining O(backlog) Python in a market cycle
(algo.py need_job_scan).  This module computes the SAME scheduled set from
models/incremental.IncrementalBuilder columns.

On the mega problem the kernel collapses --- empty cluster (no eviction, all
priority levels see identical allocatable), one unlabeled node (static fit
always true after stripping), per-round caps off --- to a single
deterministic admission order: each iteration picks the queue head with the
max f32 bid (ties: lowest queue index; market pools never use prefer-large,
models/__init__.py kernel_kwargs), and queue streams are price-sorted, so
the admission order is exactly sort-by (-f32 price, queue index,
within-queue market order).  Three things interrupt plain greedy admission,
all mirrored here:

  * per-(queue, pc) allocation caps (maximumResourceFractionPerQueue) stay
    ACTIVE in the permissive config; a candidate tripping one KILLS its
    queue for the round (fair_scheduler.py gate_queue -> q_killed), and the
    gate runs BEFORE the fit check;
  * unfeasible-key retirement (fair_scheduler.py:644-650): a failed card-1
    candidate's scheduling key is retired and identical-key entries are
    SKIPPED from then on -- skipped entries are never candidates, so they
    get NO gate check (a retired shape can therefore never kill a queue,
    while an equal-shape DIFFERENT-key row still can);
  * the all-or-nothing group unwind for split heterogeneous gangs
    (models/__init__.py:44-69), re-run with doomed groups invalidated.

The sweep runs blocked: within a block every still-active row is assumed
admitted, one vectorized pass finds the first violation event (gate trip or
fit failure), the event is applied (queue killed from that position / key
retired / unit failed), and the block re-evaluates; event-free blocks
commit in one step.  Work is O(n*R) + O(events * B*R) with events bounded
by the distinct failing scheduling keys + queues + gang units -- real
backlogs are template-shaped, so events are few.

The port's copy of the JAX package's scheduler/idealised_columnar.py: host
numpy over the port builder's columns, no device work.  tests/
test_torch_market.py holds it against the JAX sweep on the same worlds.
Exactness against the kernel path is pinned by
tests/test_market_columnar.py's randomized cross-checks (dozens of seeds
incl. tight capacity, lookback truncation, split gangs, the per-(queue, pc)
cap queue-kill, plus full-algo mode-equivalence runs).

Known bound: the sweep accumulates per-(queue, pc) allocation in
f64 while the kernel's gate accumulates q_alloc in f32.  The two paths agree
while every (queue, pc, resource) allocation stays below ~2^24 resolution
units (f32 integer-exact range); past that the kernel's f32 sum rounds and a
cap trip sitting exactly on the boundary can flip between the paths.  The
cap *threshold* itself is shared f32 (pc_queue_caps), so the divergence is
metric-only and requires both >16M units on one (queue, pc, resource) AND a
trip within one rounding ulp of the boundary -- accepted, not mirrored,
because the f64 sweep is the more accurate of the two.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.keys import SchedulingKeyIndex, class_signature
from armada_tpu_torch.core.ordering import scheduling_order_key
from armada_tpu_torch.core.types import JobSpec, NodeSpec
from armada_tpu_torch.models.problem import (
    _GangFitContext,
    _joint_capacity_ok,
    _uniform_domain_ban,
)
from armada_tpu_torch.scheduler.idealised import (
    DEFAULT_RESOURCE_UNIT,
    _strip_static_requirements,
)

_SWEEP_BLOCK = 8192


class _Unit:
    """One gang candidate unit (sub-gang after heterogeneous splitting)."""

    __slots__ = (
        "qi", "price64", "sub", "id", "need", "sig", "kkey",
        "card", "value", "nmembers", "tag", "dead", "pc",
    )

    def __init__(self):
        self.tag = ""
        self.dead = False


def _band_price_table(builder, bid_price_of) -> np.ndarray:
    """f64[Q, B] bid prices (the builder's _prices() without the f32 cast:
    build_problem's unit sort compares f64 prices; only the cross-queue
    kernel comparison is f32)."""
    from armada_tpu_torch.models.incremental import _BandProbe

    Q = max(1, len(builder.queue_names))
    B = max(1, len(builder.bands))
    table = np.zeros((Q, B), np.float64)
    for qname, qi in builder.queue_by_name.items():
        for band, bi in builder._band_index.items():
            table[qi, bi] = float(bid_price_of(_BandProbe(qname, band)))
    return table


def calculate_idealised_values_columnar(
    config: SchedulingConfig,
    *,
    pool: str,
    builder,
    bid_price_of: Callable[[JobSpec], float],
    extra_candidates: tuple = (),
    price_table: "np.ndarray | None" = None,
) -> dict:
    """{queue: idealised value} over the builder's backlog + leased sets.

    `extra_candidates`: specs that left the builder tables this cycle but
    were running when the round started -- the legacy path feeds the mega
    round the PRE-round running list (idealised_value.go:68-76), so jobs
    preempted this cycle are still candidates; the algo passes them from
    the outcome (O(preempted)).  `price_table` shares one per-cycle
    _band_price_table build with the indicative pricer.

    Mirrors calculate_idealised_values feature-for-feature: queued singles
    and every running job re-enter as candidates (idealised_value.go:68-76),
    gang siblings regroup across the queued/running split, heterogeneous
    gangs split per scheduling-key class with the joint-capacity dead check
    and the all-or-nothing group unwind, per-queue lookback cap with atomic
    split-gang truncation, floating-resource pool gate, per-(queue, pc)
    allocation caps with the queue kill, unfeasible-key retirement.
    Valuation uses the default resource unit (value_of_jobs)."""
    factory = builder.factory
    R = factory.num_resources

    # --- mega-node capacity (sum RAW atoms, floor-quantise ONCE, exactly as
    # --- the legacy mega NodeSpec flows through build_problem) --------------
    total_atoms = np.zeros((R,), np.int64)
    have_node = False
    for i, spec in enumerate(builder.node_specs):
        if not builder.node_present[i] or spec.pool != pool or spec.unschedulable:
            continue
        have_node = True
        if spec.total_resources is not None:
            total_atoms += np.asarray(spec.total_resources.atoms, np.int64)
    if not have_node:
        return {}

    floating = set(config.floating_resource_names())
    node_axes = np.array(
        [0.0 if name in floating else 1.0 for name in factory.names], np.float64
    )
    mega_units = factory.floor_units(total_atoms).astype(np.float64)
    float_total = np.zeros((R,), np.float64)
    if floating:
        fl = factory.from_mapping(config.floating_totals_for_pool(pool))
        float_total = factory.floor_units(fl.atoms).astype(np.float64) * (
            1.0 - node_axes
        )
    # One combined per-axis budget: node axes get the mega allocatable, float
    # axes the pool float cap + the kernel's 1e-3 epsilon
    # (fair_scheduler.py:425 float gate); fit viol <=> need > cap - consumed.
    cap_fit = mega_units * node_axes + (float_total + 1e-3) * (1.0 - node_axes)

    unit_vec = np.asarray(
        factory.from_mapping(DEFAULT_RESOURCE_UNIT).atoms, np.float64
    )

    price64 = (
        price_table
        if price_table is not None
        else _band_price_table(builder, bid_price_of)
    )
    qok = builder.queue_known & (builder.queue_weight > 0)

    # --- vector candidates: columnar singles + every pools-compatible run ---
    jt, rt = builder.jobs, builder.runs
    jrows = jt.live_rows()
    rrows = rt.live_rows()
    if rrows.size:
        rrows = rrows[rt.pok[rrows]]
    # running gang members regroup into gang units (below) exactly like the
    # legacy candidate list -- drop their table rows or they'd count twice
    if rrows.size and builder.running_gang_specs:
        gang_row_ids = np.array(
            [k.encode() for k in builder.running_gang_specs], rt.ids.dtype
        )
        rrows = rrows[~np.isin(rt.ids[rrows], gang_row_ids)]
    qi = np.concatenate([jt.qi[jrows], rt.qi[rrows]]).astype(np.int64)
    band = np.concatenate([jt.band[jrows], rt.band[rrows]]).astype(np.int64)
    sub = np.concatenate([jt.sub[jrows], rt.sub[rrows]])
    ids = np.concatenate([jt.ids[jrows], rt.ids[rrows]])
    need = np.concatenate(
        [jt.req[jrows], rt.req[rrows]], axis=0
    ).astype(np.float64)
    pcrow = np.concatenate([jt.pc[jrows], rt.pc[rrows]]).astype(np.int64)
    prio = np.concatenate([jt.prio[jrows], rt.prio[rrows]]).astype(np.int64)
    if jt.atoms is None:
        raise ValueError("idealised_columnar requires a market builder")
    atoms = np.concatenate([jt.atoms[jrows], rt.atoms[rrows]], axis=0)
    hasres = np.concatenate([jt.hasres[jrows], rt.hasres[rrows]])

    price = price64[qi, band]
    # bans-only entries in gang_jobs have no gang id: the mega round drops
    # bans (calculate_idealised_values passes none), so they are plain
    # singles there.  Their bands were never interned -> price them
    # directly off the provider (build_problem prices units the same way).
    # Pre-round-running extras (preempted this cycle) join the same way.
    extra_specs = [s for s in builder.gang_jobs.values() if not s.gang_id]
    extra_gang_specs = []
    for s in extra_candidates:
        if s.pools and pool not in s.pools:
            continue
        if s.queue not in builder.queue_by_name:
            continue
        (extra_gang_specs if s.gang_id else extra_specs).append(s)
    if extra_specs:
        e_qi = np.array(
            [builder.queue_by_name[s.queue] for s in extra_specs], np.int64
        )
        e_sub = np.array([s.submit_time for s in extra_specs], np.float64)
        e_ids = np.array([s.id.encode() for s in extra_specs], ids.dtype)
        e_req = np.stack(
            [
                factory.ceil_units(s.resources.atoms).astype(np.float64)
                if s.resources is not None
                else np.zeros((R,), np.float64)
                for s in extra_specs
            ]
        )
        e_atoms = np.stack(
            [
                np.asarray(s.resources.atoms, np.int64)
                if s.resources is not None
                else np.zeros((R,), np.int64)
                for s in extra_specs
            ]
        )
        e_has = np.array([s.resources is not None for s in extra_specs], bool)
        e_price = np.array(
            [float(bid_price_of(s)) for s in extra_specs], np.float64
        )
        e_pc = np.array(
            [
                builder.pc_index[config.priority_class(s.priority_class).name]
                for s in extra_specs
            ],
            np.int64,
        )
        e_prio = np.array([s.priority for s in extra_specs], np.int64)
        qi = np.concatenate([qi, e_qi])
        sub = np.concatenate([sub, e_sub])
        ids = np.concatenate([ids, e_ids])
        need = np.concatenate([need, e_req], axis=0)
        atoms = np.concatenate([atoms, e_atoms], axis=0)
        hasres = np.concatenate([hasres, e_has])
        price = np.concatenate([price, e_price])
        pcrow = np.concatenate([pcrow, e_pc])
        prio = np.concatenate([prio, e_prio])

    keep = qok[qi]
    qi, sub, ids = qi[keep], sub[keep], ids[keep]
    need, atoms, hasres = need[keep], atoms[keep], hasres[keep]
    price, pcrow, prio = price[keep], pcrow[keep], prio[keep]
    n_rows = qi.shape[0]

    # Per-(queue, priority-class) allocation caps stay ACTIVE in the mega
    # round (idealised.py's permissive config clears only the per-round
    # limits); same f32 math as the kernel problems (problem.pc_queue_caps).
    from armada_tpu_torch.models.problem import pc_queue_caps

    pc_queue_cap = pc_queue_caps(
        config,
        builder.pc_names,
        factory,
        (mega_units + float_total).astype(np.float32),
    ).astype(np.float64)

    # per-row valuation: price x max_r(raw atoms / unit) (value_of_jobs)
    with np.errstate(divide="ignore", invalid="ignore"):
        vu = np.where(
            unit_vec[None, :] > 0,
            atoms.astype(np.float64) / np.maximum(unit_vec[None, :], 1e-12),
            0.0,
        )
    val = vu.max(axis=1) if vu.shape[0] else np.zeros((0,))
    rowvalue = np.where(hasres, price * val, 0.0)

    # --- gang units ---------------------------------------------------------
    mega = NodeSpec(id="__mega__", pool=pool)
    fitctx = _GangFitContext(
        [mega],
        mega_units[None, :].astype(np.float32),
        {"__mega__": 0},
        factory,
        node_axes,
    )
    kidx = SchedulingKeyIndex()
    nil = config.node_id_label
    by_gang: dict[tuple, list] = {}
    seen = set()
    for s in builder.gang_jobs.values():
        if not s.gang_id:
            continue
        seen.add(s.id)
        gqi = builder.queue_by_name.get(s.queue)
        if gqi is None or not qok[gqi]:
            continue
        by_gang.setdefault((gqi, s.gang_id), []).append(
            _strip_static_requirements(s)
        )
    for s in builder.running_gang_specs.values():
        if s.id in seen:
            continue
        seen.add(s.id)
        if s.pools and pool not in s.pools:
            continue
        gqi = builder.queue_by_name.get(s.queue)
        if gqi is None or not qok[gqi]:
            continue
        by_gang.setdefault((gqi, s.gang_id), []).append(
            _strip_static_requirements(s)
        )
    for s in extra_gang_specs:
        if s.id in seen:
            continue
        seen.add(s.id)
        gqi = builder.queue_by_name.get(s.queue)
        if gqi is None or not qok[gqi]:
            continue
        by_gang.setdefault((gqi, s.gang_id), []).append(
            _strip_static_requirements(s)
        )

    units: list[_Unit] = []
    for (gqi, gang_id), members in by_gang.items():
        label = members[0].gang_node_uniformity_label
        uniformity = ("", "")
        uban = None
        if label:
            prov: dict = {}
            for m in members:
                prov.setdefault(class_signature(m, nil), []).append(m)
            classes = [(grp[0], len(grp)) for grp in prov.values()]
            if len(classes) == 1:
                classes = [
                    (members[0], max(len(members), members[0].gang_cardinality or 1))
                ]
            # no running placements in the mega round -> no pinned domain
            uban, chosen = _uniform_domain_ban(fitctx, label, classes, (), nil)
            uniformity = (label, chosen)
        keys = {kidx.key_of(m, nil, uniformity=uniformity) for m in members}
        if len(keys) > 1:
            by_key: dict[int, list] = {}
            for m in members:
                by_key.setdefault(
                    kidx.key_of(m, nil, uniformity=uniformity), []
                ).append(m)
            groups = list(by_key.items())
        else:
            groups = [(next(iter(keys)), members)]
        group_tag = f"{gqi}:{gang_id}" if len(groups) > 1 else ""
        dead = False
        if len(groups) > 1:
            class_info = []
            for _, grp in groups:
                glead = grp[0]
                usable = fitctx.ok & fitctx.static_fit(glead, nil)
                if uban:
                    usable = usable.copy()
                    usable[np.asarray(sorted(uban), np.int64)] = False
                req_units = (
                    factory.ceil_units(glead.resources.atoms).astype(np.float64)
                    if glead.resources is not None
                    else np.zeros((R,), np.float64)
                )
                cap = fitctx.capacity(req_units, len(grp))
                if int(cap[usable].sum()) < len(grp):
                    dead = True
                    break
                class_info.append(
                    (usable, fitctx.frac_capacity(req_units), len(grp))
                )
            if not dead:
                dead = not _joint_capacity_ok(class_info)
        for grp_key, grp in groups:
            lead = min(
                grp,
                key=lambda m: scheduling_order_key(
                    config.priority_class(m.priority_class).priority,
                    m.priority,
                    m.submit_time,
                    m.id,
                ),
            )
            lead_req = (
                factory.ceil_units(lead.resources.atoms).astype(np.float64)
                if lead.resources is not None
                else np.zeros((R,), np.float64)
            )
            value = 0.0
            nmem = 0
            for m in grp:
                if m.resources is None:
                    continue
                ratoms = np.asarray(m.resources.atoms, np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    mu = np.where(
                        unit_vec > 0, ratoms / np.maximum(unit_vec, 1e-12), 0.0
                    ).max()
                value += float(bid_price_of(m)) * float(mu)
                nmem += 1
            u = _Unit()
            u.qi = gqi
            u.price64 = float(bid_price_of(lead))
            u.pc = builder.pc_index[
                config.priority_class(lead.priority_class).name
            ]
            u.sub = lead.submit_time
            u.id = lead.id
            u.need = lead_req * len(grp)
            u.card = len(grp)
            u.value = value
            u.nmembers = nmem
            u.tag = group_tag
            # member signature in the kernel's stripped key space: identical
            # (request, pc, priority) entries share one scheduling key with
            # plain singles when the gang adds no uniformity component
            if not label:
                u.sig = (
                    tuple(np.asarray(lead.resources.atoms, np.int64).tolist())
                    if lead.resources is not None
                    else tuple([0] * R),
                    u.pc,
                    lead.priority,
                )
            else:
                u.sig = None
            u.kkey = grp_key
            # a banned-out uniformity gang cannot use the single node
            u.dead = bool(dead or (uban and 0 in uban))
            units.append(u)

    # --- merge units into the row arrays ------------------------------------
    n = n_rows + len(units)
    unit_of = np.full((n,), -1, np.int64)
    card = np.ones((n,), np.int64)
    if units:
        unit_of[n_rows:] = np.arange(len(units))
        card[n_rows:] = [u.card for u in units]
        qi = np.concatenate([qi, np.array([u.qi for u in units], np.int64)])
        sub = np.concatenate([sub, np.array([u.sub for u in units])])
        ids = np.concatenate(
            [ids, np.array([u.id.encode() for u in units], ids.dtype)]
        )
        need = np.concatenate([need, np.stack([u.need for u in units])], axis=0)
        hasres = np.concatenate(
            [hasres, np.array([u.nmembers > 0 for u in units], bool)]
        )
        price = np.concatenate(
            [price, np.array([u.price64 for u in units], np.float64)]
        )
        rowvalue = np.concatenate(
            [rowvalue, np.array([u.value for u in units], np.float64)]
        )
        pcrow = np.concatenate(
            [pcrow, np.array([u.pc for u in units], np.int64)]
        )
        prio = np.concatenate([prio, np.zeros((len(units),), np.int64)])
    if n == 0:
        return {}

    # --- scheduling-key ids (skip/retire space) -----------------------------
    # Rows and uniformity-free units share the stripped-key space
    # ((raw atoms, pc, priority)); uniformity units key off the interned
    # kidx key in a disjoint namespace.  Retirement registers only card-1
    # entries (fair_scheduler.py:647), but SKIPPING applies to any entry
    # whose key is retired -- including gangs (the cursor wbad check).
    pack = np.zeros((n, R + 2), np.int64)
    pack[:n_rows, :R] = atoms
    pack[:, R] = pcrow
    pack[:, R + 1] = prio
    uni_key = np.full((n,), -1, np.int64)
    for k, u in enumerate(units):
        if u.sig is not None:
            pack[n_rows + k, :R] = np.array(u.sig[0], np.int64)
            pack[n_rows + k, R + 1] = u.sig[2]
        else:
            uni_key[n_rows + k] = u.kkey
    packv = np.ascontiguousarray(pack).view(
        [("", np.int64)] * (R + 2)
    ).reshape(-1)
    _, key_id = np.unique(packv, return_inverse=True)
    key_id = np.asarray(key_id, np.int64)
    K_rows = int(key_id.max()) + 1
    has_uni = uni_key >= 0
    key_id[has_uni] = K_rows + uni_key[has_uni]
    num_keys = K_rows + (len(kidx.keys) if units else 0)

    return _admit(
        config, builder, n, qi, sub, ids, need, hasres, price, rowvalue,
        pcrow, card, key_id, num_keys, unit_of, units, cap_fit, pc_queue_cap,
    )


def _admit(
    config, builder, n, qi, sub, ids, need, hasres, price, rowvalue,
    pcrow, card, key_id, num_keys, unit_of, units, cap_fit, pc_queue_cap,
):
    """Lookback-cap the per-queue streams, order globally, and run the
    blocked event-driven sweep (re-run with doomed groups killed on a
    partial-group unwind, models/__init__.py:44-69)."""
    # --- within-queue market order + lookback cap ---------------------------
    wq = np.lexsort((ids, sub, -price, qi))
    qi, sub, ids = qi[wq], sub[wq], ids[wq]
    need, hasres, price = need[wq], hasres[wq], price[wq]
    rowvalue, pcrow, card = rowvalue[wq], pcrow[wq], card[wq]
    key_id, unit_of = key_id[wq], unit_of[wq]

    L = config.max_queue_lookback
    qstart = np.zeros((n,), np.int64)
    first = np.ones((n,), bool)
    first[1:] = qi[1:] != qi[:-1]
    starts = np.flatnonzero(first)
    qstart[starts] = starts
    np.maximum.accumulate(qstart, out=qstart)
    rank = np.arange(n) - qstart
    keep = rank < L
    if not keep.all() and units:
        kept_tags = set()
        cut_tags = set()
        for i in np.flatnonzero(unit_of >= 0):
            t = units[unit_of[i]].tag
            if t:
                (kept_tags if keep[i] else cut_tags).add(t)
        partial = kept_tags & cut_tags
        if partial:
            for i in np.flatnonzero(unit_of >= 0):
                if units[unit_of[i]].tag in partial:
                    keep[i] = False
    if not keep.all():
        qi, need, hasres = qi[keep], need[keep], hasres[keep]
        rowvalue, pcrow, card = rowvalue[keep], pcrow[keep], card[keep]
        key_id, unit_of, price = key_id[keep], unit_of[keep], price[keep]
        n = qi.shape[0]
        if n == 0:
            return {}

    # --- global admission order: (-f32 price, queue, within-queue pos) ------
    price32 = price.astype(np.float32)
    wq_pos = np.arange(n)  # already within-queue sorted; stable tiebreak
    order = np.lexsort((wq_pos, qi, -price32))
    qi, need, hasres = qi[order], need[order], hasres[order]
    rowvalue, pcrow, card = rowvalue[order], pcrow[order], card[order]
    key_id, unit_of = key_id[order], unit_of[order]

    total_by_tag: dict[str, int] = {}
    for i in np.flatnonzero(unit_of >= 0):
        t = units[unit_of[i]].tag
        if t:
            total_by_tag[t] = total_by_tag.get(t, 0) + 1

    excluded0 = np.zeros((n,), bool)
    for i in np.flatnonzero(unit_of >= 0):
        if units[unit_of[i]].dead:
            excluded0[i] = True

    killed_groups: set = set()
    partial: set = set()
    admitted = np.zeros((n,), bool)
    for _ in range(5):
        excluded = excluded0.copy()
        if killed_groups:
            for i in np.flatnonzero(unit_of >= 0):
                if units[unit_of[i]].tag in killed_groups:
                    excluded[i] = True
        admitted = _sweep(
            n, qi, pcrow, need, card, key_id, num_keys, excluded,
            cap_fit, pc_queue_cap, len(builder.queue_names),
        )
        placed_by_tag: dict[str, int] = {}
        for i in np.flatnonzero(admitted & (unit_of >= 0)):
            t = units[unit_of[i]].tag
            if t:
                placed_by_tag[t] = placed_by_tag.get(t, 0) + 1
        partial = {
            t
            for t, total in total_by_tag.items()
            if 0 < placed_by_tag.get(t, 0) < total
        } - killed_groups
        if not partial:
            break
        killed_groups |= partial
    if partial:
        # Attempt cap reached (models/__init__.py attempts < 4): decode
        # unwinds the still-partial groups, so their placed members leave
        # the scheduled set entirely (no value, no queue entry) while the
        # capacity they consumed stays consumed.
        for i in np.flatnonzero(unit_of >= 0):
            if units[unit_of[i]].tag in partial:
                admitted[i] = False
    values: dict = {}
    take = admitted & hasres
    if take.any():
        counts = np.bincount(qi[take])
        sums = np.bincount(
            qi[admitted],
            weights=rowvalue[admitted],
            minlength=counts.shape[0],
        )
        for q in np.flatnonzero(counts):
            values[builder.queue_names[q]] = float(sums[q])
    return values


def _sweep(
    n, qi, pcrow, need, card, key_id, num_keys, excluded,
    cap_fit, pc_queue_cap, Qn,
):
    """One full admission sweep in global order.  Within each block every
    active row is assumed admitted; the first violation event is applied
    (gate trip kills the queue from that position; a card-1 fit failure
    retires its key; any fit failure excludes the row) and the block
    re-evaluates.  Retired-key entries are SKIPPED (no gate check), exactly
    like the kernel's cursor (wbad, fair_scheduler.py:330)."""
    R = need.shape[1]
    Cn = pc_queue_cap.shape[0]
    admitted = np.zeros((n,), bool)
    consumed = np.zeros((R,), np.float64)
    q_alloc = np.zeros((Qn, Cn, R), np.float64)
    # positional: rows BEFORE the retiring/killing event keep their admission
    retired_from = np.full((max(num_keys, 1),), np.iinfo(np.int64).max, np.int64)
    killed_from = np.full((Qn,), np.iinfo(np.int64).max, np.int64)

    i = 0
    while i < n:
        j = min(n, i + _SWEEP_BLOCK)
        blk = slice(i, j)
        bq = qi[blk]
        bpc = pcrow[blk]
        bneed = need[blk]
        bkey = key_id[blk]
        bpos = np.arange(i, j)
        grp = bq * Cn + bpc
        sidx = np.argsort(grp, kind="stable")
        g_s = grp[sidx]
        newg = np.ones((g_s.shape[0],), bool)
        if g_s.shape[0] > 1:
            newg[1:] = g_s[1:] != g_s[:-1]
        seg_starts = np.flatnonzero(newg)
        seg_counts = np.diff(np.append(seg_starts, g_s.shape[0]))
        dead = np.zeros((j - i,), bool)
        while True:
            act = (
                ~excluded[blk]
                & ~dead
                & (bpos < killed_from[bq])
                & (bpos <= retired_from[bkey])
            )
            consume = bneed * act[:, None]
            bcum = np.cumsum(consume, axis=0)
            cum_before = consumed[None, :] + bcum - consume
            viol = (
                (bneed > cap_fit[None, :] - cum_before) & (bneed > 0)
            ).any(axis=1)
            # per-(queue, pc) exclusive prefix within the block
            c_s = np.cumsum(consume[sidx], axis=0) - consume[sidx]
            if seg_starts.shape[0]:
                offs = c_s[seg_starts]
                c_s = c_s - np.repeat(offs, seg_counts, axis=0)
            alloc_before = np.empty_like(c_s)
            alloc_before[sidx] = c_s
            alloc_before = alloc_before + q_alloc[bq, bpc]
            trip = (alloc_before + bneed > pc_queue_cap[bpc]).any(axis=1)
            ev = act & (trip | viol)
            idx = np.flatnonzero(ev)
            if idx.size == 0:
                break
            e = int(idx[0])
            if trip[e]:
                killed_from[bq[e]] = i + e
            else:
                dead[e] = True
                if card[i + e] == 1 and key_id[i + e] >= 0:
                    retired_from[key_id[i + e]] = min(
                        retired_from[key_id[i + e]], i + e
                    )
        admitted[blk] = act
        consumed = consumed + consume.sum(axis=0)
        if act.any():
            np.add.at(q_alloc, (bq[act], bpc[act]), bneed[act])
        i = j
    return admitted
