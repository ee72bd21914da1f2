"""Building the dense scheduling problem and decoding round results.

This is the host<->device boundary of the scheduling round: the equivalent of the
reference's per-pool context construction (scheduling_algo.go
newFairSchedulingAlgoContext:201, constructNodeDb:467, constructSchedulingContext:486)
-- except the output is a set of padded arrays instead of a NodeDb + context tree
(numpy here; models/state.py moves them to a device).

Layout conventions (see SURVEY.md section 7 "Tensor reformulation"):
- R: fixed resource axis (resolution units, integral float32).
- P levels: priority ladder index; level 0 is reserved for the *evicted* marker
  priority (the reference's internaltypes.EvictedPriority = -1): resources of evicted
  jobs stay counted at level 0 so clean fit ("schedule without preemption",
  nodedb.go:506-514) sees them, while fit at a real priority does not.  Level 1 is
  reserved for *away* placements (jobs borrowed onto another pool's nodes,
  scheduling_algo.go:216-283): below every real priority, so any home job can
  urgency-preempt them; real PC priorities occupy levels 2 and up.
- Gangs are the unit of scheduling; a plain job is a gang of cardinality 1.  Every
  *preemptible running job* also gets a gang slot (its "evictee" re-scheduling
  candidate, pinned to its node), activated in-kernel only if the job is actually
  evicted -- mirroring how evicted jobs re-enter the queue scheduler ahead of queued
  jobs (preempting_queue_scheduler.go evict -> InMemoryJobRepository; jobs pinned
  via node-id selector).
- All axes are padded to `config.shape_bucket` multiples, so array shapes change only
  when a bucket boundary is crossed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.ordering import scheduling_order_key
from armada_tpu_torch.core.keys import (
    NodeTypeIndex,
    SchedulingKeyIndex,
    class_signature,
    labels_referenced_by_selectors,
    static_fit_matrix,
    type_score_tables,
)
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob

_INF = np.float32(3.0e38)


class SchedulingProblem(NamedTuple):
    """Dense per-round problem; every field is a device-ready array."""

    # nodes
    node_total: np.ndarray  # f32[N, R] allocatable units
    node_type: np.ndarray  # i32[N]
    node_ok: np.ndarray  # bool[N] real & schedulable
    # running jobs
    run_req: np.ndarray  # f32[RJ, R]
    run_node: np.ndarray  # i32[RJ]
    run_level: np.ndarray  # i32[RJ] ladder level (>= 1)
    run_queue: np.ndarray  # i32[RJ]
    run_pc: np.ndarray  # i32[RJ] priority-class index
    run_preemptible: np.ndarray  # bool[RJ]
    run_gang: np.ndarray  # i32[RJ] evictee gang slot (-1 if not preemptible)
    run_valid: np.ndarray  # bool[RJ]
    # gangs (queued jobs + evictee slots)
    g_req: np.ndarray  # f32[G, R] per-member request
    g_card: np.ndarray  # i32[G]
    g_level: np.ndarray  # i32[G] ladder level (>= 1)
    g_queue: np.ndarray  # i32[G]
    g_key: np.ndarray  # i32[G] scheduling key (-1 for evictee slots)
    g_pc: np.ndarray  # i32[G]
    g_order: np.ndarray  # i32[G] rank within its queue (evictees first)
    g_run: np.ndarray  # i32[G] backing run for evictee slots, else -1
    g_valid: np.ndarray  # bool[G]
    # Slot not part of THIS cycle's problem (slab free-list holes, jobs beyond
    # the queue lookback, slack regions): the kernel marks these state 3
    # (absent) instead of 2 (failed) so decode never reports them.  All-False
    # under the legacy dense builders, whose padding is sliced off by
    # num_real_gangs instead.
    g_absent: np.ndarray  # bool[G]
    g_price: np.ndarray  # f32[G] bid price (market pools; 0 otherwise)
    # Minimum member bid: the spot price a crossing gang publishes
    # (queue_scheduler.go:138-144 takes the lowest member bid).
    g_spot_price: np.ndarray  # f32[G]
    # queue-ordered gang index: gangs sorted by (queue, order); per-queue
    # contiguous slices.  The kernel's candidate scan is O(Q) gathers into this
    # instead of O(G) segment reductions (the analog of the reference keeping
    # per-queue sorted job iterators, queue_scheduler.go QueuedGangIterator:273).
    gq_gang: np.ndarray  # i32[G] gang ids, (queue, order)-sorted
    q_start: np.ndarray  # i32[Q] slice offset into gq_gang
    q_len: np.ndarray  # i32[Q] slice length
    # queues
    q_weight: np.ndarray  # f32[Q] (0 = padding)
    q_cds: np.ndarray  # f32[Q] constrained demand share
    # Short-job penalty (short_job_penalty.go): resources of recently-exited
    # short jobs, charged to the queue-ordering cost only
    # (queue_scheduler.go:514-515 GetAllocationInclShortJobPenalty).
    q_penalty: np.ndarray  # f32[Q, R]
    # static fit
    compat: np.ndarray  # bool[K, T]
    # pool-level scalars/vectors
    total_pool: np.ndarray  # f32[R]
    drf_mult: np.ndarray  # f32[R]
    inv_scale: np.ndarray  # f32[R] packing-score weights
    round_cap: np.ndarray  # f32[R] max schedulable this round (absolute units)
    pc_queue_cap: np.ndarray  # f32[C, R] per-queue cap by priority class (absolute)
    protected_fraction: np.ndarray  # f32 scalar
    global_burst: np.ndarray  # i32 scalar
    perq_burst: np.ndarray  # i32[Q] per-queue burst (rate-limited)
    # Floating resources (floatingresources/): 1.0 on node-bound axes, 0.0 on
    # floating axes; per-pool floating capacity (0 on node axes).
    node_axes: np.ndarray  # f32[R]
    float_total: np.ndarray  # f32[R]
    # Market-driven pools order candidates by bid price instead of DRF cost
    # (scheduling/market_iterator.go MarketCandidateGangIterator:245).
    market: np.ndarray  # bool scalar
    # Spot-price threshold (queue_scheduler.go:135-150): once the round's
    # newly-scheduled share crosses this, the crossing gang's bid becomes the
    # pool spot price.  _INF disables (non-market pools).
    spot_cutoff: np.ndarray  # f32 scalar
    # Retry anti-affinity (scheduler.go:522-568): nodes a gang must avoid --
    # nodes where a previous attempt died.  Precomputed outside the round loop
    # as a row table so the kernel does one invariant-table gather per
    # iteration (row 0 = no bans); an in-loop scatter keyed on the gathered
    # candidate would cost a scatter per iteration.
    ban_mask: np.ndarray  # bool[BR, N]
    g_ban_row: np.ndarray  # i32[G]
    # Heterogeneity (per-node-type throughput scoring, Gavel arXiv:2008.09213):
    # `type_bias[key_type_row[key], t]` is the packing-score adjustment of a
    # candidate with scheduling key `key` on a node of static type t -- the
    # exact ban_mask discipline: dense tables precomputed OUTSIDE the round
    # loop, one invariant-table gather in-loop.  Row 0 of type_bias is the
    # all-zero insensitive row; TR == 1 (no type-sensitive key anywhere) is
    # the structural switch that compiles the exact pre-hetero kernel body.
    # `compat_pre_type` is the static fit WITHOUT the hardware-type gate --
    # the explain pass partitions type-mismatch vs shape-infeasible with it.
    type_bias: np.ndarray  # f32[TR, T]
    key_type_row: np.ndarray  # i32[K]
    compat_pre_type: np.ndarray  # bool[K, T]


@dataclasses.dataclass
class HostContext:
    """Everything needed to decode a RoundResult back to ids."""

    config: SchedulingConfig
    pool: str
    queue_names: list  # index -> queue name
    node_ids: list  # index -> node id
    gang_members: list  # gang index -> list of member job ids ([] for evictee slots)
    # gang index -> shared tag for sub-gangs split from one declared gang
    # ("" otherwise); drives the cross-class atomicity unwind in decode_result.
    gang_group: list
    run_job_ids: list  # run index -> job id
    num_real_nodes: int
    num_real_queues: int
    num_real_gangs: int
    num_real_runs: int
    ladder: tuple  # priority ladder (ladder[level-1] = priority of level)
    pc_names: list  # priority-class index -> name
    max_slots: int
    slot_width: int
    # Host-only extras for metrics: raw (uncapped) per-queue demand shares and
    # the pool's fairness total in resource atoms (node + floating capacity --
    # the denominator every published share is a fraction of).
    q_demand_raw: list = dataclasses.field(default_factory=list)
    pool_total_atoms: dict = dataclasses.field(default_factory=dict)
    # Running-gang fate-sharing (preempting_queue_scheduler.go:345-399 +
    # setEvictedGangCardinality): tag -> run indices of the gang's
    # PREEMPTIBLE members present in this problem.  run_round_on_device uses
    # it to cascade partial preemptions -- a running gang either keeps all
    # members or loses all (the reference evicts the remains of partially
    # evicted gangs and re-schedules them as one all-or-nothing unit).
    running_gangs: dict = dataclasses.field(default_factory=dict)
    # Vectorized decode support (models/incremental.py): per-gang single job
    # id as bytes (b"" for evictee slots and multi-member units), overrides
    # for multi-member units, and per-run job ids as bytes.  When set,
    # gang_members / run_job_ids may be None and decode_result takes the
    # numpy path -- a 1M-gang Python loop in decode would cost the time the
    # incremental builder saves.
    gang_ids_vec: Optional[np.ndarray] = None
    gang_members_over: dict = dataclasses.field(default_factory=dict)
    run_ids_vec: Optional[np.ndarray] = None
    # Static node-type id -> hardware type name ("" = the untyped default)
    # for the real types of this round's NodeTypeIndex; explain's per-type
    # fragmentation merges the device's per-static-type rows onto hardware
    # types through it.
    type_names: list = dataclasses.field(default_factory=list)
    # The compact decode buffer exactly as this round's fetch received it
    # (stashed by _parse_compact, overwritten per round; None on the
    # full-pull fallback).  Round verification (models/verify.py)
    # re-derives the fingerprint from these bytes, so a corrupted transfer
    # surfaces as a mismatch instead of a committed round.
    last_compact_np: Optional[np.ndarray] = None

    def members_of(self, gi: int) -> list:
        """Member job ids of gang `gi` under either representation."""
        if self.gang_members is not None:
            return self.gang_members[gi]
        over = self.gang_members_over.get(gi)
        if over is not None:
            return over
        jid = self.gang_ids_vec[gi]
        return [jid.decode()] if jid else []

    def run_job_id(self, ri: int) -> str:
        if self.run_job_ids is not None:
            return self.run_job_ids[ri]
        return self.run_ids_vec[ri].decode()


@dataclasses.dataclass
class RoundOutcome:
    """Host-side decoded result of a scheduling round (the reference's
    SchedulerResult: scheduled jobs with nodes, preempted jobs)."""

    scheduled: dict  # job id -> node id
    preempted: list  # job ids preempted (evicted and not rescheduled)
    failed: list  # job ids attempted and unschedulable this round
    num_iterations: int
    termination: str
    # Loop-body applications (RoundResult.kernel_iters); equal to
    # num_iterations at the single-commit loop shape the port runs.
    kernel_iters: int = 0
    # queue name -> {weight, fair_share, adjusted_fair_share, actual_share,
    # demand_share} (feeds cycle metrics + reports; the reference's
    # QueueSchedulingContext numbers, cycle_metrics.go:71-170).
    queue_stats: dict = dataclasses.field(default_factory=dict)
    # Market pools: bid price of the gang that crossed the spot cutoff this
    # round (queue_scheduler.go:135-150); None when unset/not market.
    spot_price: Optional[float] = None
    # Pool fairness total (resource name -> atoms, node + floating): the
    # denominator of every share above (feeds metric events).
    pool_totals: dict = dataclasses.field(default_factory=dict)
    # job ids evicted this round and re-placed (they keep running; counted by
    # the realised-value metric like the reference's RescheduledJobSchedulingContexts)
    rescheduled: list = dataclasses.field(default_factory=list)
    # {base priority: share a new queue at that priority would get}
    # (CalculateTheoreticalShare; indicative_share metric).
    indicative_shares: dict = dataclasses.field(default_factory=dict)
    # Declared-gang group tags whose placed siblings were unwound at decode
    # because another sub-gang failed (runtime contention).  Non-empty means
    # evictions those placements caused are still in the result; the caller
    # re-runs without the doomed gangs to roll them back (the reference's
    # gang-txn rollback, nodedb.go:347).
    unwound_groups: frozenset = frozenset()
    # Unschedulable-reason attribution (models/explain.py ExplainOutcome):
    # set on explain-cadence rounds, None otherwise.
    explain: Optional[object] = None


class LazyJobIds:
    """List-like over a numpy byte-id array, decoded on demand.

    A round can retire whole unfeasible key classes, putting ~the entire
    backlog into `failed`; materialising a million Python strings costs
    seconds per cycle at 1M jobs.  Consumers that only count pay O(1); only
    consumers that actually iterate pay the decode.
    """

    __slots__ = ("_raw", "_extra")

    def __init__(self, raw=None, extra=None):
        self._raw = raw if raw is not None and raw.size else None
        self._extra = list(extra) if extra else []

    def __len__(self):
        return (self._raw.size if self._raw is not None else 0) + len(self._extra)

    def __iter__(self):
        if self._raw is not None:
            # decode in chunks: a bounded consumer (itertools.islice) must
            # not pay a whole-array unicode conversion up front
            width = self._raw.dtype.itemsize
            for start in range(0, self._raw.size, 4096):
                for s in self._raw[start : start + 4096].astype(f"U{width}"):
                    yield str(s)
        yield from self._extra

    def __bool__(self):
        return len(self) > 0

    def __contains__(self, jid):
        if jid in self._extra:
            return True
        return self._raw is not None and self._raw.dtype.type(jid) in self._raw

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self)[i]
        n_raw = self._raw.size if self._raw is not None else 0
        if i < 0:
            i += len(self)
        if i < n_raw:
            return self._raw[i].decode()
        return self._extra[i - n_raw]

    def append(self, jid):
        self._extra.append(jid)

    def extend(self, jids):
        self._extra.extend(jids)

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return f"LazyJobIds(n={len(self)})"


class ChainedJobIds:
    """Concatenation of id sequences that never materialises its parts on
    extend (one possibly lazy sequence per pool round; a plain list.extend
    would decode every id)."""

    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list = []

    def extend(self, part) -> None:
        self._parts.append(part)

    def append(self, jid) -> None:
        self._parts.append([jid])

    def __len__(self):
        return sum(len(p) for p in self._parts)

    def __iter__(self):
        for p in self._parts:
            yield from p

    def __bool__(self):
        return any(len(p) for p in self._parts)

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return f"ChainedJobIds(n={len(self)})"


def pc_queue_caps(config, pc_names, factory, total_pool) -> np.ndarray:
    """f32[C, R] per-priority-class queue allocation caps: frac x f32
    total_pool (maximumResourceFractionPerQueue, constraints.go), INF where
    unconfigured.  The ONE implementation shared by build_problem, the
    incremental builder and the columnar idealised sweep, so the f32
    rounding of the cap threshold can never drift between the kernel and
    its host-side mirrors."""
    C = len(pc_names)
    R = factory.num_resources
    caps = np.full((C, R), _INF, np.float32)
    tp = np.asarray(total_pool, np.float32)
    for ci, pc_name in enumerate(pc_names):
        fr = config.priority_classes[pc_name].maximum_resource_fraction_per_queue
        for name, frac in fr.items():
            if name in factory.names:
                ri = factory.index_of(name)
                caps[ci, ri] = frac * tp[ri]
    return caps


def _pad(n: int, bucket: int) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def queue_ordered_gang_index(
    g_queue: np.ndarray, g_order: np.ndarray, num_real: int, G: int, Q: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(gq_gang[G], q_start[Q], q_len[Q]): gang ids sorted by (queue, order)
    into per-queue contiguous slices -- the kernel's O(Q) candidate index
    (SchedulingProblem.gq_gang)."""
    gq_gang = np.zeros((G,), np.int32)
    q_start = np.zeros((Q,), np.int32)
    q_len = np.zeros((Q,), np.int32)
    if num_real:
        order = np.lexsort((g_order[:num_real], g_queue[:num_real]))
        gq_gang[:num_real] = order.astype(np.int32)
        counts = np.bincount(g_queue[:num_real], minlength=Q)
        q_len[:] = counts
        q_start[1:] = np.cumsum(counts)[:-1]
    return gq_gang, q_start, q_len


class _GangFitContext:
    """Per-round vectorized helpers for host-side gang feasibility: per-node
    member capacity (one numpy op over the [N,R] totals), static-fit masks
    memoized by (selector, tolerations) signature, and per-label domain
    index arrays built once however many gangs share the label."""

    def __init__(self, pool_nodes, node_total, node_index, factory, node_axes):
        self.pool_nodes = pool_nodes
        self.node_index = node_index
        self.num_real = len(pool_nodes)
        self.totals = node_total[: self.num_real].astype(np.float64)  # [n, R]
        self.ok = np.array(
            [not n.unschedulable for n in pool_nodes], bool
        ) if pool_nodes else np.zeros((0,), bool)
        self.factory = factory
        # 1.0 on node-bound axes, 0.0 on floating axes: per-node fit must
        # never see floating requests (floating_resource_types.go; the pool
        # totals gate handles them).
        self.node_axes = np.asarray(node_axes, np.float64)
        # Free capacity (totals minus running usage) once set_running_usage is
        # called; falls back to totals until then.
        self.free = self.totals
        self._static: dict = {}
        self._domains: dict = {}

    def set_running_usage(self, run_req, run_node, run_valid) -> None:
        """Subtract running jobs' usage so occupancy-aware choices (the
        uniformity domain pick) see actual headroom, not raw node sizes."""
        if not self.num_real:
            return
        used = np.zeros_like(self.totals)
        valid = np.asarray(run_valid, bool)
        if valid.any():
            np.add.at(
                used,
                np.asarray(run_node)[valid],
                np.asarray(run_req, np.float64)[valid],
            )
        self.free = np.maximum(self.totals - used, 0.0)

    def capacity(
        self, req_units: np.ndarray, cardinality: int, occupancy: bool = False
    ) -> np.ndarray:
        """i64[n]: members of `req_units` each node holds, capped at card.
        occupancy=True measures against FREE capacity (for preferences like
        the domain pick); False against totals (static feasibility -- a full
        node is not statically infeasible, preemption can clear it)."""
        if not self.num_real:
            return np.zeros((0,), np.int64)
        base = self.free if occupancy else self.totals
        req = np.asarray(req_units, np.float64) * self.node_axes
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.floor(
                np.where(
                    req[None, :] > 0,
                    base / np.maximum(req[None, :], 1e-9),
                    np.inf,
                )
            ).min(axis=1)
        return np.minimum(np.where(np.isfinite(per), per, cardinality), cardinality).astype(np.int64)

    def frac_capacity(self, req_units: np.ndarray) -> np.ndarray:
        """f64[n]: FRACTIONAL members of `req_units` each node's total holds
        (no floor, no cardinality cap).  An upper bound on any integral
        packing, which is what the joint hopeless-gang check needs: the LP
        relaxation of "how many mixed-class members fit on this node" attains
        its optimum on a single class, so max-over-classes of this bound is
        sound for class subsets."""
        if not self.num_real:
            return np.zeros((0,), np.float64)
        req = np.asarray(req_units, np.float64) * self.node_axes
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(
                req[None, :] > 0,
                self.totals / np.maximum(req[None, :], 1e-9),
                np.inf,
            ).min(axis=1)
        return np.where(np.isfinite(per), per, np.inf)

    def static_fit(self, job: JobSpec, node_id_label: str) -> np.ndarray:
        """bool[n]: taints tolerated and selector satisfied, memoized by the
        job's static signature (nodematching.go StaticJobRequirementsMet)."""
        from armada_tpu_torch.core.types import selector_matches, taints_tolerated

        sel = tuple(
            sorted((k, v) for k, v in job.node_selector.items() if k != node_id_label)
        )
        sig = (sel, tuple(job.tolerations))
        cached = self._static.get(sig)
        if cached is None:
            seld = dict(sel)
            cached = np.array(
                [
                    taints_tolerated(n.taints, job.tolerations)
                    and selector_matches(seld, n.labels)
                    for n in self.pool_nodes
                ],
                bool,
            ) if self.pool_nodes else np.zeros((0,), bool)
            self._static[sig] = cached
        return cached

    def domains(self, label: str) -> dict:
        """{value: i64 node-index array} for nodes carrying `label`."""
        cached = self._domains.get(label)
        if cached is None:
            by_value: dict[str, list] = {}
            for i, n in enumerate(self.pool_nodes):
                v = n.labels.get(label)
                if v is not None:
                    by_value.setdefault(v, []).append(i)
            cached = {
                v: np.asarray(idx, np.int64) for v, idx in sorted(by_value.items())
            }
            self._domains[label] = cached
        return cached


def _joint_capacity_ok(class_info) -> bool:
    """Hall-condition bound over class subsets of a split gang.

    class_info: [(usable bool[n], frac_cap f64[n], member count)] per key
    class.  For a subset S of classes, no packing can place more than
    sum_n max_{c in S, usable} frac_cap_n(c) members of S (fractional-LP
    upper bound per node), so if that is < the members S needs, the declared
    gang is jointly infeasible even though each class fits alone -- the case
    the reference discovers by attempting the placement
    (gang_scheduler.go:152-227) and we must pre-kill to keep the kernel's
    sibling-unwind path cold.  Sound: only definitely-infeasible gangs fail.
    Subset enumeration is capped at 2^10; larger splits check the full set
    and pairs only (still sound, just less sharp)."""
    k = len(class_info)
    if k < 2:
        return True
    total_members = sum(count for _, _, count in class_info)
    # per-class capacity capped at what the subset could ever need: keeps
    # inf (zero-request classes) from masking a genuine shortfall elsewhere.
    caps = np.stack(
        [
            np.where(usable, np.minimum(frac, float(total_members)), 0.0)
            for usable, frac, _ in class_info
        ]
    )  # [k, n]
    counts = np.array([count for _, _, count in class_info], np.int64)
    if k <= 10:
        subsets = range(1, 1 << k)
    else:
        subsets = [(1 << k) - 1] + [
            (1 << i) | (1 << j) for i in range(k) for j in range(i + 1, k)
        ]
    for s in subsets:
        members = np.array([(s >> i) & 1 for i in range(k)], bool)
        if members.sum() < 2:
            continue  # singletons already checked with the tighter bound
        ub = caps[members].max(axis=0).sum()
        if ub < counts[members].sum():
            return False
    return True


def _uniform_domain_ban(
    fit: _GangFitContext,
    label: str,
    classes,
    banned_node_ids,
    node_id_label: str,
) -> tuple[set, str]:
    """(banned node indices, chosen value) restricting a uniformity gang to
    its best label-value domain (gang_scheduler.go tries domains; here the
    best domain is chosen per round).  `classes` is [(lead job, member
    count)] -- ONE per key class of the gang, so a heterogeneous gang's
    domain must work for every class, not just the lead's.  Scoring counts
    only schedulable, statically-fitting, non-retry-banned nodes; a domain
    whose FREE capacity satisfies every class beats one satisfying on
    totals only, which beats neither, ties broken by free capacity -- so an
    occupied domain never shadows an empty viable one, and the choice
    self-corrects round over round as occupancy shifts.  Nodes lacking the
    label are always excluded."""
    per_class = []
    for lead, count in classes:
        req = (
            fit.factory.ceil_units(lead.resources.atoms).astype(np.float64)
            if lead.resources is not None
            else np.zeros((fit.factory.num_resources,), np.float64)
        )
        cap_total = fit.capacity(req, count)
        cap_free = fit.capacity(req, count, occupancy=True)
        usable = fit.ok & fit.static_fit(lead, node_id_label)  # fresh array
        if banned_node_ids:
            for nid in banned_node_ids:
                ni = fit.node_index.get(nid)
                if ni is not None and ni < usable.shape[0]:
                    usable[ni] = False
        per_class.append((cap_total, cap_free, usable, count))
    best_value, best = "", (False, False, -1)
    for v, idx in fit.domains(label).items():
        free_total, fits_free, fits_static = 0, True, True
        for cap_total, cap_free, usable, count in per_class:
            u = usable[idx]
            cf = int(cap_free[idx][u].sum())
            free_total += cf
            if cf < count:
                fits_free = False
            if int(cap_total[idx][u].sum()) < count:
                fits_static = False
        if (fits_free, fits_static, free_total) > best:
            best_value, best = v, (fits_free, fits_static, free_total)
    allowed = set(
        int(i) for i in fit.domains(label).get(best_value, np.zeros(0, np.int64))
    )
    banned = set(range(fit.num_real)) - allowed
    return banned, best_value


def _job_sort_key(pc_priority: int, job: JobSpec):
    """Queue-internal scheduling order; single source of truth in
    core.ordering (shared with the JobDb queued index)."""
    return scheduling_order_key(pc_priority, job.priority, job.submit_time, job.id)


def build_problem(
    config: SchedulingConfig,
    *,
    pool: str,
    nodes: Sequence[NodeSpec],
    queues: Sequence[Queue],
    queued_jobs: Sequence[JobSpec],
    running: Sequence[RunningJob] = (),
    bid_price_of=None,
    away_mode: bool = False,
    global_tokens=None,
    queue_tokens=None,
    banned_nodes=None,
    queue_penalty=None,
) -> tuple[SchedulingProblem, HostContext]:
    """`bid_price_of(job) -> float` supplies bid prices; required for pools
    configured market_driven (pricer/gang_pricer.go:29-40).

    away_mode=True places queued gangs at the LOWEST real priority level (an
    away round: jobs borrowing another pool's nodes, scheduling_algo.go:216-283);
    they then never preempt anything, and home jobs evict them later via
    urgency preemption since away runs hold resources at level 1.

    global_tokens / queue_tokens clamp the burst caps to the scheduler's rate
    limiters (maximumSchedulingRate token buckets, queue_scheduler.go).

    banned_nodes: {job_id: iterable of node ids} a retried job must avoid
    (retry anti-affinity, scheduler.go:522-568).

    queue_penalty: {queue: resource atoms} short-job penalty charged to the
    queue-ordering cost (short_job_penalty.go; scheduling_algo.go:342-360)."""
    factory = config.resource_list_factory()
    R = factory.num_resources
    bucket = config.shape_bucket

    pool_nodes = [n for n in nodes if n.pool == pool]
    pool_cfg = next((pc for pc in config.pools if pc.name == pool), None)
    market = bool(pool_cfg is not None and getattr(pool_cfg, "market_driven", False))
    if market and bid_price_of is None:
        raise ValueError(f"pool {pool} is market driven but no bid_price_of given")
    # Prices are f32-canonical everywhere they order candidates: the kernel
    # orders queues by the f32 g_price tensor, and the incremental builder's
    # (queue, band) table is f32 -- rounding HERE too keeps the within-queue
    # order consistent across all three, even for f64-distinct prices that
    # collide in f32 (CLAUDE.md parity: f32 score arithmetic is the canon).
    _raw_price_of = bid_price_of or (lambda job: 0.0)
    price_of = lambda job: float(np.float32(_raw_price_of(job)))  # noqa: E731
    queue_by_name = {q.name: i for i, q in enumerate(sorted(queues, key=lambda q: q.name))}
    sorted_queues = sorted(queues, key=lambda q: q.name)

    # --- priority ladder: level 0 = evicted marker, 1..P = distinct PC priorities.
    # Levels: 0 = evicted markers, 1 = away placements, 2.. = the PC ladder.
    ladder = config.priority_ladder()
    level_of_priority = {p: i + 2 for i, p in enumerate(ladder)}
    pc_names = sorted(config.priority_classes)
    pc_index = {name: i for i, name in enumerate(pc_names)}

    def job_level(job: JobSpec) -> int:
        return level_of_priority[config.priority_class(job.priority_class).priority]

    # --- node tensors -----------------------------------------------------------
    all_jobs = list(queued_jobs) + [r.job for r in running]
    indexed = set(config.indexed_node_labels) | labels_referenced_by_selectors(
        all_jobs, config.node_id_label
    )
    ntidx = NodeTypeIndex(indexed)
    N = _pad(len(pool_nodes), bucket)
    node_total = np.zeros((N, R), np.float32)
    node_type = np.zeros((N,), np.int32)
    node_ok = np.zeros((N,), bool)
    node_index = {}
    atoms_rows = []
    atoms_idx = []
    for i, node in enumerate(pool_nodes):
        node_index[node.id] = i
        if node.total_resources is not None:
            atoms_rows.append(node.total_resources.atoms)
            atoms_idx.append(i)
        node_type[i] = ntidx.type_of(node)
        node_ok[i] = not node.unschedulable
    if atoms_rows:
        # one vectorized floor instead of a per-node numpy call
        node_total[atoms_idx] = factory.floor_units(np.stack(atoms_rows))

    # --- scheduling keys for queued jobs ---------------------------------------
    kidx = SchedulingKeyIndex()
    bans_of = banned_nodes or {}

    def _key_of(j: JobSpec, gang_bans=None, uniformity=("", "")) -> int:
        # Bans join the key (podutils.go folds affinity into SchedulingKey), so a
        # retried job's placement failure never retires the clean jobs' key class.
        # Gang members share their gang's UNION ban set: per-member bans would
        # give members distinct keys and shatter the gang into singleton
        # sub-gangs, losing all-or-nothing atomicity.  A uniformity gang's
        # chosen domain joins the key the same way.
        bans = gang_bans if gang_bans is not None else bans_of.get(j.id, ())
        return kidx.key_of(
            j, config.node_id_label, banned_nodes=bans, uniformity=uniformity
        )

    # --- running jobs + evictee gang slots --------------------------------------
    run_list = [r for r in running if r.node_id in node_index]
    RJ = _pad(len(run_list), bucket)
    run_req = np.zeros((RJ, R), np.float32)
    run_node = np.zeros((RJ,), np.int32)
    run_level = np.ones((RJ,), np.int32)
    run_queue = np.zeros((RJ,), np.int32)
    run_pc = np.zeros((RJ,), np.int32)
    run_preemptible = np.zeros((RJ,), bool)
    run_valid = np.zeros((RJ,), bool)
    run_job_ids = []

    # --- gangs: group queued jobs ----------------------------------------------
    class _Gang:
        __slots__ = (
            "jobs", "queue", "key", "level", "pc", "req", "req_atoms", "card",
            "order", "run", "price", "spot_price", "group", "uban", "dead",
        )

    floating_names = set(config.floating_resource_names())
    node_axes = np.array(
        [0.0 if name in floating_names else 1.0 for name in factory.names],
        np.float32,
    )
    fitctx = _GangFitContext(pool_nodes, node_total, node_index, factory, node_axes)

    gangs: list[_Gang] = []
    per_queue_jobs: dict[int, list] = {qi: [] for qi in range(len(sorted_queues))}
    for job in queued_jobs:
        qi = queue_by_name.get(job.queue)
        if qi is None:
            continue
        if job.pools and pool not in job.pools:
            continue
        per_queue_jobs[qi].append(job)

    gang_members_out: list[list] = []

    def _new_gang() -> _Gang:
        g = _Gang()
        gangs.append(g)
        return g

    # evictee slots first (order ranks below queued gangs per queue)
    evictee_by_queue: dict[int, list] = {qi: [] for qi in range(len(sorted_queues))}
    running_gang_groups: dict[str, list] = {}
    for ri, r in enumerate(run_list):
        run_job_ids.append(r.job.id)
        run_req[ri] = factory.ceil_units(r.job.resources.atoms) if r.job.resources else 0
        run_node[ri] = node_index[r.node_id]
        pc = config.priority_class(r.job.priority_class)
        if r.away:
            # Away runs hold resources at the lowest real level and are
            # always evictable by home jobs (scheduling_algo.go:216-283).
            run_level[ri] = 1
            preemptible = True
        else:
            run_level[ri] = level_of_priority[pc.priority]
            preemptible = pc.preemptible
        qi = queue_by_name.get(r.job.queue, -1)
        if qi < 0:
            continue  # unknown queue: cannot be evicted (pqs.go:129-131)
        run_queue[ri] = qi
        run_pc[ri] = pc_index[pc.name]
        run_preemptible[ri] = preemptible
        run_valid[ri] = True
        if preemptible:
            evictee_by_queue[qi].append(ri)
            if r.job.gang_id:
                # fate-sharing group for the partial-preemption cascade
                running_gang_groups.setdefault(
                    f"{r.job.queue}/{r.job.gang_id}", []
                ).append(ri)

    run_gang = np.full((RJ,), -1, np.int32)
    for qi, ris in evictee_by_queue.items():
        # evictees ordered among themselves by the same comparator
        if market:
            ris.sort(
                key=lambda ri: (
                    -price_of(run_list[ri].job),
                    run_list[ri].job.submit_time,
                    run_list[ri].job.id,
                )
            )
        else:
            ris.sort(
                key=lambda ri: _job_sort_key(
                    ladder[max(run_level[ri] - 2, 0)], run_list[ri].job
                )
            )
        for order, ri in enumerate(ris):
            g = _new_gang()
            g.jobs = []
            g.queue = qi
            g.key = -1
            g.level = int(run_level[ri])
            g.pc = int(run_pc[ri])
            g.req = run_req[ri].copy()
            g.req_atoms = None
            g.card = 1
            g.order = order
            g.run = ri
            g.price = float(price_of(run_list[ri].job))
            g.spot_price = g.price
            g.group = ""
            g.uban = None
            g.dead = False
            run_gang[ri] = len(gangs) - 1
            gang_members_out.append([])

    # Occupancy for the uniformity-domain pick (run tensors are now filled),
    # and where each partially-running gang's siblings already live: re-queued
    # members must rejoin the SAME domain, not the statically-best one.
    fitctx.set_running_usage(run_req, run_node, run_valid)
    running_gang_nodes: dict[tuple, list[int]] = {}
    for r in run_list:
        if r.job.gang_id:
            rqi = queue_by_name.get(r.job.queue)
            if rqi is not None:
                running_gang_nodes.setdefault((rqi, r.job.gang_id), []).append(
                    node_index[r.node_id]
                )

    # queued gangs, per queue, lookback-capped
    for qi in range(len(sorted_queues)):
        jobs = per_queue_jobs[qi]
        # group by gang id; singletons stay singletons
        by_gang: dict[str, list] = {}
        singles = []
        for job in jobs:
            if job.gang_id:
                by_gang.setdefault(job.gang_id, []).append(job)
            else:
                singles.append(job)
        def unit_key(lead_pc_priority, job):
            if market:
                return (-price_of(job), job.submit_time, job.id)
            return _job_sort_key(lead_pc_priority, job)

        units: list[tuple[tuple, list, int, str, object, bool]] = []
        for job in singles:
            pc = config.priority_class(job.priority_class)
            units.append(
                (unit_key(pc.priority, job), [job], _key_of(job), "", None, False)
            )
        for gang_id, members in by_gang.items():
            gang_bans = sorted(
                set().union(*(bans_of.get(m.id, ()) for m in members))
            ) if bans_of else ()
            # Node-uniformity (gang_scheduler.go NodeUniformity): restrict the
            # whole gang to the single best label-value domain, chosen by
            # usable static capacity; encoded as extra ban rows, so the
            # kernel needs no new machinery.  Re-chosen every round.  The
            # choice sees every key CLASS of the gang (grouped provisionally,
            # without interning junk keys), so a heterogeneous gang's domain
            # must work for all of its classes.
            label = members[0].gang_node_uniformity_label
            uniformity = ("", "")
            uban: Optional[set] = None
            if label:
                def _sig(m: JobSpec):
                    return class_signature(m, config.node_id_label)

                prov: dict = {}
                for m in members:
                    prov.setdefault(_sig(m), []).append(m)
                classes = [(grp[0], len(grp)) for grp in prov.values()]
                if len(classes) == 1:
                    classes = [
                        (
                            members[0],
                            max(len(members), members[0].gang_cardinality or 1),
                        )
                    ]
                # Partially-running gang: siblings already occupy a domain;
                # re-queued members MUST rejoin it or the gang straddles.
                pinned_values = {
                    pool_nodes[ni].labels.get(label)
                    for ni in running_gang_nodes.get((qi, gang_id), ())
                } - {None}
                if len(pinned_values) == 1:
                    chosen = next(iter(pinned_values))
                    allowed = {
                        int(i)
                        for i in fitctx.domains(label).get(
                            chosen, np.zeros(0, np.int64)
                        )
                    }
                    uban = set(range(fitctx.num_real)) - allowed
                else:
                    uban, chosen = _uniform_domain_ban(
                        fitctx, label, classes, gang_bans, config.node_id_label
                    )
                uniformity = (label, chosen)
            keys = {_key_of(m, gang_bans, uniformity) for m in members}
            if len(keys) > 1:
                # Heterogeneous gangs split per key class; the hopeless check
                # below + the decode unwind keep them atomic across classes.
                by_key: dict[int, list] = {}
                for m in members:
                    by_key.setdefault(_key_of(m, gang_bans, uniformity), []).append(m)
                groups = list(by_key.items())
            else:
                groups = [(next(iter(keys)), members)]
            group_tag = f"{qi}:{gang_id}" if len(groups) > 1 else ""
            # If the declared gang is statically hopeless, kill every sub-gang
            # up front so no sibling placement has to be unwound after the
            # fact (and no eviction is spent on it).  Two tiers, both sound
            # (never kill a feasible gang):
            #   1. per class: integer member capacity across usable nodes
            #      < member count;
            #   2. jointly: classes are individually feasible but COMPETE for
            #      the same nodes (gang_scheduler.go:152-227 discovers this by
            #      actually placing; here a Hall-condition bound over class
            #      subsets with a fractional-LP per-node capacity).
            dead = False
            if len(groups) > 1:
                class_info = []  # (usable[n], frac_cap[n], count)
                for _, grp in groups:
                    glead = grp[0]
                    usable = fitctx.ok & fitctx.static_fit(
                        glead, config.node_id_label
                    )
                    if uban:
                        usable = usable.copy()
                        usable[np.asarray(sorted(uban), np.int64)] = False
                    req_units = (
                        fitctx.factory.ceil_units(glead.resources.atoms).astype(np.float64)
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
                    key=lambda m: _job_sort_key(
                        config.priority_class(m.priority_class).priority, m
                    ),
                )
                pc = config.priority_class(lead.priority_class)
                units.append(
                    (unit_key(pc.priority, lead), grp, grp_key, group_tag, uban, dead)
                )
        units.sort(key=lambda u: u[0])
        kept = units[: config.max_queue_lookback]
        if len(units) > len(kept):
            # The lookback cap must keep or drop a split gang's sub-gangs
            # ATOMICALLY: a sibling truncated out of the problem would be
            # invisible to the decode unwind and a half-gang could lease.
            kept_tags = {u[3] for u in kept if u[3]}
            cut_tags = {u[3] for u in units[len(kept):] if u[3]}
            partial = kept_tags & cut_tags
            if partial:
                kept = [u for u in kept if u[3] not in partial]
        base = len(evictee_by_queue[qi])
        for order, (_, members, key, group_tag, uban, dead) in enumerate(kept):
            lead = members[0]
            pc = config.priority_class(lead.priority_class)
            g = _new_gang()
            g.jobs = [m.id for m in members]
            g.queue = qi
            g.key = key
            g.level = 1 if away_mode else job_level(lead)
            g.pc = pc_index[pc.name]
            # raw atoms; unit-ceiled in ONE vectorized pass at assembly
            g.req = None
            g.req_atoms = lead.resources.atoms if lead.resources else None
            g.card = len(members)
            g.order = base + order
            g.run = -1
            g.price = float(price_of(lead))
            g.spot_price = (
                g.price
                if len(members) == 1
                else min(float(price_of(m)) for m in members)
            )
            g.group = group_tag
            g.uban = uban
            g.dead = dead
            gang_members_out.append(g.jobs)

    G = _pad(len(gangs), bucket)
    g_req = np.zeros((G, R), np.float32)
    g_card = np.zeros((G,), np.int32)
    g_level = np.ones((G,), np.int32)
    g_queue = np.zeros((G,), np.int32)
    g_key = np.full((G,), -1, np.int32)
    g_pc = np.zeros((G,), np.int32)
    g_order = np.zeros((G,), np.int32)
    g_run = np.full((G,), -1, np.int32)
    g_valid = np.zeros((G,), bool)
    g_price = np.zeros((G,), np.float32)
    g_spot_price = np.zeros((G,), np.float32)
    for i, g in enumerate(gangs):
        if g.req is not None:
            g_req[i] = g.req
        g_card[i] = g.card
        g_level[i] = g.level
        g_queue[i] = g.queue
        g_key[i] = g.key
        g_pc[i] = g.pc
        g_order[i] = g.order
        g_run[i] = g.run
        g_valid[i] = not g.dead
        g_price[i] = g.price
        g_spot_price[i] = g.spot_price
    # Unit-ceil every queued gang's request in one vectorized pass (a per-gang
    # ceil_units call costs ~3us of numpy overhead; at 1M gangs that is
    # seconds of host time per round).
    atom_rows = [i for i, g in enumerate(gangs) if g.req is None]
    if atom_rows:
        mat = np.stack(
            [
                gangs[i].req_atoms
                if gangs[i].req_atoms is not None
                else np.zeros((R,), np.int64)
                for i in atom_rows
            ]
        )
        g_req[atom_rows] = factory.ceil_units(mat).astype(np.float32)

    # --- pinned node for evictee slots is derived in-kernel from run_node -------

    # --- static fit matrix ------------------------------------------------------
    K = max(1, len(kidx))
    T = max(1, len(ntidx))
    compat = np.zeros((K, T), bool)
    compat_pre_type = np.zeros((K, T), bool)
    if len(kidx) and len(ntidx):
        compat[: len(kidx), : len(ntidx)] = static_fit_matrix(kidx.keys, ntidx.types)
        compat_pre_type[: len(kidx), : len(ntidx)] = static_fit_matrix(
            kidx.keys, ntidx.types, pre_type=True
        )
    key_type_row, type_bias = type_score_tables(kidx.keys, ntidx.types, K, T)

    # --- pool totals, DRF, caps -------------------------------------------------
    float_total = np.zeros((R,), np.float32)
    if floating_names:
        fl = factory.from_mapping(config.floating_totals_for_pool(pool))
        # Same resolution-unit scale as node_total/g_req (floor like capacity).
        float_total = (
            factory.floor_units(fl.atoms).astype(np.float64) * (1 - node_axes)
        ).astype(np.float32)
    # Keep an exact f64 copy: the f32 device tensor is fine for shares, but
    # metric events publish the totals as exact quantities (a 50k-node pool's
    # byte count exceeds f32's 2^24 integer range).
    total_pool64 = node_total[: len(pool_nodes)].sum(axis=0, dtype=np.float64)
    # Floating capacity joins the pool totals for fairness + caps
    # (scheduling_algo.go:289,585 adds GetTotalAvailableForPool).
    total_pool64 = total_pool64 + float_total.astype(np.float64)
    total_pool = total_pool64.astype(np.float32)
    drf_mult = factory.multipliers_for(config.drf_multipliers()).astype(np.float32)
    scale = node_total.max(axis=0) if len(pool_nodes) else np.zeros(R, np.float32)
    inv_scale = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-9), 0.0).astype(np.float32)

    round_cap = np.full((R,), _INF, np.float32)
    for name, frac in config.maximum_resource_fraction_to_schedule.items():
        if name in factory.names:
            round_cap[factory.index_of(name)] = frac * total_pool[factory.index_of(name)]

    C = len(pc_names)
    pc_queue_cap = pc_queue_caps(config, pc_names, factory, total_pool)

    # --- ban rows: retry anti-affinity + uniformity-domain restrictions --------
    # Row 0 is the all-clear; each gang with bans gets its own row.  Shapes are
    # padded to small buckets so shapes change only when the banned-gang count
    # crosses a bucket boundary.
    g_ban_row = np.zeros((G,), np.int32)
    ban_rows: list[np.ndarray] = []
    rows_by_gang: dict[int, np.ndarray] = {}

    def _gang_row(gi: int) -> np.ndarray:
        row = rows_by_gang.get(gi)
        if row is None:
            row = np.zeros((N,), bool)
            rows_by_gang[gi] = row
        return row

    if bans_of:
        gang_of_job = {}
        for gi, members in enumerate(gang_members_out):
            for jid in members:
                gang_of_job[jid] = gi
        for jid, node_ids in bans_of.items():
            gi = gang_of_job.get(jid)
            if gi is None:
                continue
            row = _gang_row(gi)
            for nid in node_ids:
                ni = node_index.get(nid)
                if ni is not None:
                    row[ni] = True
    for gi, g in enumerate(gangs):
        if g.uban:
            row = _gang_row(gi)
            for ni in g.uban:
                row[ni] = True
    for gi, row in rows_by_gang.items():
        if row.any():
            ban_rows.append(row)
            g_ban_row[gi] = len(ban_rows)
    BR = _pad(len(ban_rows) + 1, 8) if ban_rows else 1
    ban_mask = np.zeros((BR, N), bool)
    for i, row in enumerate(ban_rows):
        ban_mask[i + 1] = row

    # --- queue-ordered gang index ----------------------------------------------
    Q = _pad(len(sorted_queues), bucket)
    gq_gang, q_start, q_len = queue_ordered_gang_index(
        g_queue, g_order, len(gangs), G, Q
    )

    # --- queues: weights + constrained demand share ----------------------------
    q_weight = np.zeros((Q,), np.float32)
    q_cds = np.zeros((Q,), np.float32)
    q_penalty = np.zeros((Q, R), np.float32)
    if queue_penalty:
        for qname, atoms in queue_penalty.items():
            qi = queue_by_name.get(qname)
            if qi is not None:
                q_penalty[qi] = factory.ceil_units(atoms).astype(np.float32)
    demand_by_pc = np.zeros((len(sorted_queues), C, R), np.float64)
    nreal = len(gangs)
    if nreal:
        queued_mask = g_run[:nreal] < 0
        contrib = g_req[:nreal].astype(np.float64) * g_card[:nreal, None]
        np.add.at(
            demand_by_pc,
            (g_queue[:nreal][queued_mask], g_pc[:nreal][queued_mask]),
            contrib[queued_mask],
        )
    nr = len(run_list)
    if nr:
        rv = run_valid[:nr]
        np.add.at(
            demand_by_pc,
            (run_queue[:nr][rv], run_pc[:nr][rv]),
            run_req[:nr][rv].astype(np.float64),
        )
    q_demand_raw = [0.0] * len(sorted_queues)
    for qi, q in enumerate(sorted_queues):
        q_weight[qi] = q.weight
        raw = demand_by_pc[qi].sum(axis=0)
        capped = np.minimum(demand_by_pc[qi], pc_queue_cap).sum(axis=0)
        capped = np.minimum(capped, total_pool.astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(total_pool > 0, capped / np.maximum(total_pool, 1e-9), 0.0)
            rawfrac = np.where(
                total_pool > 0, raw / np.maximum(total_pool, 1e-9), 0.0
            )
        q_cds[qi] = max(0.0, float((frac * drf_mult).max())) if R else 0.0
        # RAW demand share (may exceed 1) for metric events: the reference's
        # metricevents distinguishes demand from constrained_demand.
        q_demand_raw[qi] = max(0.0, float((rawfrac * drf_mult).max())) if R else 0.0

    # --- burst caps, clamped by the rate limiters' available tokens -----------
    burst_cfg = config.maximum_scheduling_burst or 2**31 - 1
    if global_tokens is not None:
        burst_cfg = max(0, min(burst_cfg, int(global_tokens)))
    perq_cfg = config.maximum_per_queue_scheduling_burst or 2**31 - 1
    perq_burst = np.full((Q,), 2**31 - 1, np.int32)
    for qi, q in enumerate(sorted_queues):
        cap = perq_cfg
        if queue_tokens is not None and q.name in queue_tokens:
            cap = max(0, min(cap, int(queue_tokens[q.name])))
        perq_burst[qi] = min(cap, 2**31 - 1)

    max_card = int(g_card.max()) if len(gangs) else 1
    if max_card > 10_000:
        raise ValueError(f"gang cardinality {max_card} exceeds the supported 10k")
    W = max(1, min(max_card, N))
    S = max(1, min(len(gangs), burst_cfg))

    problem = SchedulingProblem(
        node_total=node_total,
        node_type=node_type,
        node_ok=node_ok,
        run_req=run_req,
        run_node=run_node,
        run_level=run_level,
        run_queue=run_queue,
        run_pc=run_pc,
        run_preemptible=run_preemptible,
        run_gang=run_gang,
        run_valid=run_valid,
        g_req=g_req,
        g_card=g_card,
        g_level=g_level,
        g_queue=g_queue,
        g_key=g_key,
        g_pc=g_pc,
        g_order=g_order,
        g_run=g_run,
        g_valid=g_valid,
        g_absent=np.zeros_like(g_valid),
        g_price=g_price,
        g_spot_price=g_spot_price,
        gq_gang=gq_gang,
        q_start=q_start,
        q_len=q_len,
        q_weight=q_weight,
        q_cds=q_cds,
        q_penalty=q_penalty,
        compat=compat,
        total_pool=total_pool,
        drf_mult=drf_mult,
        inv_scale=inv_scale,
        round_cap=round_cap,
        pc_queue_cap=pc_queue_cap.astype(np.float32),
        # Away rounds never evict: guests take genuinely free capacity only
        # (the host's home rounds handle eviction; an away guest must not be
        # able to displace a home job).
        protected_fraction=np.float32(
            _INF if away_mode else config.protected_fraction_of_fair_share
        ),
        global_burst=np.int32(min(burst_cfg, 2**31 - 1)),
        perq_burst=perq_burst,
        node_axes=node_axes,
        float_total=float_total,
        market=np.bool_(market),
        spot_cutoff=np.float32(
            pool_cfg.spot_price_cutoff
            if market and pool_cfg is not None and pool_cfg.spot_price_cutoff > 0
            else _INF
        ),
        ban_mask=ban_mask,
        g_ban_row=g_ban_row,
        type_bias=type_bias,
        key_type_row=key_type_row,
        compat_pre_type=compat_pre_type,
    )
    ctx = HostContext(
        config=config,
        pool=pool,
        queue_names=[q.name for q in sorted_queues],
        node_ids=[n.id for n in pool_nodes],
        gang_members=gang_members_out,
        gang_group=[g.group for g in gangs],
        run_job_ids=run_job_ids,
        num_real_nodes=len(pool_nodes),
        num_real_queues=len(sorted_queues),
        num_real_gangs=len(gangs),
        num_real_runs=len(run_list),
        ladder=ladder,
        pc_names=pc_names,
        max_slots=S,
        slot_width=W,
        q_demand_raw=q_demand_raw,
        pool_total_atoms={
            name: int(round(float(total_pool64[i]) * factory.resolutions[i]))
            for i, name in enumerate(factory.names)
            if total_pool64[i]
        },
        running_gangs={
            tag: tuple(ris)
            for tag, ris in running_gang_groups.items()
            if len(ris) > 1
        },
        type_names=[nt.hw_type for nt in ntidx.types],
    )
    return problem, ctx




_TERMINATIONS = ["exhausted", "global_burst", "round_resource_cap", "max_iterations"]


def queue_stats_from_result(result, problem: SchedulingProblem, ctx: HostContext) -> dict:
    """Per-queue share numbers from the final round state.  Fair shares are
    recomputed from the same inputs the round used, on the device the result
    lies on (a CUDA result runs the water-filling kernel)."""
    import torch

    from armada_tpu_torch.ops.fairness import fair_shares, unweighted_drf_cost

    dev = result.q_alloc.device

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    shares = fair_shares(t(problem.q_weight), t(problem.q_cds))
    actual = unweighted_drf_cost(result.q_alloc, t(problem.total_pool), t(problem.drf_mult))
    penalty = unweighted_drf_cost(
        t(problem.q_penalty), t(problem.total_pool), t(problem.drf_mult)
    )
    fs = shares.fair_share.cpu().numpy()
    afs = shares.demand_capped_adjusted_fair_share.cpu().numpy()
    actual = actual.cpu().numpy()
    penalty = penalty.cpu().numpy()
    q_weight = np.asarray(problem.q_weight)
    q_cds = np.asarray(problem.q_cds)
    out = {}
    for qi in range(ctx.num_real_queues):
        out[ctx.queue_names[qi]] = {
            "weight": float(q_weight[qi]),
            "fair_share": float(fs[qi]),
            "adjusted_fair_share": float(afs[qi]),
            "actual_share": float(actual[qi]),
            "demand_share": float(q_cds[qi]),
            "demand_share_raw": (
                float(ctx.q_demand_raw[qi]) if qi < len(ctx.q_demand_raw) else 0.0
            ),
            "short_job_penalty": float(penalty[qi]),
        }
    return out


# Caps of the packed one-transfer decode; a round whose failed/evicted counts
# exceed them falls back to pulling the full arrays.
COMPACT_FCAP = 8192
COMPACT_ECAP = 8192


def _dispatch_compact(result, ctx: HostContext):
    """Enqueue the result compaction behind the round on the result's device
    without reading it back: (buffer, fcap, ecap)."""
    from armada_tpu_torch.models.fair_scheduler import compact_result

    G = int(result.g_state.shape[0])
    RJ = int(result.run_evicted.shape[0])
    fcap = min(G, COMPACT_FCAP)
    ecap = min(RJ, COMPACT_ECAP) if RJ else 0
    buf = compact_result(
        result, ctx.num_real_gangs, ctx.num_real_runs, fcap=fcap, ecap=ecap
    )
    return buf, fcap, ecap


def _fetch_compact(ctx: HostContext, dispatched):
    """Pull the decode inputs in one device-to-host copy and parse them."""
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    ctx.last_compact_np = None

    buf_dev, fcap, ecap = dispatched
    buf = buf_dev.cpu().numpy()
    TRANSFER_STATS.count_down(buf.nbytes)
    if os.environ.get("ARMADA_FAULT"):
        # round_corrupt `bytes` drill (core/faults): flip a bit in the
        # buffer AS RECEIVED -- decode and the verification fingerprint both
        # see the corrupted copy, as with real transfer corruption.  Slot 3
        # (sched_count) is decode-inert, so only the fingerprint catches it.
        from armada_tpu_torch.core import faults as _faults

        if _faults.active("round_corrupt", modes=("bytes",)):
            buf = buf.copy()
            buf[min(3, buf.size - 1)] ^= np.int32(1 << 20)
    return _parse_compact(buf, ctx, fcap, ecap)


def _parse_compact(buf: np.ndarray, ctx: HostContext, fcap: int, ecap: int):
    """Decode-input tuple from a fetched compact buffer, or None when a cap
    overflowed (the caller then pulls the full arrays).  Stashes the exact
    bytes on the ctx (HostContext.last_compact_np) for the verification
    fingerprint cross-check (models/verify.py)."""
    from armada_tpu_torch.models.fair_scheduler import COMPACT_HEADER

    ctx.last_compact_np = buf

    (
        n_slots, iterations, termination, _sched_count, spot_bits, n_failed,
        n_pre, n_res, kernel_iters,
    ) = (int(v) for v in buf[:COMPACT_HEADER])
    if n_failed > fcap or n_pre > ecap or n_res > ecap:
        return None
    spot = float(np.int32(spot_bits).view(np.float32))
    S, W = ctx.max_slots, ctx.slot_width
    off = COMPACT_HEADER
    slot_gang = buf[off : off + S]
    off += S
    slot_nodes = buf[off : off + S * W].reshape(S, W)
    off += S * W
    slot_counts = buf[off : off + S * W].reshape(S, W)
    off += S * W
    g2 = buf[off : off + n_failed]
    off += fcap
    pre_idx = buf[off : off + n_pre]
    off += ecap
    res_idx = buf[off : off + n_res]

    sched_set = set(int(g) for g in slot_gang[:n_slots])
    failed_set = set(int(g) for g in g2)

    def state_of(gi: int) -> int:
        if gi in sched_set:
            return 1
        return 2 if gi in failed_set else 0

    return (
        n_slots, slot_gang, slot_nodes, slot_counts, g2, pre_idx, res_idx,
        state_of, iterations, termination, spot, kernel_iters,
    )


def begin_decode(result, ctx: HostContext):
    """Start the decode without blocking: the compaction is enqueued behind
    the round on its stream.  Returns a zero-arg callable producing the
    RoundOutcome; `finish.fetch()` performs just the blocking fetch."""
    dispatched = _dispatch_compact(result, ctx)
    box: dict = {}

    def fetch():
        if "v" not in box:
            box["v"] = _fetch_compact(ctx, dispatched)
        return box["v"]

    def finish() -> RoundOutcome:
        return decode_result(result, ctx, _fetched=fetch())

    finish.dispatched = dispatched
    finish.fetch = fetch
    return finish


def begin_decode_stacked(result, ctxs: list):
    """begin_decode for a stacked round: `result` is a RoundResult whose
    every field carries a leading lane axis (schedule_round_stacked);
    `ctxs[i]` is lane i's HostContext.  One stacked compaction (kernel K-F
    on a card) and one [P, L] device-to-host copy replace P of each.

    Returns per-lane finish callables with begin_decode's API: ``finish()``
    -> RoundOutcome, ``finish.fetch()`` = the blocking fetch of THIS lane's
    row (the first caller pays the one shared transfer),
    ``finish.dispatched`` = the shared (buffer, fcap, ecap) handle.  Unlike
    the JAX package, which returns None for a host-array result, the port
    always decodes stacked: a CPU stack runs the plain versions."""
    from armada_tpu_torch.kernels.compact import compact_result_stacked
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    G = int(result.g_state.shape[1])
    RJ = int(result.run_evicted.shape[1])
    fcap = min(G, COMPACT_FCAP)
    ecap = min(RJ, COMPACT_ECAP) if RJ else 0
    buf = compact_result_stacked(
        result, [c.num_real_gangs for c in ctxs], [c.num_real_runs for c in ctxs],
        fcap=fcap, ecap=ecap,
    )
    box: dict = {}

    def fetch_all() -> np.ndarray:
        if "all" not in box:
            arr = buf.cpu().numpy()
            TRANSFER_STATS.count_down(arr.nbytes)
            box["all"] = arr
        return box["all"]

    finishes = []
    for i, ctx in enumerate(ctxs):

        def fetch(i=i, ctx=ctx):
            if i not in box:
                box[i] = _parse_compact(fetch_all()[i], ctx, fcap, ecap)
            return box[i]

        def finish(i=i, ctx=ctx, fetch=fetch) -> RoundOutcome:
            fetched = fetch()
            # the lane slice of the stacked result is taken only when a cap
            # overflowed (the full-array decode needs it)
            lane = None if fetched is not None else lane_slice(result, i)
            return decode_result(lane, ctx, _fetched=fetched)

        finish.dispatched = (buf, fcap, ecap)
        finish.fetch = fetch
        finish.stacked_index = i
        finishes.append(finish)
    return finishes


def lane_slice(tree, i: int):
    """Lane `i` of a stacked SchedulingProblem or RoundResult, every field
    in a fresh buffer: one launch of kernel K-G on a card, t[i].clone() per
    field on the CPU."""
    from armada_tpu_torch.kernels.lanes import lane_slice as wrapper

    return wrapper(tree, i)


_UNFETCHED = object()  # decode_result sentinel: None is a real fetch result


def decode_result(result, ctx: HostContext, _fetched=_UNFETCHED) -> RoundOutcome:
    """Map round tensors back to job and node ids (the reference's
    SchedulerResult)."""
    compact = (
        _fetched if _fetched is not _UNFETCHED
        else _fetch_compact(ctx, _dispatch_compact(result, ctx))
    )
    if compact is not None:
        (
            n_slots, slot_gang, slot_nodes, slot_counts, g2, pre_idx, res_idx,
            state_of, iterations, termination, spot, kernel_iters,
        ) = compact
    else:
        g_state = result.g_state.cpu().numpy()
        slot_gang = result.slot_gang.cpu().numpy()
        slot_nodes = result.slot_nodes.cpu().numpy()
        slot_counts = result.slot_counts.cpu().numpy()
        n_slots = int(result.n_slots)
        nr = ctx.num_real_runs
        ev = result.run_evicted.cpu().numpy()[:nr]
        rs = result.run_rescheduled.cpu().numpy()[:nr]
        pre_idx = np.flatnonzero(ev & ~rs)
        res_idx = np.flatnonzero(ev & rs)
        g2 = np.flatnonzero(g_state[: ctx.num_real_gangs] == 2)
        state_of = lambda gi: int(g_state[gi])  # noqa: E731
        iterations = int(result.iterations)
        kernel_iters = int(result.kernel_iters)
        termination = int(result.termination)
        spot = float(result.spot_price)

    scheduled: dict = {}
    for s in range(n_slots):
        gi = int(slot_gang[s])
        members = ctx.members_of(gi)
        mi = 0
        for w in range(ctx.slot_width):
            node = int(slot_nodes[s, w])
            for _ in range(int(slot_counts[s, w])):
                if mi < len(members):
                    scheduled[members[mi]] = ctx.node_ids[node]
                    mi += 1

    preempted = [ctx.run_job_id(int(ri)) for ri in pre_idx]
    rescheduled = [ctx.run_job_id(int(ri)) for ri in res_idx]

    if ctx.gang_members is None:
        # Vectorized path: a round can retire whole unfeasible key classes
        # (g_state=2 en masse); per-id Python here costs seconds at 1M
        # gangs, so decode stays lazy until someone iterates.
        ids = ctx.gang_ids_vec[g2]
        extra = [
            m
            for gi, members in ctx.gang_members_over.items()
            if state_of(gi) == 2
            for m in members
        ]
        failed = LazyJobIds(ids[ids != b""], extra)
    else:
        failed = []
        for gi in g2:
            failed.extend(ctx.members_of(int(gi)))

    # Cross-class gang atomicity: a declared gang split into per-key sub-gangs
    # unwinds its placed siblings when another sub-gang failed; the caller
    # re-runs the round without the doomed gangs.
    unwound = set()
    groups: dict = {}
    # Split-gang tags live only on multi-member units under the vectorized
    # representation; the list path may tag any gang.
    tagged = (
        ctx.gang_members_over.keys()
        if ctx.gang_members is None
        else range(ctx.num_real_gangs)
    )
    for gi in tagged:
        tag = ctx.gang_group[gi]
        if tag:
            groups.setdefault(tag, []).append(gi)
    for tag, gis in groups.items():
        states = {state_of(gi) for gi in gis}
        if 1 in states and states != {1}:
            unwound.add(tag)
            for gi in gis:
                if state_of(gi) == 1:
                    for jid in ctx.members_of(gi):
                        scheduled.pop(jid, None)
                        failed.append(jid)

    return RoundOutcome(
        scheduled=scheduled,
        preempted=preempted,
        rescheduled=rescheduled,
        failed=failed,
        num_iterations=iterations,
        kernel_iters=kernel_iters,
        termination=_TERMINATIONS[termination],
        spot_price=spot if spot >= 0 else None,
        unwound_groups=frozenset(unwound),
    )
