"""FairSchedulingAlgo: the per-cycle scheduling decision over all pools.

Equivalent of the reference's SchedulingAlgo interface + FairSchedulingAlgo
(internal/scheduler/scheduling/scheduling_algo.go:36-41,100-848): collect
healthy executors' nodes, the queued and running jobs per pool, run one
scheduling round per pool -- here the port's CUDA kernels
(armada_tpu_torch.models) -- and apply the decisions to the JobDb
transaction.

The port's copy of the JAX package's scheduler/algo.py, with an explicit
`device` (the card unless the caller passes device="cpu").  Both assembly
modes (the incremental feed and the legacy per-cycle build), the
pool-parallel window, the serial per-pool loop and the away rounds are
ported, and so is the market half: market-driven pools served through a
bid-price provider, the indicative gang pricer, the idealised and realised
values (the mega-node round runs on the card too), the optimiser and
priority overrides (scheduler/providers.py, pricer.py, idealised*.py,
optimiser.py).  Market pools stay out of the pool-parallel window.  The
trace spans carry no decision and are left out; the watchdog's degraded
attribution reads "never degraded" until its supervisor is ported
(ROADMAP item 8).

Executor health filters mirror scheduling_algo.go:
  * stale executors (heartbeat older than executor_timeout_s) are excluded
    entirely (filterStaleExecutors:798);
  * cordoned executors keep their nodes visible (running jobs still count for
    fairness) but unschedulable (filterCordonedExecutors:780);
  * lagging executors (too many unacknowledged leases) likewise stop receiving
    new jobs but keep their allocation counted (filterLaggingExecutors:816).
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Callable, Optional, Sequence

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.pipeline import (
    pipeline_enabled,
    pool_parallel_enabled,
    prefetch_worthwhile,
)
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob
from armada_tpu_torch.jobdb.job import Job, JobRun
from armada_tpu_torch.jobdb.jobdb import WriteTxn
from armada_tpu_torch.models import (
    PoolRoundSpec,
    RoundOutcome,
    collect_round_stats,
    dispatch_pool_rounds,
    run_round_on_device,
    run_scheduling_round,
)
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
from armada_tpu_torch.scheduler.ratelimit import SchedulingRateLimiters


@dataclasses.dataclass
class PoolStats:
    pool: str
    outcome: RoundOutcome
    num_nodes: int
    num_queued: int
    num_running: int
    # Wall seconds of THIS pool's round (prepare + dispatch share + fetch +
    # apply) and whether it paid a failover window -- always False in the
    # port, which has no failover ladder yet.
    round_s: float = 0.0
    degraded: bool = False
    # Market pools only (cycle_metrics.go:534,455,456): configured-shape
    # prices, the per-queue idealised ("boundary-less cluster") values, and
    # the realised values of what actually scheduled -- idealised minus
    # realised is the expectation gap (idealised_value_scheduler.go:28-33).
    market: bool = False
    indicative_prices: dict = dataclasses.field(default_factory=dict)
    idealised_values: dict = dataclasses.field(default_factory=dict)
    realised_values: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerResult:
    """The decisions of one cycle (the reference's SchedulerResult)."""

    # (job AFTER lease applied, its new run)
    scheduled: list = dataclasses.field(default_factory=list)
    # (job AFTER preemption applied, the preempted run)
    preempted: list = dataclasses.field(default_factory=list)
    # job ids attempted but unplaceable this round; lazily chained -- a round
    # can retire an entire unfeasible key class (~the whole backlog), and
    # materialising those ids costs seconds at 1M jobs (models/problem.py
    # LazyJobIds).
    failed: "object" = None
    pools: list = dataclasses.field(default_factory=list)  # list[PoolStats]

    def __post_init__(self):
        if self.failed is None:
            from armada_tpu_torch.models.problem import ChainedJobIds

            self.failed = ChainedJobIds()


def _new_run_id() -> str:
    return uuid.uuid4().hex


def _running_of(job: Job, run: JobRun) -> RunningJob:
    """RunningJob view of a (job, run) pair for round inputs."""
    return RunningJob(
        job=dataclasses.replace(job.spec, priority=job.priority),
        node_id=run.node_id,
        priority=run.scheduled_at_priority or 0,
        away=run.pool_scheduled_away,
    )


class FairSchedulingAlgo:
    """Schedule(ctx, txn) over every pool; mutates the txn with the outcome."""

    def __init__(
        self,
        config: SchedulingConfig,
        queues: Callable[[], Sequence[Queue]],
        clock_ns: Callable[[], int],
        run_id_factory: Callable[[], str] = _new_run_id,
        collect_stats: bool = True,
        bid_prices=None,
        priority_overrides=None,
        feed=None,
        device="cuda",
    ):
        """bid_prices: BidPriceProvider for market-driven pools;
        priority_overrides: PriorityOverrideProvider replacing per-(pool,
        queue) fair-share weights (scheduler/providers.py);
        feed: scheduler.incremental_algo.IncrementalProblemFeed -- when
        set, pool rounds assemble from cycle-persistent builders instead of
        re-reading every Job from the txn (the reference keeps its jobDb
        between cycles, scheduler.go:240-246).  The feed must be attached to
        the same JobDb the txns come from, and its device must be `device`.
        device: where the rounds run (the idealised mega-node round of the
        legacy mode too) -- the card unless the caller passes device="cpu"."""
        from armada_tpu_torch.models import _resolve_device

        self.device = _resolve_device(device)
        self.feed = feed
        self.config = config
        self._queues = queues
        self._clock_ns = clock_ns
        self._run_id = run_id_factory
        self.bid_prices = bid_prices
        self.priority_overrides = priority_overrides
        market_pools = [p.name for p in config.pools if p.market_driven]
        if market_pools and bid_prices is None:
            raise ValueError(
                f"pools {market_pools} are market driven: FairSchedulingAlgo "
                "needs a bid_prices provider (scheduler/providers.py)"
            )
        from armada_tpu_torch.scheduler.short_job_penalty import ShortJobPenalty

        self.short_job_penalty = ShortJobPenalty(
            config.short_job_penalty_cutoffs()
        )
        self.gang_pricer = None
        if any(p.market_driven and p.gangs_to_price for p in config.pools):
            from armada_tpu_torch.scheduler.pricer import IndicativeGangPricer

            self.gang_pricer = IndicativeGangPricer(config)
        self.optimiser = None
        if config.optimiser_enabled:
            from armada_tpu_torch.scheduler.optimiser import Optimiser, OptimiserConfig

            self.optimiser = Optimiser(
                config,
                OptimiserConfig(
                    enabled=True,
                    maximum_job_size_to_preempt=(
                        config.optimiser_maximum_job_size_to_preempt
                    ),
                    max_stuck_jobs_per_cycle=config.optimiser_max_stuck_jobs,
                ),
            )
        # Per-queue share stats cost an extra device->host transfer; turn off
        # when neither metrics nor reports are wired.  The optimiser's ideal
        # victim order NEEDS the shares, and metric events publish them, so
        # either forces collection.
        self.collect_stats = (
            collect_stats
            or self.optimiser is not None
            or config.publish_metric_events
        )
        # Rate limiters (maximumSchedulingRate token buckets): clamp the
        # per-round burst caps so sustained throughput meets the config.
        self.rate_limiters = SchedulingRateLimiters(
            config.maximum_scheduling_rate,
            config.maximum_scheduling_burst,
            config.maximum_per_queue_scheduling_rate,
            config.maximum_per_queue_scheduling_burst,
            clock=lambda: self._clock_ns() / 1e9,
        )

    # --- executor health (scheduling_algo.go:780-830) -----------------------

    def _healthy_executors(
        self, executors: Sequence[ExecutorSnapshot], now_ns: int
    ) -> list[ExecutorSnapshot]:
        timeout_ns = int(self.config.executor_timeout_s * 1e9)
        out = []
        for ex in executors:
            if now_ns - ex.last_update_ns > timeout_ns:
                continue  # stale: invisible this round
            lagging = (
                len(ex.unacknowledged_runs)
                > self.config.max_unacknowledged_jobs_per_executor
            )
            if ex.cordoned or lagging:
                ex = dataclasses.replace(
                    ex,
                    nodes=tuple(
                        dataclasses.replace(n, unschedulable=True) for n in ex.nodes
                    ),
                )
            out.append(ex)
        return out

    # --- the per-cycle entry point ------------------------------------------

    def schedule(
        self,
        txn: WriteTxn,
        executors: Sequence[ExecutorSnapshot],
        now_ns: Optional[int] = None,
        quarantined_nodes: frozenset = frozenset(),
        shadow_work: Optional[list] = None,
    ) -> SchedulerResult:
        """quarantined_nodes: node ids excluded for high failure rates --
        treated like cordoned nodes: running jobs keep counting, nothing new
        lands.

        shadow_work: zero-arg callables the caller wants run in a kernel
        shadow (decision-independent host work); drained in the first device
        round's shadow, or inline before returning when no round runs.
        Decisions are identical either way -- shadow thunks must not read
        this cycle's outcome or mutate its problem inputs."""
        now_ns = self._clock_ns() if now_ns is None else now_ns
        pending_shadow = list(shadow_work or [])

        def drain_shadow():
            while pending_shadow:
                pending_shadow.pop(0)()

        result = SchedulerResult()
        if self.config.disable_scheduling:
            # Incident brake (config disableScheduling): an EMPTY result, not
            # a skipped cycle, so metrics/reports cadence continues
            # (scheduling_algo.go:116 returns an empty SchedulerResult).
            drain_shadow()
            return result

        healthy = self._healthy_executors(executors, now_ns)
        nodes: list[NodeSpec] = []
        executor_of_node: dict[str, str] = {}
        for ex in healthy:
            for n in ex.nodes:
                if n.id in quarantined_nodes and not n.unschedulable:
                    n = dataclasses.replace(n, unschedulable=True)
                nodes.append(n)
                executor_of_node[n.id] = ex.id

        queues = list(self._queues())
        known_queues = {q.name for q in queues}

        pools = [p.name for p in self.config.pools]
        for n in nodes:
            if n.pool not in pools:
                pools.append(n.pool)

        incremental = self.feed is not None
        market_pools = {p.name for p in self.config.pools if p.market_driven}
        if incremental:
            # Overlay this txn's uncommitted changes onto the persistent
            # builders.  overlay() records what it applied so the same
            # deltas firing again (later pools' overlays, the commit
            # subscription) skip the idempotent re-apply.
            self.feed.overlay(txn._upserts, txn._deletes)
        # The full per-job txn scans below are what the incremental feed
        # exists to avoid; they remain for the legacy path and the short-job
        # penalty (derived from retained TERMINAL jobs the feed drops).
        # Incremental market pools compute their observability straight off
        # the builder columns (scheduler/idealised_columnar.py, pricer
        # _prepare_columnar), so a 1M-job market cycle stays O(deltas).
        need_job_scan = not incremental
        need_run_scan = (not incremental) or self.short_job_penalty.enabled

        # Queued jobs: validated, in a known queue, with their CURRENT priority
        # (reprioritisation updates Job.priority, not the immutable spec).
        queued_jobs: list[JobSpec] = []
        job_of_spec: dict[str, Job] = {}
        banned_nodes: dict[str, tuple] = {}  # retry anti-affinity
        if need_job_scan:
            for qname in txn.queues_with_queued_jobs():
                if qname not in known_queues:
                    continue
                for job in txn.queued_jobs(qname):
                    if not job.validated:
                        continue
                    # Validated pools (Job.pools) override the requested ones.
                    queued_jobs.append(
                        dataclasses.replace(
                            job.spec,
                            priority=job.priority,
                            pools=job.pools or job.spec.pools,
                        )
                    )
                    job_of_spec[job.id] = job
                    bans = job.anti_affinity_nodes()
                    if bans:
                        banned_nodes[job.id] = bans

        # Running jobs, grouped by pool of their run; short-job penalties
        # accumulate per (run pool, queue) off retained terminal jobs
        # (scheduling_algo.go:342-360 shortJobPenaltyByQueue).
        running_by_pool: dict[str, list[RunningJob]] = {p: [] for p in pools}
        penalty_by_pool: dict[str, dict[str, "object"]] = {}
        if need_run_scan:
            for job in txn.all_jobs():
                run = job.latest_run
                if job.queue not in known_queues:
                    continue
                if run is not None and self.short_job_penalty.applies(job, now_ns):
                    if job.spec.resources is not None:
                        pool_map = penalty_by_pool.setdefault(run.pool or "default", {})
                        prev = pool_map.get(job.queue)
                        atoms = job.spec.resources.atoms
                        pool_map[job.queue] = (
                            atoms
                            if prev is None
                            else [a + b for a, b in zip(prev, atoms)]
                        )
                    continue
                if run is None or run.in_terminal_state() or job.in_terminal_state():
                    continue
                pool = run.pool or "default"
                if pool not in running_by_pool:
                    running_by_pool[pool] = []
                running_by_pool[pool].append(_running_of(job, run))

        bid_price_of = None
        if self.bid_prices is not None:
            provider = self.bid_prices
            # Providers may scope bids per pool (pkg/bidstore keys prices by
            # pool); static in-process providers ignore the extra argument.
            import inspect

            takes_pool = "pool" in inspect.signature(provider.price).parameters

            def _pool_pricer(pool: str):
                if takes_pool:
                    return lambda job: provider.price(
                        job.queue, job.price_band, pool
                    )
                return lambda job: provider.price(job.queue, job.price_band)

            bid_price_of = _pool_pricer("")

        def pool_queues(pool: str) -> list:
            if self.priority_overrides is None:
                return queues
            return [
                (
                    Queue(q.name, ov)
                    if (ov := self.priority_overrides.override(pool, q.name))
                    is not None
                    else q
                )
                for q in queues
            ]

        queue_names = [q.name for q in queues]

        def round_tokens():
            return self.rate_limiters.tokens(queue_names)

        def consume_round(outcome):
            by_queue: dict[str, int] = {}
            for jid in outcome.scheduled:
                job = job_of_spec.get(jid) or txn.get(jid)
                if job is not None:
                    by_queue[job.queue] = by_queue.get(job.queue, 0) + 1
            if by_queue:
                self.rate_limiters.consume(by_queue)

        def commit_outcome(
            pool, outcome, *, num_queued, num_running, pool_nodes,
            market_b=None, running=(), bid_price_of=None, round_s=0.0,
        ):
            """The common per-pool tail -- consume, apply, overlay, stats --
            shared by the serial loop and the pool-parallel window's fetch
            phase.  ALWAYS called in pool-list order: the cross-pool apply
            order (and so the event order) is identical in every mode."""
            nonlocal queued_jobs
            consume_round(outcome)
            self._apply_outcome(txn, outcome, pool, executor_of_node, now_ns, result)
            if incremental:
                # Later pools must see this pool's leases/preemptions; the
                # overlay registry keeps this O(this pool's changes), not
                # O(all txn upserts so far).  (Under the pool-parallel
                # window this is additionally a certified no-op on the
                # OTHER window pools' tables -- pools_independent -- and it
                # fires in the same order as the serial loop regardless.)
                self.feed.overlay(txn._upserts)
            stats = PoolStats(
                pool=pool,
                outcome=outcome,
                num_nodes=len(pool_nodes),
                num_queued=num_queued,
                num_running=num_running,
                round_s=round_s,
            )
            if pool in market_pools:
                stats.market = True
                if incremental:
                    self._market_observability_columnar(
                        stats, pool, pool_nodes, txn, market_b, outcome,
                        bid_price_of,
                    )
                else:
                    self._market_observability(
                        stats, pool, pool_nodes, pool_queues(pool),
                        queued_jobs, running, outcome, bid_price_of,
                    )
            result.pools.append(stats)
            # Jobs scheduled in this pool are no longer queued for later pools.
            scheduled_ids = set(outcome.scheduled)
            if scheduled_ids:
                queued_jobs = [
                    j for j in queued_jobs if j.id not in scheduled_ids
                ]

        # --- pool-parallel serving (ARMADA_POOL_PARALLEL) ----------------------
        # Consecutive eligible pools form a WINDOW whose rounds all dispatch
        # through the device before any fetch, and shape-matched window
        # pools run as ONE stacked round (models.dispatch_pool_rounds).
        # Decisions stay identical to the serial loop: fetch/decode/apply
        # runs strictly in pool-list order, and the window only forms when
        # the cycle CERTIFIES independence --
        #   * every queued job restricted to exactly one pool
        #     (feed.pools_independent(): pool A's apply then provably cannot
        #     touch pool B's assembled problem -- leases land in A's builder
        #     only, removes target ids B never held);
        #   * rate-limiter tokens provably NON-BINDING for the whole window
        #     (armed buckets make pool B's token reading depend on pool A's
        #     consumption; when every windowed pool's tokens minus the
        #     window's worst-case prior consumption still exceed its whole
        #     backlog, the caps cannot trip in either order and the reading
        #     difference is decision-inert);
        #   * non-market pools only (market observability reads builder
        #     state between rounds).
        # Anything else drains the window and runs serially -- a per-cycle
        # decision (a tenant submitting a multi-pool job just flips the next
        # cycle back to serial; scheduler/pool_serving.py counts it).
        pool_parallel_armed = (
            pool_parallel_enabled() and incremental and len(pools) > 1
        )
        pool_parallel_ok = (
            pool_parallel_armed and self.feed.pools_independent()
        )
        window: list = []  # prepared, undispatched eligible pool rounds
        window_demand = [0]  # queued members across the open window
        pool_round_s: dict = {}
        cycle_stacked = [0, 0]  # launches, pools covered
        parallel_used = [False]
        pools_t0 = time.monotonic()

        def finish_window_round(entry, fin) -> None:
            pool = entry["pool"]
            t0 = time.monotonic()
            res, outcome = fin()
            if self.collect_stats:
                collect_round_stats(
                    res, entry["pview"], entry["ctx"], self.config, outcome
                )
            dt = time.monotonic() - t0 + entry["prep_s"]
            pool_round_s[pool] = dt
            commit_outcome(
                pool,
                outcome,
                num_queued=entry["num_queued"],
                num_running=entry["num_running"],
                pool_nodes=entry["pool_nodes"],
                round_s=dt,
            )

        def flush_window() -> None:
            if not window:
                return
            entries = list(window)
            window.clear()
            window_demand[0] = 0
            specs = [e["spec"] for e in entries]
            t0 = time.monotonic()
            finishes, stacked, stacked_pools, _dispatch_failed = dispatch_pool_rounds(
                specs, self.config, device=self.device
            )
            share = (time.monotonic() - t0) / len(entries)
            cycle_stacked[0] += stacked
            cycle_stacked[1] += stacked_pools
            if len(entries) >= 2:
                parallel_used[0] = True
            for e, fin in zip(entries, finishes):
                e["prep_s"] += share
                finish_window_round(e, fin)

        for pool in pools:
            pool_nodes = [n for n in nodes if n.pool == pool]
            if not pool_nodes:
                continue
            window_eligible = pool_parallel_ok and pool not in market_pools
            if not window_eligible:
                # Ineligible pool ahead: every windowed round fetches and
                # applies NOW, so this pool's prepare sees exactly the state
                # the serial loop would have shown it.
                flush_window()
            bid_price_of = _pool_pricer(pool) if self.bid_prices is not None else None
            running = running_by_pool.get(pool, [])
            if incremental:
                prep_t0 = time.monotonic()
                b = self.feed.builder_for(pool, txn)
                # Market prices are re-read from the provider every cycle;
                # the builder's _prices() snapshot uses this callable.
                b.bid_price_of = bid_price_of
                b.set_queues(pool_queues(pool))
                b.set_nodes(pool_nodes)
                num_queued = len(b.jobs.key_of_id) + len(b.gang_jobs)
                num_running = len(b.runs.key_of_id)
                if not num_queued and not num_running:
                    continue
                g_tokens, q_tokens = round_tokens()
                if window_eligible:
                    # Token certification: this pool's burst caps must stay
                    # non-binding even if every EARLIER window pool schedules
                    # its entire backlog first (serial tokens >= this
                    # parallel reading minus that worst case).  num_queued
                    # counts gang MEMBERS, the unit the caps count.  A
                    # failure drains the window and runs this pool serially.
                    cum = window_demand[0]
                    tokens_ok = (
                        g_tokens is None or g_tokens - cum >= num_queued
                    ) and (
                        q_tokens is None
                        or all(
                            v - cum >= num_queued for v in q_tokens.values()
                        )
                    )
                    if not tokens_ok:
                        window_eligible = False
                        flush_window()
                        # The flush consumed the windowed pools' tokens;
                        # re-read so this pool's serial round sees exactly
                        # what the serial loop would have handed it.
                        g_tokens, q_tokens = round_tokens()
                # Slot-stable slab deltas: O(deltas) device upload per cycle
                # (models/slab.py); the round runs on the device-resident
                # problem the cache keeps current by scatter.
                bundle, ctx = b.assemble_delta(
                    global_tokens=g_tokens,
                    queue_tokens=q_tokens,
                    queue_penalty=penalty_by_pool.get(pool),
                )
                pview = bundle.stats_view()
                # A thunk, not a value: the device apply runs inside the
                # round's dispatch.  Early-bound (default args): the closure
                # only ever touches the cache and bundle of ITS round.
                devcache = self.feed.devcache_for(pool)
                if window_eligible:
                    # Window prepare: dispatch is deferred to the flush so
                    # shape-matched pools can stack into one launch; the
                    # spec mirrors the serial run_round_on_device call
                    # exactly.  The cross-pool content prefetch thunk is
                    # omitted here -- every window pool's bundle applies at
                    # this flush anyway, and the prefetch is decision-neutral.
                    window_demand[0] += num_queued
                    window.append(
                        dict(
                            pool=pool,
                            pview=pview,
                            ctx=ctx,
                            num_queued=num_queued,
                            num_running=num_running,
                            pool_nodes=pool_nodes,
                            prep_s=time.monotonic() - prep_t0,
                            spec=PoolRoundSpec(
                                problem=pview,
                                ctx=ctx,
                                device_problem=(
                                    lambda dc=devcache, b_=bundle: dc.apply(b_)
                                ),
                                host_problem=bundle.materialize,
                                shadow_work=(drain_shadow,),
                            ),
                        )
                    )
                    continue
                # Kernel shadow: the caller's deferred thunks plus the OTHER
                # pools' decision-independent slab prefetch (their submit
                # overlays are already final; this pool's bundle just
                # applied, so it is skipped) ride this round's kernels and
                # result fetch.
                shadow = [drain_shadow]
                if (
                    pipeline_enabled()
                    and len(self.feed.builders) > 1
                    and prefetch_worthwhile(self.device)
                ):
                    shadow.append(
                        lambda p=pool: self.feed.prefetch_content(skip_pool=p)
                    )
                res, outcome = run_round_on_device(
                    pview,
                    ctx,
                    self.config,
                    device=self.device,
                    device_problem=lambda dc=devcache, b_=bundle: dc.apply(b_),
                    host_problem=bundle.materialize,
                    shadow_work=shadow,
                )
                if self.collect_stats:
                    collect_round_stats(res, pview, ctx, self.config, outcome)
                dt = time.monotonic() - prep_t0  # prepare + round + stats
                pool_round_s[pool] = dt
                commit_outcome(
                    pool, outcome, num_queued=num_queued,
                    num_running=num_running, pool_nodes=pool_nodes,
                    market_b=b, running=running, bid_price_of=bid_price_of,
                    round_s=dt,
                )
            else:
                if not queued_jobs and not running:
                    continue
                num_queued, num_running = len(queued_jobs), len(running)
                g_tokens, q_tokens = round_tokens()
                t0 = time.monotonic()
                outcome = run_scheduling_round(
                    self.config,
                    pool=pool,
                    nodes=pool_nodes,
                    queues=pool_queues(pool),
                    queued_jobs=queued_jobs,
                    running=running,
                    collect_stats=self.collect_stats,
                    bid_price_of=bid_price_of,
                    global_tokens=g_tokens,
                    queue_tokens=q_tokens,
                    banned_nodes=banned_nodes,
                    queue_penalty=penalty_by_pool.get(pool),
                    device=self.device,
                )
                dt = time.monotonic() - t0
                pool_round_s[pool] = dt
                commit_outcome(
                    pool, outcome, num_queued=num_queued,
                    num_running=num_running, pool_nodes=pool_nodes,
                    running=running, bid_price_of=bid_price_of, round_s=dt,
                )
        flush_window()
        if pool_round_s:
            # Cycle-level pool observability: the overlap ratio (sum of
            # per-pool round seconds over the pool section's wall clock --
            # ~1.0 serial, > 1.0 when dispatches overlapped fetches) and the
            # pool_serving ledger.
            from armada_tpu_torch.scheduler.pool_serving import pool_serving_stats

            wall = max(time.monotonic() - pools_t0, 1e-9)
            overlap = sum(pool_round_s.values()) / wall
            pool_serving_stats().record_cycle(
                parallel=parallel_used[0],
                armed=pool_parallel_armed,
                pool_round_s=pool_round_s,
                stacked_launches=cycle_stacked[0],
                stacked_pools=cycle_stacked[1],
                overlap_ratio=overlap,
            )

        # Away pass (scheduling_algo.go:216-283, nodePools:282): a pool's
        # still-queued jobs borrow nodes FROM its configured away_pools, at the
        # away priority level so the host pool's home jobs can always evict
        # them.  The host's running set is refreshed with this cycle's own
        # decisions (leases added, preemptions removed) so the away round
        # cannot double-book capacity the home rounds just committed.
        preempted_ids = {job.id for job, _ in result.preempted}
        extra_running: dict[str, list[RunningJob]] = {}
        for job, run in result.scheduled:
            extra_running.setdefault(run.pool, []).append(_running_of(job, run))

        def host_running(host: str) -> list[RunningJob]:
            kept = [
                r
                for r in running_by_pool.get(host, [])
                if r.job.id not in preempted_ids
            ]
            return kept + extra_running.get(host, [])

        for pool_cfg in self.config.pools:
            if not pool_cfg.away_pools:
                continue
            home_pool = pool_cfg.name
            # The feed tracks pool-restricted queued jobs in a side set, so
            # the away candidate scan is O(candidates), not O(backlog).
            away_pool_source = (
                self.feed.away_candidates(txn) if incremental else queued_jobs
            )
            away_jobs = [
                j
                for j in away_pool_source
                if j.pools and home_pool in j.pools
            ]
            if not away_jobs:
                continue
            if incremental:
                # Retry anti-affinity for away candidates (the legacy scan
                # collected these into banned_nodes already).
                for j in away_jobs:
                    job = txn.get(j.id)
                    bans = job.anti_affinity_nodes() if job is not None else ()
                    if bans:
                        banned_nodes[j.id] = bans
            for host in pool_cfg.away_pools:
                host_nodes = [n for n in nodes if n.pool == host]
                if not host_nodes or not away_jobs:
                    continue
                g_tokens, q_tokens = round_tokens()
                outcome = run_scheduling_round(
                    self.config,
                    pool=host,
                    nodes=host_nodes,
                    queues=pool_queues(host),
                    queued_jobs=[
                        dataclasses.replace(j, pools=(host,))
                        for j in away_jobs
                    ],
                    running=(
                        self.feed.running_of(host, txn)
                        if incremental
                        else host_running(host)
                    ),
                    collect_stats=False,
                    bid_price_of=(
                        _pool_pricer(host)
                        if self.bid_prices is not None
                        else None
                    ),
                    away_mode=True,
                    global_tokens=g_tokens,
                    queue_tokens=q_tokens,
                    banned_nodes=banned_nodes,
                    queue_penalty=penalty_by_pool.get(host),
                    device=self.device,
                )
                consume_round(outcome)
                self._apply_outcome(
                    txn, outcome, host, executor_of_node, now_ns, result, away=True
                )
                if incremental:
                    self.feed.overlay(txn._upserts)
                scheduled_ids = set(outcome.scheduled)
                if scheduled_ids:
                    queued_jobs = [
                        j for j in queued_jobs if j.id not in scheduled_ids
                    ]
                    away_jobs = [
                        j for j in away_jobs if j.id not in scheduled_ids
                    ]
                    for job, run in result.scheduled:
                        if job.id in scheduled_ids:
                            extra_running.setdefault(run.pool, []).append(
                                _running_of(job, run)
                            )

        # Optimiser pass (optimiser/node_scheduler.go via pqs.go:250-272):
        # jobs the rounds could not place get one targeted-preemption attempt.
        if self.optimiser is not None:
            self._optimise_stuck(
                txn,
                result,
                queued_jobs,
                nodes,
                running_by_pool,
                extra_running,
                executor_of_node,
                now_ns,
                banned_nodes,
            )

        # No device round ran (or the legacy path): the caller's thunks
        # still execute exactly once, just without a shadow to hide in.
        drain_shadow()
        return result

    def _market_observability(
        self,
        stats: PoolStats,
        pool: str,
        pool_nodes: list,
        queues: list,
        queued_jobs: list,
        running: list,
        outcome: RoundOutcome,
        bid_price_of,
    ) -> None:
        """Market-pool extras: indicative gang prices against the post-round
        state (pqs.go runPricer:596) and idealised per-queue values
        (scheduling_algo.go:595 CalculateIdealisedValue), the mega-node
        round on the algo's device."""
        if bid_price_of is None:
            return
        if self.gang_pricer is not None:
            preempted_now = set(outcome.preempted)
            by_id = {j.id: j for j in queued_jobs}
            running_now = [r for r in running if r.job.id not in preempted_now]
            for jid, nid in outcome.scheduled.items():
                job = by_id.get(jid)
                if job is not None:
                    running_now.append(RunningJob(job=job, node_id=nid))
            stats.indicative_prices = self.gang_pricer.price_pool_gangs(
                pool, pool_nodes, running_now, bid_price_of
            )
        from armada_tpu_torch.scheduler.idealised import (
            calculate_idealised_values,
            value_of_jobs,
        )

        stats.idealised_values = calculate_idealised_values(
            self.config,
            pool=pool,
            nodes=pool_nodes,
            queues=queues,
            queued_jobs=queued_jobs,
            running=running,
            bid_price_of=bid_price_of,
            device=self.device,
        )
        # Realised value: what this round's actual placements are worth --
        # newly scheduled jobs plus evicted-and-rescheduled ones
        # (scheduling_algo.go:670-676 valueFromSchedulingResult on the real
        # context), in the SAME valuation currency as idealised.
        spec_of = {j.id: j for j in queued_jobs}
        spec_of.update({r.job.id: r.job for r in running})
        placed = (
            spec_of[jid]
            for jid in list(outcome.scheduled) + list(outcome.rescheduled)
            if jid in spec_of
        )
        stats.realised_values = value_of_jobs(
            placed, bid_price_of, self.config.resource_list_factory()
        )

    def _market_observability_columnar(
        self,
        stats: PoolStats,
        pool: str,
        pool_nodes: list,
        txn: WriteTxn,
        builder,
        outcome: RoundOutcome,
        bid_price_of,
    ) -> None:
        """Incremental-mode market observability: the same three quantities
        as _market_observability, read off the builder columns instead of
        spec lists (the builder's runs table already reflects this pool's
        leases and preemptions -- feed.overlay() ran before stats).
        Realised values stay O(decisions) via txn lookups."""
        if bid_price_of is None:
            return
        from armada_tpu_torch.scheduler.idealised import value_of_jobs
        from armada_tpu_torch.scheduler.idealised_columnar import (
            _band_price_table,
            calculate_idealised_values_columnar,
        )

        price_table = _band_price_table(builder, bid_price_of)
        if self.gang_pricer is not None:
            stats.indicative_prices = self.gang_pricer.price_pool_gangs_columnar(
                pool, pool_nodes, builder, bid_price_of, price_table
            )
        # The mega round's candidate set is the PRE-round state
        # (idealised_value.go:68-76): jobs preempted this cycle already left
        # the builder tables (feed.overlay() ran), so they re-enter here
        # explicitly -- O(preempted) txn lookups.
        preempted_specs = []
        for jid in outcome.preempted:
            job = txn.get(jid)
            if job is not None:
                preempted_specs.append(
                    dataclasses.replace(
                        job.spec,
                        priority=job.priority,
                        pools=job.pools or job.spec.pools,
                    )
                )
        stats.idealised_values = calculate_idealised_values_columnar(
            self.config,
            pool=pool,
            builder=builder,
            bid_price_of=bid_price_of,
            extra_candidates=tuple(preempted_specs),
            price_table=price_table,
        )
        placed = []
        for jid in list(outcome.scheduled) + list(outcome.rescheduled):
            job = txn.get(jid)
            if job is not None:
                placed.append(job.spec)
        stats.realised_values = value_of_jobs(
            placed, bid_price_of, self.config.resource_list_factory()
        )

    def _optimise_stuck(
        self,
        txn: WriteTxn,
        result: SchedulerResult,
        queued_jobs: list,
        nodes: list,
        running_by_pool: dict,
        extra_running: dict,
        executor_of_node: dict,
        now_ns: int,
        banned_nodes: Optional[dict] = None,
    ) -> None:
        preempted_ids = {job.id for job, _ in result.preempted}
        still_queued = {j.id: j for j in queued_jobs}

        def resolve_queued(jid):
            spec = still_queued.get(jid)
            if spec is not None:
                return spec
            # Incremental mode keeps no spec list; the txn is the truth.
            job = txn.get(jid)
            if job is None or not job.queued or not job.validated:
                return None
            return dataclasses.replace(
                job.spec, priority=job.priority, pools=job.pools or job.spec.pools
            )

        # The optimiser places at most max_stuck_jobs_per_cycle; collecting a
        # generous multiple of that preserves its own candidate ordering
        # while keeping the scan O(candidates), not O(failed backlog) -- a
        # round can retire whole key classes (~the entire backlog in
        # outcome.failed, decoded lazily in chunks).
        candidate_cap = max(100, 10 * self.optimiser.opt.max_stuck_jobs_per_cycle)
        for stats in result.pools:
            pool = stats.pool
            stuck = []
            for jid in stats.outcome.failed:
                spec = resolve_queued(jid)
                if spec is not None:
                    stuck.append(spec)
                    if len(stuck) >= candidate_cap:
                        break
            if not stuck:
                continue
            pool_nodes = [n for n in nodes if n.pool == pool]
            if self.feed is not None:
                running_now = self.feed.running_of(pool, txn)
            else:
                running_now = [
                    r
                    for r in running_by_pool.get(pool, [])
                    if r.job.id not in preempted_ids
                ] + extra_running.get(pool, [])
            if self.feed is not None and banned_nodes is not None:
                # Incremental mode skipped the legacy scan that collects
                # retry anti-affinity: resolve bans for the stuck set so the
                # optimiser cannot re-place a job on the node it died on.
                for spec in stuck:
                    job = txn.get(spec.id)
                    bans = job.anti_affinity_nodes() if job is not None else ()
                    if bans:
                        banned_nodes[spec.id] = bans
            shares = stats.outcome.queue_stats
            decisions = self.optimiser.optimise(
                stuck,
                pool_nodes,
                running_now,
                actual_share={q: s["actual_share"] for q, s in shares.items()},
                fair_share={
                    q: s["adjusted_fair_share"] for q, s in shares.items()
                },
                banned_nodes=banned_nodes,
            )
            for d in decisions:
                # The rate limiters gate optimiser placements too.
                spec = resolve_queued(d.job_id)
                queue = spec.queue if spec is not None else ""
                g_tokens, q_tokens = self.rate_limiters.tokens([queue])
                if g_tokens is not None and g_tokens < 1:
                    break
                if q_tokens is not None and q_tokens.get(queue, 1) < 1:
                    continue
                synthetic = RoundOutcome(
                    scheduled={d.job_id: d.node_id},
                    preempted=list(d.preempted_job_ids),
                    failed=[],
                    num_iterations=0,
                    termination="optimiser",
                )
                self._apply_outcome(
                    txn, synthetic, pool, executor_of_node, now_ns, result
                )
                self.rate_limiters.consume({queue: 1})
                still_queued.pop(d.job_id, None)


    # --- applying a pool outcome to the txn ---------------------------------

    def _apply_outcome(
        self,
        txn: WriteTxn,
        outcome: RoundOutcome,
        pool: str,
        executor_of_node: dict,
        now_ns: int,
        result: SchedulerResult,
        away: bool = False,
    ) -> None:
        away_priority = self.config.priority_ladder()[0]
        for job_id, node_id in outcome.scheduled.items():
            job = txn.get(job_id)
            if job is None:
                continue
            pc = job.priority_class(self.config)
            run = JobRun(
                id=self._run_id(),
                job_id=job_id,
                created_ns=now_ns,
                executor=executor_of_node.get(node_id, ""),
                node_id=node_id,
                node_name=node_id,
                pool=pool,
                scheduled_at_priority=away_priority if away else pc.priority,
                pool_scheduled_away=away,
            )
            job = job.with_new_run(run)
            txn.upsert(job)
            result.scheduled.append((job, run))

        for job_id in outcome.preempted:
            job = txn.get(job_id)
            if job is None or job.in_terminal_state():
                continue
            run = job.latest_run
            if run is None or run.in_terminal_state():
                continue
            run = run.with_preempted()
            job = job.with_updated_run(run).with_failed()
            txn.upsert(job)
            result.preempted.append((job, run))

        result.failed.extend(outcome.failed)
