"""Feed JobDb deltas into cycle-persistent incremental problem builders.

The reference's scheduler keeps its jobDb between cycles and only applies
event deltas (internal/scheduler/scheduler.go:240-246); the tensor analog is
models/incremental.IncrementalBuilder, and THIS module is the glue: a JobDb
commit subscriber that translates job-state changes into builder deltas, so
FairSchedulingAlgo can assemble a 1M-job pool problem in O(delta) Python +
O(G) numpy instead of re-reading a million Job objects every second.

Mapping (idempotent -- the same delta may arrive twice: once from the open
txn's overlay at schedule time and again at commit):

  queued+validated  -> submit(spec @ current priority, retry bans) per pool
  running           -> remove from backlogs; lease(run) on the run's pool
  terminal/deleted  -> remove + unlease everywhere

Away-pass candidates (jobs restricted to specific pools) are tracked in a
side set so the away rounds never need a full backlog scan.

The port's copy of the JAX package's scheduler/incremental_algo.py.  The
feed takes the device its caches live on (the card unless the caller
passes device="cpu").  While the mesh serving plane is armed
(parallel/serving.py) every pool's cache is a node-axis-sharded
MeshDeviceDeltaCache.  The feed's reset hook (core/watchdog.py) replaces
every cache on every backend transition: each rung of the mesh ladder, a
fallback to the CPU rung and a promotion back to the card.  A batch's
pending deltas remember the job ids they hold (`_Pending`), so a job new
to the batch skips the per-job purge over every pool (the JAX package
purges every job); the deltas flushed are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.core.types import RunningJob
from armada_tpu_torch.jobdb.job import Job
from armada_tpu_torch.models.incremental import IncrementalBuilder
from armada_tpu_torch.models.slab import DeviceDeltaCache
from armada_tpu_torch.ops.trace import recorder as _trace


class _Pending(dict):
    """A batch's builder deltas: pool -> (submits, bans, leases, removals),
    and `ids`, every job id the submits, bans or leases may hold -- so a
    job seen for the first time in the batch (every job of a load) skips
    the purge's pass over the pools."""

    __slots__ = ("ids",)

    def __init__(self):
        super().__init__()
        self.ids: set = set()


class IncrementalProblemFeed:
    """Per-pool IncrementalBuilders + device caches, fed from JobDb commits.

    Market-driven pools ride the same tables, stored in (queue, band,
    submit, id) order; the per-cycle bid re-sort is a slice permutation
    inside the builder (models/incremental._market_perm).  The scheduling
    algo refreshes each market builder's `bid_price_of` before assembling
    (prices come from the provider, re-read every cycle).
    """

    def __init__(self, config: SchedulingConfig, device="cuda"):
        self.config = config
        self.device = device
        self.builders: dict[str, IncrementalBuilder] = {}
        self.devcaches: dict[str, DeviceDeltaCache] = {}
        # queued job ids with an explicit pools restriction: the away pass's
        # candidate set (scheduling_algo.go:216-283) without a backlog scan.
        self.pool_restricted: set[str] = set()
        # Pool-parallel certification sets (round 17): a queued job with NO
        # pools restriction sits in EVERY builder's backlog, and one listing
        # >= 2 pools sits in each of them -- either makes two pools' rounds
        # order-dependent (pool A scheduling it changes pool B's problem),
        # so the cycle must stay serial.  Both empty <=> every queued job
        # is restricted to exactly one pool <=> all backlogs are pairwise
        # disjoint <=> dispatching pool B before pool A's apply is
        # bit-neutral (pools_independent()).  Same lifecycle as
        # pool_restricted: queued adds, lease/terminal removes.
        self.unrestricted_queued: set[str] = set()
        self.multi_pool_queued: set[str] = set()
        # running gang membership: job id -> (pool, queue, gang id), so gang
        # domain pins can be forgotten when the run ends (else the
        # note_running_gang sets grow forever).
        self._gang_of: dict[str, tuple] = {}
        # Open-txn overlay registry: job id -> the exact (immutable) Job
        # instance already applied mid-txn via overlay(), plus overlaid
        # deletes.  The commit's subscriber re-fire passes the same
        # instances, so identity lets it skip the idempotent second apply --
        # which profiling showed was ~half the sidecar cycle's feed cost
        # (lease_many/remove_many/apply_job all ran twice per cycle, and the
        # per-pool overlay re-applied every earlier pool's upserts).  A job
        # re-upserted after its overlay is a NEW instance (jobdb Jobs are
        # immutable), so it misses the registry and re-applies correctly.
        self._overlaid: dict[str, Job] = {}
        self._overlaid_deletes: set[str] = set()
        self._jobdb = None
        # Builders must exist BEFORE the first delta arrives or it is lost --
        # the feed retains no job state of its own.  Configured pools are
        # eager; pools discovered later from node snapshots are backfilled
        # from the JobDb in builder_for.
        for p in config.pools:
            self.builders[p.name] = IncrementalBuilder(config, p.name)
            self.devcaches[p.name] = self.new_device_cache()
        # A backend transition (a fallback to the CPU rung, a promotion, a
        # mesh ladder rung) must drop every device-resident cache this feed
        # owns.  Held weakly: a closed
        # feed is garbage, not a leak in the hook registry.
        from armada_tpu_torch.core.watchdog import add_reset_hook

        add_reset_hook(self.reset_device_state)

    def new_device_cache(self) -> DeviceDeltaCache:
        """The feed's device-cache factory, on the feed's device: a
        node-axis-sharded mesh cache while the mesh serving plane is armed,
        else a DeviceDeltaCache.  Consulted at every cache (re)build -- feed
        init, resync, late pool discovery and the reset hook -- so a ladder
        step re-shards through cache replacement."""
        from armada_tpu_torch.parallel.serving import mesh_serving

        if mesh_serving().enabled():
            from armada_tpu_torch.parallel.mesh_slab import MeshDeviceDeltaCache

            return MeshDeviceDeltaCache(device=self.device)
        return DeviceDeltaCache(device=self.device)

    def reset_device_state(self) -> None:
        """Drop device-resident problem state after a backend transition:
        REPLACE each pool's cache and invalidate the builders' prefetch
        bookkeeping so rows already shipped re-enter the next bundle.
        Replacement, never mutation of the live object: the hook can fire
        from the re-probe thread (a promotion) while a round is mid-apply,
        or while an abandoned worker still holds the old cache; both keep a
        consistent object that becomes garbage, and every later cycle takes
        the fresh cache, whose first apply is a full upload to the device
        the supervisor targets then.  Host tables are untouched."""
        for pool in list(self.devcaches):
            self.devcaches[pool] = self.new_device_cache()
        for b in self.builders.values():
            b.invalidate_prefetch()

    def attach(self, jobdb) -> None:
        self._jobdb = jobdb
        jobdb.subscribe(self.on_delta)
        # schedule() overlays the OPEN txn's buffer onto the builders; if
        # that txn aborts (publish failure, leadership fencing), builder
        # state has run ahead of the JobDb with nothing to correct it --
        # breaking the invariant that state only advances with a committed txn.
        # Aborts are rare, so the remedy is a full resync.
        jobdb.subscribe_abort(self.resync)

    def resync(self) -> None:
        """Discard all builder state and rebuild from committed JobDb state."""
        self.builders = {}
        self.devcaches = {}
        self.pool_restricted = set()
        self.unrestricted_queued = set()
        self.multi_pool_queued = set()
        self._gang_of = {}
        self._overlaid = {}
        self._overlaid_deletes = set()
        for p in self.config.pools:
            self.builders[p.name] = IncrementalBuilder(self.config, p.name)
            self.devcaches[p.name] = self.new_device_cache()
        if self._jobdb is not None:
            pending = _Pending()
            for job in self._jobdb.read_txn().all_jobs():
                self.apply_job(job, pending)
            self._flush(pending)

    def builder_for(self, pool: str, txn=None) -> Optional[IncrementalBuilder]:
        b = self.builders.get(pool)
        if b is None:
            b = IncrementalBuilder(self.config, pool)
            self.builders[pool] = b
            self.devcaches[pool] = self.new_device_cache()
            if txn is not None:
                # Late pool discovery (a node snapshot introduced a pool not
                # in config): one-time backfill scan.
                pending = _Pending()
                for job in txn.all_jobs():
                    self.apply_job(job, pending)
                self._flush(pending)
        return b

    def devcache_for(self, pool: str) -> DeviceDeltaCache:
        return self.devcaches[pool]

    def prefetch_content(self, skip_pool: str = None) -> int:
        """Shadow-pipeline stage (b): ship every builder's decision-
        independent dirty rows to its device cache now (see
        IncrementalBuilder.prefetch_content for the soundness boundary and
        skip conditions).  Called from a kernel shadow (the running pool is
        skipped -- its bundle already applied) or right after a commit so
        the upload overlaps the caller's inter-cycle work."""
        shipped = 0
        for pool, b in self.builders.items():
            if pool == skip_pool:
                continue
            cache = self.devcaches.get(pool)
            if cache is not None:
                shipped += b.prefetch_content(cache)
        return shipped

    # ------------------------------------------------------------ deltas ----

    def on_delta(self, upserts: dict, deletes: set) -> None:
        # The commit subscriber: skip anything overlay() already applied
        # within the committing txn, then drop the registry (it is only
        # meaningful inside that txn).
        self._apply_delta(upserts, deletes, record=False)
        self._overlaid.clear()
        self._overlaid_deletes.clear()

    def overlay(self, upserts: dict, deletes: set = frozenset()) -> None:
        """Mid-txn application (the schedule-time overlay of the OPEN txn's
        buffer): applies like on_delta but records each applied instance so
        neither a later per-pool overlay nor the commit re-fire pays for it
        again."""
        self._apply_delta(upserts, deletes, record=True)

    def _apply_delta(self, upserts: dict, deletes, record: bool) -> None:
        # Per-job submit()/lease() is one np.insert PER COLUMN PER JOB --
        # O(table) each, so a K-job commit against a 1M-row table would cost
        # O(K x table x pools).  Accumulate the batch and flush once per
        # builder (one np.insert per column total), the same shape bench.py's
        # backlog load uses.
        with _trace().span("feed_apply", upserts=len(upserts), deletes=len(deletes),
                           overlay=record):
            self._apply_delta_traced(upserts, deletes, record)

    def _apply_delta_traced(self, upserts: dict, deletes, record: bool) -> None:
        for job_id in deletes:
            if job_id in self._overlaid_deletes:
                continue
            if record:
                self._overlaid_deletes.add(job_id)
            self._remove_everywhere(job_id)
        pending = _Pending()
        overlaid = self._overlaid
        for job in upserts.values():
            if overlaid.get(job.id) is job:
                continue
            if record:
                overlaid[job.id] = job
            self.apply_job(job, pending)
        self._flush(pending)

    def _pending_for(
        self, pending: _Pending, pool: str
    ) -> tuple[dict, dict, dict, dict]:
        entry = pending.get(pool)
        if entry is None:
            # submits/bans/leases/removals all keyed by job id: a re-applied
            # job within one batch must not become two live rows
            # (submit_many/lease_many only de-dupe against the TABLE, not
            # within their own batch).
            entry = pending[pool] = ({}, {}, {}, {})
        return entry

    @staticmethod
    def _purge_pending(pending: _Pending, job_id: str, leases_too: bool) -> None:
        if job_id not in pending.ids:
            return
        for submits, ban_map, leases, _removals in pending.values():
            submits.pop(job_id, None)
            ban_map.pop(job_id, None)
            if leases_too:
                leases.pop(job_id, None)

    def _flush(self, pending: _Pending) -> None:
        for pool, (submits, bans, leases, removals) in pending.items():
            b = self.builders.get(pool)
            if b is None:
                continue
            if removals:
                # Batched: a cycle's ~1k scheduled jobs leave the backlog
                # with one table pass + one demand update (remove_many),
                # not 1k binary searches through numpy dispatch wrappers.
                b.remove_many(list(removals))
            if submits:
                b.submit_many(list(submits.values()), bans or None)
            if leases:
                b.lease_many(list(leases.values()))

    def _remove_everywhere(self, job_id: str) -> None:
        self.pool_restricted.discard(job_id)
        self.unrestricted_queued.discard(job_id)
        self.multi_pool_queued.discard(job_id)
        for b in self.builders.values():
            b.remove(job_id)
            b.unlease(job_id)
        self._forget_gang(job_id)

    def _forget_gang(self, job_id: str) -> None:
        entry = self._gang_of.pop(job_id, None)
        if entry is not None:
            pool, queue, gang_id = entry
            b = self.builders.get(pool)
            if b is not None:
                b.forget_running_gang(queue, gang_id, job_id)

    def apply_job(self, job: Job, pending: Optional[_Pending] = None) -> None:
        """Translate one job's state into builder deltas.  Removes/unleases
        apply immediately (tombstones, cheap); submits/leases go into
        `pending` (flushed by the caller as one batch per builder) or flush
        inline when called one-shot."""
        flush_here = pending is None
        if pending is None:
            pending = _Pending()
        if job.in_terminal_state():
            self._remove_everywhere(job.id)
            self._purge_pending(pending, job.id, leases_too=True)
            return
        if job.queued:
            if not job.validated:
                return
            pools = job.pools or job.spec.pools
            if job.priority == job.spec.priority and pools == job.spec.pools:
                spec = job.spec
            else:
                spec = dataclasses.replace(
                    job.spec, priority=job.priority, pools=pools
                )
            bans = job.anti_affinity_nodes()
            if spec.pools:
                self.pool_restricted.add(job.id)
                self.unrestricted_queued.discard(job.id)
                if len(spec.pools) >= 2:
                    self.multi_pool_queued.add(job.id)
                else:
                    self.multi_pool_queued.discard(job.id)
            else:
                self.pool_restricted.discard(job.id)
                self.multi_pool_queued.discard(job.id)
                self.unrestricted_queued.add(job.id)
            jid = job.id
            self._purge_pending(pending, jid, leases_too=True)
            pending.ids.add(jid)
            jid_b = jid.encode()
            ban = tuple(bans) if bans else None
            for name, b in self.builders.items():
                # Guarded: a fresh submit was never leased anywhere, so the
                # per-builder probe degrades to O(1) dict checks (the feed
                # hot loop -- ~100ms/cycle of the round-6 profile).
                b.unlease_if_present(jid, jid_b)
                entry = pending.get(name)
                if entry is None:
                    entry = self._pending_for(pending, name)
                entry[0][spec.id] = spec
                if ban is not None:
                    entry[1][spec.id] = ban
            if flush_here:
                self._flush(pending)
            return
        # leased / running
        self.pool_restricted.discard(job.id)
        self.unrestricted_queued.discard(job.id)
        self.multi_pool_queued.discard(job.id)
        run = job.latest_run
        for name in self.builders:
            self._pending_for(pending, name)[3][job.id] = True
        self._purge_pending(pending, job.id, leases_too=True)
        jid_b = job.id.encode()
        if run is None or run.in_terminal_state():
            for b in self.builders.values():
                b.unlease_if_present(job.id, jid_b)
            self._forget_gang(job.id)
            return
        pool = run.pool or "default"
        for name, b in self.builders.items():
            if name != pool:
                b.unlease_if_present(job.id, jid_b)
        # Existing builders only: creating one here would skip builder_for's
        # one-time JobDb backfill and permanently hide the queued backlog
        # from a late-discovered pool (the algo creates builders WITH a txn).
        b = self.builders.get(pool)
        if b is None:
            return
        r = RunningJob(
            job=(
                job.spec
                if job.priority == job.spec.priority
                else dataclasses.replace(job.spec, priority=job.priority)
            ),
            node_id=run.node_id,
            priority=run.scheduled_at_priority or 0,
            away=run.pool_scheduled_away,
        )
        self._pending_for(pending, pool)[2][job.id] = r
        pending.ids.add(job.id)
        if job.spec.gang_id:
            b.note_running_gang(job.queue, job.spec.gang_id, job.id)
            self._gang_of[job.id] = (pool, job.queue, job.spec.gang_id)
        if flush_here:
            self._flush(pending)

    # ------------------------------------------------------------ queries ---

    def pools_independent(self) -> bool:
        """Every queued job restricted to exactly ONE pool -- all builders'
        backlogs pairwise disjoint, so the pools' rounds commute: pool A's
        apply only removes ids pool B never held (its overlay is a no-op on
        B's tables) and preemptions only touch A's own run table.  The
        pool-parallel cycle (scheduler/algo.py) requires this to dispatch
        pool B before pool A's decisions land; two O(1) set checks per
        cycle."""
        return not self.unrestricted_queued and not self.multi_pool_queued

    def running_of(self, pool: str, txn) -> list[RunningJob]:
        """RunningJob views of the pool's leased set, reconstructed from the
        builder's run table + txn specs -- for the away rounds, which go
        through the per-cycle builder and need host objects.  O(runs in
        pool), not O(all jobs)."""
        b = self.builders.get(pool)
        if b is None:
            return []
        out = []
        for row in b.runs.live_rows():
            jid = b.runs.ids[row].tobytes().rstrip(b"\0").decode()
            job = txn.get(jid)
            if job is None:
                continue
            run = job.latest_run
            if run is None or run.in_terminal_state():
                continue
            out.append(
                RunningJob(
                    job=dataclasses.replace(job.spec, priority=job.priority),
                    node_id=run.node_id,
                    priority=run.scheduled_at_priority or 0,
                    away=run.pool_scheduled_away,
                )
            )
        return out

    def away_candidates(self, txn) -> list:
        """Still-queued specs with an explicit pools restriction."""
        out = []
        for jid in sorted(self.pool_restricted):
            job = txn.get(jid)
            if job is None or not job.queued or not job.validated:
                continue
            out.append(
                dataclasses.replace(
                    job.spec,
                    priority=job.priority,
                    pools=job.pools or job.spec.pools,
                )
            )
        return out
