"""The port's IncrementalBuilder against the JAX package's.

The same mutation feed (submits with gangs, bans and selectors, leases,
unleases, cancels, reprioritisations) drives a JAX builder and a port
builder, five cycles each, in a plain, a lookback-truncated and a market
pool whose prices move every cycle.  Every cycle:

- `assemble()`: every problem array equal (dtype and values) and every
  HostContext field equal;
- `assemble_delta()`: the bundle's sig, seq, dirty indices, every row
  column, every whole field, the gq splice and `materialize()` equal, and
  the context equal;
- the port's cycle (DeviceDeltaCache on the CPU + run_round_on_device)
  decides exactly what the JAX cycle decides.
"""

import dataclasses
import random

import numpy as np
import pytest

from armada_tpu.models import run_round_on_device as jax_run_round
from armada_tpu.models.incremental import IncrementalBuilder as JaxBuilder
from armada_tpu.models.slab import DeviceDeltaCache as JaxCache
from armada_tpu.core.types import RunningJob
from armada_tpu_torch.models import run_round_on_device
from armada_tpu_torch.models.incremental import IncrementalBuilder
from armada_tpu_torch.models.slab import DeviceDeltaCache
from test_incremental import CFG, MCFG, _BANDS, _job, _market_world, _pricer, _random_world


def _same(a, b, what):
    if callable(a) and not isinstance(a, type):
        a, b = a(), b()
    if hasattr(a, "_d"):  # the slab context's sparse group-tag view
        a, b = a._d, b._d
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def _problems_equal(a, b, what):
    for name in a._fields:
        _same(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), f"{what}.{name}")


def _ctx_equal(a, b, what):
    for f in dataclasses.fields(a):
        if f.name in ("config", "last_compact_np"):
            continue
        _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")


def _bundles_equal(a, b, what):
    assert a.sig == b.sig and a.seq == b.seq and a.ev_base == b.ev_base, what
    for name in ("sg_idx", "rr_idx"):
        _same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    for name in ("sg_cols", "rr_cols", "ev_cols", "fulls"):
        _same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    assert (a.gq_splice is None) == (b.gq_splice is None), f"{what}.gq_splice"
    if a.gq_splice is not None:
        for x, y in zip(a.gq_splice, b.gq_splice):
            _same(x, y, f"{what}.gq_splice")
    _problems_equal(a.materialize(), b.materialize(), f"{what}.materialize()")


class Twins:
    """A JAX and a port builder fed the same mutations."""

    def __init__(self, cfg, queues, nodes, price_of=None):
        self.pair = [cls(cfg, "default", queues, bid_price_of=price_of)
                     for cls in (JaxBuilder, IncrementalBuilder)]
        for b in self.pair:
            b.set_nodes(nodes)

    def __getattr__(self, name):
        def call(*a, **kw):
            out = [getattr(b, name)(*a, **kw) for b in self.pair]
            return out

        return call


def _load(t, jobs, running, banned=None):
    t.submit_many(jobs, banned)
    for r in running:
        t.lease(r)
        if r.job.gang_id:
            t.note_running_gang(r.job.queue, r.job.gang_id, r.job.id)


def _scenario(kind):
    if kind == "market":
        nodes, queues, jobs, running, prices = _market_world(5, num_jobs=90, gangs=2)
        return MCFG, nodes, queues, jobs, running, dict(prices)
    nodes, queues, jobs, running = _random_world(7, num_jobs=80)
    cfg = CFG if kind == "plain" else dataclasses.replace(CFG, max_queue_lookback=10)
    return cfg, nodes, queues, jobs, running, None


@pytest.mark.parametrize("kind", ["plain", "lookback", "market"])
def test_builders_equal_over_cycles(kind):
    cfg, nodes, queues, jobs, running, prices = _scenario(kind)
    price_of = _pricer(prices) if prices is not None else None  # reads `prices` live
    rng = random.Random(42)
    banned = {jobs[0].id: (nodes[0].id, nodes[1].id), jobs[5].id: (nodes[2].id,)}
    dense = Twins(cfg, queues, nodes, price_of)
    delta = Twins(cfg, queues, nodes, price_of)
    for t in (dense, delta):
        _load(t, jobs, running, banned)
    jobs_by_id = {j.id: j for j in jobs}
    running = list(running)
    jcache, tcache = JaxCache(), DeviceDeltaCache(device="cpu")
    next_id = [0]
    splices = 0
    for cycle in range(5):
        (jp, jctx), (tp, tctx) = dense.assemble()
        _problems_equal(tp, jp, f"cycle {cycle} assemble()")
        _ctx_equal(tctx, jctx, f"cycle {cycle} assemble() ctx")

        (jb, jbctx), (tb, tbctx) = delta.assemble_delta()
        _bundles_equal(tb, jb, f"cycle {cycle} bundle")
        _ctx_equal(tbctx, jbctx, f"cycle {cycle} bundle ctx")
        splices += tb.gq_splice is not None

        _, jout = jax_run_round(jb.stats_view(), jbctx, cfg,
                                device_problem=jcache.apply(jb))
        _, tout = run_round_on_device(tb.stats_view(), tbctx, cfg, device="cpu",
                                      device_problem=tcache.apply(tb))
        assert tout.scheduled == jout.scheduled
        assert sorted(tout.preempted) == sorted(jout.preempted)
        assert sorted(tout.rescheduled) == sorted(jout.rescheduled)
        assert list(tout.failed) == list(jout.failed)
        assert tout.termination == jout.termination
        assert tout.spot_price == jout.spot_price

        for t in (dense, delta):
            t.remove_many(list(jout.scheduled))
        leases = []
        for jid, nid in jout.scheduled.items():
            spec = jobs_by_id.pop(jid, None)
            if spec is not None:
                leases.append(RunningJob(job=spec, node_id=nid))
        running.extend(leases)
        for t in (dense, delta):
            t.lease_many(leases)
            for r in leases:
                if r.job.gang_id:
                    t.note_running_gang(r.job.queue, r.job.gang_id, r.job.id)
        for jid in jout.preempted:
            running = [r for r in running if r.job.id != jid]
            for t in (dense, delta):
                t.unlease(jid)
        if running:
            r = running.pop(rng.randrange(len(running)))
            for t in (dense, delta):
                t.unlease(r.job.id)
        for _ in range(2):
            if jobs_by_id:
                jid = rng.choice(sorted(jobs_by_id))
                jobs_by_id.pop(jid)
                for t in (dense, delta):
                    t.remove(jid)
        fresh = []
        for _ in range(10):
            i = next_id[0]
            next_id[0] += 1
            spec = _job(f"new{i:04d}", rng.choice(["qa", "qb", "qc"]), rng.choice([1, 2, 4]),
                        pc=rng.choice(["low", "high"]), prio=rng.randrange(3),
                        sub=10.0 + cycle + rng.random(),
                        node_selector={"rack": rng.choice("ab")} if rng.random() < 0.3 else {},
                        price_band=rng.choice(_BANDS) if prices is not None else "")
            jobs_by_id[spec.id] = spec
            fresh.append(spec)
        for t in (dense, delta):
            t.submit_many(fresh)
        if jobs_by_id:
            jid = rng.choice(sorted(jobs_by_id))
            spec = dataclasses.replace(jobs_by_id[jid], priority=rng.randrange(5))
            jobs_by_id[jid] = spec
            for t in (dense, delta):
                t.reprioritise(spec)
        if prices is not None:
            for key in prices:
                prices[key] = float(rng.randrange(1, 8))
    if kind != "market":  # a price move re-uploads whole every cycle
        assert splices > 0, "the gq splice never engaged"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_shot_outcomes_equal(seed):
    nodes, queues, jobs, running = _random_world(seed)
    t = Twins(CFG, queues, nodes)
    _load(t, jobs, running)
    (jp, jctx), (tp, tctx) = t.assemble()
    _problems_equal(tp, jp, "assemble()")
    _, jout = jax_run_round(jp, jctx, CFG)
    _, tout = run_round_on_device(tp, tctx, CFG, device="cpu")
    assert tout.scheduled == jout.scheduled
    assert sorted(tout.preempted) == sorted(jout.preempted)
    assert list(tout.failed) == list(jout.failed)
