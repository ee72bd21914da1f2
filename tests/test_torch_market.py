"""The port's market-driven serving cycle against the JAX package's.

The same seeded inputs go through the JAX package and its port with
device="cpu", and every result must be equal with no tolerance:

- the providers (the bid fallback chain, the static bid and override
  tables, the no-op pair);
- the indicative gang pricer: `price_gang`, `price_pool_gangs` and
  `price_pool_gangs_columnar`, with every unschedulable reason (an
  oversized gang, cardinality zero, a label not indexed, a label no node
  carries, no fit) and node-uniformity groups;
- the idealised values: `calculate_idealised_values` (the mega-node round)
  and `calculate_idealised_values_columnar` (the sweep) on plain,
  tight-capacity and lookback-truncated worlds -- each against its JAX
  twin, and the two routes against each other (these worlds stay below
  2^24 resolution units, where the routes agree);
- the optimiser's unit cases (the seven of tests/test_optimiser.py);
- `FairSchedulingAlgo` over a market JobDb for three cycles in both
  assembly modes, fresh and with a preempting price move: decisions, spot
  price, indicative prices, idealised and realised values;
- priority overrides on two pools; the optimiser unsticking a job through
  the algo; a market pool kept out of the pool-parallel window; the
  ValueError for a market pool without a provider.
"""

from __future__ import annotations

import dataclasses
import itertools
import random

import numpy as np
import pytest

from armada_tpu.core import config as jax_config
from armada_tpu.core import types as jax_types
from armada_tpu.jobdb import job as jax_job
from armada_tpu.jobdb import jobdb as jax_jobdb
from armada_tpu.models import incremental as jax_incremental
from armada_tpu.models import verify as jax_verify
from armada_tpu.scheduler import algo as jax_algo
from armada_tpu.scheduler import executors as jax_executors
from armada_tpu.scheduler import idealised as jax_idealised
from armada_tpu.scheduler import idealised_columnar as jax_columnar
from armada_tpu.scheduler import incremental_algo as jax_incremental_algo
from armada_tpu.scheduler import optimiser as jax_optimiser
from armada_tpu.scheduler import pool_serving as jax_pool_serving
from armada_tpu.scheduler import pricer as jax_pricer
from armada_tpu.scheduler import providers as jax_providers

import armada_tpu_torch.models as tm
from armada_tpu_torch.core import config as t_config
from armada_tpu_torch.core import types as t_types
from armada_tpu_torch.jobdb import job as t_job
from armada_tpu_torch.jobdb import jobdb as t_jobdb
from armada_tpu_torch.models import explain as t_explain
from armada_tpu_torch.models import incremental as t_incremental
from armada_tpu_torch.models import verify as t_verify
from armada_tpu_torch.scheduler import algo as t_algo
from armada_tpu_torch.scheduler import executors as t_executors
from armada_tpu_torch.scheduler import idealised as t_idealised
from armada_tpu_torch.scheduler import idealised_columnar as t_columnar
from armada_tpu_torch.scheduler import incremental_algo as t_incremental_algo
from armada_tpu_torch.scheduler import optimiser as t_optimiser
from armada_tpu_torch.scheduler import pool_serving as t_pool_serving
from armada_tpu_torch.scheduler import pricer as t_pricer
from armada_tpu_torch.scheduler import providers as t_providers

NOW_NS = 10**15
PCS = ("armada-preemptible", "armada-default")
BANDS = ("", "low", "mid", "high")


class _Ns:
    """One side's classes and modules, by the names the worlds below use."""

    def __init__(self, config, types, job, jobdb, incremental, executors, feed, algo,
                 providers, pricer, idealised, columnar, optimiser, device_kw):
        self.SchedulingConfig = config.SchedulingConfig
        self.PoolConfig = config.PoolConfig
        self.PriorityClass = config.PriorityClass
        self.GangDefinition = config.GangDefinition
        self.Queue = types.Queue
        self.NodeSpec = types.NodeSpec
        self.JobSpec = types.JobSpec
        self.RunningJob = types.RunningJob
        self.Job = job.Job
        self.JobRun = job.JobRun
        self.JobDb = jobdb.JobDb
        self.IncrementalBuilder = incremental.IncrementalBuilder
        self.ExecutorSnapshot = executors.ExecutorSnapshot
        self.Feed = feed.IncrementalProblemFeed
        self.Algo = algo.FairSchedulingAlgo
        self.providers = providers
        self.pricer = pricer
        self.idealised = idealised
        self.columnar = columnar
        self.optimiser = optimiser
        self.device_kw = device_kw


JAX = _Ns(jax_config, jax_types, jax_job, jax_jobdb, jax_incremental, jax_executors,
          jax_incremental_algo, jax_algo, jax_providers, jax_pricer, jax_idealised,
          jax_columnar, jax_optimiser, {})
PORT = _Ns(t_config, t_types, t_job, t_jobdb, t_incremental, t_executors,
           t_incremental_algo, t_algo, t_providers, t_pricer, t_idealised, t_columnar,
           t_optimiser, {"device": "cpu"})


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for name in ("ARMADA_POOL_PARALLEL", "ARMADA_FAULT", "ARMADA_VERIFY",
                 "ARMADA_EXPLAIN_INTERVAL", "ARMADA_COMMIT_K", "ARMADA_CACHE_SLOTS",
                 "ARMADA_BATCH_K"):
        monkeypatch.delenv(name, raising=False)

    def reset():
        jax_verify.reset_verify_state()
        jax_pool_serving.reset_pool_serving_stats()
        t_verify.reset_verify_state()
        t_pool_serving.reset_pool_serving_stats()
        tm.reset_stack_cache()
        t_explain.reset_cadence()

    reset()
    yield
    reset()


def _price_view(r):
    return (r.evaluated, r.schedulable, r.price, r.unschedulable_reason)


def _prices_equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for name in a:
        assert _price_view(a[name]) == _price_view(b[name]), (what, name, a[name], b[name])


def _values_equal(a: dict, b: dict, what: str):
    """Per-queue values, equal in keys and as f64 bit patterns."""
    assert sorted(a) == sorted(b), (what, a, b)
    for q in a:
        assert np.float64(a[q]).tobytes() == np.float64(b[q]).tobytes(), (what, q, a, b)


# --- 1. the providers -------------------------------------------------------------


def test_providers_equal_jax():
    rng = random.Random(3)
    queues, bands, pools = ("qa", "qb", "qc"), ("", "low", "high"), ("", "p0", "p1")
    table = {}
    for q, b, p in itertools.product(queues, bands, pools):
        if rng.random() < 0.5:
            table[(q, b, p)] = float(rng.choice([0.5, 1.0, 2.5, 7.0]))
    static = {(q, b): float(rng.choice([1.0, 3.0])) for q, b in itertools.product(queues, bands)
              if rng.random() < 0.6}
    overrides = {(p, q): float(rng.choice([0.25, 4.0])) for p, q in itertools.product(pools, queues)
                 if rng.random() < 0.5}
    sides = []
    for ns in (JAX, PORT):
        P = ns.providers
        bid = P.StaticBidPriceProvider(static, default=0.75)
        ov = P.StaticPriorityOverrideProvider(overrides)
        noop = P.NoOpProviders()
        got = []
        for q, b, p in itertools.product(queues + ("qz",), bands + ("mid",), pools):
            got.append((P.most_specific_bid(table, q, b, p), bid.price(q, b),
                        ov.override(p, q), noop.price(q, b), noop.override(p, q)))
        sides.append(got)
    assert sides[0] == sides[1]
    assert any(v[2] is not None for v in sides[1]) and any(v[2] is None for v in sides[1])


# --- 2. the seeded market world ---------------------------------------------------------


def _config(ns, gangs_to_price=(), lookback=100_000, indexed=("zone", "rack")):
    return ns.SchedulingConfig(
        shape_bucket=32,
        max_queue_lookback=lookback,
        indexed_node_labels=tuple(indexed),
        pools=(ns.PoolConfig("default", market_driven=True, spot_price_cutoff=0.5,
                             gangs_to_price=tuple(gangs_to_price)),),
    )


def _shapes(ns):
    """One shape for every branch of the pricer: plain fits, a wide gang, a
    uniformity group over indexed labels, a label no node carries, a label
    not indexed, a gang larger than the pool, cardinality zero, and a
    selector no node matches."""
    G = ns.GangDefinition
    res = lambda cpu, mem: {"cpu": cpu, "memory": mem}  # noqa: E731
    return (
        ("small", G(size=1, priority_class=PCS[0], resources=res(2, 1))),
        ("wide", G(size=3, priority_class=PCS[0], resources=res(4, 2))),
        ("zoned", G(size=2, priority_class=PCS[0], resources=res(2, 1), node_uniformity="zone")),
        ("racked", G(size=2, priority_class=PCS[0], resources=res(1, 1), node_uniformity="rack")),
        ("unindexed", G(size=2, priority_class=PCS[0], resources=res(1, 1),
                        node_uniformity="pod")),
        ("huge", G(size=64, priority_class=PCS[0], resources=res(16, 8))),
        ("empty", G(size=0, priority_class=PCS[0], resources=res(1, 1))),
        ("selected", G(size=1, priority_class=PCS[0], resources=res(1, 1),
                       node_selector={"zone": "nowhere"})),
    )


def _market_world(ns, seed, *, gangs=True, lookback=100_000, shapes=False):
    """test_market_columnar.random_world, built from `ns`'s classes: the
    same seed gives the same world on both sides.  Nodes carry a zone
    label; prices are f32-exact, per (queue, band)."""
    rng = random.Random(seed)
    nq = rng.randint(1, 3)
    queues = [ns.Queue(f"q{i}", weight=rng.choice([0.5, 1.0, 2.0])) for i in range(nq)]
    config = _config(ns, _shapes(ns) if shapes else (), lookback=lookback)
    F = config.resource_list_factory()
    nodes = [
        ns.NodeSpec(
            id=f"n{i}", pool="default",
            labels={"zone": rng.choice(["a", "b"])},
            total_resources=F.from_mapping({"cpu": rng.choice([4, 8, 16]), "memory": 32}),
            unschedulable=(rng.random() < 0.1),
        )
        for i in range(rng.randint(2, 5))
    ]
    table = {(q.name, b): float(np.float32(rng.choice([1.0, 2.0, 3.5, 5.0, 8.0])))
             for q in queues for b in BANDS}

    def price_of(job):
        return table[(job.queue, job.price_band)]

    queued, running = [], []
    jid = itertools.count(1)

    def spec(queue, cpu, pc, band, gang_id="", card=0, label=""):
        return ns.JobSpec(
            id=f"j{next(jid):04d}", queue=queue, priority_class=pc, price_band=band,
            submit_time=float(rng.randint(0, 5)),
            resources=(None if cpu is None
                       else F.from_mapping({"cpu": cpu, "memory": rng.choice([1, 2])})),
            gang_id=gang_id, gang_cardinality=card, gang_node_uniformity_label=label,
        )

    for _ in range(rng.randint(10, 40)):
        queued.append(spec(rng.choice(queues).name,
                           rng.choice([1, 2, 4, None if rng.random() < 0.05 else 8]),
                           rng.choice(PCS), rng.choice(BANDS)))
    if gangs:
        for g in range(rng.randint(0, 3)):
            q = rng.choice(queues).name
            card = rng.randint(1, 4)
            label = "zone" if rng.random() < 0.3 else ""
            hetero = rng.random() < 0.4
            members = [
                spec(q, rng.choice([1, 2]) if (hetero and m % 2) else 2,
                     PCS[m % 2] if hetero else PCS[0], rng.choice(BANDS),
                     gang_id=f"g{g}", card=card, label=label)
                for m in range(card)
            ]
            split = rng.randint(0, card)
            running.extend(ns.RunningJob(job=m, node_id=rng.choice(nodes).id)
                           for m in members[:split])
            queued.extend(members[split:])
    for _ in range(rng.randint(0, 12)):
        s = spec(rng.choice(queues).name, rng.choice([1, 2, 4]), rng.choice(PCS),
                 rng.choice(BANDS))
        running.append(ns.RunningJob(job=s, node_id=rng.choice(nodes).id))

    builder = ns.IncrementalBuilder(config, "default", queues, bid_price_of=price_of)
    builder.set_nodes(nodes)
    builder.submit_many(queued)
    builder.lease_many(running)
    return config, queues, nodes, queued, running, builder, price_of


# --- 3. the indicative gang pricer ---------------------------------------------------


def _pricer_results(ns, seed):
    config, queues, nodes, queued, running, builder, price_of = _market_world(
        ns, 3000 + seed, shapes=True)
    pricer = ns.pricer.IndicativeGangPricer(config)
    legacy = pricer.price_pool_gangs("default", nodes, running, price_of)
    columnar = pricer.price_pool_gangs_columnar("default", nodes, builder, price_of)
    one = {name: pricer.price_gang(d, "default", nodes, running, price_of)
           for name, d in config.pools[0].gangs_to_price}
    return legacy, columnar, one


@pytest.mark.parametrize("seed", range(6))
def test_pricer_equals_jax(seed):
    want = _pricer_results(JAX, seed)
    got = _pricer_results(PORT, seed)
    for w, g, what in zip(want, got, ("price_pool_gangs", "columnar", "price_gang")):
        _prices_equal(w, g, f"seed {seed} {what}")
    legacy, columnar, one = got
    _prices_equal(legacy, columnar, f"seed {seed}: legacy vs columnar")
    _prices_equal(legacy, one, f"seed {seed}: price_pool_gangs vs price_gang")
    reasons = {name: r.unschedulable_reason for name, r in legacy.items()}
    P = t_pricer
    assert reasons["huge"] == P.GANG_EXCEEDS_ALLOCATABLE
    assert reasons["empty"] == P.GANG_CARDINALITY_ZERO
    if reasons["small"] != P.GANG_EXCEEDS_ALLOCATABLE:  # some node is schedulable
        assert reasons["unindexed"] == P.UNIFORMITY_NOT_INDEXED
        assert reasons["racked"] == P.NO_NODES_WITH_UNIFORMITY
        assert reasons["selected"] == P.DOES_NOT_FIT
        assert legacy["small"].schedulable


def test_pricer_ties_break_by_job_id():
    """Residents of equal bid are evicted in job-id order (the stable sort of
    (bid, id)): a node of four equal-bid residents prices a gang that needs
    two of them at that bid, on both sides, legacy and columnar."""
    out = []
    for ns in (JAX, PORT):
        config = _config(ns, (("pair", ns.GangDefinition(size=1, priority_class=PCS[0],
                                                         resources={"cpu": 4, "memory": 1})),))
        F = config.resource_list_factory()
        nodes = [ns.NodeSpec(id="n0", pool="default",
                             total_resources=F.from_mapping({"cpu": 8, "memory": 32}))]
        queues = [ns.Queue("qa"), ns.Queue("qb")]
        running = [
            ns.RunningJob(job=ns.JobSpec(id=jid, queue=q, priority_class=PCS[0], price_band="low",
                                         resources=F.from_mapping({"cpu": 2, "memory": 1})),
                          node_id="n0")
            for jid, q in (("j3", "qa"), ("j1", "qb"), ("j4", "qb"), ("j2", "qa"))
        ]
        price_of = lambda job: 2.0 if job.queue == "qa" else 2.0  # noqa: E731
        b = ns.IncrementalBuilder(config, "default", queues, bid_price_of=price_of)
        b.set_nodes(nodes)
        b.lease_many(running)
        pricer = ns.pricer.IndicativeGangPricer(config)
        out.append((pricer.price_pool_gangs("default", nodes, running, price_of),
                    pricer.price_pool_gangs_columnar("default", nodes, b, price_of)))
    for (w, g) in zip(out[0], out[1]):
        _prices_equal(w, g, "ties")
    assert out[1][0]["pair"].price == 2.0 and out[1][0]["pair"].schedulable


# --- 4. the idealised values ------------------------------------------------------------


def _idealised(ns, kind, seed):
    if kind == "lookback":
        world = _market_world(ns, 2000 + seed, lookback=7)
    else:
        world = _market_world(ns, (1000 if kind == "tight" else 0) + seed)
    config, queues, nodes, queued, running, builder, price_of = world
    if kind == "tight":
        # one small node: most candidates fail mid-stream
        nodes = [ns.NodeSpec(id=nodes[0].id, pool="default",
                             total_resources=config.resource_list_factory().from_mapping(
                                 {"cpu": 5, "memory": 8}))]
        builder.set_nodes(nodes)
    legacy = ns.idealised.calculate_idealised_values(
        config, pool="default", nodes=nodes, queues=queues, queued_jobs=queued,
        running=running, bid_price_of=price_of, **ns.device_kw)
    columnar = ns.columnar.calculate_idealised_values_columnar(
        config, pool="default", builder=builder, bid_price_of=price_of)
    return legacy, columnar


@pytest.mark.parametrize("kind,seed", [("plain", 0), ("tight", 0), ("lookback", 0)])
def test_idealised_values_equal_jax(kind, seed):
    """The mega-node round (port with device="cpu") and the sweep each equal
    their JAX twin exactly; below 2^24 units the two routes agree too."""
    want_legacy, want_columnar = _idealised(JAX, kind, seed)
    legacy, columnar = _idealised(PORT, kind, seed)
    _values_equal(want_legacy, legacy, f"{kind} {seed}: calculate_idealised_values")
    _values_equal(want_columnar, columnar, f"{kind} {seed}: columnar")
    assert sorted(legacy) == sorted(columnar)
    for q in legacy:
        assert np.isclose(legacy[q], columnar[q]), (kind, seed, legacy, columnar)


@pytest.mark.parametrize("kind,seed", [
    (kind, seed) for kind in ("plain", "tight", "lookback") for seed in range(1, 9)
])
def test_idealised_columnar_equals_jax(kind, seed):
    """The sweep alone over more seeds (host numpy on both sides)."""
    def columnar(ns):
        if kind == "lookback":
            world = _market_world(ns, 2000 + seed, lookback=7)
        else:
            world = _market_world(ns, (1000 if kind == "tight" else 0) + seed)
        config, _q, nodes, _j, _r, builder, price_of = world
        if kind == "tight":
            builder.set_nodes([ns.NodeSpec(
                id=nodes[0].id, pool="default",
                total_resources=config.resource_list_factory().from_mapping(
                    {"cpu": 5, "memory": 8}))])
        return ns.columnar.calculate_idealised_values_columnar(
            config, pool="default", builder=builder, bid_price_of=price_of)

    _values_equal(columnar(JAX), columnar(PORT), f"{kind} {seed}")


# --- 5. the optimiser's unit cases ------------------------------------------------------


def _optimiser_case(ns, case):
    """The seven unit cases of tests/test_optimiser.py, built from `ns`."""
    cfg = ns.SchedulingConfig(shape_bucket=32)
    F = cfg.resource_list_factory()

    def node(nid, cpu="8"):
        return ns.NodeSpec(id=nid, pool="default",
                           total_resources=F.from_mapping({"cpu": cpu, "memory": "32"}))

    def spec(jid, queue="q", cpu="4", pc="armada-preemptible", submit=0.0):
        return ns.JobSpec(id=jid, queue=queue, priority_class=pc, submit_time=submit,
                          resources=F.from_mapping({"cpu": cpu, "memory": "2"}))

    def running(jid, nid, queue="hog", cpu="4", submit=0.0, away=False):
        return ns.RunningJob(job=spec(jid, queue=queue, cpu=cpu, submit=submit), node_id=nid,
                             away=away)

    O = ns.optimiser

    def opt(**kw):
        return O.Optimiser(cfg, O.OptimiserConfig(enabled=True, **kw))

    share = dict(actual_share={"hog": 0.9, "starved": 0.0}, fair_share={"hog": 0.5, "starved": 0.5})
    if case == "disabled":
        return [O.Optimiser(cfg, O.OptimiserConfig(enabled=False)).optimise(
            [spec("s")], [node("n0")], [], {}, {})]
    if case == "over_share_newest_first":
        runs = [running("old", "n0", submit=1.0), running("new", "n0", submit=9.0)]
        return [opt().optimise([spec("stuck", queue="starved")], [node("n0")], runs, **share)]
    if case == "away_guests_first":
        runs = [running("home-job", "n0", submit=9.0), running("guest", "n0", submit=1.0,
                                                                 away=True)]
        return [opt().optimise([spec("stuck", queue="starved")], [node("n0")], runs,
                               actual_share={"hog": 0.9}, fair_share={"hog": 0.5})]
    if case == "size_cap":
        return [opt(maximum_job_size_to_preempt={"cpu": "4", "memory": "64"}).optimise(
            [spec("stuck", cpu="8")], [node("n0")], [running("big", "n0", cpu="8")],
            actual_share={"hog": 1.0}, fair_share={"hog": 0.5})]
    if case == "non_preemptible":
        runs = [ns.RunningJob(job=spec("prod", queue="hog", cpu="8", pc="armada-default"),
                              node_id="n0")]
        return [opt().optimise([spec("stuck", cpu="8")], [node("n0")], runs,
                               actual_share={"hog": 1.0}, fair_share={"hog": 0.5})]
    if case == "cheapest_node":
        runs = [running(f"a{i}", "n0", cpu="2", submit=i) for i in range(1, 5)]
        runs += [running("b1", "n1", cpu="4", submit=5), running("b2", "n1", cpu="4", submit=6)]
        return [opt().optimise([spec("stuck", cpu="4")], [node("n0"), node("n1")], runs,
                               actual_share={"hog": 1.0}, fair_share={"hog": 0.3})]
    assert case == "banned_node"
    runs = [running("victim", "n0", submit=9.0)]
    kw = dict(actual_share={"hog": 0.9}, fair_share={"hog": 0.5})
    return [
        opt().optimise([spec("stuck", queue="starved")], [node("n0")], runs, **kw),
        opt().optimise([spec("stuck", queue="starved")], [node("n0")], runs,
                       banned_nodes={"stuck": ("n0",)}, **kw),
        opt().optimise([spec("stuck", queue="starved")], [node("n0"), node("n1")], runs,
                       banned_nodes={"stuck": ("n0",)}, **kw),
    ]


_OPT_EXPECT = {
    "disabled": [[]],
    "over_share_newest_first": [[("stuck", "n0", ["new"])]],
    "away_guests_first": [[("stuck", "n0", ["guest"])]],
    "size_cap": [[]],
    "non_preemptible": [[]],
    "cheapest_node": [[("stuck", "n1", ["b2"])]],
    "banned_node": [[("stuck", "n0", [])], [], [("stuck", "n1", [])]],
}


@pytest.mark.parametrize("case", sorted(_OPT_EXPECT))
def test_optimiser_cases_equal_jax(case):
    def view(calls):
        return [[(d.job_id, d.node_id, list(d.preempted_job_ids)) for d in c] for c in calls]

    want = view(_optimiser_case(JAX, case))
    got = view(_optimiser_case(PORT, case))
    assert got == want
    assert got == _OPT_EXPECT[case]


# --- 6. FairSchedulingAlgo over a market JobDb ---------------------------------------------


def _algo_market_cycles(ns, incremental, seed):
    """test_market_columnar._algo_market_stats for three cycles, from `ns`:
    a market pool of three 8-cpu nodes with two priced shapes and
    f32-exact (queue, band) prices.  Cycle 0 submits singles and two gangs,
    cycle 1 fresh singles, and cycle 2 moves the top band to 50 and submits
    top-band singles that outbid and preempt earlier placements.  The
    world's sizes are fixed so that the JAX rounds share their compiled
    shapes.  Returns per cycle the decisions and the market PoolStats."""
    rng = random.Random(seed)
    shapes = (("probe", ns.GangDefinition(size=2, priority_class=PCS[0],
                                          resources={"cpu": 2, "memory": 1})),
              ("zoned", ns.GangDefinition(size=2, priority_class=PCS[0],
                                          resources={"cpu": 2, "memory": 1},
                                          node_uniformity="zone")))
    config = dataclasses.replace(
        _config(ns, shapes), incremental_problem_build=incremental,
        maximum_scheduling_burst=6, maximum_scheduling_rate=0.0,
        maximum_per_queue_scheduling_rate=0.0)
    F = config.resource_list_factory()
    queues = [ns.Queue(f"q{i}") for i in range(3)]
    nodes = tuple(
        ns.NodeSpec(id=f"n{i}", pool="default", executor="ex1", labels={"zone": "ab"[i % 2]},
                    total_resources=F.from_mapping({"cpu": 8, "memory": 16}))
        for i in range(3)
    )
    table = {(q.name, b): float(np.float32(rng.choice([1.0, 2.0, 4.0])))
             for q in queues for b in BANDS}

    class TableProvider(ns.providers.StaticBidPriceProvider):
        def price(self, queue, band):
            return table[(queue, band)]

    jdb = ns.JobDb(config)
    feed = None
    if incremental:
        feed = ns.Feed(config, **ns.device_kw)
        feed.attach(jdb)
    run_ids = itertools.count()
    algo = ns.Algo(config, queues=lambda: queues, clock_ns=lambda: NOW_NS,
                   run_id_factory=lambda: f"run{next(run_ids):05d}",
                   bid_prices=TableProvider({}, default=1.0), feed=feed, **ns.device_kw)

    def single(jid, band, submit, cpus):
        return ns.JobSpec(id=jid, queue=rng.choice(queues).name, priority_class=rng.choice(PCS),
                          price_band=band, submit_time=submit,
                          resources=F.from_mapping({"cpu": rng.choice(cpus), "memory": 1}))

    out = []
    for c in range(3):
        txn = jdb.write_txn()
        specs = []
        if c == 0:
            specs = [single(f"j{i:03d}", rng.choice(BANDS), float(rng.randint(0, 3)), (1, 2, 4))
                     for i in range(16)]
            for g in range(2):
                q = rng.choice(queues).name
                specs += [ns.JobSpec(id=f"g{g}m{m}", queue=q, priority_class=PCS[0],
                                     price_band=rng.choice(BANDS), submit_time=1.0,
                                     resources=F.from_mapping({"cpu": 2, "memory": 1}),
                                     gang_id=f"g{g}", gang_cardinality=2) for m in range(2)]
        else:
            if c == 2:
                table.update({(q.name, "high"): 50.0 for q in queues})
            specs = [single(f"c{c}p{i}", "high" if c == 2 else rng.choice(BANDS), 5.0 + c,
                            (2, 4)) for i in range(6)]
        for spec in specs:
            txn.upsert(ns.Job(spec=spec, validated=True, pools=("default",)))
        snap = ns.ExecutorSnapshot(id="ex1", pool="default", nodes=nodes,
                                   last_update_ns=NOW_NS + c * 10**9)
        result = algo.schedule(txn, [snap], now_ns=NOW_NS + c * 10**9)
        (stats,) = [s for s in result.pools if s.market]
        o = stats.outcome
        out.append(dict(
            scheduled=[(job.id, run.id, run.node_id) for job, run in result.scheduled],
            preempted=sorted(job.id for job, _ in result.preempted),
            failed=sorted(result.failed),
            spot=np.float64(o.spot_price).tobytes(),
            iterations=o.num_iterations,
            prices=stats.indicative_prices,
            idealised=stats.idealised_values,
            realised=stats.realised_values,
        ))
        txn.commit()
    return out


@pytest.mark.parametrize("incremental,seed", [(False, 0), (True, 0), (True, 1)],
                         ids=["legacy-0", "incremental-0", "incremental-1"])
def test_algo_market_cycles_equal_jax(incremental, seed):
    """Three cycles -- fresh, fresh again, a preempting price move -- decide
    as the JAX package decides, with the same spot price, indicative
    prices and idealised and realised values, in both assembly modes."""
    want = _algo_market_cycles(JAX, incremental, seed)
    got = _algo_market_cycles(PORT, incremental, seed)
    for c, (w, g) in enumerate(zip(want, got)):
        what = f"cycle {c}"
        for key in ("scheduled", "preempted", "failed", "spot", "iterations"):
            assert g[key] == w[key], f"{what}: {key}"
        _prices_equal(w["prices"], g["prices"], what)
        _values_equal(w["idealised"], g["idealised"], f"{what}: idealised")
        _values_equal(w["realised"], g["realised"], f"{what}: realised")
    assert got[0]["scheduled"] and got[0]["idealised"] and got[0]["prices"]
    assert got[2]["preempted"], "the price move preempted nothing"


def test_algo_market_modes_agree():
    """The port's two assembly modes give the same market PoolStats (the
    columnar observability equals the spec walk on these worlds)."""
    for seed in (0, 1):
        legacy = _algo_market_cycles(PORT, False, seed)
        inc = _algo_market_cycles(PORT, True, seed)
        for c, (a, b) in enumerate(zip(legacy, inc)):
            assert sorted(x[0] for x in a["scheduled"]) == sorted(x[0] for x in b["scheduled"])
            _prices_equal(a["prices"], b["prices"], f"cycle {c}")
            assert sorted(a["idealised"]) == sorted(b["idealised"])
            for q in a["idealised"]:
                assert np.isclose(a["idealised"][q], b["idealised"][q])
            _values_equal(a["realised"], b["realised"], f"cycle {c}: realised")


# --- 7. priority overrides, the optimiser, the window, the refusal ---------------------------


def _two_pool_cycles(ns, incremental, overrides, parallel=False, market_third=False):
    """Two (or, with market_third, three) pools of three 8-cpu nodes, every
    job restricted to one pool; the overrides reweigh queues per pool.
    Returns per cycle the ordered decisions and per pool the queue shares."""
    pools = ["p0", "p1"] + (["m"] if market_third else [])
    config = ns.SchedulingConfig(
        shape_bucket=32, incremental_problem_build=incremental, maximum_scheduling_burst=5,
        maximum_scheduling_rate=0.0, maximum_per_queue_scheduling_rate=0.0,
        pools=tuple(ns.PoolConfig(p, market_driven=(p == "m")) for p in pools),
    )
    F = config.resource_list_factory()
    jdb = ns.JobDb(config)
    feed = None
    if incremental:
        feed = ns.Feed(config, **ns.device_kw)
        feed.attach(jdb)
    run_ids = itertools.count()
    queues = [ns.Queue(f"q{i}", 1.0) for i in range(3)]
    kw = {}
    if overrides:
        kw["priority_overrides"] = ns.providers.StaticPriorityOverrideProvider(
            {("p0", "q0"): 8.0, ("p1", "q2"): 0.25, ("p1", "q1"): 5.0})
    if market_third:
        kw["bid_prices"] = ns.providers.StaticBidPriceProvider({("q1", ""): 3.0}, default=1.0)
    algo = ns.Algo(config, queues=lambda: queues, clock_ns=lambda: NOW_NS,
                   run_id_factory=lambda: f"run{next(run_ids):05d}", feed=feed,
                   **kw, **ns.device_kw)
    executors = [
        ns.ExecutorSnapshot(
            id=f"ex-{p}", pool=p, last_update_ns=NOW_NS,
            nodes=tuple(ns.NodeSpec(id=f"{p}-n{k}", pool=p,
                                    total_resources=F.from_mapping({"cpu": "8", "memory": "32"}))
                        for k in range(3)))
        for p in pools
    ]
    rng = np.random.default_rng(11)
    out, seq = [], itertools.count()
    for c in range(3):
        txn = jdb.write_txn()
        for _ in range(30 if c == 0 else 8):
            i = next(seq)
            pool = pools[i % len(pools)]
            spec = ns.JobSpec(
                id=f"j{i:04d}", queue=f"q{int(rng.integers(0, 3))}", submit_time=float(i),
                priority_class="armada-preemptible", pools=(pool,),
                resources=F.from_mapping({"cpu": str(1 + int(rng.integers(0, 3))),
                                          "memory": "1"}))
            txn.upsert(ns.Job(spec=spec, queued=True, validated=True, pools=(pool,)))
        result = algo.schedule(txn, executors, NOW_NS)
        out.append((
            [(job.id, run.id, run.node_id) for job, run in result.scheduled],
            sorted(job.id for job, _ in result.preempted),
            {ps.pool: sorted((q, s["weight"], s["fair_share"], s["actual_share"])
                             for q, s in ps.outcome.queue_stats.items())
             for ps in result.pools},
            {ps.pool: (ps.market, sorted(ps.idealised_values.items())) for ps in result.pools},
        ))
        txn.commit()
    return out


@pytest.mark.parametrize("incremental", [False, True], ids=["legacy", "incremental"])
def test_priority_overrides_on_two_pools_equal_jax(incremental):
    want = _two_pool_cycles(JAX, incremental, overrides=True)
    got = _two_pool_cycles(PORT, incremental, overrides=True)
    assert got == want
    plain = _two_pool_cycles(PORT, incremental, overrides=False)
    assert [c[2] for c in plain] != [c[2] for c in got], "the overrides changed nothing"


@pytest.mark.parametrize("incremental", [True], ids=["incremental"])
def test_optimiser_unsticks_a_job_through_the_algo(incremental):
    """tests/test_optimiser.py's end-to-end case on a JobDb with no control
    plane: the hogs fill two 8-cpu nodes, normal eviction is off, and the
    optimiser preempts one node's worth of hogs for the 8-cpu job."""
    def run(ns):
        cfg = ns.SchedulingConfig(
            shape_bucket=32, protected_fraction_of_fair_share=100.0, optimiser_enabled=True,
            default_priority_class="armada-preemptible", incremental_problem_build=incremental)
        F = cfg.resource_list_factory()
        jdb = ns.JobDb(cfg)
        feed = None
        if incremental:
            feed = ns.Feed(cfg, **ns.device_kw)
            feed.attach(jdb)
        run_ids = itertools.count()
        algo = ns.Algo(cfg, queues=lambda: [ns.Queue("hog"), ns.Queue("starved")],
                       clock_ns=lambda: NOW_NS, run_id_factory=lambda: f"r{next(run_ids):04d}",
                       collect_stats=False, feed=feed, **ns.device_kw)
        assert algo.collect_stats, "the optimiser forces the share stats"
        ex = [ns.ExecutorSnapshot(
            id="ex", pool="default", last_update_ns=NOW_NS,
            nodes=tuple(ns.NodeSpec(id=f"n{k}", pool="default",
                                    total_resources=F.from_mapping({"cpu": "8", "memory": "32"}))
                        for k in range(2)))]
        out = []
        for c, (queue, n, cpu) in enumerate((("hog", 8, "2"), ("starved", 1, "8"),
                                              ("starved", 0, "8"))):
            txn = jdb.write_txn()
            for i in range(n):
                spec = ns.JobSpec(id=f"{queue}{c}-{i}", queue=queue, submit_time=float(c),
                                  priority_class="armada-preemptible",
                                  resources=F.from_mapping({"cpu": cpu, "memory": "2"}))
                txn.upsert(ns.Job(spec=spec, queued=True, validated=True))
            result = algo.schedule(txn, ex, NOW_NS)
            out.append(([(j.id, r.id, r.node_id) for j, r in result.scheduled],
                        sorted(j.id for j, _ in result.preempted)))
            txn.commit()
        return out

    want, got = run(JAX), run(PORT)
    assert got == want
    placed, preempted = got[1]
    assert [p[0] for p in placed] == ["starved1-0"] and len(preempted) == 4


def test_market_pool_stays_out_of_the_window(monkeypatch):
    """With ARMADA_POOL_PARALLEL=1 and every job restricted to one pool, the
    two fair-share pools stack into one launch and the market pool runs
    serially after them: every stacked launch covers exactly the two
    (a market pool in the window would make it three).  Decisions and the
    market stats equal the JAX package's and the port's serial arm."""
    monkeypatch.setenv("ARMADA_POOL_PARALLEL", "1")
    want = _two_pool_cycles(JAX, True, overrides=False, market_third=True)
    jax_snap = jax_pool_serving.pool_serving_stats().snapshot()
    got = _two_pool_cycles(PORT, True, overrides=False, market_third=True)
    snap = t_pool_serving.pool_serving_stats().snapshot()
    monkeypatch.setenv("ARMADA_POOL_PARALLEL", "0")
    serial = _two_pool_cycles(PORT, True, overrides=False, market_third=True)
    assert got == want == serial
    assert snap["parallel_cycles"] == 3 and snap["stacked_launches"] >= 1
    assert snap["stacked_pools"] == 2 * snap["stacked_launches"]
    for key in ("parallel_cycles", "stacked_launches", "stacked_pools"):
        assert snap[key] == jax_snap[key], key
    assert all(c[3]["m"][0] and c[3]["m"][1] for c in got), "the market pool's stats"


def test_market_pool_without_a_provider_raises():
    for ns in (JAX, PORT):
        cfg = ns.SchedulingConfig(pools=(ns.PoolConfig("m", market_driven=True),))
        with pytest.raises(ValueError, match="market driven"):
            ns.Algo(cfg, queues=lambda: [], clock_ns=lambda: NOW_NS, **ns.device_kw)
