"""The port's round end to end, on the CPU, against the JAX package.

- `armada_tpu_torch.models.run_scheduling_round(device="cpu")` against
  `armada_tpu.models.run_scheduling_round` (its default statics) on the
  worlds of tests/test_parity_full.py: the whole RoundOutcome must be equal.
- The port against the independent sequential oracles of tests/test_parity.py
  and tests/test_parity_full.py.
- The port's host builders against the reference's: build_problem and
  synthetic_problem arrays equal field by field.
"""

import dataclasses

import numpy as np
import pytest

import armada_tpu.models as jax_models
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu_torch.models import build_problem, run_scheduling_round
from armada_tpu_torch.models.synthetic import synthetic_problem, variety_world
from test_parity import CFG as SINGLETON_CFG
from test_parity import oracle_round, random_problem
from test_parity_full import _Oracle
from test_torch_round import WORLDS, _world_case


def _run_both(cfg, nodes, queues, jobs, running, prices):
    bid = (lambda job: prices.get(job.queue, 0.0)) if prices else None
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=jobs,
              running=running, bid_price_of=bid)
    ref = jax_models.run_scheduling_round(cfg, **kw)
    got = run_scheduling_round(cfg, **kw, device="cpu")
    return ref, got


@pytest.mark.parametrize("kind,seed", WORLDS + [("gangs", 3), ("evict", 9)])
def test_outcome_equals_reference(kind, seed):
    cfg, (nodes, queues, jobs, running), prices = _world_case(kind, seed)
    ref, got = _run_both(cfg, nodes, queues, jobs, running, prices)
    assert got.scheduled == ref.scheduled
    assert sorted(got.preempted) == sorted(ref.preempted)
    assert sorted(got.rescheduled) == sorted(ref.rescheduled)
    assert list(got.failed) == list(ref.failed)
    assert got.termination == ref.termination
    assert got.num_iterations == ref.num_iterations
    assert got.spot_price == ref.spot_price
    assert got.unwound_groups == ref.unwound_groups
    assert got.queue_stats == ref.queue_stats
    assert got.pool_totals == ref.pool_totals


@pytest.mark.parametrize("seed,market", [(4, False), (5, True)])
def test_variety_outcome_equals_reference(seed, market):
    config, kw = variety_world(seed, market=market, num_nodes=70)
    config = dataclasses.replace(config, indicative_share_base_priorities=(1, 2, 3))
    ref = jax_models.run_scheduling_round(config, **kw)
    got = run_scheduling_round(config, **kw, device="cpu")
    assert got.scheduled == ref.scheduled
    assert sorted(got.preempted) == sorted(ref.preempted)
    assert list(got.failed) == list(ref.failed)
    assert got.termination == ref.termination
    assert got.spot_price == ref.spot_price
    assert got.queue_stats == ref.queue_stats
    assert got.indicative_shares == ref.indicative_shares


def _rollback_case(name):
    """The gang-transaction rollback worlds of tests/test_gang_rollback.py,
    plus a running gang that would be preempted only in part."""
    from armada_tpu.core.types import Queue, RunningJob
    from test_gang_rollback import CFG as RB_CFG
    from test_gang_rollback import gang_member, job, rnode

    victim = RunningJob(job=job("victim", cpu="8", queue="qv", pc="low"), node_id="n1",
                        priority=100)
    queues = [Queue("q"), Queue("qv")]
    members = [gang_member("m1", submit_time=1.0, selector={"rack": "a"}),
               gang_member("m2", submit_time=2.0, selector={"rack": "b"})]
    if name == "unwound_sibling":
        x = job("x", cpu="8", submit_time=0.0, node_selector={"rack": "b"})
        return RB_CFG, dict(nodes=[rnode("n1", "a"), rnode("n2", "b")], queues=queues,
                            queued_jobs=[x] + members, running=[victim])
    if name == "rollback_keeps_singles":
        singles = [job(f"s{i}", cpu="4", submit_time=0.0) for i in range(4)]
        x = job("x", cpu="16", submit_time=0.5, node_selector={"rack": "b"})
        return RB_CFG, dict(nodes=[rnode("n1", "a"), rnode("n2", "b", cpu="32")],
                            queues=queues, queued_jobs=singles + [x] + members,
                            running=[victim])
    running = [
        RunningJob(job=job(f"r{i}", cpu="8", queue="qa", pc="low", gang_id="rg",
                           gang_cardinality=2), node_id=f"n{i}")
        for i in (1, 2)
    ]
    h = job("h", cpu="8", queue="qb", submit_time=0.0, node_selector={"rack": "b"})
    cfg = RB_CFG if name == "running_gang_urgency" else dataclasses.replace(
        RB_CFG, protected_fraction_of_fair_share=0.0)
    return cfg, dict(nodes=[rnode("n1", "a"), rnode("n2", "b")],
                     queues=[Queue("qa"), Queue("qb")], queued_jobs=[h], running=running)


@pytest.mark.parametrize("name", ["unwound_sibling", "rollback_keeps_singles",
                                  "running_gang_urgency", "running_gang_evicted"])
def test_gang_rollback_equals_reference(name):
    cfg, kw = _rollback_case(name)
    ref = jax_models.run_scheduling_round(cfg, pool="default", **kw)
    got = run_scheduling_round(cfg, pool="default", **kw, device="cpu")
    assert got.scheduled == ref.scheduled
    assert sorted(got.preempted) == sorted(ref.preempted)
    assert sorted(got.rescheduled) == sorted(ref.rescheduled)
    assert sorted(got.failed) == sorted(ref.failed)
    assert got.unwound_groups == ref.unwound_groups == frozenset()
    if name.startswith("running_gang"):
        assert sorted(got.preempted) == ["r1", "r2"]  # the whole gang goes


def test_compact_overflow_falls_back_to_full_pull(monkeypatch):
    """Caps smaller than the round's failed / preempted counts: decode pulls
    the full arrays and the outcome is unchanged."""
    import armada_tpu_torch.models.problem as tproblem

    cfg, (nodes, queues, jobs, running), _ = _world_case("away", 3)
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=jobs, running=running)
    want = run_scheduling_round(cfg, **kw, device="cpu")
    assert len(want.preempted) > 1  # more than the cap of 1
    monkeypatch.setattr(tproblem, "COMPACT_FCAP", 1)
    monkeypatch.setattr(tproblem, "COMPACT_ECAP", 1)
    got = run_scheduling_round(cfg, **kw, device="cpu")
    assert got.scheduled == want.scheduled
    assert got.preempted == want.preempted
    assert list(got.failed) == list(want.failed)
    assert got.num_iterations == want.num_iterations


@pytest.mark.parametrize("seed", [1, 7, 13, 42, 99])
def test_singleton_oracle(seed):
    rng = np.random.default_rng(seed)
    nodes, queues, jobs = random_problem(rng, num_nodes=12, num_jobs=80, num_queues=4)
    expected = oracle_round(SINGLETON_CFG, nodes, queues, jobs)
    outcome = run_scheduling_round(SINGLETON_CFG, pool="default", nodes=nodes,
                                   queues=queues, queued_jobs=jobs, device="cpu")
    assert set(outcome.scheduled) == set(expected)


@pytest.mark.parametrize("seed", [3, 21])
def test_singleton_oracle_under_saturation(seed):
    rng = np.random.default_rng(seed)
    nodes, queues, jobs = random_problem(rng, num_nodes=4, num_jobs=120, num_queues=3)
    expected = oracle_round(SINGLETON_CFG, nodes, queues, jobs)
    outcome = run_scheduling_round(SINGLETON_CFG, pool="default", nodes=nodes,
                                   queues=queues, queued_jobs=jobs, device="cpu")
    assert set(outcome.scheduled) == set(expected)


@pytest.mark.parametrize("kind,seed", [("gangs", 4), ("gangs", 5), ("evict", 13),
                                       ("evict", 17), ("away", 11), ("pccap", 21)])
def test_full_oracle(kind, seed):
    cfg, (nodes, queues, jobs, running), prices = _world_case(kind, seed)
    o_sched, o_preempted, _ = _Oracle(cfg, nodes, queues, jobs, running, prices=prices).run()
    outcome = run_scheduling_round(cfg, pool="default", nodes=nodes, queues=queues,
                                   queued_jobs=jobs, running=running, device="cpu",
                                   collect_stats=False)
    assert set(outcome.scheduled) == set(o_sched)
    assert sorted(outcome.preempted) == sorted(o_preempted)


@pytest.mark.parametrize("kind,seed", [("gangs", 1), ("evict", 2), ("away", 3),
                                       ("market", 4), ("pccap", 6)])
def test_build_problem_arrays_equal(kind, seed):
    cfg, (nodes, queues, jobs, running), prices = _world_case(kind, seed)
    bid = (lambda job: prices.get(job.queue, 0.0)) if prices else None
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=jobs,
              running=running, bid_price_of=bid)
    jp, jctx = jax_models.build_problem(cfg, **kw)
    tp, tctx = build_problem(cfg, **kw)
    assert jp._fields == tp._fields
    for name in jp._fields:
        a, b = np.asarray(getattr(jp, name)), np.asarray(getattr(tp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in ("queue_names", "node_ids", "gang_members", "gang_group", "run_job_ids",
              "num_real_gangs", "num_real_runs", "max_slots", "slot_width", "ladder"):
        assert getattr(jctx, f) == getattr(tctx, f), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_problem_equal(seed):
    kw = dict(num_nodes=50, num_gangs=300, num_queues=7, num_runs=20,
              max_gang_cardinality=3, type_sensitive_frac=0.3, seed=seed)
    jp, jm = jax_synthetic(**kw)
    tp, tm = synthetic_problem(**kw)
    assert jm == tm
    for name in jp._fields:
        a, b = np.asarray(getattr(jp, name)), np.asarray(getattr(tp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_synthetic_world_equal():
    from armada_tpu.models.synthetic import synthetic_world as jax_world
    from armada_tpu_torch.models.synthetic import synthetic_world

    kw = dict(num_nodes=30, num_jobs=200, num_queues=5, num_runs=20, seed=3, market=True)
    j = jax_world(**kw)
    t = synthetic_world(**kw)

    def plain(x):
        if dataclasses.is_dataclass(x):
            return {k: plain(v) for k, v in dataclasses.asdict(x).items()}
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, np.ndarray):
            return x.tolist()
        return x

    for a, b in zip(j[1:5], t[1:5]):
        assert plain(list(a)) == plain(list(b))
