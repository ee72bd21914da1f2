"""The placement loop's remaining shapes through the port's entry points,
against the JAX package on the CPU: prefer-large configured, jobs carrying
`node_type_scores`, and ARMADA_COMMIT_K armed, through
run_scheduling_round (run_round_on_device), dispatch_pool_rounds and
FairSchedulingAlgo.schedule in both pool arms.  Outcomes must be equal,
kernel_iters included; market pools run the single-commit body whatever
the environment says.  The rounds themselves are in
tests/test_torch_loop_shapes.py.
"""

import dataclasses

import numpy as np
import pytest

import armada_tpu.models as jm
import armada_tpu_torch.models as tm
from armada_tpu.core.config import PoolConfig, SchedulingConfig
from armada_tpu.core.types import JobSpec, NodeSpec, Queue
from test_hetero import CFG as HETERO_CFG
from test_hetero import job as hetero_job
from test_hetero import node as hetero_node
from test_parity_full import CFG as PARITY_CFG
from test_parity_full import world
from test_torch_pool_parallel import (  # noqa: F401 (_fresh_state: autouse resets)
    MultiPoolWorld,
    _assert_results_equal,
    _dispatch_specs,
    _dispatch_world,
    _fresh_state,
    _Jax,
    _outcome_key,
    _Port,
)
from armada_tpu_torch.scheduler import pool_serving as t_pool_serving


def _both(cfg, **kw):
    ref = jm.run_scheduling_round(cfg, pool="default", collect_stats=False, **kw)
    got = tm.run_scheduling_round(cfg, pool="default", collect_stats=False, device="cpu", **kw)
    for name in ("scheduled", "rescheduled", "unwound_groups", "termination", "num_iterations",
                 "spot_price", "kernel_iters"):
        assert getattr(got, name) == getattr(ref, name), name
    assert sorted(got.preempted) == sorted(ref.preempted)
    assert list(got.failed) == list(ref.failed)
    return got


# --- prefer-large ----------------------------------------------------------------------


def test_prefer_large_world_through_run_scheduling_round():
    """tests/test_round_scheduler.py test_prefer_large_job_ordering's world:
    burst 1, an empty farm; prefer-large puts the larger gang first."""
    cfg = SchedulingConfig(shape_bucket=32, maximum_scheduling_burst=1)
    f = cfg.resource_list_factory()
    nodes = [NodeSpec(id="n0", pool="default",
                      total_resources=f.from_mapping({"cpu": "8", "memory": "32"}))]
    queues = [Queue("big"), Queue("small")]
    jobs = [
        JobSpec(id="jb", queue="big", resources=f.from_mapping({"cpu": "4", "memory": "2"})),
        JobSpec(id="js", queue="small", resources=f.from_mapping({"cpu": "2", "memory": "2"})),
    ]
    kw = dict(nodes=nodes, queues=queues, queued_jobs=jobs)
    assert set(_both(cfg, **kw).scheduled) == {"js"}
    pl = dataclasses.replace(cfg, enable_prefer_large_job_ordering=True)
    assert set(_both(pl, **kw).scheduled) == {"jb"}


@pytest.mark.parametrize("seed,running", [(3, 0), (8, 40)])
def test_prefer_large_parity_worlds(seed, running):
    """Gangs, mixed priority classes and (with running jobs and no
    protection) evictees, ordered by prefer-large."""
    cfg = dataclasses.replace(PARITY_CFG, enable_prefer_large_job_ordering=True,
                              protected_fraction_of_fair_share=0.0 if running else
                              PARITY_CFG.protected_fraction_of_fair_share)
    nodes, queues, jobs, run = world(seed, num_nodes=80, num_jobs=250, num_running=running)
    _both(cfg, nodes=nodes, queues=queues, queued_jobs=jobs, running=run)


# --- node-type scores --------------------------------------------------------------------


def test_bias_steers_placement_to_fast_type():
    """tests/test_hetero.py's world: the throughput bias flips best fit from
    the smaller node to the faster type's bigger node."""
    nodes = [hetero_node("slow", cpu=8, mem=32, node_type="v4"),
             hetero_node("fast", cpu=32, mem=128, node_type="v6")]
    queues = [Queue("qa", 1.0)]
    got = _both(HETERO_CFG, nodes=nodes, queues=queues, queued_jobs=[
        hetero_job("j1", node_type_scores=(("v4", 1.0), ("v6", 4.0)))])
    assert got.scheduled == {"j1": "fast"}


def test_whitelist_excludes_unnamed_types():
    nodes = [hetero_node("a", node_type="v4"), hetero_node("b", node_type="v6"),
             hetero_node("c", node_type="")]
    got = _both(HETERO_CFG, nodes=nodes, queues=[Queue("qa", 1.0)], queued_jobs=[
        hetero_job("j1", node_type_scores=(("v6", 1.0),)),
        hetero_job("j2", sub=1.0, node_type_scores=(("v9", 1.0),)),
    ])
    assert got.scheduled.get("j1") == "b"
    assert "j2" in got.failed


@pytest.mark.parametrize("commit_k", [1, 8])
def test_mixed_fleet_with_type_scores(monkeypatch, commit_k):
    """A fleet of three node types; a third of the jobs declare
    throughputs per type, the rest none."""
    monkeypatch.setenv("ARMADA_COMMIT_K", str(commit_k))
    rng = np.random.default_rng(11)
    types = ("v4", "v5e", "v6")
    nodes = [hetero_node(f"n{i:02d}", cpu=int(rng.choice([8, 16, 32])), mem=64,
                         node_type=types[i % 3]) for i in range(24)]
    queues = [Queue(f"q{i}", 1.0 + i) for i in range(4)]
    jobs = []
    for i in range(160):
        scores = ()
        if i % 3 == 0:
            scores = tuple((t, float(rng.choice([1.0, 2.0, 4.0]))) for t in types[: 1 + i % 2 + 1])
        jobs.append(hetero_job(f"j{i:03d}", cpu=int(rng.choice([1, 2, 4])), mem=2, sub=float(i),
                               queue=f"q{i % 4}", node_type_scores=scores))
    got = _both(HETERO_CFG, nodes=nodes, queues=queues, queued_jobs=jobs)
    assert got.scheduled
    if commit_k > 1:
        assert got.kernel_iters < got.num_iterations


# --- ARMADA_COMMIT_K -------------------------------------------------------------------------


@pytest.mark.parametrize("commit_k", [1, 4, 8])
@pytest.mark.parametrize("seed", [6, 14, 27])
def test_multi_commit_conflict_heavy_worlds(monkeypatch, seed, commit_k):
    """tests/test_parity_full.py's conflict-heavy worlds: few nodes, gangs
    among singles."""
    monkeypatch.setenv("ARMADA_COMMIT_K", str(commit_k))
    nodes, queues, jobs, running = world(seed, num_nodes=30, num_jobs=250, num_running=0,
                                         gangs=4)
    _both(PARITY_CFG, nodes=nodes, queues=queues, queued_jobs=jobs, running=running)


@pytest.mark.parametrize("commit_k", [4, 8])
@pytest.mark.parametrize("seed", [5, 17])
def test_multi_commit_eviction_worlds(monkeypatch, seed, commit_k):
    monkeypatch.setenv("ARMADA_COMMIT_K", str(commit_k))
    cfg = dataclasses.replace(PARITY_CFG, protected_fraction_of_fair_share=0.0)
    nodes, queues, jobs, running = world(seed, num_nodes=120, num_jobs=150, num_running=60,
                                         gangs=0)
    got = _both(cfg, nodes=nodes, queues=queues, queued_jobs=jobs, running=running)
    assert got.rescheduled or got.preempted


def test_market_pool_runs_single_commit(monkeypatch):
    """A market pool with ARMADA_COMMIT_K=8 and prefer-large configured: bid
    order, and the single-commit body (trips equal logical steps)."""
    monkeypatch.setenv("ARMADA_COMMIT_K", "8")
    cfg = dataclasses.replace(
        PARITY_CFG, enable_prefer_large_job_ordering=True,
        pools=(PoolConfig("default", market_driven=True, spot_price_cutoff=0.1),))
    rng = np.random.default_rng(4)
    nodes, queues, jobs, running = world(4, num_nodes=40, num_jobs=200, num_running=0, gangs=0)
    prices = {q.name: float(rng.integers(1, 10)) for q in queues}
    got = _both(cfg, nodes=nodes, queues=queues, queued_jobs=jobs, running=running,
                bid_price_of=lambda j: prices.get(j.queue, 0.0))
    assert got.kernel_iters == got.num_iterations
    assert got.scheduled


@pytest.mark.parametrize("case", ["commit_k", "prefer_large"])
def test_dispatch_pool_rounds_with_loop_shapes(monkeypatch, case):
    """dispatch_pool_rounds stacks three shape-matched pools and runs the
    fourth solo, every round with the armed shape; outcomes and results
    equal JAX's on two cycles."""
    if case == "commit_k":
        monkeypatch.setenv("ARMADA_COMMIT_K", "8")
    sides = []
    for ns, jax_side in ((_Jax, True), (_Port, False)):
        cfg, builders, caches = _dispatch_world(ns, jax_side)
        if case == "prefer_large":
            cfg = dataclasses.replace(cfg, enable_prefer_large_job_ordering=True)
        sides.append(dict(ns=ns, cfg=cfg, b=builders, c=caches, specs={}))
    for cycle in range(2):
        for side in sides:
            for pi, pool in enumerate(side["b"]):
                rng = np.random.default_rng(100 * cycle + pi)
                new = _dispatch_specs(side["ns"], side["cfg"], pool, cycle, rng)
                side["specs"].update((s.id, s) for s in new)
                side["b"][pool].submit_many(new)
        fins = []
        for side, mod, kw in ((sides[0], jm, {}), (sides[1], tm, {"device": "cpu"})):
            specs = []
            for pool, b in side["b"].items():
                bundle, ctx = b.assemble_delta()
                specs.append(mod.PoolRoundSpec(
                    problem=bundle.stats_view(), ctx=ctx,
                    device_problem=lambda c=side["c"][pool], x=bundle: c.apply(x),
                    host_problem=bundle.materialize))
            fin, n, npools, _ = mod.dispatch_pool_rounds(specs, side["cfg"], **kw)
            assert (n, npools) == (1, 3)
            fins.append(fin)
        for pool, jf, tf in zip(sides[0]["b"], *fins):
            jres, jout = jf()
            tres, tout = tf()
            assert _outcome_key(jout) == _outcome_key(tout), (cycle, pool)
            assert jout.kernel_iters == tout.kernel_iters, (cycle, pool)
            _assert_results_equal(jres() if callable(jres) else jres,
                                  tres() if callable(tres) else tres, f"{cycle} {pool}")
            for side in sides:
                b = side["b"][pool]
                b.remove_many(list(jout.scheduled))
                b.lease_many([side["ns"].RunningJob(job=side["specs"][jid], node_id=node,
                                                    priority=1000)
                              for jid, node in sorted(jout.scheduled.items())])
                for jid in jout.preempted:
                    b.unlease(jid)


def _algo_run(ns, monkeypatch, parallel, seed):
    monkeypatch.setenv("ARMADA_POOL_PARALLEL", "1" if parallel else "0")
    return MultiPoolWorld(ns, 4, True, seed).run()


def test_fair_scheduling_algo_with_commit_k_8(monkeypatch):
    """FairSchedulingAlgo over a churning four-pool JobDb with
    ARMADA_COMMIT_K=8, as tests/test_pool_parallel.py runs it: the port's
    serial and pool-parallel arms equal the JAX package's decisions, and
    the single-commit run's."""
    monkeypatch.setenv("ARMADA_COMMIT_K", "8")
    want = _algo_run(_Jax, monkeypatch, False, seed=1)
    serial = _algo_run(_Port, monkeypatch, False, seed=1)
    t_pool_serving.reset_pool_serving_stats()
    parallel = _algo_run(_Port, monkeypatch, True, seed=1)
    assert serial == want
    assert parallel == serial
    assert t_pool_serving.pool_serving_stats().snapshot()["stacked_launches"] > 0
    monkeypatch.setenv("ARMADA_COMMIT_K", "1")
    assert _algo_run(_Port, monkeypatch, False, seed=1) == serial
