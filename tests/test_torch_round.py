"""The port's plain scheduling round against the JAX package's round.

Identical numpy problems go to `armada_tpu.models.fair_scheduler.
schedule_round` -- called with the single-commit uncached loop shape
(cache_slots=0, batch_k=1, commit_k=1, unroll=1; the other shapes are in
tests/test_torch_loop_shapes.py) -- and to
`armada_tpu_torch.models.fair_scheduler.schedule_round(device="cpu")`.
Every RoundResult field except kernel_iters must be equal, f32 fields bit
for bit, and so must the packed decode buffers.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from armada_tpu.core.config import PoolConfig
from armada_tpu.models import build_problem as jax_build_problem
from armada_tpu.models.fair_scheduler import compact_result as jax_compact
from armada_tpu.models.fair_scheduler import schedule_round as jax_round
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu_torch.models.fair_scheduler import (
    compact_result,
    move_runs_to_evicted,
    round_prologue,
    schedule_round,
)
from armada_tpu_torch.ops.fit import allocatable_from_used
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from armada_tpu_torch.models.synthetic import variety_world
from test_parity_full import CAP_CFG, CFG, world

UNCACHED = dict(cache_slots=0, batch_k=1, commit_k=1, unroll=1)


def _compare(problem, meta, num_real_gangs, num_real_runs):
    ref = [np.asarray(x) for x in jax_round(problem, **meta, **UNCACHED)]
    res = schedule_round(problem, **meta, device="cpu")
    got = result_to_numpy(res)
    for name, a, b in zip(got._fields, ref, got):
        if name == "kernel_iters":
            continue
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    G, RJ = problem.g_req.shape[0], problem.run_req.shape[0]
    fcap, ecap = min(G, 64), min(RJ, 64)
    jbuf = np.array(jax_compact(
        jax_round(problem, **meta, **UNCACHED), np.int32(num_real_gangs),
        np.int32(num_real_runs), fcap=fcap, ecap=ecap,
    ))
    tbuf = compact_result(res, num_real_gangs, num_real_runs, fcap=fcap, ecap=ecap).numpy()
    # word 8 is kernel_iters (physical loop trips), the one field outside parity
    jbuf[8] = tbuf[8]
    np.testing.assert_array_equal(jbuf, tbuf)
    return got


SYNTH = dict(num_nodes=150, num_gangs=400, num_queues=64, num_runs=80, global_burst=10_000,
             perq_burst=30)


@pytest.mark.parametrize("seed,card", [(0, 8), (1, 8), (2, 8), (3, 8), (4, 1)])
def test_round_synthetic(seed, card):
    problem, meta = jax_synthetic(**SYNTH, max_gang_cardinality=card, seed=seed)
    got = _compare(problem, meta, 400, 80)
    assert int(got.n_slots) > 0


def _market():
    return dataclasses.replace(CFG, pools=(PoolConfig("default", market_driven=True),))


def _world_case(kind, seed):
    if kind == "gangs":
        return CFG, world(seed), None
    if kind == "evict":
        cfg = dataclasses.replace(CFG, protected_fraction_of_fair_share=0.0)
        return cfg, world(seed, num_nodes=120, num_jobs=150, num_running=60, gangs=0), None
    if kind == "away":
        return CFG, world(seed, num_nodes=60, num_jobs=400, num_running=80, gangs=0,
                          away_frac=1.0), None
    if kind == "market":
        rng = np.random.default_rng(seed)
        w = world(seed, num_nodes=40, num_jobs=200, num_running=0, gangs=0)
        prices = {q.name: float(rng.integers(1, 10)) for q in w[1]}
        return _market(), w, prices
    if kind == "pccap":
        return CAP_CFG, world(seed, num_nodes=60, num_jobs=250, num_running=30, gangs=0), None
    raise ValueError(kind)


WORLDS = [("gangs", 1), ("gangs", 2), ("evict", 2), ("evict", 5), ("away", 3),
          ("away", 7), ("market", 4), ("market", 8), ("pccap", 6), ("pccap", 12)]


@pytest.mark.parametrize("kind,seed", WORLDS)
def test_round_parity_worlds(kind, seed):
    cfg, (nodes, queues, jobs, running), prices = _world_case(kind, seed)
    bid = (lambda job: prices.get(job.queue, 0.0)) if prices else None
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running, bid_price_of=bid)
    meta = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                slot_width=ctx.slot_width)
    got = _compare(problem, meta, ctx.num_real_gangs, ctx.num_real_runs)
    if kind == "evict":
        assert got.run_evicted.any()


@pytest.mark.parametrize("seed,market", [(1, False), (2, True), (3, False)])
def test_round_variety_worlds(seed, market):
    """The branch-covering world (bans, zones, taints, a
    floating resource, caps, away runs, eviction, spot crossing), small."""
    config, kw = variety_world(seed, market=market, num_nodes=70)
    problem, ctx = jax_build_problem(config, **kw)
    meta = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                slot_width=ctx.slot_width)
    got = _compare(problem, meta, ctx.num_real_gangs, ctx.num_real_runs)
    assert int(got.termination) == 2  # the round cap tripped
    assert got.run_evicted.any()
    assert (float(got.spot_price) > 0) == market


@pytest.mark.parametrize("seed", [0, 1])
def test_prologue_scatter_order_is_irrelevant(seed):
    """The prologue's scatter-adds of running usage are exact in any order
    (integral resolution units) -- what lets the CUDA kernel use atomics."""
    cfg, (nodes, queues, jobs, running), _ = _world_case("evict", 2 + seed)
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running)
    num_levels = len(ctx.ladder) + 2
    p = problem_from_numpy(problem, "cpu")
    alloc, q_alloc, q_alloc_pc, _, run_evicted, _ = round_prologue(p, num_levels)
    # the same sums, accumulated one run at a time in a shuffled order
    order = list(range(p.run_req.shape[0]))
    random.Random(seed).shuffle(order)
    N, R = p.node_total.shape
    used = torch.zeros((num_levels, N, R))
    qa = torch.zeros_like(q_alloc)
    for j in order:
        if bool(p.run_valid[j]):
            used[int(p.run_level[j]), int(p.run_node[j])] += p.run_req[j] * p.node_axes
            qa[int(p.run_queue[j])] += p.run_req[j]
    alloc2 = allocatable_from_used(p.node_total, used)
    alloc2, qa, _ = move_runs_to_evicted(alloc2, qa, q_alloc_pc, p,
                                         run_evicted.to(torch.float32), num_levels)
    assert torch.equal(alloc, alloc2)
    assert torch.equal(q_alloc, qa)


def test_problem_from_numpy_keeps_fields():
    """Same field names, dtypes and shapes on both sides of the boundary
    (0-d scalars included), and result_to_numpy is its inverse for results."""
    problem, meta = jax_synthetic(**SYNTH, max_gang_cardinality=3, seed=5)
    p = problem_from_numpy(problem, "cpu")
    for name in problem._fields:
        a, t = np.asarray(getattr(problem, name)), getattr(p, name)
        assert tuple(t.shape) == a.shape, name
        assert t.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    res = schedule_round(p, **meta, device="cpu")
    back = result_to_numpy(res)
    for name in res._fields:
        np.testing.assert_array_equal(back[res._fields.index(name)],
                                      getattr(res, name).numpy(), err_msg=name)
    assert back.iterations.shape == ()


def test_unported_statics_raise():
    """K11's decision-neutral variants (the per-key fit cache, the batch_k
    pick chain, unroll) are ported now: each runs and equals the JAX
    package's round at the same statics, kernel_iters included (the rest
    of K11 is in tests/test_torch_fit_cache.py)."""
    problem, meta = jax_synthetic(**SYNTH, max_gang_cardinality=1, seed=0)
    for kw in (dict(batch_k=8), dict(cache_slots=64), dict(unroll=2)):
        statics = dict(UNCACHED, **kw)
        ref = jax_round(problem, **meta, **statics)
        got = result_to_numpy(schedule_round(problem, **meta, **statics, device="cpu"))
        for name, a, b in zip(got._fields, ref, got):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{kw} {name}")
        assert int(got.n_slots) > 0


def test_round_adversarial_windows():
    """The placement loop's 16-entry cursor window at its edges
    (models/synthetic.py adversarial_windows: whole windows of a bad key,
    bad keys in mid-window, queues shorter than the window, windows that
    cross q_len), the plain round against the JAX package's."""
    from armada_tpu_torch.models.synthetic import adversarial_windows

    problem, meta = jax_synthetic(num_nodes=60, num_gangs=600, num_queues=40, num_runs=30,
                                  global_burst=500, perq_burst=500, seed=3)
    problem = adversarial_windows(problem)
    got = _compare(problem, meta, 600, 30)
    assert int(got.n_slots) > 0
    bad = int(problem.compat.shape[0]) - 1
    assert (np.asarray(got.g_state)[np.asarray(problem.g_key) == bad] == 2).any()


def _capacity(clusters_at_16: int = 8):
    """A card's cluster capacity as cudaOccupancyMaxActiveClusters answers
    it on one CTA an SM: clusters_at_16 x 16 SMs in whole clusters."""
    return lambda s: (clusters_at_16 * 16) // s


@pytest.mark.parametrize("case", ["largest", "wide", "untiled cache", "lanes", "cpu", "none"])
def test_cluster_size_owner(case):
    """kernels/round.py choose_cluster_size, the one owner of the
    placement loop's cluster size, as a pure function of N, the lanes, the
    loop shape and the capacity it is handed."""
    from armada_tpu_torch.kernels.round import MAX_CLUSTER, choose_cluster_size
    from armada_tpu_torch.models.fair_scheduler import block_size

    cap = _capacity()
    pick = lambda N, P=1, **kw: choose_cluster_size(N, P, capacity=cap, device="cuda", **kw)  # noqa: E731
    if case == "largest":
        assert pick(57_344) == MAX_CLUSTER == 16
        assert pick(6_144) == 16 and pick(2_000) == 16 and pick(48) == 16
        assert pick(7 * 11 * 13) == 13  # the largest divisor of N up to 16
    elif case == "wide":
        for kw in (dict(commit_k=17), dict(batch_k=17), dict(commit_k=64)):
            assert pick(57_344, **kw) == 1
        assert pick(57_344, commit_k=16) == 16 and pick(57_344, batch_k=16) == 16
    elif case == "untiled cache":
        # N / S must stay a multiple of the cache's block
        for N in (2_000, 48, 6_144, 57_344, 64):
            s = pick(N, cache_slots=8)
            assert s <= pick(N) and N % s == 0 and (N // s) % block_size(N) == 0
        assert pick(2_000, cache_slots=8) == 5 < pick(2_000)
        assert pick(64, cache_slots=8) == 1
    elif case == "lanes":
        for P in (1, 7, 8, 9, 20, 64, 200):
            s = pick(6_144, P)
            assert s == 1 or cap(s) >= P, (P, s)  # P clusters of S fit at once
            bigger = [t for t in range(s + 1, MAX_CLUSTER + 1) if 6_144 % t == 0]
            assert all(cap(t) < P for t in bigger), (P, s)
        assert pick(6_144, 9) == 12 and pick(6_144, 200) == 1
    elif case == "cpu":
        assert choose_cluster_size(57_344, 1, capacity=cap, device="cpu") == 1
    elif case == "none":
        assert choose_cluster_size(57_344, 1, capacity=lambda s: 0, device="cuda") == 1
