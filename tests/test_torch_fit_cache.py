"""K11, the placement loop's decision-neutral bodies, in the port's plain
round against the JAX package's round on the CPU: the per-key fit cache
(cache_slots > 0), the certified pick chain (batch_k > 1) and unroll, solo,
stacked and through the entry points.

The same numpy problems go to `armada_tpu.models.fair_scheduler.
schedule_round` and to the port's `schedule_round(device="cpu")` with the
same statics.  Every RoundResult field must be equal, f32 bit for bit,
kernel_iters included, and so must the packed decode buffers.  Small cache
slot counts (4) make keys collide, so misses and overwrites happen.
"""

import dataclasses

import numpy as np
import pytest

import armada_tpu.models as jm
import armada_tpu_torch.models as tm
from armada_tpu.core.config import PoolConfig
from armada_tpu.models import build_problem as jax_build_problem
from armada_tpu.models.fair_scheduler import compact_result as jax_compact
from armada_tpu.models.fair_scheduler import schedule_round as jax_round
from armada_tpu.models.fair_scheduler import schedule_round_stacked as jax_round_stacked
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu_torch.models.fair_scheduler import (
    TERM_MAX_ITER,
    block_size,
    compact_result,
    round_statics,
    schedule_round,
    schedule_round_stacked,
)
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from test_parity_full import CFG as PARITY_CFG
from test_parity_full import world
from test_torch_loop_shapes import _assert_equal, _lanes, _synthetic
from test_torch_loop_shapes_entry import _algo_run
from test_torch_pool_parallel import _fresh_state, _Port  # noqa: F401 (autouse resets)
from test_torch_round import _world_case

UNCACHED = dict(cache_slots=0, batch_k=1, unroll=1, commit_k=1)
# a burst of singles over few keys: hits, collisions at 4 slots, long chains
BURST = dict(num_nodes=200, num_gangs=2000, num_queues=16, num_runs=0, global_burst=600,
             perq_burst=600, seed=3, max_gang_cardinality=1)


def _compare(problem, meta, what, **statics):
    """JAX round vs the port's plain round at the same statics, every field
    and the packed decode buffer."""
    kw = dict(UNCACHED, **statics)
    ref = jax_round(problem, **meta, **kw)
    port = schedule_round(problem, **meta, **kw, device="cpu")
    got = result_to_numpy(port)
    _assert_equal(ref, got, what)
    G, RJ = problem.g_req.shape[0], problem.run_req.shape[0]
    fcap, ecap = min(G, 64), min(RJ, 64)
    jbuf = np.asarray(jax_compact(ref, np.int32(G), np.int32(RJ), fcap=fcap, ecap=ecap))
    tbuf = compact_result(port, G, RJ, fcap=fcap, ecap=ecap).numpy()
    np.testing.assert_array_equal(jbuf, tbuf, err_msg=f"{what}: compact buffer")
    return got


def _burst():
    return jax_synthetic(**BURST)


def _world_problem(kind, seed):
    cfg, (nodes, queues, jobs, running), prices = _world_case(kind, seed)
    bid = (lambda j: prices.get(j.queue, 0.0)) if prices else None
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running, bid_price_of=bid)
    meta = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                slot_width=ctx.slot_width)
    return problem, meta


# --- the statics ---------------------------------------------------------------------------


def test_statics_resolve_as_in_the_jax_package(monkeypatch):
    problem, _ = jax_synthetic(num_nodes=60, num_gangs=200, num_queues=8, num_runs=0, seed=4)
    p = problem_from_numpy(problem, "cpu")
    K = int(p.compat.shape[0])
    for name in ("ARMADA_CACHE_SLOTS", "ARMADA_BATCH_K", "ARMADA_COMMIT_K"):
        monkeypatch.delenv(name, raising=False)
    # nothing armed: 0, 1, 1 on every device (the JAX package arms a
    # 64-slot cache on its CPU platform; decisions are the same)
    st = round_statics(p)
    assert (st["cache_slots"], st["batch_k"], st["unroll"], st["commit_k"]) == (0, 1, 1, 1)
    monkeypatch.setenv("ARMADA_CACHE_SLOTS", "64")
    assert round_statics(p)["cache_slots"] == min(64, K)  # clamped to the compat rows
    monkeypatch.setenv("ARMADA_BATCH_K", "8")
    assert round_statics(p)["batch_k"] == 1  # the cache forces batch_k = 1
    monkeypatch.setenv("ARMADA_CACHE_SLOTS", "0")
    assert round_statics(p)["batch_k"] == 8
    assert round_statics(p, prefer_large=True)["batch_k"] == 1
    assert round_statics(p, commit_k=4)["batch_k"] == 1  # commit_k wins
    assert round_statics(p, cache_slots=100)["cache_slots"] == 100  # an argument is not clamped
    assert round_statics(p, unroll=4)["unroll"] == 4
    assert block_size(57_344) == 64 and block_size(50_000) == 16 and block_size(7) == 1


# --- the per-key fit cache -----------------------------------------------------------------------


@pytest.mark.parametrize("slots", [4, 64])
def test_fit_cache_burst(slots):
    problem, meta = _burst()
    got = _compare(problem, meta, f"burst cache_slots={slots}", cache_slots=slots)
    assert int(got.kernel_iters) == int(got.iterations) and int(got.n_slots) > 0


@pytest.mark.parametrize("seed", [1])
def test_fit_cache_odd_weights(seed):
    """Packing-score weights that are not powers of two, so that the f32
    association of the cached scores decides near-ties: the port's cached
    round equals the JAX package's cached round, and decides as its
    uncached one."""
    problem, meta = jax_synthetic(num_nodes=300, num_gangs=2000, num_queues=8, num_runs=100,
                                  global_burst=5000, perq_burst=5000, seed=seed,
                                  max_gang_cardinality=1)
    rng = np.random.default_rng(seed)
    inv = (1.0 / rng.integers(3, 1000, size=problem.inv_scale.shape)).astype(np.float32)
    problem = problem._replace(inv_scale=inv)
    got = _compare(problem, meta, f"odd weights seed {seed}", cache_slots=16)
    base = result_to_numpy(schedule_round(problem, **meta, **UNCACHED, device="cpu"))
    _assert_equal(base, got, f"odd weights seed {seed}: cached vs uncached")


@pytest.mark.parametrize("case", ["commit_k", "prefer_large", "hetero"])
def test_fit_cache_with_loop_shapes(case):
    """The cache beside K10 (16 slots), prefer-large and the node-type bias
    (TR > 1: type-sensitive singles take the general path)."""
    problem, meta = _synthetic("hetero" if case == "hetero" else "cached")
    statics = dict(cache_slots=4)
    if case == "commit_k":
        statics = dict(cache_slots=16, commit_k=8)
    elif case == "prefer_large":
        statics["prefer_large"] = True
    got = _compare(problem, meta, f"{case} {statics}", **statics)
    if "commit_k" in statics:
        assert int(got.kernel_iters) < int(got.iterations)


@pytest.mark.parametrize("kind,seed,slots", [("evict", 2, 4), ("market", 4, 4)])
def test_fit_cache_parity_worlds(kind, seed, slots):
    """Evictees (pinned, never cached) and a market pool (bid order, the
    spot price)."""
    problem, meta = _world_problem(kind, seed)
    got = _compare(problem, meta, f"{kind} {seed} cache_slots={slots}", cache_slots=slots)
    if kind == "evict":
        assert got.run_evicted.any()
    assert int(got.n_slots) > 0


# --- the certified pick chain ----------------------------------------------------------------------


@pytest.mark.parametrize("case,batch_k", [("burst", 2), ("burst", 8), ("fewq", 4),
                                          ("cached", 4), ("hetero", 4), ("evict", 4),
                                          ("market", 4)])
def test_pick_chain(case, batch_k):
    """Singles (long same-key chains), gangs among singles with evictions,
    TR > 1 (biased picks in the chain), evictees replayed on their pinned
    nodes, and a market round (bid keys, the spot price in the chain): the
    same logical steps in fewer trips.  Four queues make long same-queue
    chains that reach the end of the cursor window."""
    if case == "burst":
        problem, meta = _burst()
    elif case == "fewq":
        problem, meta = jax_synthetic(**dict(BURST, num_queues=4, seed=5))
    elif case in ("cached", "hetero"):
        problem, meta = _synthetic(case)
    else:
        problem, meta = _world_problem(case, 5 if case == "evict" else 8)
    got = _compare(problem, meta, f"{case} batch_k={batch_k}", batch_k=batch_k)
    assert int(got.kernel_iters) < int(got.iterations)


def test_pick_chain_at_the_iteration_bound():
    problem, meta = _burst()
    got = _compare(problem, meta, "burst batch_k=2 max_iterations=37", batch_k=2,
                   max_iterations=37)
    assert int(got.termination) == TERM_MAX_ITER and int(got.iterations) == 37


# --- unroll --------------------------------------------------------------------------------------------


@pytest.mark.parametrize("statics", [dict(unroll=4, max_iterations=41),
                                     dict(unroll=3, cache_slots=4)])
def test_unroll(statics):
    """unroll reads the loop condition every `unroll` steps; the steps past
    the end are no-ops, so nothing changes, kernel_iters included."""
    problem, meta = _burst()
    got = _compare(problem, meta, f"burst {statics}", **statics)
    if "max_iterations" in statics:
        assert int(got.iterations) == 41 and int(got.kernel_iters) == 41


# --- the stacked round ------------------------------------------------------------------------------


@pytest.mark.parametrize("statics", [dict(cache_slots=4, unroll=2), dict(batch_k=4)])
def test_stacked_round_k11(statics):
    """schedule_round_stacked with each static, every lane with its own
    cache: lane by lane equal to JAX's stacked round (vmap)."""
    base, meta = jax_synthetic(num_nodes=80, num_gangs=300, num_queues=16, num_runs=30,
                               global_burst=200, perq_burst=40, seed=7, max_gang_cardinality=2)
    stacked, _ = _lanes(base, 3)
    kw = dict(UNCACHED, **statics)
    ref = jax_round_stacked(stacked, **meta, **kw)
    got = result_to_numpy(schedule_round_stacked(problem_from_numpy(stacked, "cpu"), **meta,
                                                 **kw))
    _assert_equal(ref, got, f"stacked {statics}")


# --- the entry points ----------------------------------------------------------------------------------


def _both(cfg, **kw):
    ref = jm.run_scheduling_round(cfg, pool="default", collect_stats=False, **kw)
    got = tm.run_scheduling_round(cfg, pool="default", collect_stats=False, device="cpu", **kw)
    for name in ("scheduled", "rescheduled", "unwound_groups", "termination", "num_iterations",
                 "spot_price", "kernel_iters"):
        assert getattr(got, name) == getattr(ref, name), name
    assert sorted(got.preempted) == sorted(ref.preempted)
    assert list(got.failed) == list(ref.failed)
    return got


@pytest.mark.parametrize("env", [dict(ARMADA_CACHE_SLOTS="64"),
                                 dict(ARMADA_CACHE_SLOTS="0", ARMADA_BATCH_K="8")])
def test_run_scheduling_round_with_armed_environment(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = dataclasses.replace(PARITY_CFG, protected_fraction_of_fair_share=0.0)
    nodes, queues, jobs, running = world(17, num_nodes=60, num_jobs=200, num_running=40,
                                         gangs=3)
    got = _both(cfg, nodes=nodes, queues=queues, queued_jobs=jobs, running=running)
    assert got.scheduled
    if "ARMADA_BATCH_K" in env:
        assert got.kernel_iters < got.num_iterations


def test_fair_scheduling_algo_with_armed_environment(monkeypatch):
    """FairSchedulingAlgo over a churning four-pool JobDb (seed 1, the world
    that tests/test_torch_loop_shapes_entry.py holds against the JAX
    package): the port's pool-parallel arm with the pick chain armed
    (stacked lanes) and its serial arm with the cache armed decide as its
    unarmed serial arm."""
    for name in ("ARMADA_CACHE_SLOTS", "ARMADA_BATCH_K", "ARMADA_COMMIT_K"):
        monkeypatch.delenv(name, raising=False)
    want = _algo_run(_Port, monkeypatch, False, seed=1)
    monkeypatch.setenv("ARMADA_BATCH_K", "8")
    assert _algo_run(_Port, monkeypatch, True, seed=1) == want
    monkeypatch.setenv("ARMADA_CACHE_SLOTS", "64")
    assert _algo_run(_Port, monkeypatch, False, seed=1) == want


def test_market_pool_with_the_cache_through_the_entry_point(monkeypatch):
    monkeypatch.setenv("ARMADA_CACHE_SLOTS", "4")
    cfg = dataclasses.replace(
        PARITY_CFG, pools=(PoolConfig("default", market_driven=True, spot_price_cutoff=0.1),))
    rng = np.random.default_rng(4)
    nodes, queues, jobs, running = world(4, num_nodes=40, num_jobs=200, num_running=0, gangs=0)
    prices = {q.name: float(rng.integers(1, 10)) for q in queues}
    got = _both(cfg, nodes=nodes, queues=queues, queued_jobs=jobs, running=running,
                bid_price_of=lambda j: prices.get(j.queue, 0.0))
    assert got.scheduled


def test_kernel_wrapper_refuses_shapes_it_does_not_hold():
    """The round kernel's wrapper names its limits before it touches the
    card: batch_k above MAX_BATCH_K on the sharded round (the wide chain
    runs solo and stacked only), and the chain beside the cache, commit_k or
    prefer-large (round_statics never resolves those)."""
    from armada_tpu_torch.kernels import round as kernel_round

    problem, meta = _burst()
    p = problem_from_numpy(problem, "cpu")
    kw = dict(meta, max_iterations=100, prefer_large=False, commit_k=1)
    with pytest.raises(ValueError, match="wide"):
        kernel_round._launch(p, 0, **kw, batch_k=kernel_round.MAX_BATCH_K + 1, shards=2)
    for bad in (dict(cache_slots=4), dict(commit_k=4)):
        with pytest.raises(ValueError, match="batch_k > 1"):
            kernel_round._launch(p, 0, **dict(kw, **bad), batch_k=8)
