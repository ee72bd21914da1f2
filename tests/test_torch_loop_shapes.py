"""The placement loop's remaining shapes in the port's plain round, against
the JAX package's round on the CPU: the multi-commit extension
(commit_k > 1), the node-type bias (TR > 1) and prefer-large ordering, solo
and stacked.

The same numpy problems go to `armada_tpu.models.fair_scheduler.
schedule_round` (cache_slots=0, batch_k=1, unroll=1 unless a case says
otherwise) and to the port's `schedule_round(device="cpu")`.  Every
RoundResult field must be equal, f32 bit for bit, kernel_iters included at
the same commit_k: a port that never extended would match on decisions
alone.  The entry points (run_scheduling_round, FairSchedulingAlgo) are in
tests/test_torch_loop_shapes_entry.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from armada_tpu.core.config import PoolConfig
from armada_tpu.core.types import Queue
from armada_tpu.models import build_problem as jax_build_problem
from armada_tpu.models.fair_scheduler import compact_result as jax_compact
from armada_tpu.models.fair_scheduler import schedule_round as jax_round
from armada_tpu.models.fair_scheduler import schedule_round_stacked as jax_round_stacked
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu_torch.kernels import round as kernel_round
from armada_tpu_torch.models.fair_scheduler import (
    TERM_MAX_ITER,
    compact_result,
    round_statics,
    schedule_round,
    schedule_round_stacked,
)
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from test_round_scheduler import job, make_config, node
from test_torch_round import _world_case

UNCACHED = dict(cache_slots=0, batch_k=1, unroll=1)

# tests/test_round_scheduler.py's burst problem (test_multi_commit_shrinks_
# burst_iterations) and its cached-mode problem (test_multi_commit_bit_
# exact_both_cache_modes); tests/test_hetero.py's type-sensitive problem
# (test_hetero_cache_and_commit_k_bit_equal)
BURST = dict(num_nodes=400, num_gangs=8000, num_queues=32, num_runs=0, global_burst=2000,
             perq_burst=2000, seed=3, max_gang_cardinality=1)
CACHED_MODE = dict(num_nodes=400, num_gangs=4000, num_queues=16, num_runs=300, global_burst=250,
                   perq_burst=60, seed=0, max_gang_cardinality=3)
HETERO = dict(num_nodes=64, num_gangs=300, num_queues=8, num_runs=40, num_node_types=4,
              type_sensitive_frac=0.5, global_burst=200, perq_burst=60, seed=3,
              max_gang_cardinality=3)


@functools.lru_cache(maxsize=None)
def _synthetic(name):
    return jax_synthetic(**{"burst": BURST, "cached": CACHED_MODE, "hetero": HETERO}[name])


def _assert_equal(ref, got, what):
    for name, a, b in zip(got._fields, ref, got):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}.{name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")


def _compare(problem, meta, what, jax_statics=None, **statics):
    """JAX round vs the port's plain round, every field; and the packed
    decode buffers, kernel_iters word included.  `jax_statics` overrides
    the JAX side's loop shape (its cached body, for one case)."""
    ref = jax_round(problem, **meta, **(jax_statics or UNCACHED), **statics)
    port = schedule_round(problem, **meta, **statics, device="cpu")
    got = result_to_numpy(port)
    _assert_equal(ref, got, what)
    G, RJ = problem.g_req.shape[0], problem.run_req.shape[0]
    fcap, ecap = min(G, 64), min(RJ, 64)
    jbuf = np.asarray(jax_compact(ref, np.int32(G), np.int32(RJ), fcap=fcap, ecap=ecap))
    tbuf = compact_result(port, G, RJ, fcap=fcap, ecap=ecap).numpy()
    np.testing.assert_array_equal(jbuf, tbuf, err_msg=f"{what}: compact buffer")
    return got


# --- the multi-commit extension ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _burst_at(commit_k):
    problem, meta = _synthetic("burst")
    return _compare(problem, meta, f"burst K={commit_k}", commit_k=commit_k)


@pytest.mark.parametrize("commit_k", [1, 2, 4, 8])
def test_burst_problem_at_every_commit_k(commit_k):
    got = _burst_at(commit_k)
    base = _burst_at(1)
    # the same logical steps at every K; the trips shrink
    assert int(got.iterations) == int(base.iterations) == int(base.kernel_iters)
    assert int(got.n_slots) == int(base.n_slots) > 0
    if commit_k == 8:
        assert 2 * int(got.kernel_iters) <= int(base.kernel_iters), \
            (int(got.kernel_iters), int(base.kernel_iters))


@pytest.mark.parametrize("commit_k", [1, 2, 4, 8])
def test_cached_mode_problem_at_every_commit_k(commit_k):
    """The JAX side runs its per-key fit cache (16 slots), the port its
    uncached body: the cache changes neither decisions nor trips."""
    problem, meta = _synthetic("cached")
    got = _compare(problem, meta, f"cached-mode K={commit_k}",
                   jax_statics=dict(cache_slots=16, batch_k=1, unroll=1), commit_k=commit_k)
    if commit_k > 1:
        assert int(got.kernel_iters) < int(got.iterations)


@pytest.mark.parametrize("commit_k", [1, 4, 8])
def test_hetero_problem_at_every_commit_k(commit_k):
    """TR > 1: the head's biased packing score, and extension lanes that
    truncate at type-sensitive picks."""
    problem, meta = _synthetic("hetero")
    assert problem.type_bias.shape[0] > 1
    got = _compare(problem, meta, f"hetero K={commit_k}", commit_k=commit_k)
    assert int(got.n_slots) > 0


def test_market_round_keeps_its_trips():
    """Market rounds (bid order, spot crossing) never extend: at K = 8 the
    trip count equals K = 1's, on both sides (tests/test_round_scheduler.py
    test_multi_commit_market_rounds_bypass's world)."""
    cfg = dataclasses.replace(
        make_config(),
        pools=(PoolConfig("default", market_driven=True, spot_price_cutoff=0.1),),
    )
    nodes = [node(cfg, f"n{i}", cpu="8", memory="32Gi") for i in range(8)]
    queues = [Queue(f"q{i}", 1.0) for i in range(4)]
    prices = {f"q{i}": float(1 + i) for i in range(4)}
    jobs = [job(cfg, f"j{i:03d}", f"q{i % 4}", cpu="1", submit_time=float(i)) for i in range(60)]
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, bid_price_of=lambda j: prices[j.queue])
    meta = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                slot_width=ctx.slot_width)
    base = _compare(problem, meta, "market K=1", commit_k=1)
    got = _compare(problem, meta, "market K=8", commit_k=8)
    assert int(got.kernel_iters) == int(base.kernel_iters) == int(base.iterations)
    assert float(got.spot_price) >= 0


@pytest.mark.parametrize("max_iterations", [37, 400])
def test_small_iteration_bound_at_commit_k_8(max_iterations):
    """The extension's picks stop at the iteration bound, and the round
    ends with TERM_MAX_ITER at the same logical step as JAX's."""
    problem, meta = _synthetic("burst")
    got = _compare(problem, meta, f"burst K=8 max_iterations={max_iterations}", commit_k=8,
                   max_iterations=max_iterations)
    assert int(got.termination) == TERM_MAX_ITER
    assert int(got.iterations) == max_iterations
    assert int(got.kernel_iters) < max_iterations


# --- prefer-large ordering ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefer_large_synthetic_gangs(seed):
    problem, meta = jax_synthetic(num_nodes=150, num_gangs=400, num_queues=64, num_runs=80,
                                  global_burst=10_000, perq_burst=30, max_gang_cardinality=8,
                                  seed=seed)
    got = _compare(problem, meta, f"prefer-large seed {seed}", prefer_large=True)
    default = result_to_numpy(schedule_round(problem, **meta, device="cpu"))
    # the ordering changed what the round did
    assert not np.array_equal(got.g_state, default.g_state) or \
        not np.array_equal(got.slot_gang, default.slot_gang)


@pytest.mark.parametrize("kind,seed", [("evict", 2), ("evict", 5), ("gangs", 1)])
def test_prefer_large_worlds_with_evictees(kind, seed):
    """Parity worlds with eviction (evictee heads in the order) and gangs."""
    cfg, (nodes, queues, jobs, running), _ = _world_case(kind, seed)
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running)
    meta = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                slot_width=ctx.slot_width)
    got = _compare(problem, meta, f"prefer-large {kind} {seed}", prefer_large=True)
    if kind == "evict":
        assert got.run_evicted.any()


def test_prefer_large_forces_a_single_commit():
    """prefer_large re-ranks every queue per placement: commit_k resolves to
    1 whatever is asked, as in the JAX package."""
    problem, meta = jax_synthetic(num_nodes=60, num_gangs=200, num_queues=8, num_runs=0, seed=4)
    p = problem_from_numpy(problem, "cpu")
    assert round_statics(p, prefer_large=True, commit_k=8)["commit_k"] == 1
    assert round_statics(p, commit_k=64)["commit_k"] == 8  # clamped to Q
    got = _compare(problem, meta, "prefer-large K=8", prefer_large=True, commit_k=8)
    assert int(got.kernel_iters) == int(got.iterations)


# --- the stacked round ---------------------------------------------------------------------


def _lanes(base, P: int):
    """P lanes of one shape from one problem: queue weights rolled, nodes and
    gangs masked differently in each (numpy, as both packages take them)."""
    lanes = [base]
    for i in range(1, P):
        r = np.random.default_rng(100 + i)
        lanes.append(base._replace(
            q_weight=np.roll(base.q_weight, i),
            node_ok=base.node_ok & (r.random(base.node_ok.shape[0]) > 0.05 * i),
            g_valid=base.g_valid & (r.random(base.g_valid.shape[0]) > 0.1 * i),
        ))
    return type(base)(*(np.stack(f) for f in zip(*lanes))), lanes


@pytest.mark.parametrize("case", ["commit_k", "hetero", "prefer_large"])
def test_stacked_round_loop_shapes(case):
    """schedule_round_stacked with each new static: lane by lane equal to
    JAX's stacked round, and each lane to the port's solo round."""
    if case == "hetero":
        base, meta = jax_synthetic(**dict(HETERO, num_gangs=200))
        statics = dict(commit_k=4)
    else:
        base, meta = jax_synthetic(num_nodes=80, num_gangs=300, num_queues=16, num_runs=30,
                                   global_burst=200, perq_burst=40, seed=7,
                                   max_gang_cardinality=2)
        statics = dict(commit_k=8) if case == "commit_k" else dict(prefer_large=True)
    stacked, lanes = _lanes(base, 3)
    ref = jax_round_stacked(stacked, **meta, **UNCACHED, **statics)
    got = schedule_round_stacked(problem_from_numpy(stacked, "cpu"), **meta, **statics)
    _assert_equal(ref, result_to_numpy(got), f"stacked {case}")
    for i, lane in enumerate(lanes):
        solo = schedule_round(lane, **meta, **statics, device="cpu")
        for name in solo._fields:
            assert torch.equal(getattr(solo, name), getattr(got, name)[i]), f"lane {i}.{name}"
    if "commit_k" in statics:
        assert (got.kernel_iters < got.iterations).all()


# --- what stays refused ------------------------------------------------------------------


def test_kernel_refuses_a_commit_k_above_its_maximum():
    """The solo and stacked CUDA rounds take any commit_k (above
    MAX_COMMIT_K in the wide instantiations); the sharded round holds at
    most MAX_COMMIT_K picks, and above it the wrapper raises before it
    touches the problem (checked here on CPU tensors)."""
    problem, meta = jax_synthetic(num_nodes=20, num_gangs=60, num_queues=40, num_runs=0)
    p = problem_from_numpy(problem, "cpu")
    statics = round_statics(p, commit_k=kernel_round.MAX_COMMIT_K + 1)
    assert statics["commit_k"] == kernel_round.MAX_COMMIT_K + 1
    with pytest.raises(ValueError, match=str(kernel_round.MAX_COMMIT_K)):
        kernel_round._launch(p, 0, **meta, **statics, shards=2)
    # the plain version runs any width
    assert int(schedule_round(p, **meta, **statics, device="cpu").n_slots) > 0
