"""Two repairs of the round, held on the CPU against the JAX package.

- Widths.  The card's round takes any commit_k and batch_k the JAX package
  runs (above 16 the wide instantiations, whose tables live in scratch
  sized by the width; a width beyond the card's memory raises with the
  bytes it needs).  Their plain version -- the arithmetic the kernel is
  held to on the card -- equals the JAX round at commit_k 32 and at
  batch_k 32 in every RoundResult field, kernel_iters included, solo and
  stacked.
- The round's own water-fill at a queue axis Q that is not a multiple of
  32: a shape bucket of Q (25..31 and 33..63) pads the queue axis to Q,
  and the plain round equals the JAX round in every field on a world whose
  eviction gate reads the fair shares.
"""

import functools

import numpy as np
import pytest

from armada_tpu.core.types import Queue, RunningJob
from armada_tpu.models import build_problem as jax_build_problem
from armada_tpu.models.fair_scheduler import schedule_round as jax_round
from armada_tpu.models.fair_scheduler import schedule_round_stacked as jax_round_stacked
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu_torch.models.fair_scheduler import (
    round_statics,
    schedule_round,
    schedule_round_stacked,
)
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from test_round_scheduler import job, make_config, node

UNCACHED = dict(cache_slots=0, batch_k=1, unroll=1)
# 40 queues, so that commit_k 32 is not clamped to Q
WIDE_WORLD = dict(num_nodes=96, num_gangs=1_500, num_queues=40, num_runs=60,
                  global_burst=600, perq_burst=600, max_gang_cardinality=1, seed=11)
WIDE = 32


@functools.lru_cache(maxsize=None)
def _wide_problem():
    return jax_synthetic(**WIDE_WORLD)


def _assert_equal(ref, got, what):
    for name, a, b in zip(got._fields, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}.{name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("statics", [dict(commit_k=WIDE), dict(batch_k=WIDE)],
                         ids=["commit_k", "batch_k"])
def test_wide_round_equals_jax(statics):
    problem, meta = _wide_problem()
    jax_statics = dict(UNCACHED, **statics)
    ref = jax_round(problem, **meta, **jax_statics)
    got = result_to_numpy(schedule_round(problem, **meta, **jax_statics, device="cpu"))
    _assert_equal(ref, got, str(statics))
    assert int(got.kernel_iters) < int(got.iterations) // 2  # the width really batched
    # no clamp: the statics resolve to the width asked for
    p = problem_from_numpy(problem, "cpu")
    resolved = round_statics(p, **jax_statics)
    assert resolved["commit_k"] == statics.get("commit_k", 1)
    assert resolved["batch_k"] == statics.get("batch_k", 1)


def test_wide_scratch_beyond_the_card_raises_with_the_bytes(monkeypatch):
    """The wrapper sizes the wide tables by the width and, where the card
    has fewer bytes free, raises and names the bytes; below that it hands
    back the per-lane sizes.  The card's free memory and the library's
    sizes are stood in for here; chip_smoke.py drives it on the card."""
    import torch

    from armada_tpu_torch.kernels import round as round_kernel

    sizes = (10, 1 << 30, 1 << 31)  # ints, floats, bytes a lane
    need = 3 * (4 * sizes[0] + 4 * sizes[1] + sizes[2])
    monkeypatch.setattr(round_kernel, "wide_need", lambda commit_k, batch_k: sizes)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (need - 1, 1 << 40))
    with pytest.raises(RuntimeError, match=f"commit_k=40000, batch_k=1 needs {need} bytes"):
        round_kernel.wide_scratch(3, 40_000, 1, "cuda:0")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (need, 1 << 40))
    assert round_kernel.wide_scratch(3, 40_000, 1, "cuda:0") == sizes


def test_wide_round_stacked_equals_jax():
    """Three lanes at commit_k 32: every lane equals the JAX stacked round."""
    problem, meta = _wide_problem()
    rng = np.random.default_rng(5)
    lanes = []
    for i in range(3):
        w = np.roll(problem.q_weight, i)
        ok = problem.node_ok & (rng.random(problem.node_ok.shape[0]) > 0.05 * i)
        lanes.append(problem._replace(q_weight=w, node_ok=ok))
    stacked = type(problem)(*(np.stack(f) for f in zip(*lanes)))
    statics = dict(UNCACHED, commit_k=WIDE)
    ref = jax_round_stacked(stacked, **meta, **statics)
    got = result_to_numpy(schedule_round_stacked(problem_from_numpy(stacked, "cpu"), **meta,
                                                 **statics))
    _assert_equal(ref, got, "stacked commit_k=32")


def _waterfill_world(Q: int):
    """Q - 2 queues of varied weights (bucket Q pads the queue axis to Q),
    preemptible runs spread over them and a backlog in every queue: the
    eviction gate compares each queue's share with its water-filled fair
    share."""
    cfg = make_config(shape_bucket=Q, protected_fraction_of_fair_share=0.7)
    rng = np.random.default_rng(Q)
    nq = Q - 2
    nodes = [node(cfg, f"n{i}", cpu="8", memory="32Gi") for i in range(10)]
    queues = [Queue(f"q{i:02d}", weight=float(rng.choice([0.5, 1.0, 2.0, 3.0]))) for i in range(nq)]
    running, jobs = [], []
    for i in range(60):
        q = queues[int(rng.integers(0, nq))].name
        running.append(RunningJob(job(cfg, f"r{i}", q, cpu="1", pc="p0"), node_id=f"n{i % 10}"))
    for i, q in enumerate(queues):
        for k in range(1 + i % 4):
            jobs.append(job(cfg, f"j{i}-{k}", q.name, cpu=str(1 + k % 2), pc="p1"))
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running)
    return problem, dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                         slot_width=ctx.slot_width)


@pytest.mark.parametrize("Q", [q for q in range(25, 64) if q != 32])
def test_round_waterfill_at_q_not_a_multiple_of_32(Q):
    problem, meta = _waterfill_world(Q)
    assert problem.q_weight.shape[0] == Q
    ref = jax_round(problem, **meta, **UNCACHED)
    got = result_to_numpy(schedule_round(problem, **meta, device="cpu"))
    _assert_equal(ref, got, f"Q={Q}")
    assert int(got.scheduled_count) > 0
    assert got.run_evicted.any()  # the gate read the fair shares
