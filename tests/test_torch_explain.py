"""The port's explain pass (kernel K-J's plain version) against the JAX
package's.

- On rounds of small worlds (plain, market, branch-covering) the plain
  buffer equals the JAX `_explain_kernel_impl` buffer word for word, with
  the key and failed lists both uncapped and truncated by small kcap/fcap.
- Random inputs whose free-capacity sums pass 2^24 (fractional f32 values,
  several node types): frag_free and type_frag_free are bit-equal, so the
  reduction order is XLA:CPU's (windows of 32 with split padding; the
  scatter left to right), not a tolerance.
- The explain cadence through run_round_on_device: the decoded
  ExplainOutcome equals the JAX package's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from armada_tpu.models import explain as jax_explain_mod
from armada_tpu.models import run_round_on_device as jax_run_round
from armada_tpu.models.explain import _explain_kernel_impl
from armada_tpu_torch.models import explain as E
from armada_tpu_torch.models import run_round_on_device
from armada_tpu_torch.models.fair_scheduler import schedule_round
from armada_tpu_torch.models.problem import build_problem
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from armada_tpu_torch.models.synthetic import synthetic_world, variety_world


@functools.lru_cache(maxsize=None)
def _jax_kernel(kcap, fcap):
    return jax.jit(functools.partial(_explain_kernel_impl, kcap=kcap, fcap=fcap))


def _both(args, kcap, fcap):
    want = np.asarray(_jax_kernel(kcap, fcap)(*args))
    got = E.explain_kernel_plain(*[torch.as_tensor(np.array(a)) for a in args[:-1]],
                                 int(args[-1]), kcap=kcap, fcap=fcap).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _world(kind, seed):
    if kind == "synthetic":
        config, nodes, queues, specs, running, _ = synthetic_world(
            num_nodes=50, num_jobs=2500, num_queues=5, num_runs=60, seed=seed, shape_bucket=64)
        return build_problem(config, pool="default", nodes=nodes, queues=queues,
                             queued_jobs=specs, running=running)
    config, kw = variety_world(seed, num_nodes=70, market=kind == "market")
    return build_problem(config, **kw)


def _args(problem, r, num_real_gangs):
    p = problem
    return [np.asarray(x) for x in (
        p.compat, p.compat_pre_type, p.node_type, p.node_ok, p.node_total, p.node_axes,
        p.g_req, p.g_card, p.g_queue, p.g_key, p.g_run, p.g_valid, p.g_absent, r.g_state,
        r.alloc, r.q_killed)] + [np.int32(num_real_gangs)]


@pytest.mark.parametrize("kind,seed", [("synthetic", 0), ("synthetic", 1), ("variety", 4),
                                       ("variety", 5), ("market", 6)])
@pytest.mark.parametrize("caps", ["full", "truncated"])
def test_round_buffers_equal(kind, seed, caps):
    problem, ctx = _world(kind, seed)
    dp = problem_from_numpy(problem, "cpu")
    res = schedule_round(dp, num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                         slot_width=ctx.slot_width, device="cpu")
    r = result_to_numpy(res)
    K = problem.compat.shape[0]
    G = problem.g_req.shape[0]
    kcap, fcap = (K, G) if caps == "full" else (min(K, 2), min(G, 3))
    buf = _both(_args(problem, r, ctx.num_real_gangs), kcap, fcap)
    assert int(buf[1]) > 0  # keys with unplaced jobs
    if caps == "truncated":
        assert int(buf[1]) > kcap or int(buf[2]) > fcap or kind == "synthetic"


def _random_inputs(rng, N, T, K=6, G=300, Q=4, R=4):
    alloc = (rng.integers(16_000, 96_000, (3, N, R)) + rng.random((3, N, R))).astype(np.float32)
    alloc[0, rng.random(N) < 0.05] *= -1  # negative allocatable clamps to 0
    return [
        rng.random((K, T)) < 0.8, rng.random((K, T)) < 0.9,
        rng.integers(0, T, N).astype(np.int32), rng.random(N) < 0.95,
        rng.integers(50_000, 100_000, (N, R)).astype(np.float32),
        np.array([1, 1, 1, 0][:R], np.float32),
        rng.integers(0, 120_000, (G, R)).astype(np.float32), rng.integers(1, 3, G).astype(np.int32),
        rng.integers(0, Q, G).astype(np.int32), rng.integers(-1, K, G).astype(np.int32),
        np.where(rng.random(G) < 0.1, rng.integers(0, 5, G), -1).astype(np.int32),
        rng.random(G) < 0.9, rng.random(G) < 0.1, rng.integers(0, 4, G).astype(np.int32),
        alloc, rng.random(Q) < 0.3, np.int32(G - 20),
    ]


@pytest.mark.parametrize("N,T", [(20, 1), (31, 2), (33, 2), (2048, 3), (5000, 4)])
def test_fragmentation_sums_bit_equal(N, T):
    rng = np.random.default_rng(N + T)
    args = _random_inputs(rng, N, T)
    buf = _both(args, kcap=4, fcap=16)
    Q, R = 4, 4
    off = E._HEADER + 2 * E.NUM_REASONS + Q * E.NUM_REASONS + 3 * 4 + 2 * 16
    frag_free = buf[off: off + R].view(np.float32)
    if N >= 2048:  # the association question is live only past 2^24
        assert frag_free.max() > 2 ** 24


def test_explain_cadence_through_the_round():
    config, nodes, queues, specs, running, _ = synthetic_world(
        num_nodes=50, num_jobs=400, num_queues=5, num_runs=60, seed=3, shape_bucket=64)
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=specs, running=running)
    problem, ctx = build_problem(config, **kw)
    from armada_tpu.models import build_problem as jax_build

    jproblem, jctx = jax_build(config, **kw)
    tokens = (E.arm_default(2), jax_explain_mod.arm_default(2))
    E.reset_cadence()
    jax_explain_mod.reset_cadence()
    try:
        outs = []
        for _ in range(3):
            _, t = run_round_on_device(problem, ctx, config, device="cpu")
            _, j = jax_run_round(jproblem, jctx, config)
            outs.append((t, j))
    finally:
        E.disarm_default(tokens[0])
        jax_explain_mod.disarm_default(tokens[1])
    for i, (t, j) in enumerate(outs):
        if i % 2:
            assert t.explain is None and j.explain is None
            continue
        assert t.explain.summary() == j.explain.summary()
        assert list(t.explain.iter_job_reasons()) == list(j.explain.iter_job_reasons())
        assert sum(t.explain.failed_counts.values()) == len(t.failed)
