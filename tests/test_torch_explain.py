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


@pytest.mark.parametrize("case", ["one_type_past_2_24", "empty_type", "t1", "index_rule"])
def test_explain_adversarial_bit_equal(case):
    """K-J's adversarial cases, the plain version against the JAX program:
    every node of one type (that type's sums past 2^24: the longest chain),
    a type with no nodes, T = 1, and node types outside [0, T) (JAX clamps
    the compat gathers and drops the per-type scatters)."""
    rng = np.random.default_rng(11)
    N, T = 5000, 1 if case == "t1" else 3
    args = _random_inputs(rng, N, T)
    nt = args[2]
    if case == "one_type_past_2_24":
        nt[:] = 2
    elif case == "empty_type":
        nt[nt == 1] = 0
    elif case == "index_rule":
        nt[::7] = -1
        nt[1::11] = T
        nt[2::13] = T + 5
        nt[3::17] = -T - 1
    buf = _both(args, kcap=4, fcap=16)
    Q, R = 4, 4
    tff = E._HEADER + 2 * E.NUM_REASONS + Q * E.NUM_REASONS + 3 * 4 + 2 * 16 + 2 * R
    type_free = buf[tff: tff + T * R].view(np.float32).reshape(T, R)
    if case == "one_type_past_2_24":
        assert type_free[2].max() > 2 ** 24 and not type_free[:2].any()
    if case == "empty_type":
        assert not type_free[1].any()


def test_explain_plan_layout():
    """K-J's wrapper on CPU tensors, without the launch: the buffer is the
    head of one arena a call; the argument block holds every input's
    address, the scratch's 256-aligned addresses after the buffer, the
    bytes the kernel's memset zeroes (the buffer and the accumulated
    scratch) and the shapes; the plan is cached by signature; an input of
    another dtype is refused by name."""
    from armada_tpu_torch.kernels import explain as KX

    rng = np.random.default_rng(5)
    args = _random_inputs(rng, 300, 3)
    ts = [torch.as_tensor(np.asarray(a)) for a in args[:-1]]
    kcap, fcap = 4, 16
    out, call = KX.explain_plan(ts, int(args[-1]), kcap=kcap, fcap=fcap)
    plans = len(KX._PLANS)
    out2, call2 = KX.explain_plan(ts, int(args[-1]), kcap=kcap, fcap=fcap)
    assert len(KX._PLANS) == plans
    K, T = args[0].shape
    N, R = args[4].shape
    G, Q = args[13].shape[0], args[15].shape[0]
    assert out.numel() == E.explain_len(Q, R, T, kcap, fcap) and out.dtype == torch.int32
    assert out.storage_offset() == 0
    assert [int(w) for w in call[:16]] == [t.data_ptr() for t in ts]
    scratch = [int(call[KX.WORD[n]]) for n in KX._SCRATCH]
    assert scratch[0] == out.data_ptr()
    assert all(b > a and (b - a) % KX.ALIGN == 0 for a, b in zip(scratch, scratch[1:]))
    kr = scratch[KX._SCRATCH.index("kr")] - scratch[0]
    assert call[KX.WORD["zero_bytes"]] == kr + 4 * K * E.NUM_REASONS
    assert scratch[KX._SCRATCH.index("counts")] - scratch[0] >= call[KX.WORD["zero_bytes"]]
    words = dict(N=N, R=R, G=G, K=K, T=T, Q=Q, real_g=int(args[-1]), kcap=kcap, fcap=fcap)
    for k, v in words.items():
        assert call[KX.WORD[k]] == v, k
    assert out.untyped_storage().nbytes() >= scratch[-1] - scratch[0]
    bad = list(ts)
    bad[7] = bad[7].to(torch.int64)
    with pytest.raises(TypeError, match="g_card"):
        KX.explain_plan(bad, int(args[-1]), kcap=kcap, fcap=fcap)
