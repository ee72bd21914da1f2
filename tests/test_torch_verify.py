"""The port's round verification (kernel K-I's plain version) against the
JAX package's.

- On clean rounds of small worlds the plain buffer equals the JAX
  `_verify_kernel_impl` buffer word for word, and the verdict passes.
- Each of the eight invariant bits is raised by a corruption aimed at it,
  in both packages alike (the buffers stay equal).
- The tolerances: XLA:CPU evaluates `0.5 + 1e-3 * node_total` and
  `1.0 + 1e-3 * max(...)` as one fused multiply-add; a difference that
  lands between the fused and the twice-rounded threshold flags exactly as
  in the JAX package.
- A fetched compact buffer that differs from the device's fingerprint, or a
  corrupted result, raises RoundVerificationError out of the port's
  run_round_on_device when verification is armed.
"""

import jax
import numpy as np
import pytest
import torch

from armada_tpu.models.verify import _verify_kernel_impl
from armada_tpu_torch.core import watchdog
from armada_tpu_torch.models import run_round_on_device
from armada_tpu_torch.models import verify as V
from armada_tpu_torch.models.fair_scheduler import compact_result_plain, schedule_round
from armada_tpu_torch.models.problem import build_problem
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from armada_tpu_torch.models.synthetic import synthetic_world, variety_world
from armada_tpu_torch.scheduler.quarantine import reset_device_quarantine

_JAX_VERIFY = jax.jit(_verify_kernel_impl)
F32 = np.float32


def _round(seed, kind):
    if kind == "variety":
        config, kw = variety_world(seed, num_nodes=60)
        problem, ctx = build_problem(config, **kw)
    else:
        config, nodes, queues, specs, running, _ = synthetic_world(
            num_nodes=40, num_jobs=300, num_queues=4, num_runs=60, seed=seed, shape_bucket=64)
        problem, ctx = build_problem(config, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=specs, running=running)
    dp = problem_from_numpy(problem, "cpu")
    result = schedule_round(dp, num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                            slot_width=ctx.slot_width, device="cpu")
    return problem, ctx, result


def _inputs(problem, result_np, compact, num_real_gangs):
    p, r = problem, result_np
    return [
        np.asarray(p.node_total), np.asarray(p.node_ok), np.asarray(p.node_axes),
        np.asarray(p.run_req), np.asarray(p.run_node), np.asarray(p.run_queue),
        np.asarray(p.run_valid), np.asarray(p.g_req), np.asarray(p.g_card),
        np.asarray(p.g_queue), np.asarray(p.g_run), r.g_state, r.slot_gang, r.slot_nodes,
        r.slot_counts, r.n_slots, r.run_evicted, r.run_rescheduled, r.alloc[0], r.q_alloc,
        r.scheduled_count, compact, np.int32(num_real_gangs),
    ]


def _both(args):
    want = np.asarray(_JAX_VERIFY(*args))
    got = V.verify_kernel_plain(*[torch.as_tensor(np.array(a)) for a in args[:-1]],
                                int(args[-1])).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def _clean(seed, kind):
    problem, ctx, result = _round(seed, kind)
    compact = compact_result_plain(result, ctx.num_real_gangs, ctx.num_real_runs,
                                   fcap=64, ecap=64).numpy()
    return problem, ctx, result_to_numpy(result), compact


@pytest.mark.parametrize("kind,seed", [("synthetic", 0), ("synthetic", 1), ("variety", 2),
                                       ("variety", 3)])
def test_clean_round_buffers_equal(kind, seed):
    problem, ctx, r, compact = _clean(seed, kind)
    buf = _both(_inputs(problem, r, compact, ctx.num_real_gangs))
    assert int(buf[V._H_FLAGS]) == 0
    assert int(buf[V._H_SCHED_COUNT]) > 0
    ctx.last_compact_np = compact
    assert V.verdict_of(buf, ctx)["ok"]


def _corrupt(bit, problem, r):
    """Aim a corruption at invariant `bit`; returns the (problem, result)."""
    r = r._replace(**{f: np.array(getattr(r, f)) for f in r._fields})
    placed = np.flatnonzero((r.g_state == 1) & (np.asarray(problem.g_run) < 0))
    N = r.alloc.shape[1]
    if bit == 0:
        r = r._replace(scheduled_count=np.int32(r.scheduled_count + 7))
    elif bit == 1:
        g_card = np.array(problem.g_card)
        g_card[placed[0]] += 1
        problem = problem._replace(g_card=g_card)
    elif bit == 2:
        g_state = r.g_state.copy()
        g_state[placed[0]] = 2
        r = r._replace(g_state=g_state)
    elif bit == 3:
        counts = r.slot_counts.copy()
        counts[0, 0] += 1
        r = r._replace(slot_counts=counts)
    elif bit == 4:
        nodes = r.slot_nodes.copy()
        nodes[0, 0] = N
        r = r._replace(slot_nodes=nodes)
    elif bit == 5:
        alloc = r.alloc.copy()
        alloc[0, 1, 0] += F32(100.0)
        r = r._replace(alloc=alloc)
    elif bit == 6:
        q_alloc = r.q_alloc.copy()
        q_alloc[0, 0] += F32(100.0)
        r = r._replace(q_alloc=q_alloc)
    elif bit == 7:
        rs = r.run_rescheduled.copy()
        rs[np.flatnonzero(np.asarray(problem.run_valid) & ~r.run_evicted)[0]] = True
        r = r._replace(run_rescheduled=rs)
    return problem, r


@pytest.mark.parametrize("bit", range(8))
def test_each_invariant_fires(bit):
    problem, ctx, r, compact = _clean(0, "synthetic")
    problem, bad = _corrupt(bit, problem, r)
    buf = _both(_inputs(problem, bad, compact, ctx.num_real_gangs))
    assert int(buf[V._H_FLAGS]) & (1 << bit), (bit, int(buf[V._H_FLAGS]))
    ctx.last_compact_np = compact
    with pytest.raises(V.RoundVerificationError) as e:
        V.verdict_of(buf, ctx)
    assert V.CHECK_NAMES[bit] in e.value.sites


def _threshold_cases(kind):
    """(x, hi, fused): values where the fused threshold fma(1e-3, x, c) and
    the twice-rounded c + 1e-3 * x differ; hi is the larger of the two, the
    |difference| each case is built to land on exactly."""
    rng = np.random.default_rng(7)
    c = F32(0.5) if kind == "node" else F32(1.0)
    lo, span = (0.26, 0.74) if kind == "node" else (0.5, 0.5)
    x = (lo + rng.random(400_000) * span).astype(F32)
    sep = (c + (F32(1e-3) * x).astype(F32)).astype(F32)
    fused = (np.float64(c) + np.float64(F32(1e-3)) * x.astype(np.float64)).astype(F32)
    pick = np.flatnonzero(sep != fused)[:8]
    assert pick.size
    return [(x[i], max(sep[i], fused[i]), fused[i]) for i in pick]


def _tiny(node_total, alloc0, run_req=0.0, q_alloc=0.0):
    one_i = np.zeros(1, np.int32)
    return [
        np.array([[node_total]], F32), np.ones(1, bool), np.ones(1, F32),
        np.array([[run_req]], F32), one_i, one_i, np.array([run_req > 0]),
        np.zeros((1, 1), F32), np.ones(1, np.int32), one_i, np.full(1, -1, np.int32), one_i,
        one_i, np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32), np.int32(0),
        np.zeros(1, bool), np.zeros(1, bool), np.array([[alloc0]], F32),
        np.array([[q_alloc]], F32), np.int32(0), np.zeros(3, np.int32), np.int32(1),
    ]


@pytest.mark.parametrize("kind", ["node", "queue"])
def test_tolerance_is_one_fused_multiply_add(kind):
    for x, hi, fused in _threshold_cases(kind):
        if kind == "node":
            # used = 0 and alloc0 = total - hi, exact (Sterbenz): |diff| = hi
            args = _tiny(x, F32(x - hi))
            bit, diff = 5, abs(F32(x - hi) - x)
        else:
            # expected = one run's usage x, q_alloc = x - hi: |diff| = hi
            args = _tiny(F32(1e6), F32(1e6) - x, run_req=x, q_alloc=F32(x - hi))
            bit, diff = 6, abs(F32(x - hi) - x)
        assert diff == hi
        buf = _both(args)
        assert bool(int(buf[V._H_FLAGS]) & (1 << bit)) == bool(hi > fused), (x, hi, fused)


def test_fingerprint_mismatch_raises():
    problem, ctx, r, compact = _clean(1, "synthetic")
    buf = _both(_inputs(problem, r, compact, ctx.num_real_gangs))
    flipped = compact.copy()
    flipped[3] ^= np.int32(1 << 20)
    ctx.last_compact_np = flipped
    with pytest.raises(V.RoundVerificationError) as e:
        V.verdict_of(buf, ctx)
    assert e.value.sites == (V.SITE_FINGERPRINT,)
    ctx.last_compact_np = compact[:-1]
    with pytest.raises(V.RoundVerificationError):
        V.verdict_of(buf, ctx)
    bad = buf.copy()
    bad[V._H_VERSION] = 9
    with pytest.raises(V.RoundVerificationError) as e:
        V.verdict_of(bad, ctx)
    assert e.value.sites == (V.SITE_BUFFER,)


def test_armed_round_passes_and_a_corrupted_one_raises(monkeypatch):
    config, nodes, queues, specs, running, _ = synthetic_world(
        num_nodes=40, num_jobs=300, num_queues=4, num_runs=60, seed=4, shape_bucket=64)
    problem, ctx = build_problem(config, pool="default", nodes=nodes, queues=queues,
                                 queued_jobs=specs, running=running)
    state = V.reset_verify_state()
    token = V.arm_default(True)
    try:
        _, outcome = run_round_on_device(problem, ctx, config, device="cpu")
        assert outcome.scheduled
        assert state.rounds == 1 and state.failures == 0
        assert V.healthz_block()["last_verdict"]["ok"]

        import armada_tpu_torch.models as M

        real = M.schedule_round

        def corrupted(*a, **kw):
            res = real(*a, **kw)
            counts = res.slot_counts.clone()
            counts[0, 0] += 1
            return res._replace(slot_counts=counts)

        monkeypatch.setattr(M, "schedule_round", corrupted)
        with pytest.raises(V.RoundVerificationError):
            run_round_on_device(problem, ctx, config, device="cpu")
        # unarmed, the refusal propagates: no rung re-runs the round
        assert state.failures == 1
        assert not watchdog.supervisor().degraded
    finally:
        V.disarm_default(token)
        watchdog.reset_supervisor()
        reset_device_quarantine()
    assert not V.verify_enabled()


_JAX_VERIFY_STACKED = jax.jit(jax.vmap(_verify_kernel_impl))


@pytest.fixture(scope="module")
def clean_round_args():
    problem, ctx, r, compact = _clean(0, "synthetic")
    args = [torch.as_tensor(np.array(a)) for a in _inputs(problem, r, compact, ctx.num_real_gangs)]
    return args[:-1], int(args[-1])


_CASES = ("gang_repeated", "gang_wraps_and_drops", "gang_at_real_count", "gang_past_real_count",
          "n_slots_negative", "n_slots_past_s", "alloc0_nonfinite", "q_alloc_nonfinite",
          "inf_without_nan", "no_runs", "compact_empty", "compact_odd")


@pytest.mark.parametrize("name", _CASES)
def test_adversarial_case_equals_jax(name, clean_round_args):
    """K-I's adversarial cases (models/synthetic.py adversarial_verify_cases,
    which chip_smoke.py holds the kernels to on the card): the plain
    version equals the JAX package word for word, solo and as a stack of
    three lanes with different real-gang counts against its jax.vmap."""
    from armada_tpu_torch.kernels.verify import verify_round_stacked
    from armada_tpu_torch.models.synthetic import adversarial_verify_cases, stacked_verify_case

    cases = {n: (a, g) for n, a, g in adversarial_verify_cases(*clean_round_args)}
    assert tuple(cases) == _CASES
    args, real = cases[name]
    got = _both([t.numpy() for t in args] + [np.int32(real)])
    st, reals = stacked_verify_case(args, real)
    assert len(set(reals)) == 3
    jargs = [t.numpy() for t in st]
    jargs[18] = jargs[18][:, 0]
    want = np.asarray(_JAX_VERIFY_STACKED(*jargs, np.asarray(reals, np.int32)))
    stacked = verify_round_stacked(*st, reals).numpy()
    np.testing.assert_array_equal(stacked, want)
    np.testing.assert_array_equal(stacked[0], got)


@pytest.mark.parametrize("bit", range(8))
def test_corrupted_inputs_fire_their_bit(bit, clean_round_args):
    """The corruptions chip_smoke.py aims at each invariant on the card
    (models/synthetic.py corrupted_verify_inputs) raise their bit, in the
    plain version and the JAX package alike."""
    from armada_tpu_torch.models.synthetic import corrupted_verify_inputs

    args, real = clean_round_args
    cases = corrupted_verify_inputs(args, real)
    assert [b for b, _ in cases] == list(range(8))
    got = _both([t.numpy() for t in cases[bit][1]] + [np.int32(real)])
    assert int(got[V._H_FLAGS]) & (1 << bit), (bit, int(got[V._H_FLAGS]))


def test_plan_fills_the_argument_block(clean_round_args):
    """K-I's plan on CPU tensors: the argument block's words (pointers,
    shapes, the epoch, the real-gang counts by value, a device table only
    past INLINE lanes), the workspace's size, and the checks."""
    from armada_tpu_torch.kernels import verify as KV
    from armada_tpu_torch.models.synthetic import stacked_verify_case

    args, real = clean_round_args
    out, call, ws, table = KV.verify_plan(args, real)
    N, R = args[0].shape
    G, Q, (S, W) = args[11].shape[0], args[19].shape[0], args[13].shape
    assert out.shape == (16,) and table is None
    assert [int(call[KV.WORD[n]]) for n in ("N", "R", "RJ", "G", "Q", "S", "W", "L", "lanes")] == [
        N, R, args[3].shape[0], G, Q, S, W, args[21].shape[0], 1]
    assert list(call[:len(KV._IN)]) == [t.data_ptr() for t in args]
    assert call[KV.WORD["out"]] == out.data_ptr() and call[KV.WORD["ws"]] == ws.buf.data_ptr()
    assert call[KV.WORD["real_inline"]] == real and ws.buf.numel() == KV.ws_lane_bytes(N, R, Q, G)
    epoch = int(call[KV.WORD["epoch"]])
    assert int(KV.verify_plan(args, real)[1][KV.WORD["epoch"]]) == epoch + 1

    st, _ = stacked_verify_case(args, real, lanes=1)
    P = KV.INLINE + 3
    st = [t.expand((P,) + tuple(t.shape[1:])).contiguous() for t in st]
    reals = list(range(P))
    out, call, ws, table = KV.verify_plan(st, reals, lanes=P)
    assert out.shape == (P, 16) and ws.buf.numel() == P * KV.ws_lane_bytes(N, R, Q, G)
    assert list(call[KV.WORD["real_inline"]:]) == reals[:KV.INLINE]
    assert table.tolist() == reals and call[KV.WORD["real_table"]] == table.data_ptr()
    assert call[KV.WORD["alloc0_stride"]] == N * R

    with pytest.raises(ValueError):
        KV.verify_plan(args[:3] + [args[3][1:]] + args[4:], real)
    with pytest.raises(TypeError):
        KV.verify_plan(args[:11] + [args[11].long()] + args[12:], real)
    with pytest.raises(ValueError):
        KV.verify_plan(st, reals[:-1], lanes=P)
