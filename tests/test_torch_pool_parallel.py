"""The port's multi-pool serving cycle against the JAX package's.

Inputs are made from numpy seeds and go, as numpy arrays or as the same
specs, through the JAX function and its port with device="cpu".  Results
must be equal with no tolerance (f32 bit for bit):

- the stacked round (K-D's plain version) lane by lane against JAX
  `schedule_round_stacked`, and against the port's solo round;
- the stacked compaction (K-F) byte for byte against JAX `_compact_stacked`,
  `begin_decode_stacked`'s outcomes, and the stacked verification buffer;
- stacking and slicing lanes (K-E, K-G) and the stack's identity memo, and
  the kernels' layout and descriptor table run on the host;
- `dispatch_pool_rounds` over IncrementalBuilders, per-pool outcomes and
  the stacking counts;
- `FairSchedulingAlgo.schedule` over a churning multi-pool JobDb, both
  assembly modes, serial and pool-parallel arms, the serial fallbacks and
  the pool-serving counters;
- the away-round explain cadence repair.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import armada_tpu.models as jm
from armada_tpu.core import faults as jax_faults
from armada_tpu.core import watchdog as jax_watchdog
from armada_tpu.core import config as jax_config
from armada_tpu.core import types as jax_types
from armada_tpu.jobdb import job as jax_job
from armada_tpu.jobdb import jobdb as jax_jobdb
from armada_tpu.models import fair_scheduler as jax_fs
from armada_tpu.models import incremental as jax_incremental
from armada_tpu.models import problem as jax_problem
from armada_tpu.models import slab as jax_slab
from armada_tpu.models import verify as jax_verify
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu.scheduler import algo as jax_algo
from armada_tpu.scheduler import executors as jax_executors
from armada_tpu.scheduler import incremental_algo as jax_incremental_algo
from armada_tpu.scheduler import pool_serving as jax_pool_serving
from armada_tpu.scheduler.quarantine import reset_device_quarantine

import armada_tpu_torch.models as tm
from armada_tpu_torch.core import config as t_config
from armada_tpu_torch.core import types as t_types
from armada_tpu_torch.jobdb import job as t_job
from armada_tpu_torch.jobdb import jobdb as t_jobdb
from armada_tpu_torch.kernels import lanes as t_lanes
from armada_tpu_torch.kernels.compact import compact_result_stacked
from armada_tpu_torch.models import explain as t_explain
from armada_tpu_torch.models import fair_scheduler as t_fs
from armada_tpu_torch.models import incremental as t_incremental
from armada_tpu_torch.models import problem as t_problem
from armada_tpu_torch.models import slab as t_slab
from armada_tpu_torch.models import verify as t_verify
from armada_tpu_torch.models.state import problem_from_numpy
from armada_tpu_torch.scheduler import algo as t_algo
from armada_tpu_torch.scheduler import executors as t_executors
from armada_tpu_torch.scheduler import incremental_algo as t_incremental_algo
from armada_tpu_torch.scheduler import pool_serving as t_pool_serving

NOW_NS = 1_000_000_000_000
UNCACHED = dict(cache_slots=0, batch_k=1, commit_k=1, unroll=1)
SYNTH = dict(num_nodes=150, num_gangs=400, num_runs=80, global_burst=10_000, perq_burst=30,
             max_gang_cardinality=8)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for name in ("ARMADA_POOL_PARALLEL", "ARMADA_FAULT", "ARMADA_VERIFY",
                 "ARMADA_EXPLAIN_INTERVAL", "ARMADA_COMMIT_K", "ARMADA_CACHE_SLOTS",
                 "ARMADA_BATCH_K"):
        monkeypatch.delenv(name, raising=False)

    def reset():
        jax_faults.reset_counters()
        jax_verify.reset_verify_state()
        reset_device_quarantine()
        jax_pool_serving.reset_pool_serving_stats()
        jax_watchdog.reset_supervisor()
        t_verify.reset_verify_state()
        t_pool_serving.reset_pool_serving_stats()
        tm.reset_stack_cache()
        t_explain.reset_cadence()

    reset()
    yield
    reset()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_results_equal(jax_res, port_res, what):
    for name in jax_res._fields:
        a, b = np.asarray(getattr(jax_res, name)), _np(getattr(port_res, name))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}.{name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")


def _outcome_key(o):
    return (
        sorted(o.scheduled.items()), sorted(o.preempted), sorted(o.rescheduled),
        sorted(o.failed), o.num_iterations, o.termination, o.spot_price,
        sorted(o.unwound_groups),
    )


# --- 0. the away-round cadence repair ------------------------------------------


def test_away_round_leaves_the_explain_cadence():
    """run_scheduling_round(away_mode=True) must not tick the host pool's
    explain cadence (JAX passes explain_enabled=not away_mode); a home
    round does tick it."""
    from armada_tpu_torch.models.synthetic import synthetic_world

    config, nodes, queues, specs, running, _ = synthetic_world(
        num_nodes=20, num_jobs=60, num_queues=3, num_runs=5, shape_bucket=32)
    token = t_explain.arm_default(10)
    try:
        kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=specs,
                  running=running, collect_stats=False, device="cpu")
        before = dict(t_explain._round_counters)
        out = tm.run_scheduling_round(config, away_mode=True, **kw)
        assert out.explain is None
        assert t_explain._round_counters == before, "an away round ticked the cadence"
        home = tm.run_scheduling_round(config, **kw)
        assert home.explain is not None  # the first home round explains
        assert t_explain._round_counters.get("default") == 1
        # the phase-split entry point takes the same knob
        problem, ctx = t_problem.build_problem(
            config, pool="default", nodes=nodes, queues=queues, queued_jobs=specs,
            running=running)
        fin = tm.dispatch_round_on_device(problem, ctx, config, device="cpu",
                                          explain_enabled=False)
        _, split = fin()
        assert t_explain._round_counters.get("default") == 1
        assert split.scheduled == home.scheduled and split.explain is None
    finally:
        t_explain.disarm_default(token)


# --- 1. the stacked round (K-D) ---------------------------------------------------


def _synthetic_lanes(Q: int, P: int):
    lanes, meta = [], None
    for seed in range(P):
        p, meta = jax_synthetic(**SYNTH, num_queues=Q, seed=seed)
        lanes.append(p)
    return jax_problem.SchedulingProblem(*(np.stack(f) for f in zip(*lanes))), lanes, meta


@pytest.mark.parametrize("Q,P", [(29, 2), (40, 3), (64, 4), (97, 2), (256, 3)])
def test_stacked_round_equals_jax_and_the_solo_round(Q, P):
    stacked, lanes, meta = _synthetic_lanes(Q, P)
    ref = jax_fs.schedule_round_stacked(stacked, **meta, **UNCACHED)
    got = t_fs.schedule_round_stacked(problem_from_numpy(stacked, "cpu"), **meta)
    _assert_results_equal(ref, got, f"stacked Q={Q} P={P}")
    for i, lane in enumerate(lanes):
        solo = t_fs.schedule_round(lane, **meta, device="cpu")
        for name in solo._fields:
            assert torch.equal(getattr(solo, name), getattr(got, name)[i]), f"lane {i}.{name}"
    assert all(int(n) > 0 for n in got.n_slots)


# --- 2. stacked decode and verification (K-F, K-I stacked) ---------------------------

POOLS3 = ("p0", "p1", "p2")


def _builder_lanes(ns):
    """Three pools of one shape, each with its own seeded backlog and runs:
    (per-pool host problems, contexts) from `ns`'s IncrementalBuilder."""
    cfg = ns.SchedulingConfig(
        shape_bucket=32,
        priority_classes={
            "low": ns.PriorityClass("low", priority=100, preemptible=True),
            "high": ns.PriorityClass("high", priority=1000, preemptible=False),
        },
        default_priority_class="high",
        pools=tuple(ns.PoolConfig(p) for p in POOLS3),
    )
    F = cfg.resource_list_factory()
    queues = [ns.Queue(f"q{i}", 1.0 + i) for i in range(3)]
    out = []
    for pi, pool in enumerate(POOLS3):
        rng = np.random.default_rng(pi)
        b = ns.IncrementalBuilder(cfg, pool, queues)
        b.set_nodes([
            ns.NodeSpec(id=f"{pool}-n{k}", pool=pool,
                        total_resources=F.from_mapping({"cpu": "8", "memory": "32"}))
            for k in range(3)
        ])
        specs = []
        for i in range(20):
            card = 2 if i % 7 == 0 else 0
            specs.append(ns.JobSpec(
                id=f"{pool}-j{i:03d}", queue=f"q{int(rng.integers(0, 3))}",
                priority_class="low" if i < 10 else "high", submit_time=float(i),
                pools=(pool,), gang_id=f"{pool}-g{i}" if card else "", gang_cardinality=card,
                resources=F.from_mapping({"cpu": str(1 + int(rng.integers(0, 3))),
                                          "memory": "1"}),
            ))
            if card:
                specs.append(dataclasses.replace(specs[-1], id=specs[-1].id + "s"))
        # the low-priority (preemptible) head runs; the high-priority rest
        # queues against the full nodes
        b.lease_many([ns.RunningJob(job=s, node_id=f"{pool}-n{k % 3}", priority=100)
                      for k, s in enumerate(specs[1:9])])
        b.submit_many(specs[:1] + specs[9:])
        problem, ctx = b.assemble()
        out.append((problem, ctx))
    return out


class _Jax:
    """The JAX package's classes, by the names the worlds below use."""

    SchedulingConfig = jax_config.SchedulingConfig
    PoolConfig = jax_config.PoolConfig
    PriorityClass = jax_config.PriorityClass
    Queue = jax_types.Queue
    NodeSpec = jax_types.NodeSpec
    JobSpec = jax_types.JobSpec
    RunningJob = jax_types.RunningJob
    IncrementalBuilder = jax_incremental.IncrementalBuilder
    Job = jax_job.Job
    JobDb = jax_jobdb.JobDb
    ExecutorSnapshot = jax_executors.ExecutorSnapshot
    Feed = jax_incremental_algo.IncrementalProblemFeed
    Algo = jax_algo.FairSchedulingAlgo
    device_kw: dict = {}


class _Port:
    """The port's classes, by the same names."""

    SchedulingConfig = t_config.SchedulingConfig
    PoolConfig = t_config.PoolConfig
    PriorityClass = t_config.PriorityClass
    Queue = t_types.Queue
    NodeSpec = t_types.NodeSpec
    JobSpec = t_types.JobSpec
    RunningJob = t_types.RunningJob
    IncrementalBuilder = t_incremental.IncrementalBuilder
    Job = t_job.Job
    JobDb = t_jobdb.JobDb
    ExecutorSnapshot = t_executors.ExecutorSnapshot
    Feed = t_incremental_algo.IncrementalProblemFeed
    Algo = t_algo.FairSchedulingAlgo
    device_kw = {"device": "cpu"}


def _stack_np(problems):
    return jax_problem.SchedulingProblem(*(np.stack(f) for f in zip(*problems)))


def test_stacked_decode_and_verify_equal_jax():
    jl, tl = _builder_lanes(_Jax), _builder_lanes(_Port)
    for (jp, _), (tp, _) in zip(jl, tl):
        for name in jp._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                          np.asarray(getattr(tp, name)), err_msg=name)
    jctx = [c for _, c in jl]
    tctx = [c for _, c in tl]
    stacked = _stack_np([p for p, _ in jl])
    meta = dict(num_levels=len(jctx[0].ladder) + 2, max_slots=jctx[0].max_slots,
                slot_width=jctx[0].slot_width)
    jres = jax_fs.schedule_round_stacked(stacked, **meta, **UNCACHED)
    tstack = problem_from_numpy(stacked, "cpu")
    tres = t_fs.schedule_round_stacked(tstack, **meta)
    _assert_results_equal(jres, tres, "builder lanes")
    assert any(int(n) > 0 for n in tres.n_slots)
    assert any(bool(t.any()) for t in tres.run_evicted), "the lanes must preempt something"

    # the stacked compaction, byte for byte
    G, RJ = stacked.g_req.shape[1], stacked.run_req.shape[1]
    fcap, ecap = min(G, t_problem.COMPACT_FCAP), min(RJ, t_problem.COMPACT_ECAP)
    gangs = [c.num_real_gangs for c in tctx]
    runs = [c.num_real_runs for c in tctx]
    jbuf = np.asarray(jax_problem._compact_stacked()(
        jres, np.asarray(gangs, np.int32), np.asarray(runs, np.int32), fcap=fcap, ecap=ecap))
    tbuf = compact_result_stacked(tres, gangs, runs, fcap=fcap, ecap=ecap).numpy()
    assert jbuf.dtype == tbuf.dtype
    np.testing.assert_array_equal(jbuf, tbuf)

    # begin_decode_stacked: per-lane outcomes
    jfins = jax_problem.begin_decode_stacked(jres, jctx)
    tfins = t_problem.begin_decode_stacked(tres, tctx)
    for jf, tf in zip(jfins, tfins):
        assert _outcome_key(jf()) == _outcome_key(tf())

    # the stacked verification buffer
    jver = np.asarray(jax_verify._kernel_stacked()(
        stacked.node_total, stacked.node_ok, stacked.node_axes, stacked.run_req,
        stacked.run_node, stacked.run_queue, stacked.run_valid, stacked.g_req, stacked.g_card,
        stacked.g_queue, stacked.g_run, jres.g_state, jres.slot_gang, jres.slot_nodes,
        jres.slot_counts, jres.n_slots, jres.run_evicted, jres.run_rescheduled,
        jres.alloc[:, 0], jres.q_alloc, jres.scheduled_count, jbuf,
        np.asarray(gangs, np.int32)))
    tver = t_verify.dispatch_verify_stacked(tstack, tres, torch.as_tensor(tbuf), tctx)
    np.testing.assert_array_equal(jver, tver.numpy())
    for j, ctx in enumerate(tctx):
        ctx.last_compact_np = tbuf[j]
        assert t_verify.verdict_of(tver.numpy()[j], ctx)["ok"]


_CAP_EDGE_WIDTHS = dict(G=9_001, RJ=4_099, S=7, W=3, cap=1_000)
_CAP_EDGE_LANES = 5


def _cap_edge_cases(lanes):
    from armada_tpu_torch.models.synthetic import adversarial_compact_cases

    w = _CAP_EDGE_WIDTHS
    return {c[0]: c[1:] for c in adversarial_compact_cases(w["G"], w["RJ"], w["S"], w["W"],
                                                           cap=w["cap"], lanes=lanes)}


@pytest.mark.parametrize("name", ["1000 failed at fcap 1000", "1001 failed at fcap 1000",
                                  "0 failed at fcap 1000", "real counts 0",
                                  "real counts whole, caps whole", "every flag set", "no runs"])
def test_compact_cap_edges_equal_jax(name):
    """K-C's plain version against JAX `compact_result` word for word at the
    cap edges (models/synthetic.py adversarial_compact_cases, the cases
    chip_smoke.py holds the kernel to on the card): failed gangs at the cap
    (count = cap), one past it (count = cap + 1, the header keeping the true
    count) and none; real counts of 0 and of the whole axis; every flag set;
    no runs (RJ = 0, ecap 0)."""
    arrs, rg, rr, fcap, ecap = _cap_edge_cases(0)[name]
    j = np.asarray(jax_fs.compact_result(jax_fs.RoundResult(**arrs), rg, rr, fcap=fcap,
                                         ecap=ecap))
    t = t_fs.compact_result(t_fs.RoundResult(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
                            rg, rr, fcap=fcap, ecap=ecap).numpy()
    assert j.dtype == t.dtype
    np.testing.assert_array_equal(j, t)
    assert t[5] == int((arrs["g_state"][:rg] == 2).sum())


@pytest.mark.parametrize("name", ["1000 failed at fcap 1000", "1001 failed at fcap 1000",
                                  "no runs", "real counts differ by lane"])
def test_compact_stacked_cap_edges_equal_jax(name):
    """K-F's plain version against JAX `_compact_stacked` (jax.vmap of
    compact_result) word for word at the cap edges, over lanes with
    different data, and with real counts that differ lane by lane."""
    arrs, rg, rr, fcap, ecap = _cap_edge_cases(_CAP_EDGE_LANES)[name]
    j = np.asarray(jax_problem._compact_stacked()(
        jax_fs.RoundResult(**arrs), np.asarray(rg, np.int32), np.asarray(rr, np.int32),
        fcap=fcap, ecap=ecap))
    t = compact_result_stacked(
        t_fs.RoundResult(**{k: torch.as_tensor(v) for k, v in arrs.items()}), rg, rr,
        fcap=fcap, ecap=ecap).numpy()
    assert j.dtype == t.dtype and j.shape[0] == _CAP_EDGE_LANES
    np.testing.assert_array_equal(j, t)


def test_compact_plan_words_and_signature_cache():
    """The K-C/K-F wrapper's argument block (kernels/compact.py
    compact_plan, run on CPU tensors): the inputs', output's and
    workspace's pointers, the widths, the tag (1..255, turning over), the
    real counts by value -- in a device table only past INLINE lanes -- and
    one plan a signature; inputs the kernel does not take are refused."""
    from armada_tpu_torch.kernels import compact as KC
    from armada_tpu_torch.models.synthetic import compact_arrays

    KC._PLANS.clear()
    KC._WORKSPACES.clear()
    res = t_fs.RoundResult(**{k: torch.as_tensor(v)
                              for k, v in compact_arrays(5_000, 300, 4, 2, lanes=3).items()})
    out, call, ws, table = KC.compact_plan(res, [5_000, 10, 0], [300, 7, 1], lanes=3, fcap=64,
                                           ecap=32)
    W = KC.WORD
    assert out.shape == (3, t_fs.compact_len(4, 2, 64, 32)) and table is None
    assert [int(call[W[n]]) for n in KC._IN] == [getattr(res, n).data_ptr() for n in KC._IN]
    assert int(call[W["out"]]) == out.data_ptr() and int(call[W["ws"]]) == ws.buf.data_ptr()
    assert [int(call[W[n]]) for n in ("G", "RJ", "S", "W", "fcap", "ecap", "lanes", "tag")] == [
        5_000, 300, 4, 2, 64, 32, 3, 1]
    inline = call[W["real_inline"]:].view(np.int32)
    assert inline[:6].tolist() == [5_000, 300, 10, 7, 0, 1]
    assert call.nbytes == 8 * KC.ARGS_WORDS
    assert ws.buf.numel() == 3 * KC.ws_lane_words(5_000, 300) == 3 * (2 + 2 * 1)
    plan = next(iter(KC._PLANS.values()))
    for k in range(2, 258):
        _, call, ws2, _ = KC.compact_plan(res, [1] * 3, [1] * 3, lanes=3, fcap=64, ecap=32)
        assert ws2 is ws and int(call[W["tag"]]) == (k - 1) % 255 + 1
    assert len(KC._PLANS) == 1 and next(iter(KC._PLANS.values())) is plan
    solo = t_fs.RoundResult(*(t[0] for t in res))
    _, call, _, _ = KC.compact_plan(solo, 17, 5, fcap=0, ecap=0)
    assert call[W["real_inline"]:].view(np.int32)[:2].tolist() == [17, 5]
    assert int(call[W["lanes"]]) == 1
    wide = t_fs.RoundResult(**{k: torch.as_tensor(v)
                               for k, v in compact_arrays(10, 5, 1, 1, lanes=300).items()})
    _, call, _, table = KC.compact_plan(wide, list(range(300)), [2] * 300, lanes=300, fcap=3,
                                        ecap=2)
    assert table.shape == (300, 2) and table[299].tolist() == [299, 2]
    assert int(call[W["real_table"]]) == table.data_ptr()
    with pytest.raises(ValueError, match="caps"):
        KC.compact_plan(solo, 1, 1, fcap=5_001, ecap=0)
    with pytest.raises(TypeError, match="g_state"):
        KC.compact_plan(solo._replace(g_state=solo.g_state.long()), 1, 1, fcap=1, ecap=1)
    with pytest.raises(ValueError, match="expected 3"):
        KC.compact_plan(res, [1, 2], [1, 2], lanes=3, fcap=1, ecap=1)
    with pytest.raises(ValueError, match="contiguous"):
        KC.compact_plan(res._replace(slot_nodes=res.slot_nodes.transpose(1, 2)), [1] * 3,
                        [1] * 3, lanes=3, fcap=1, ecap=1)


# --- 3. lanes (K-E, K-G) and the stack memo --------------------------------------


def test_lanes_round_trip_and_identity_memo():
    stacked, lanes, _ = _synthetic_lanes(16, 3)
    dps = [problem_from_numpy(p, "cpu") for p in lanes]
    st = t_lanes.stack(dps)
    for name in st._fields:
        assert torch.equal(getattr(st, name), torch.as_tensor(getattr(stacked, name))), name
    for i, dp in enumerate(dps):
        back = t_lanes.lane_slice(st, i)
        for name in dp._fields:
            assert torch.equal(getattr(back, name), getattr(dp, name)), name
            assert getattr(back, name).data_ptr() != getattr(st, name).data_ptr()

    key = ("k",)
    first = tm._stack_problems(key, dps)
    assert tm._stack_problems(key, list(dps)) is first, "same device problems: reuse"
    changed = list(dps)
    changed[1] = dps[1]._replace(g_valid=dps[1].g_valid.clone())
    fresh = tm._stack_problems(key, changed)
    assert fresh is not first, "a lane changed: a fresh stack"
    assert torch.equal(fresh.g_valid, first.g_valid)
    assert tm._stack_problems(key, changed) is fresh
    for k in range(tm._STACK_CACHE_CAP + 1):  # the cap bounds what it pins
        tm._stack_problems(("other", k), dps)
    assert len(tm._STACK_CACHE) <= tm._STACK_CACHE_CAP
    tm.reset_stack_cache()
    assert not tm._STACK_CACHE


# The batched copy's plan (K-E's and K-G's layout and descriptor table) on
# CPU tensors: the table run on the host with the kernel's own semantics --
# each tile of each descriptor as a narrow head, the words and a narrow tail
# (csrc/lanes.cu copy_range), one ctypes.memmove each -- must give the plain
# versions and the JAX package's stack (`_stack_problems`) and `lane_slice`
# on the same numpy inputs, bit for bit.

Odd = collections.namedtuple("Odd", "big flags ids mis16 mis8 tail")
Empty = collections.namedtuple("Empty", "a none b")


def _run_table(table) -> None:
    tile0 = table["tile0"]
    nbytes = table["bytes"]
    tiles = -(-nbytes // t_lanes.TILE)
    assert (nbytes > 0).all() and (tile0 == np.cumsum(tiles) - tiles).all()
    masks = (1 << table["wlog"].astype(np.int64)) - 1
    assert (((table["src"] ^ table["dst"]) & masks) == 0).all()
    for tile in range(int(tiles.sum())):
        k = int(np.searchsorted(tile0, tile0.dtype.type(tile), side="right")) - 1
        src, dst, n, first, mask = (int(table[c][k]) for c in ("src", "dst", "bytes", "tile0",
                                                                "wlog"))
        mask = (1 << mask) - 1
        a = (tile - first) * t_lanes.TILE
        e = min(a + t_lanes.TILE, n)
        ab, ae = a + (-(dst + a) & mask), e - ((dst + e) & mask)
        if ae <= ab:
            ab = ae = e  # shorter than a word: all narrow
        else:  # the words: aligned on both sides
            assert ((src + ab) & mask) == 0 and ((dst + ab) & mask) == 0
            assert ((ae - ab) & mask) == 0
        for lo, hi in ((a, ab), (ab, ae), (ae, e)):
            ctypes.memmove(dst + lo, src + lo, hi - lo)


def _assert_trees_equal(got, ref, what):
    assert type(got) is type(ref), what
    for name in ref._fields:
        x, y = getattr(got, name), getattr(ref, name)
        assert x.dtype == y.dtype and x.shape == y.shape and x.is_contiguous(), f"{what}.{name}"
        assert torch.equal(x, y), f"{what}.{name}"


def _assert_equals_numpy(got, ref, what):
    """`got` (torch) equals `ref` (numpy or JAX arrays) field by field, bit
    for bit; where JAX, without x64, narrowed a 64-bit input, by value."""
    for name in got._fields:
        x, y = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert x.shape == y.shape, f"{what}.{name}"
        if x.dtype == y.dtype:
            assert x.tobytes() == y.tobytes(), f"{what}.{name}"
        else:
            assert x.dtype.itemsize == 8 and y.dtype.itemsize == 4, f"{what}.{name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{name}")


def _jax_stack(case, np_trees):
    """The JAX package's stack of `np_trees` (`_stack_problems`, the
    program K-E replaces), with its memo entry dropped again."""
    key = ("lane plan test", case)
    try:
        return jm._stack_problems(key, np_trees)
    finally:
        jm._STACK_CACHE.pop(key, None)


def _no_alias(out, trees):
    inputs = {t.data_ptr() for tree in trees for t in tree if t.numel()}
    assert not any(t.numel() and t.data_ptr() in inputs for t in out)


def _odd_lanes(P):
    """Odd-length bool and int32 fields, a field of several tiles, sources
    at odd byte offsets (views into one buffer) and a zero-size field."""
    out = []
    for li in range(P):
        rng = np.random.default_rng(40 + li)
        raw = torch.as_tensor(rng.integers(0, 256, 90_011, dtype=np.uint8))
        out.append(Odd(torch.as_tensor(rng.standard_normal(20_001).astype(np.float32)),
                       torch.as_tensor(rng.random(37) < 0.5),
                       torch.as_tensor(rng.integers(-5, 5, 13, dtype=np.int32)),
                       raw[2 + 2 * li:40_004 + 2 * li].view(torch.int16),
                       raw[1 + li:33 + li],
                       torch.zeros((0, 3), dtype=torch.float64)))
    return out


def _lane_trees(case):
    """(torch lanes on the CPU, the same lanes as numpy trees, their numpy
    stack where the test world made one)."""
    if case in ("problem", "result", "p1"):
        stacked, lanes, meta = _synthetic_lanes(29, 1 if case == "p1" else 3)
        if case != "result":
            return [problem_from_numpy(p, "cpu") for p in lanes], lanes, stacked
        res = t_fs.schedule_round_stacked(problem_from_numpy(stacked, "cpu"), **meta)
        trees = [t_lanes.slice_plain(res, i) for i in range(3)]
    elif case == "odd":
        trees = _odd_lanes(3)
    else:
        trees = [Empty(torch.arange(5, dtype=torch.int32) + li, torch.zeros(0, dtype=torch.bool),
                       torch.ones((2, 0, 4))) for li in range(2)]
    return trees, [type(t)(*(x.numpy() for x in t)) for t in trees], None


@pytest.mark.parametrize("case", ["problem", "result", "odd", "zero", "p1"])
def test_lane_plans_run_on_the_host_equal_the_plain_versions(case):
    trees, np_trees, np_stacked = _lane_trees(case)
    out, table = t_lanes.stack_plan(trees)
    _run_table(table)
    ref = t_lanes.stack_plain(trees)
    _assert_trees_equal(out, ref, f"{case} stack")
    jstack = _jax_stack(case, np_trees)
    _assert_equals_numpy(out, jstack, f"{case} stack vs JAX")
    if np_stacked is not None:
        _assert_equals_numpy(out, np_stacked, f"{case} stack vs the test world's stack")
    _no_alias(out, trees)
    if case == "odd":  # narrow heads, tails and words are used
        assert (table["wlog"] < 4).any() and (table["tile0"][1:] - table["tile0"][:-1] > 1).any()
    for i in range(len(trees)):
        lane, table = t_lanes.slice_plan(ref, i)
        _run_table(table)
        _assert_trees_equal(lane, t_lanes.slice_plain(ref, i), f"{case} slice {i}")
        _assert_equals_numpy(lane, jax_problem.lane_slice(jstack, i), f"{case} slice {i} vs JAX")
        _no_alias(lane, [ref])


def test_lane_plan_signature_hit_and_refusals():
    t_lanes._LAYOUTS.clear()
    lanes = _odd_lanes(3)
    out, table = t_lanes.stack_plan(lanes)
    _run_table(table)
    _assert_trees_equal(out, t_lanes.stack_plain(lanes), "miss")
    assert len(t_lanes._LAYOUTS) == 1
    swapped = lanes[::-1]  # the same signature, other data: a hit
    out, table = t_lanes.stack_plan(swapped)
    _run_table(table)
    _assert_trees_equal(out, t_lanes.stack_plain(swapped), "hit")
    jstack = _jax_stack("hit", [Odd(*(x.numpy() for x in t)) for t in swapped])
    _assert_equals_numpy(out, jstack, "hit vs JAX")
    assert len(t_lanes._LAYOUTS) == 1
    lane, table = t_lanes.slice_plan(out, 0)  # a slice's miss, then its hit on lane 2
    _run_table(table)
    lane, table = t_lanes.slice_plan(out, 2)
    _run_table(table)
    _assert_equals_numpy(lane, jax_problem.lane_slice(jstack, 2), "slice hit vs JAX")
    assert len(t_lanes._LAYOUTS) == 2
    bad = {
        "shape": lanes[1]._replace(flags=lanes[1].flags[:-1]),
        "dtype": lanes[1]._replace(ids=lanes[1].ids.to(torch.int64)),
        "contiguity": lanes[1]._replace(big=torch.zeros(40_002)[::2]),
        "tensor": lanes[1]._replace(ids=lanes[1].ids.numpy()),
    }
    for what, tree in bad.items():
        with pytest.raises(ValueError, match="ids|flags|big"):
            t_lanes.stack_plan([lanes[0], tree, lanes[2]])
    assert len(t_lanes._LAYOUTS) == 2, "a refused call leaves no layout"
    stacked = t_lanes.stack_plain(lanes)
    t_lanes.slice_plan(stacked, 2)
    with pytest.raises(IndexError):
        t_lanes.slice_plan(stacked, 3)
    with pytest.raises(ValueError, match="flags"):
        t_lanes.slice_plan(stacked._replace(flags=stacked.flags.t()), 0)
    with pytest.raises(ValueError, match="lane axis"):
        t_lanes.slice_plan(stacked._replace(ids=stacked.ids[:2]), 0)


def test_arena_lane_feeds_the_round_as_fresh_buffers():
    """A lane whose fields are views of one arena (storage offsets not 0)
    runs the solo round -- what the rollback re-run does with a sliced lane
    -- as the plain slice does; and no module of the port reads a field's
    storage, re-points or resizes it."""
    stacked, _, meta = _synthetic_lanes(29, 3)
    st = problem_from_numpy(stacked, "cpu")
    lane, table = t_lanes.slice_plan(st, 1)
    _run_table(table)
    got = t_fs.schedule_round(lane, **meta, device="cpu")
    ref = t_fs.schedule_round(t_lanes.slice_plain(st, 1), **meta, device="cpu")
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    pattern = re.compile(r"storage_offset|untyped_storage|\.storage\(|\.set_\(|\.resize_")
    root = pathlib.Path(t_lanes.__file__).resolve().parents[1]
    hits = [f"{p.relative_to(root)}:{k}" for p in sorted(root.rglob("*.py"))
            for k, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line)]
    assert not hits, hits


# --- 4. dispatch_pool_rounds ---------------------------------------------------------


def _dispatch_world(ns, jax_side: bool):
    """Four pools: p0..p2 shape-matched (3 nodes each), p3 larger (40 nodes,
    another padded shape).  Returns (config, builders, caches)."""
    pools = ("p0", "p1", "p2", "p3")
    cfg = ns.SchedulingConfig(
        shape_bucket=32,
        priority_classes={
            "low": ns.PriorityClass("low", priority=100, preemptible=True),
            "high": ns.PriorityClass("high", priority=1000, preemptible=False),
        },
        default_priority_class="high",
        pools=tuple(ns.PoolConfig(p) for p in pools),
    )
    F = cfg.resource_list_factory()
    queues = [ns.Queue(f"q{i}", 1.0 + i) for i in range(3)]
    builders, caches = {}, {}
    for pi, pool in enumerate(pools):
        b = ns.IncrementalBuilder(cfg, pool, queues)
        b.set_nodes([
            ns.NodeSpec(id=f"{pool}-n{k}", pool=pool,
                        total_resources=F.from_mapping({"cpu": "8", "memory": "32"}))
            for k in range(40 if pool == "p3" else 3)
        ])
        builders[pool] = b
        caches[pool] = jax_slab.DeviceDeltaCache() if jax_side else t_slab.DeviceDeltaCache("cpu")
    return cfg, builders, caches


def _dispatch_specs(ns, cfg, pool, cycle, rng):
    F = cfg.resource_list_factory()
    n = 40 if pool == "p3" else 8
    return [
        ns.JobSpec(id=f"{pool}-c{cycle}-{i:03d}", queue=f"q{int(rng.integers(0, 3))}",
                   priority_class="low" if cycle == 0 else "high", submit_time=cycle * 100.0 + i,
                   pools=(pool,),
                   resources=F.from_mapping({"cpu": str(1 + int(rng.integers(0, 3))),
                                             "memory": "1"}))
        for i in range(n)
    ]


def test_dispatch_pool_rounds_equals_jax(monkeypatch):
    """Three shape-matched pools stack into one launch, the fourth pool
    dispatches solo in the same window; two verified cycles, decisions
    applied back to both sides' builders."""
    monkeypatch.setenv("ARMADA_VERIFY", "1")
    sides = []
    for ns, jax_side in ((_Jax, True), (_Port, False)):
        cfg, builders, caches = _dispatch_world(ns, jax_side)
        sides.append(dict(ns=ns, cfg=cfg, b=builders, c=caches, specs={}))
    jside, tside = sides
    for cycle in range(2):
        for side in sides:
            for pi, pool in enumerate(side["b"]):
                rng = np.random.default_rng(100 * cycle + pi)
                new = _dispatch_specs(side["ns"], side["cfg"], pool, cycle, rng)
                side["specs"].update((s.id, s) for s in new)
                side["b"][pool].submit_many(new)
        for side, mod in ((jside, jm), (tside, tm)):
            side["pspecs"] = []
            for pool, b in side["b"].items():
                bundle, ctx = b.assemble_delta()
                side["pspecs"].append(mod.PoolRoundSpec(
                    problem=bundle.stats_view(), ctx=ctx,
                    device_problem=lambda c=side["c"][pool], x=bundle: c.apply(x),
                    host_problem=bundle.materialize))
        jfin, jn, jpools, jfailed = jm.dispatch_pool_rounds(jside["pspecs"], jside["cfg"])
        tfin, tn, tpools, tfailed = tm.dispatch_pool_rounds(tside["pspecs"], tside["cfg"],
                                                            device="cpu")
        assert (tn, tpools, tfailed) == (jn, jpools, jfailed) == (1, 3, set())
        for pool, jf, tf in zip(jside["b"], jfin, tfin):
            jres, jout = jf()
            tres, tout = tf()
            assert _outcome_key(jout) == _outcome_key(tout), (cycle, pool)
            jres = jres() if callable(jres) else jres
            tres = tres() if callable(tres) else tres
            _assert_results_equal(jres, tres, f"cycle {cycle} {pool}")
            for side in sides:
                b = side["b"][pool]
                b.remove_many(list(jout.scheduled))
                b.lease_many([side["ns"].RunningJob(job=side["specs"][jid], node_id=node,
                                                    priority=1000)
                              for jid, node in sorted(jout.scheduled.items())])
                for jid in jout.preempted:
                    b.unlease(jid)
    assert t_verify.verify_state().rounds == 8 and t_verify.verify_state().failures == 0


# --- 5. FairSchedulingAlgo over a churning multi-pool JobDb ---------------------------


class MultiPoolWorld:
    """JobDb + feed + algo over P pool-restricted tenants, driven by a seeded
    churn script (submits with gangs, cancels, reprioritisations; the
    capacity squeeze makes later high-priority submits preempt low ones) --
    the harness of tests/test_pool_parallel.py, built from the classes of
    `ns` (the JAX package's or the port's)."""

    def __init__(self, ns, npools: int, incremental: bool, seed: int,
                 unlimited: bool = True, multi_pool_job: bool = False):
        kw = {}
        if unlimited:
            kw.update(maximum_scheduling_rate=0.0, maximum_per_queue_scheduling_rate=0.0)
        self.cfg = ns.SchedulingConfig(
            shape_bucket=32,
            priority_classes={
                "low": ns.PriorityClass("low", priority=100, preemptible=True),
                "high": ns.PriorityClass("high", priority=1000, preemptible=False),
            },
            default_priority_class="high",
            maximum_scheduling_burst=1_000,
            incremental_problem_build=incremental,
            pools=tuple(ns.PoolConfig(f"p{i}") for i in range(npools)),
            **kw,
        )
        self.ns = ns
        self.F = self.cfg.resource_list_factory()
        self.npools = npools
        self.jdb = ns.JobDb(self.cfg)
        self.feed = None
        if incremental:
            self.feed = ns.Feed(self.cfg, **ns.device_kw)
            self.feed.attach(self.jdb)
        self.rng = np.random.default_rng(seed)
        self.seq = 0
        self.live: list = []
        self.multi_pool_job = multi_pool_job
        self.executors = [
            ns.ExecutorSnapshot(
                id=f"ex{p}", pool=f"p{p}", last_update_ns=NOW_NS,
                nodes=tuple(
                    ns.NodeSpec(id=f"n{p}-{k}", pool=f"p{p}",
                                total_resources=self.F.from_mapping({"cpu": "8", "memory": "32"}))
                    for k in range(3)
                ),
            )
            for p in range(npools)
        ]
        run_ids = itertools.count()
        self.algo = ns.Algo(
            self.cfg,
            queues=lambda: [ns.Queue(f"q{i}", 1.0 + i) for i in range(3)],
            clock_ns=lambda: NOW_NS,
            run_id_factory=lambda: f"run{next(run_ids):06d}",
            feed=self.feed,
            **ns.device_kw,
        )

    def _submit(self, txn, n: int, pc: str, gang_every: int = 0):
        ns = self.ns
        for _ in range(n):
            i = self.seq
            self.seq += 1
            pool = f"p{i % self.npools}"
            pools = (pool,)
            if self.multi_pool_job and i == 7 and self.npools >= 2:
                pools = ("p0", "p1")  # breaks the independence certification
            gang_id, card = "", 0
            if gang_every and i % gang_every == 0:
                gang_id, card = f"g{i}", 2
            spec = ns.JobSpec(
                id=f"j{i:05d}", queue=f"q{int(self.rng.integers(0, 3))}",
                priority_class=pc, submit_time=float(i), pools=pools, gang_id=gang_id,
                gang_cardinality=card,
                resources=self.F.from_mapping(
                    {"cpu": str(1 + int(self.rng.integers(0, 3))), "memory": "1"}),
            )
            txn.upsert(ns.Job(spec=spec, queued=True, validated=True, pools=pools))
            self.live.append(spec.id)
            if card:
                sib = dataclasses.replace(spec, id=f"{spec.id}s")
                txn.upsert(ns.Job(spec=sib, queued=True, validated=True, pools=pools))
                self.live.append(sib.id)

    def run(self, cycles: int = 3):
        """Seeded churn; returns (per-cycle ordered decisions, final state)."""
        out = []
        for c in range(cycles):
            txn = self.jdb.write_txn()
            self._submit(txn, 14 if c == 0 else 6, "low" if c < 2 else "high", gang_every=5)
            if c >= 1 and len(self.live) > 4:
                for jid in self.live[2:4]:
                    job = txn.get(jid)
                    if job is not None and job.queued:
                        txn.upsert(dataclasses.replace(job, cancelled=True))
                job = txn.get(self.live[4])
                if job is not None and job.queued and not job.in_terminal_state():
                    txn.upsert(dataclasses.replace(job, priority=5000 + c))
            result = self.algo.schedule(txn, self.executors, NOW_NS)
            out.append((
                [(ps.pool, sorted(ps.outcome.scheduled.items()), sorted(ps.outcome.preempted))
                 for ps in result.pools],
                [(job.id, run.id, run.node_id) for job, run in result.scheduled],
                sorted(job.id for job, _ in result.preempted),
            ))
            txn.commit()
        final = sorted(
            (j.id, j.queued, j.in_terminal_state(),
             None if j.latest_run is None else (j.latest_run.id, j.latest_run.node_id))
            for j in self.jdb.read_txn().all_jobs()
        )
        return out, final


def _run(ns, monkeypatch, parallel, *, npools, seed, incremental=True, verify=False,
         unlimited=True, multi_pool_job=False):
    monkeypatch.setenv("ARMADA_POOL_PARALLEL", "1" if parallel else "0")
    monkeypatch.setenv("ARMADA_VERIFY", "1" if verify else "0")
    return MultiPoolWorld(ns, npools, incremental, seed, unlimited=unlimited,
                          multi_pool_job=multi_pool_job).run()


def _snap(stats):
    s = stats.snapshot()
    return {k: s[k] for k in ("cycles", "parallel_cycles", "serial_fallback_cycles",
                              "stacked_launches", "stacked_pools")}


@pytest.mark.parametrize("npools,seed,incremental,verify", [
    (2, 0, True, False),
    (4, 1, True, True),
    (3, 2, False, False),
])
def test_fair_scheduling_algo_equals_jax_in_both_arms(monkeypatch, npools, seed, incremental,
                                                     verify):
    """Per cycle, the port's ordered decisions and final job states equal the
    JAX package's (its serial arm, which its own tests pin to its parallel
    arm), with pool-parallel off and on; the port's two arms equal each
    other, and the parallel arm stacks."""
    want = _run(_Jax, monkeypatch, False, npools=npools, seed=seed,
                incremental=incremental, verify=verify)
    serial = _run(_Port, monkeypatch, False, npools=npools, seed=seed,
                  incremental=incremental, verify=verify)
    t_pool_serving.reset_pool_serving_stats()
    parallel = _run(_Port, monkeypatch, True, npools=npools, seed=seed,
                    incremental=incremental, verify=verify)
    assert serial == want, "the serial arm differs from the JAX package"
    assert parallel == serial, "the pool-parallel arm differs from the serial arm"
    assert any(sched for _pools, sched, _pre in want[0]), "the scenario must schedule"
    counts = _snap(t_pool_serving.pool_serving_stats())
    if incremental:
        assert counts["parallel_cycles"] > 0 and counts["stacked_launches"] > 0
        assert counts["stacked_pools"] >= 2 * counts["stacked_launches"]
    else:
        assert counts["parallel_cycles"] == 0
    if verify:
        assert t_verify.verify_state().rounds > 0 and t_verify.verify_state().failures == 0


@pytest.mark.parametrize("case", ["multi_pool_job", "binding_rate_limits"])
def test_serial_fallbacks_and_counters_as_in_jax(monkeypatch, case):
    """A queued multi-pool job, or armed rate limiters that bind against the
    frozen clock, keep the cycle serial; decisions stay equal to the JAX
    package's, and the pool-serving counters (parallel and fallback cycles,
    stacked launches and pools) equal its counters."""
    kw = (dict(npools=3, seed=2, multi_pool_job=True) if case == "multi_pool_job"
          else dict(npools=3, seed=0, unlimited=False))
    want = _run(_Jax, monkeypatch, True, **kw)
    jax_counts = _snap(jax_pool_serving.pool_serving_stats())
    got = _run(_Port, monkeypatch, True, **kw)
    counts = _snap(t_pool_serving.pool_serving_stats())
    serial = _run(_Port, monkeypatch, False, **kw)
    assert got == want == serial
    assert counts == jax_counts
    if case == "multi_pool_job":
        assert counts["serial_fallback_cycles"] > 0
        # once the multi-pool job leases, later cycles stack again
        assert counts["stacked_launches"] > 0


def test_feed_independence_tracking():
    """pools_independent() follows the queued-job lifecycle: unrestricted
    and multi-pool jobs break it; terminating them restores it."""
    ns = _Port
    cfg = ns.SchedulingConfig(pools=(ns.PoolConfig("p0"), ns.PoolConfig("p1")),
                              shape_bucket=32)
    F = cfg.resource_list_factory()
    jdb = ns.JobDb(cfg)
    feed = ns.Feed(cfg, device="cpu")
    feed.attach(jdb)

    def upsert(job):
        txn = jdb.write_txn()
        txn.upsert(job)
        txn.commit()

    spec = ns.JobSpec(id="a", queue="q0", submit_time=0.0, pools=("p0",),
                      resources=F.from_mapping({"cpu": "1", "memory": "1"}))
    upsert(ns.Job(spec=spec, queued=True, validated=True, pools=("p0",)))
    assert feed.pools_independent()
    free = dataclasses.replace(spec, id="b", pools=())
    upsert(ns.Job(spec=free, queued=True, validated=True))
    assert not feed.pools_independent()
    upsert(ns.Job(spec=free, queued=True, validated=True, cancelled=True))
    assert feed.pools_independent()
    both = dataclasses.replace(spec, id="c", pools=("p0", "p1"))
    upsert(ns.Job(spec=both, queued=True, validated=True, pools=("p0", "p1")))
    assert not feed.pools_independent()


def test_algo_refuses_what_is_not_ported():
    """Nothing of the algo's configuration is refused any more: market
    pools, bid prices, the gang pricer, the optimiser and priority
    overrides construct as in the JAX package, and the one refusal left is
    the JAX package's own -- a market pool without a bid-price provider
    raises ValueError on both sides."""
    from armada_tpu.scheduler.providers import StaticBidPriceProvider as JaxBids
    from armada_tpu_torch.scheduler.providers import (
        StaticBidPriceProvider, StaticPriorityOverrideProvider,
    )

    for ns, bids in ((_Jax, JaxBids({})), (_Port, StaticBidPriceProvider({}))):
        base = dict(queues=lambda: [], clock_ns=lambda: NOW_NS, **ns.device_kw)
        market = ns.SchedulingConfig(pools=(ns.PoolConfig("m", market_driven=True),))
        with pytest.raises(ValueError, match="market driven"):
            ns.Algo(market, **base)
        algo = ns.Algo(market, bid_prices=bids, **base)
        assert algo.gang_pricer is None and algo.optimiser is None
    ns = _Port
    base = dict(queues=lambda: [], clock_ns=lambda: NOW_NS, device="cpu")
    priced = ns.SchedulingConfig(pools=(ns.PoolConfig(
        "m", market_driven=True,
        gangs_to_price=(("one", t_config.GangDefinition(size=1, resources={"cpu": 1})),)),))
    assert ns.Algo(priced, bid_prices=StaticBidPriceProvider({}), **base).gang_pricer is not None
    opt = ns.Algo(ns.SchedulingConfig(optimiser_enabled=True), collect_stats=False, **base)
    assert opt.optimiser is not None and opt.collect_stats
    ov = StaticPriorityOverrideProvider({("default", "q"): 2.0})
    assert ns.Algo(ns.SchedulingConfig(), priority_overrides=ov, **base).priority_overrides is ov


def test_armed_loop_shapes_raise(monkeypatch):
    """ARMADA_CACHE_SLOTS / ARMADA_BATCH_K arm K11's variants, which are
    ported now: the armed round runs and equals the JAX package's round
    under the same environment, kernel_iters included (the cache off on
    both sides for the pick chain: the JAX package's CPU default would arm
    it, and the cache forces batch_k = 1).  ARMADA_COMMIT_K is ported
    (tests/test_torch_loop_shapes*.py); an armed ARMADA_COMMIT_K resolves
    batch_k to 1, as in JAX."""
    stacked, lanes, meta = _synthetic_lanes(8, 2)
    p = problem_from_numpy(lanes[0], "cpu")
    for env in (dict(ARMADA_CACHE_SLOTS="64"), dict(ARMADA_CACHE_SLOTS="0", ARMADA_BATCH_K="8")):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        want = jax_fs.schedule_round(lanes[0], **meta)
        got = t_fs.schedule_round(p, **meta, device="cpu")
        for field, a, b in zip(got._fields, want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{env} {field}")
        assert int(got.n_slots) > 0
        for name in env:
            monkeypatch.delenv(name)
    monkeypatch.setenv("ARMADA_COMMIT_K", "1")
    assert int(t_fs.schedule_round(p, **meta, device="cpu").n_slots) > 0
    monkeypatch.setenv("ARMADA_BATCH_K", "8")
    monkeypatch.setenv("ARMADA_COMMIT_K", "8")
    assert t_fs.round_statics(p)["commit_k"] == 8
    assert t_fs.round_statics(p)["batch_k"] == 1
    assert int(t_fs.schedule_round(p, **meta, device="cpu").n_slots) > 0