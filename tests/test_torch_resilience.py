"""The port's runtime and resilience layer against the JAX package's.

Each test runs the same world, made from a numpy seed, and the same drill
through the JAX package and through the port with device="cpu", one side at
a time, and compares what a consumer reads: decisions, supervisor snapshots
(backend, fallbacks, consecutive_failures, promotions), quarantine strikes,
PoolStats.degraded and dispatch_failed, and cycle-trace annotations.  No
test asserts an elapsed time: hang drills use ARMADA_FAULT_HANG_S <= 1 and
deadlines <= 0.2 s, and every abandoned worker is joined before the test
ends.

- the fault harness (core/faults): spec parsing, one-shot entries,
  after_n, the round_corrupt mode filter, the bounded hang;
- the watchdog (core/watchdog): run_with_deadline, the abandoned worker
  that launches nothing, the re-probe promoting after N healthy probes,
  the in-process launch check refusing a promotion;
- the failover ladder: an injected error and hang bit-equal, incremental
  failover resetting the device caches, a RuntimeError from a kernel
  wrapper propagating, a CUDA error walking the ladder, the round_corrupt
  drills refused and re-run, an unarmed round never falling back to the
  CPU, the mesh ladder's rungs on a CPU mesh;
- the multi-pool cycle with a drill on one pool;
- the device quarantine, the node quarantine, the race harness and the
  cycle trace.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import pytest
import torch

import armada_tpu.models as jm
from armada_tpu.analysis import tsan as jax_tsan
from armada_tpu.core import faults as jax_faults
from armada_tpu.core import watchdog as jax_watchdog
from armada_tpu.models import verify as jax_verify
from armada_tpu.ops import trace as jax_trace
from armada_tpu.parallel import serving as jax_serving
from armada_tpu.scheduler import quarantine as jax_quarantine

import armada_tpu_torch.models as tm
from armada_tpu_torch.analysis import tsan as t_tsan
from armada_tpu_torch.core import faults as t_faults
from armada_tpu_torch.core import watchdog as t_watchdog
from armada_tpu_torch.models import explain as t_explain
from armada_tpu_torch.models import verify as t_verify
from armada_tpu_torch.ops import trace as t_trace
from armada_tpu_torch.parallel import serving as t_serving
from armada_tpu_torch.scheduler import quarantine as t_quarantine
from tests.test_torch_pool_parallel import (
    NOW_NS, MultiPoolWorld, _dispatch_specs, _dispatch_world, _Jax, _outcome_key, _Port,
)

SIDES = ("jax", "port")
FAULTS = dict(jax=jax_faults, port=t_faults)
WATCHDOG = dict(jax=jax_watchdog, port=t_watchdog)
QUARANTINE = dict(jax=jax_quarantine, port=t_quarantine)
TRACE = dict(jax=jax_trace, port=t_trace)
NS = dict(jax=_Jax, port=_Port)
SNAP_KEYS = ("backend", "fallbacks", "consecutive_failures", "promotions")


def _reset_all() -> None:
    for side in SIDES:
        FAULTS[side].reset_counters()
        WATCHDOG[side].reset_supervisor()
        QUARANTINE[side].reset_device_quarantine()
        TRACE[side].reset_recorder()
    jax_verify.reset_verify_state()
    t_verify.reset_verify_state()
    jax_serving.reset_mesh_serving()
    t_serving.reset_mesh_serving()
    tm.reset_stack_cache()
    t_explain.reset_cadence()


def _join_abandoned() -> None:
    """Join every watchdog worker of either package (a hang drill's worker
    sleeps at most ARMADA_FAULT_HANG_S)."""
    for t in threading.enumerate():
        if t.name.startswith("watchdog:"):
            t.join(30.0)
    assert t_watchdog.drain_abandoned(30.0) == 0


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh counters, supervisors, quarantines and recorders on both sides;
    automatic re-probe off (tests promote explicitly); each package's reset
    hooks saved and restored, so one test's caches never absorb another's
    transitions."""
    for name in ("ARMADA_FAULT", "ARMADA_WATCHDOG_S", "ARMADA_VERIFY", "ARMADA_POOL_PARALLEL",
                 "ARMADA_QUARANTINE_STRIKES", "ARMADA_TRACE", "ARMADA_FAULT_HANG_S",
                 "ARMADA_EXPLAIN_INTERVAL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ARMADA_REPROBE_INTERVAL_S", "0")
    saved = {s: list(WATCHDOG[s]._reset_hooks) for s in SIDES}
    _reset_all()
    yield
    _join_abandoned()
    _reset_all()
    for s in SIDES:
        WATCHDOG[s]._reset_hooks[:] = saved[s]


def _snap(side) -> dict:
    s = WATCHDOG[side].supervisor().snapshot()
    return {k: s[k] for k in SNAP_KEYS}


def _make_config(ns, **kw):
    return ns.SchedulingConfig(
        shape_bucket=64,
        priority_classes={
            "low": ns.PriorityClass("low", priority=100, preemptible=True),
            "high": ns.PriorityClass("high", priority=1000, preemptible=False),
        },
        default_priority_class="high",
        maximum_scheduling_burst=32,
        **kw,
    )


def _make_world(ns, cfg, num_nodes=6, num_queues=2):
    F = cfg.resource_list_factory()
    nodes = [ns.NodeSpec(id=f"n{i}", pool="default",
                         total_resources=F.from_mapping({"cpu": "16", "memory": "64"}))
             for i in range(num_nodes)]
    return F, nodes, [ns.Queue(f"q{i}", weight=1.0 + i) for i in range(num_queues)]


def _make_job(ns, F, i, queue="q0", pc="high", cpu=2):
    return ns.JobSpec(id=f"j{i}", queue=queue, priority_class=pc, submit_time=float(i),
                      resources=F.from_mapping({"cpu": str(cpu), "memory": "1"}))


def _round_inputs(side):
    ns = NS[side]
    cfg = _make_config(ns)
    F, nodes, queues = _make_world(ns, cfg)
    jobs = [_make_job(ns, F, i, f"q{i % 2}") for i in range(12)]
    running = [ns.RunningJob(job=_make_job(ns, F, 100 + i, "q0", pc="low", cpu=14),
                             node_id=f"n{i}") for i in range(2)]
    return cfg, nodes, queues, jobs, running


def _pool_round(side, inputs):
    cfg, nodes, queues, jobs, running = inputs
    mod, kw = (jm, {}) if side == "jax" else (tm, dict(device="cpu"))
    out = mod.run_scheduling_round(cfg, pool="default", nodes=nodes, queues=queues,
                                   queued_jobs=jobs, running=running, collect_stats=False, **kw)
    return sorted(out.scheduled.items()), sorted(out.preempted)


# --- 1. the fault harness ---------------------------------------------------------


def _spec_script(faults, monkeypatch) -> list:
    out = []

    def fire(site, **kw):
        try:
            faults.check(site, **kw)
            out.append((site, None))
        except Exception as e:  # noqa: BLE001 - the type is the record
            out.append((site, type(e).__name__))

    monkeypatch.setenv("ARMADA_FAULT", "siteA:error,siteB:error:2, bad")
    for site in ("siteA", "siteA", "siteB", "siteB", "siteB", "siteB"):
        fire(site)
    faults.reset_counters()
    monkeypatch.setenv("ARMADA_FAULT", "siteC:error")
    fire("siteC", exc=ConnectionError)
    fire("other")
    monkeypatch.delenv("ARMADA_FAULT")
    fire("siteA")
    out.append(faults.armed("siteA"))
    monkeypatch.setenv("ARMADA_FAULT", "siteA:hang:4")
    out.append(faults.armed("siteA"))
    return out


def test_fault_spec_parsing_and_one_shot(monkeypatch):
    """One-shot entries, after_n, a custom exception type, unknown sites and
    malformed entries: the port's harness answers every check as the JAX
    package's does."""
    want = _spec_script(jax_faults, monkeypatch)
    jax_faults.reset_counters()
    got = _spec_script(t_faults, monkeypatch)
    assert got == want
    assert want[:6] == [("siteA", "FaultInjected"), ("siteA", None), ("siteB", None),
                        ("siteB", None), ("siteB", "FaultInjected"), ("siteB", None)]


def test_fault_hang_is_bounded_and_one_shot(monkeypatch):
    monkeypatch.setenv("ARMADA_FAULT", "siteH:hang")
    monkeypatch.setenv("ARMADA_FAULT_HANG_S", "0.05")
    for side in SIDES:
        assert FAULTS[side].check("siteH") is None  # returns after the bounded hang
        assert FAULTS[side].active("siteH") is None  # spent


def _after_n_script(faults, monkeypatch) -> list:
    out = []
    monkeypatch.setenv("ARMADA_FAULT", "s:error:1,s:hang:3")
    out += [faults.active("s") for _ in range(6)]
    faults.reset_counters()
    monkeypatch.setenv("ARMADA_FAULT", "s:error:nope,junk,s2:error")
    out += [faults.active("s"), faults.active("s2")]
    monkeypatch.setenv("ARMADA_FAULT", "s3:error")
    out += [faults.active("s3"), faults.active("s3")]
    faults.reset_counters()
    out.append(faults.active("s3"))
    faults.reset_counters()
    monkeypatch.setenv("ARMADA_FAULT", "round_corrupt:bytes:1,round_corrupt:header")
    hl, b = ("header", "lane"), ("bytes",)
    out += [faults.active("round_corrupt", modes=hl), faults.active("round_corrupt", modes=hl)]
    out += [faults.active("round_corrupt", modes=b) for _ in range(3)]
    faults.reset_counters()
    out += [faults.active("round_corrupt"), faults.active("round_corrupt")]
    return out


def test_after_n_independence_and_the_round_corrupt_mode_filter(monkeypatch):
    """after_n counts per (site, mode, after_n) entry, in spec order; a
    filtered check point neither consumes nor advances another mode's
    entry -- the same answers on both sides."""
    want = _after_n_script(jax_faults, monkeypatch)
    got = _after_n_script(t_faults, monkeypatch)
    assert got == want
    assert want[:6] == [None, "error", None, None, "hang", None]


# --- 2. the watchdog ----------------------------------------------------------------


def test_run_with_deadline_and_the_abandoned_worker(monkeypatch):
    """Results and errors cross the deadline thread on both sides; a timeout
    raises RoundTimeout.  The port's abandoned worker then launches
    nothing: its next launch_guard raises, and nothing after it runs."""
    for side in SIDES:
        wd = WATCHDOG[side]
        assert wd.run_with_deadline(lambda: 42, 5.0) == 42
        with pytest.raises(ValueError):
            wd.run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("x")), 5.0)
    release = threading.Event()
    launched = []

    def wedge():
        release.wait(10.0)
        t_watchdog.launch_guard("round")
        launched.append(True)

    with pytest.raises(t_watchdog.RoundTimeout):
        t_watchdog.run_with_deadline(wedge, 0.05)
    assert len(t_watchdog.abandoned_workers()) == 1
    release.set()
    assert t_watchdog.drain_abandoned(10.0) == 0
    assert launched == []
    # a guard outside any attempt, or in a live attempt, is free
    t_watchdog.launch_guard()
    assert t_watchdog.run_with_deadline(lambda: t_watchdog.launch_guard() or 7, 5.0) == 7


def _reprobe(side, probe_results, local=None) -> tuple:
    sup = WATCHDOG[side].supervisor()
    sup.configure(deadline_s=60.0, reprobe_interval_s=0.01, healthy_checks=2)
    probes = []

    def fake_probe(timeout_s):
        probes.append(timeout_s)
        i = len(probes) - 1
        return (probe_results[i] if i < len(probe_results) else True), "cpu"

    sup._probe = fake_probe
    if local is not None:
        sup._local_check = local
    resets = []
    keeper = lambda: resets.append(sup.backend)  # noqa: E731
    WATCHDOG[side].add_reset_hook(keeper)
    sup.record_failure("test wedge")
    limit = time.monotonic() + 20.0  # a bounded wait, not a measurement
    while sup._reprobe_thread is not None and time.monotonic() < limit:
        time.sleep(0.01)
    return _snap(side), resets, len(probes), sup


def test_reprobe_promotes_after_n_healthy_probes():
    """A failure degrades and fires the hooks; the re-probe promotes after
    two healthy probes following an unhealthy one, firing the hooks again:
    the same snapshot on both sides."""
    got = {side: _reprobe(side, [False, True, True])[:3] for side in SIDES}
    assert got["port"] == got["jax"]
    snap, resets, probes = got["port"]
    assert snap == dict(backend="device", fallbacks=1, consecutive_failures=0, promotions=1)
    assert resets == ["cpu", "device"] and probes == 3


def test_promotion_needs_a_launch_in_this_process():
    """Healthy probes do not promote while this process cannot launch (a
    sticky CUDA error): the port stays degraded and says why; once the
    launch succeeds, the next healthy probe promotes."""
    state = {"ok": False}

    def local(timeout_s):
        return state["ok"], "in-process launch failed: illegal address"

    sup = t_watchdog.supervisor()
    sup.configure(reprobe_interval_s=0, healthy_checks=1)
    sup._local_check = local
    sup.record_failure("CUDA error")
    assert sup.promote() is False and sup.degraded
    assert "illegal address" in sup.snapshot()["promotion_refused"]
    state["ok"] = True
    assert sup.promote() is True and not sup.degraded
    assert sup.snapshot()["promotion_refused"] is None


def test_healthz_reports_device_state():
    """The supervisor's snapshot and the verify block's quarantine
    scoreboard, the two device blocks of the health report, read the same
    on both sides through a failure."""
    blocks = {}
    for side, verify in (("jax", jax_verify), ("port", t_verify)):
        before = _snap(side)
        WATCHDOG[side].supervisor().record_failure("drill")
        after = WATCHDOG[side].supervisor().snapshot()
        q = verify.healthz_block()["quarantine"]
        blocks[side] = (before, {k: after[k] for k in SNAP_KEYS}, after["last_fallback_reason"],
                        q["strike_threshold"], q["strike_totals"], q["quarantined"])
    assert blocks["port"] == blocks["jax"]
    assert blocks["port"][1]["backend"] == "cpu" and blocks["port"][2] == "drill"


# --- 3. the failover ladder -----------------------------------------------------------


def _error_failover(side, monkeypatch) -> dict:
    inputs = _round_inputs(side)
    clean = _pool_round(side, inputs)
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    monkeypatch.setenv("ARMADA_FAULT", "device_round:error")
    faulted = _pool_round(side, inputs)
    snap = WATCHDOG[side].supervisor().snapshot()
    degraded = _pool_round(side, inputs)
    WATCHDOG[side].supervisor().promote()
    promoted = _pool_round(side, inputs)
    monkeypatch.delenv("ARMADA_FAULT")
    monkeypatch.delenv("ARMADA_WATCHDOG_S")
    return dict(clean=clean, faulted=faulted, degraded=degraded, promoted=promoted,
                snap={k: snap[k] for k in SNAP_KEYS}, reason=snap["last_fallback_reason"],
                after=_snap(side))


def test_device_error_failover_bit_equal(monkeypatch):
    """An injected error under an armed deadline completes the round on the
    CPU rung with the fault-free decisions; the degraded steady state and
    the promoted card decide the same: every figure equal to the JAX
    package's."""
    got = {side: _error_failover(side, monkeypatch) for side in SIDES}
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["clean"][0], "the scenario must schedule"
    assert p["faulted"] == p["degraded"] == p["promoted"] == p["clean"]
    assert p["snap"] == dict(backend="cpu", fallbacks=1, consecutive_failures=1, promotions=0)
    assert "injected fault" in p["reason"]
    assert p["after"] == dict(backend="device", fallbacks=1, consecutive_failures=0, promotions=1)


def test_device_hang_failover(monkeypatch):
    """A hang at the device attempt: the watchdog abandons the worker at the
    deadline and the CPU re-run decides as a fault-free run, on both sides
    (no elapsed-time assertion; the abandoned workers are joined)."""
    got = {}
    for side in SIDES:
        inputs = _round_inputs(side)
        clean = _pool_round(side, inputs)
        monkeypatch.setenv("ARMADA_WATCHDOG_S", "0.2")
        monkeypatch.setenv("ARMADA_FAULT", "device_round:hang")
        monkeypatch.setenv("ARMADA_FAULT_HANG_S", "1")
        faulted = _pool_round(side, inputs)
        for name in ("ARMADA_FAULT", "ARMADA_WATCHDOG_S"):
            monkeypatch.delenv(name)
        snap = WATCHDOG[side].supervisor().snapshot()
        got[side] = (clean, faulted, {k: snap[k] for k in SNAP_KEYS},
                     snap["last_fallback_reason"].split(":")[0])
        _join_abandoned()
    assert got["port"] == got["jax"]
    clean, faulted, snap, reason = got["port"]
    assert faulted == clean and snap["backend"] == "cpu" and reason == "RoundTimeout"


def _incremental_script(side, monkeypatch, inject: bool) -> list:
    ns = NS[side]
    FAULTS[side].reset_counters()
    WATCHDOG[side].reset_supervisor()
    cfg = _make_config(ns)
    F, nodes, queues = _make_world(ns, cfg)
    feed = ns.Feed(cfg, **ns.device_kw)
    b = feed.builder_for("default")
    b.set_queues(queues)
    b.set_nodes(nodes)
    spec_of = {}
    mod, kw = (jm, {}) if side == "jax" else (tm, dict(device="cpu"))

    def submit(lo, n):
        specs = [_make_job(ns, F, lo + i) for i in range(n)]
        spec_of.update((s.id, s) for s in specs)
        b.submit_many(specs)

    submit(0, 10)
    decisions = []
    for cycle in range(3):
        if inject and cycle == 1:
            monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
            monkeypatch.setenv("ARMADA_FAULT", "device_round:error")
        bundle, ctx = b.assemble_delta()
        devcache = feed.devcache_for("default")
        _, outcome = mod.run_round_on_device(
            bundle.stats_view(), ctx, cfg,
            device_problem=lambda dc=devcache, b_=bundle: dc.apply(b_),
            host_problem=bundle.materialize, **kw)
        if inject and cycle == 1:
            # the reset hook replaced the cache and disarmed the prefetch
            assert feed.devcaches["default"]._prev is None
            assert b._last_sig is None
            assert b.prefetch_content(feed.devcaches["default"]) == 0
            assert WATCHDOG[side].supervisor().degraded
        if inject and cycle == 2:
            # degraded: the fresh cache uploaded whole, to the CPU
            dc = feed.devcaches["default"]
            if side == "port":
                assert dc.last_apply == "full" and dc.resident.g_req.device.type == "cpu"
        decisions.append((sorted(outcome.scheduled.items()), sorted(outcome.preempted)))
        b.remove_many(outcome.scheduled.keys())
        b.lease_many([ns.RunningJob(job=spec_of[jid], node_id=nid)
                      for jid, nid in outcome.scheduled.items()])
        submit(100 * (cycle + 1), 4)
    monkeypatch.delenv("ARMADA_FAULT", raising=False)
    monkeypatch.delenv("ARMADA_WATCHDOG_S", raising=False)
    return decisions


def test_incremental_failover_resets_device_state(monkeypatch):
    """A device loss on the slab path: the feed's reset hook replaces the
    delta cache and disarms the builders' prefetch; the next cycles upload
    whole and decide as a fault-free replay -- and as the JAX package."""
    monkeypatch.setenv("ARMADA_PIPELINE_PREFETCH", "1")
    got = {side: (_incremental_script(side, monkeypatch, False),
                  _incremental_script(side, monkeypatch, True)) for side in SIDES}
    assert got["port"] == got["jax"]
    clean, faulted = got["port"]
    assert faulted == clean and any(sched for sched, _ in clean)


def test_a_wrapper_runtime_error_propagates_and_degrades_nothing(monkeypatch):
    """The ladder's error set is narrow: a RuntimeError out of a kernel
    wrapper (an argument check, a failed build) propagates from an armed
    round and degrades nothing; a torch.AcceleratorError (a CUDA error)
    walks the ladder and the CPU rung decides as a clean round."""
    from armada_tpu_torch.kernels import compact as t_compact

    inputs = _round_inputs("port")
    clean = _pool_round("port", inputs)
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    real = t_compact.compact_result
    calls = []

    def failing(kind):
        def wrapper(*a, **kw):
            calls.append(kind)
            if len(calls) == 1:
                raise kind("compact: launch failed (argument check -3)")
            return real(*a, **kw)
        return wrapper

    monkeypatch.setattr(t_compact, "compact_result", failing(RuntimeError))
    with pytest.raises(RuntimeError, match="argument check"):
        _pool_round("port", inputs)
    assert _snap("port") == dict(backend="device", fallbacks=0, consecutive_failures=0,
                                 promotions=0)
    calls.clear()
    monkeypatch.setattr(t_compact, "compact_result", failing(torch.AcceleratorError))
    assert _pool_round("port", inputs) == clean
    snap = t_watchdog.supervisor().snapshot()
    assert snap["backend"] == "cpu" and snap["last_fallback_reason"].startswith("AcceleratorError")


def _corrupt_drills(side, monkeypatch, strikes: int) -> dict:
    """Each round_corrupt mode on a verified armed round: refused, re-run on
    the CPU rung, promoted back between drills."""
    inputs = _round_inputs(side)
    verify = jax_verify if side == "jax" else t_verify
    monkeypatch.setenv("ARMADA_VERIFY", "1")
    clean = _pool_round(side, inputs)
    QUARANTINE[side].reset_device_quarantine(strikes=strikes)
    out = dict(clean=clean, rounds=[], sites=[])
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    for mode in ("header", "lane", "bytes"):
        FAULTS[side].reset_counters()
        monkeypatch.setenv("ARMADA_FAULT", f"round_corrupt:{mode}")
        before = dict(verify.verify_state().snapshot()["failures_by_site"])
        out["rounds"].append(_pool_round(side, inputs))
        after = verify.verify_state().snapshot()["failures_by_site"]
        out["sites"].append(sorted(k for k, v in after.items() if v > before.get(k, 0)))
        out.setdefault("promoted", []).append(WATCHDOG[side].supervisor().promote())
    q = QUARANTINE[side].device_quarantine().snapshot()
    out["strikes"] = sorted(q["strike_totals"].values())
    out["quarantined"] = len(q["quarantined"])
    out["snap"] = _snap(side)
    out["failures"] = verify.verify_state().failures
    monkeypatch.delenv("ARMADA_FAULT")
    return out


def test_round_corrupt_drills_are_refused_and_rerun(monkeypatch):
    """header, lane and bytes: each verified round is refused, re-run on the
    CPU rung and equals the honest round; each adds one quarantine strike;
    at the strike threshold the gate blocks the promotion -- the same
    verdicts, strikes and snapshots as the JAX package's."""
    got = {side: _corrupt_drills(side, monkeypatch, strikes=3) for side in SIDES}
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["rounds"] == [p["clean"]] * 3
    assert p["failures"] == 3
    assert p["sites"] == [["gang-count", "slot-count"], ["lane", "node-capacity"],
                          ["fingerprint"]]
    assert p["strikes"] == [3] and p["quarantined"] == 1
    assert p["promoted"] == [True, True, False]
    assert p["snap"]["backend"] == "cpu" and p["snap"]["fallbacks"] == 3
    # the operator clear lets the next healthy probe promote
    assert t_quarantine.device_quarantine().clear()
    assert t_watchdog.supervisor().promote() is True


@pytest.mark.parametrize("drill", ["round_corrupt:header", "device_round:error"])
def test_an_unarmed_round_never_falls_back_to_the_cpu(monkeypatch, drill):
    """The ladder is opt-in: unarmed, a refused verification propagates
    after its quarantine strike and a drilled device error propagates;
    neither re-runs the round on the CPU rung nor degrades the supervisor
    (the JAX package walks the ladder on a refused verification even
    unarmed), and the next round decides as a clean one."""
    inputs = _round_inputs("port")
    monkeypatch.setenv("ARMADA_VERIFY", "1")
    clean = _pool_round("port", inputs)
    monkeypatch.setenv("ARMADA_FAULT", drill)
    with pytest.raises((t_verify.RoundVerificationError, t_faults.FaultInjected)):
        _pool_round("port", inputs)
    monkeypatch.delenv("ARMADA_FAULT")
    assert _snap("port") == dict(backend="device", fallbacks=0, consecutive_failures=0,
                                 promotions=0)
    strikes = t_quarantine.device_quarantine().snapshot()["strike_totals"]
    assert sorted(strikes.values()) == ([1] if drill.startswith("round_corrupt") else [])
    assert _pool_round("port", inputs) == clean


def _mesh_ladder(side, monkeypatch) -> dict:
    inputs = _round_inputs(side)
    verify = jax_verify if side == "jax" else t_verify
    serving = jax_serving if side == "jax" else t_serving
    clean = _pool_round(side, inputs)
    ms = serving.mesh_serving()
    ms.configure(8)
    monkeypatch.setenv("ARMADA_VERIFY", "1")
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    rungs = []
    real = ms.degrade

    def degrade(reason):
        mesh = real(reason)
        rungs.append((reason.split(":")[0], None if mesh is None else int(mesh.devices.size)))
        return mesh

    monkeypatch.setattr(ms, "degrade", degrade)
    # a CUDA-error-shaped drill at the device attempt, then a refused
    # verification on the 4-shard rung: two rungs down, then success on 2
    monkeypatch.setenv("ARMADA_FAULT", "device_round:error,round_corrupt:header")
    got = _pool_round(side, inputs)
    out = dict(clean=clean, got=got, rungs=rungs, snap=_snap(side),
               devices=ms.snapshot()["devices"], degrades=ms.snapshot()["degrades"],
               failures=verify.verify_state().failures)
    monkeypatch.delenv("ARMADA_FAULT")
    ms.restore()
    out["restored"] = ms.snapshot()["devices"]
    ms.configure(0)
    return out


def test_mesh_ladder_on_a_cpu_mesh(monkeypatch):
    """The mesh rungs before the CPU rung: an error on the 8-shard round
    re-runs on 4 shards, a refused verification there re-runs on 2, which
    answers as the single-device round -- the same rung sequence, outcome
    and snapshots as the JAX package's on its 8-device CPU mesh; no rung
    that recovers records a supervisor failure."""
    got = {side: _mesh_ladder(side, monkeypatch) for side in SIDES}
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["got"] == p["clean"]
    assert p["rungs"] == [("FaultInjected", 4), ("RoundVerificationError", 2)]
    assert p["snap"]["fallbacks"] == 0 and p["snap"]["backend"] == "device"
    assert (p["devices"], p["degrades"], p["restored"]) == (2, 2, 8)
    # the port's mesh lies on one card: the refused rung struck it once
    assert sorted(t_quarantine.device_quarantine().snapshot()["strike_totals"].values()) == [1]


# --- 4. the multi-pool cycle -------------------------------------------------------------


def test_dispatch_pool_rounds_with_a_drilled_pool(monkeypatch):
    """A drill fails the third pool's armed dispatch: that pool alone is in
    dispatch_failed and re-runs on the CPU rung, nothing stacks (a drill is
    armed), and every pool decides as the JAX package's."""
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    monkeypatch.setenv("ARMADA_FAULT", "device_round:error:2")
    got = {}
    for side, mod, jax_side in (("jax", jm, True), ("port", tm, False)):
        ns = NS[side]
        cfg, builders, caches = _dispatch_world(ns, jax_side)
        pspecs = []
        for pi, pool in enumerate(builders):
            builders[pool].submit_many(_dispatch_specs(ns, cfg, pool, 0,
                                                       np.random.default_rng(pi)))
            bundle, ctx = builders[pool].assemble_delta()
            pspecs.append(mod.PoolRoundSpec(
                problem=bundle.stats_view(), ctx=ctx,
                device_problem=lambda c=caches[pool], x=bundle: c.apply(x),
                host_problem=bundle.materialize))
        kw = {} if jax_side else dict(device="cpu")
        fins, n, npools, failed = mod.dispatch_pool_rounds(pspecs, cfg, **kw)
        got[side] = ((n, npools, failed), [_outcome_key(f()[1]) for f in fins], _snap(side))
        FAULTS[side].reset_counters()
    assert got["port"] == got["jax"]
    assert got["port"][0] == (0, 0, {2})
    assert got["port"][2]["fallbacks"] == 1


def _drilled_cycles(side, monkeypatch, parallel: bool, drill: str):
    monkeypatch.setenv("ARMADA_POOL_PARALLEL", "1" if parallel else "0")
    world = MultiPoolWorld(NS[side], 4, True, 3)
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "60")
    out = []
    for c in range(3):
        if c == 1:
            monkeypatch.setenv("ARMADA_FAULT", drill)
        txn = world.jdb.write_txn()
        world._submit(txn, 14 if c == 0 else 6, "low" if c < 2 else "high", gang_every=5)
        res = world.algo.schedule(txn, world.executors, NOW_NS)
        txn.commit()
        out.append(([(ps.pool, sorted(ps.outcome.scheduled.items()),
                      sorted(ps.outcome.preempted), ps.degraded) for ps in res.pools],
                    [(job.id, run.id, run.node_id) for job, run in res.scheduled]))
        if c == 1:
            monkeypatch.delenv("ARMADA_FAULT")
            WATCHDOG[side].supervisor().promote()
    return out, _snap(side)


@pytest.mark.parametrize("parallel", [True, False])
def test_multi_pool_cycle_with_a_drill_on_one_pool(monkeypatch, parallel):
    """FairSchedulingAlgo over four pools, a drill on the second pool's
    device attempt in the middle cycle: the same PoolStats.degraded vector,
    decisions and supervisor snapshot as the JAX package's, serial and
    pool-parallel; the drilled cycle decides as an undrilled one."""
    got = {}
    for side in SIDES:
        got[side] = _drilled_cycles(side, monkeypatch, parallel, "device_round:error:1")
        _reset_all()
    assert got["port"] == got["jax"]
    cycles, snap = got["port"]
    degraded = [[d for *_x, d in pools] for pools, _ in cycles]
    assert degraded[0] == degraded[2] == [False] * 4
    # serial: the pools after the failure run on the CPU rung, degraded;
    # pool-parallel: they were dispatched before it, and the rule reads the
    # supervisor before the window's dispatch
    assert degraded[1] == ([False, True, False, False] if parallel
                           else [False, True, True, True])
    assert snap == dict(backend="device", fallbacks=1, consecutive_failures=0, promotions=1)
    clean, _ = _drilled_cycles("port", monkeypatch, parallel, "")
    assert [[p[:3] for p in pools] for pools, _ in clean] == \
        [[p[:3] for p in pools] for pools, _ in cycles]


# --- 5. quarantine ----------------------------------------------------------------------------

S = int(1e9)


def _node_quarantine(q_mod) -> list:
    q = q_mod.NodeQuarantine(failure_threshold=3, window_s=60, cooldown_s=120)
    out = [q.record_failure("n0", 0), q.record_failure("n0", 10 * S),
           q.record_failure("n0", 20 * S), q.quarantined(21 * S),
           q.quarantined(20 * S + 121 * S)]
    q2 = q_mod.NodeQuarantine(failure_threshold=3, window_s=60, cooldown_s=120)
    q2.record_failure("n1", 0)
    q2.record_failure("n1", 70 * S)
    out += [q2.record_failure("n1", 140 * S), q2.quarantined(141 * S)]
    off = q_mod.NodeQuarantine(failure_threshold=0)
    out += [off.record_failure("n0", 0), off.quarantined(1)]
    return out


def _device_quarantine(q_mod) -> list:
    dq = q_mod.DeviceQuarantine(strikes=2, window_s=600)
    out = [dq.record_strikes(["d0"], "a"), dq.promotion_blocked(),
           dq.record_strikes(["d0", "d1", ""], "b"), sorted(dq.quarantined()),
           dq.promotion_blocked(), dq.clear("d1"), dq.clear(), dq.promotion_blocked()]
    off = q_mod.DeviceQuarantine(strikes=0)
    out += [off.record_strikes(["d0"] * 3, "c"), off.snapshot()["strike_totals"]]
    return out


def test_quarantine_threshold_window_cooldown_and_disabled():
    """The node quarantine's threshold, window, cooldown and disabled form,
    and the device quarantine's strikes, gate and clear: the same answers
    on both sides."""
    assert _node_quarantine(t_quarantine) == _node_quarantine(jax_quarantine)
    assert _device_quarantine(t_quarantine) == _device_quarantine(jax_quarantine)
    assert _node_quarantine(t_quarantine)[3] == {"n0"}


def test_quarantine_gate_blocks_the_mesh_restore():
    ms = t_serving.mesh_serving()
    ms.configure(8)
    assert ms.serving_mesh("cpu").devices.size == 8
    dq = t_quarantine.reset_device_quarantine(strikes=1)
    ms.degrade("drill")
    dq.record_strikes(["cpu"], "refused")
    assert ms.restore() is False and ms.snapshot()["devices"] == 4
    dq.clear()
    assert ms.restore() is True and ms.snapshot()["devices"] == 8
    ms.configure(0)


# --- 6. the race harness ------------------------------------------------------------------------


@pytest.fixture
def armed():
    was = {m: m.enabled() for m in (jax_tsan, t_tsan)}
    for m in (jax_tsan, t_tsan):
        m.enable()
        m.reset()
    yield
    for m, w in was.items():
        m.take_violations()
        if not w:
            m.disable()


def _lock_order(tsan) -> list:
    tsan.reset()
    a, b = tsan.make_lock("inv.a"), tsan.make_lock("inv.b")
    with a:
        with b:
            pass
    clean = tsan.take_violations()
    with b:
        with a:
            pass
    inv = tsan.take_violations()
    c, d = tsan.make_lock("cls.instance"), tsan.make_lock("cls.instance")
    with c:
        with d:
            pass
    same = tsan.take_violations()
    g = tsan.GenerationGuard("unit")
    tok = g.begin()
    ok = g.commit(tok, "clean")
    g.bump()
    stale = (g.commit(tok, "stale"), tsan.take_violations())
    guard = (tsan.check_generation("builder.prefetch_mark", 0, 0),
             tsan.check_generation("builder.prefetch_mark", 0, 1), tsan.take_violations())
    return [clean, inv, same, ok, stale, guard]


def test_lock_order_and_generation_checks(armed):
    """A consistent order is clean, an inversion and same-name nesting are
    recorded, a stale commit and the builder's prefetch tripwire are
    recorded: the same violations, word for word, on both sides."""
    assert _lock_order(t_tsan) == _lock_order(jax_tsan)
    clean, inv, same, ok, stale, guard = _lock_order(t_tsan)
    assert clean == [] and len(inv) == 1 and "lock-order inversion" in inv[0]
    assert len(same) == 1 and ok is True and stale[0] is False and len(stale[1]) == 1
    assert guard[:2] == (True, False) and "builder.prefetch_mark" in guard[2][0]


def _small_bundle():
    ns = _Port
    cfg = _make_config(ns)
    F, nodes, queues = _make_world(ns, cfg)
    b = ns.IncrementalBuilder(cfg, "default", queues)
    b.set_nodes(nodes)
    b.submit_many([_make_job(ns, F, i) for i in range(6)])
    return b.assemble_delta()[0]


def test_stale_devcache_write_detected_and_a_clean_apply_records_nothing(armed):
    """A reset landing while apply() is in flight (an abandoned worker's
    interleaving, driven through the public path: the bundle's materialize
    fires the reset) is recorded; a clean apply records nothing; the reset
    still forces the next apply to upload whole."""
    from armada_tpu_torch.models.slab import DeviceDeltaCache

    bundle = _small_bundle()
    dc = DeviceDeltaCache("cpu")
    dc.apply(bundle)
    assert t_tsan.violations() == []
    real = bundle.materialize
    dc2 = DeviceDeltaCache("cpu")

    def materialize_and_reset():
        dc2.reset()  # the mid-flight device-loss reset
        return real()

    bundle.materialize = materialize_and_reset
    dc2.apply(bundle)
    found = t_tsan.take_violations()
    assert len(found) == 1
    assert "generation-stale write" in found[0] and "devcache" in found[0]
    assert dc2._sig is None and dc2.resets == 1


def test_prefetch_marks_under_tsan_stay_clean(armed, monkeypatch):
    """The incremental failover script with the harness armed: no violation
    on the port's side (the production guards keep every write in its
    generation)."""
    monkeypatch.setenv("ARMADA_PIPELINE_PREFETCH", "1")
    _incremental_script("port", monkeypatch, True)
    assert t_tsan.violations() == []


# --- 7. the cycle trace ---------------------------------------------------------------------------


def _trace_mechanics(trace_mod) -> list:
    rec = trace_mod.reset_recorder()
    with rec.cycle("cyc", seq=7):
        with rec.span("outer", pool="default"):
            with rec.span("inner"):
                pass
            rec.note("tick", bytes=42)
        with rec.span("second"):
            pass
    (t,) = rec.last()
    outer = t.root.children[0]
    out = [t.root.name, t.root.args, [c.name for c in t.root.children],
           [c.name for c in outer.children], outer.children[1].args]
    ring = trace_mod.reset_recorder(ring=3)
    for i in range(5):
        with ring.cycle("cyc", n=i):
            pass
    out.append([x.root.args["n"] for x in ring.last()])
    rec = trace_mod.reset_recorder()
    out.append(rec.span("x") is trace_mod._NOOP)
    with rec.cycle("cyc"):
        t1 = threading.Thread(target=lambda: rec.span("worker_span").__enter__(), daemon=True)
        t1.start()
        t1.join()
        with rec.cycle("inner"):
            rec.annotate(degraded=True, failover_reason="drill")
    (t,) = rec.last()
    out += [[c.name for c in t.root.children], t.root.args, rec.nested_cycles]
    block = rec.healthz_block()
    out += [block["cycles"], block["kind"], sorted(s["name"] for s in block["top_spans"])]
    doc = trace_mod.chrome_trace(rec.last())
    out.append(sorted({e["ph"] for e in doc["traceEvents"]}))
    return out


def test_trace_nesting_ring_noop_and_export(monkeypatch):
    """Span nesting, args and notes, the ring, the shared no-op span,
    cross-thread spans on the cycle root, a nested cycle degrading to a
    span, root annotations, the health block and the Chrome export: the
    same trees on both sides."""
    assert _trace_mechanics(t_trace) == _trace_mechanics(jax_trace)
    monkeypatch.setenv("ARMADA_TRACE", "0")
    rec = t_trace.reset_recorder()
    assert rec.cycle("x") is t_trace._NOOP


def _zombie(trace_mod) -> tuple:
    rec = trace_mod.reset_recorder()
    handle = []
    with rec.cycle("cyc"):
        with rec.span("round"):
            handle.append(rec.capture())
    (old,) = rec.last()
    n0 = old.span_count

    def zombie():
        rec.adopt(handle[0])
        with rec.span("late_kernel"):
            pass
        rec.note("late_xfer", bytes=1)

    with rec.cycle("next_cycle") as fresh:
        t = threading.Thread(target=zombie, daemon=True)
        t.start()
        t.join()
        fresh_count = fresh.span_count
    return old.span_count - n0, fresh_count, [c.name for c in rec.last()[-1].root.children]


def test_cross_thread_adoption_and_zombie_spans_dropped():
    """A worker adopting a captured handle nests under the caller's span;
    once that cycle finalized, its spans are dropped, charging nothing to
    the cycle that is live then -- on both sides."""
    assert _zombie(t_trace) == _zombie(jax_trace) == (0, 1, [])
    rec = t_trace.reset_recorder()
    with rec.cycle("cyc"):
        with rec.span("round"):
            t_watchdog.run_with_deadline(lambda: rec.span("kernel_dispatch").__enter__(), 5.0)
    (t,) = rec.last()
    assert [c.name for c in t.root.children[0].children] == ["kernel_dispatch"]


def _walk(span, out):
    out.append(span.name)
    for c in span.children:
        _walk(c, out)
    return out


def test_failover_cycle_attribution(monkeypatch):
    """Under a device_round hang the cycle that paid the failover carries
    it: the root annotated degraded with the reason, a cpu_failover span
    with the re-run's dispatch and fetch beneath it -- on both sides."""
    monkeypatch.setenv("ARMADA_WATCHDOG_S", "0.2")
    monkeypatch.setenv("ARMADA_FAULT", "device_round:hang")
    monkeypatch.setenv("ARMADA_FAULT_HANG_S", "1")
    got = {}
    for side in SIDES:
        inputs = _round_inputs(side)
        rec = TRACE[side].reset_recorder()
        with rec.cycle("drill_cycle"):
            sched, _ = _pool_round(side, inputs)
        (t,) = rec.last()
        failover = next(c for c in t.root.children if c.name == "cpu_failover")
        sub = set(_walk(failover, []))
        got[side] = (bool(sched), t.root.args["degraded"],
                     t.root.args["failover_reason"].split(":")[0],
                     {"kernel_dispatch", "fetch_decode"} <= sub)
        FAULTS[side].reset_counters()
        _join_abandoned()
    assert got["port"] == got["jax"] == (True, True, "RoundTimeout", True)


def test_pool_rounds_equal_with_tracing_armed(monkeypatch):
    """Tracing armed is decision-neutral: the multi-pool world decides the
    same traced and untraced, and the traced cycles carry the round spans
    and the overlap annotation (the device profiler bridge armed too)."""
    from tests.test_torch_pool_parallel import _run

    monkeypatch.setenv("ARMADA_TRACE", "0")
    plain = _run(_Port, monkeypatch, True, npools=3, seed=1)
    monkeypatch.setenv("ARMADA_TRACE", "1")
    monkeypatch.setenv("ARMADA_TRACE_TORCH", "1")
    rec = t_trace.reset_recorder()
    assert rec._torch_bridge
    cycles = []
    real_schedule = _Port.Algo.schedule

    def traced(self, *a, **kw):
        with t_trace.recorder().cycle("schedule"):
            out = real_schedule(self, *a, **kw)
        cycles.append(t_trace.recorder().last(1)[0])
        return out

    monkeypatch.setattr(_Port.Algo, "schedule", traced)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        armed_run = _run(_Port, monkeypatch, True, npools=3, seed=1)
    assert armed_run == plain
    names = set(_walk(cycles[-1].root, []))
    assert {"round", "kernel_dispatch", "fetch_decode", "apply_outcome", "devcache_apply",
            "assemble"} <= names
    assert "pool_overlap_ratio" in cycles[-1].root.args
    assert "kernel_dispatch" in {e.name for e in prof.events()}


def test_stage_histograms_and_transfer_notes():
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    rec = t_trace.reset_recorder()
    TRANSFER_STATS.reset()
    with rec.cycle("cyc"):
        with rec.span("stage_a"):
            pass
        with rec.span("stage_a"):
            pass
        TRANSFER_STATS.count_up(1234)
        TRANSFER_STATS.count_down(99)
    assert set(rec.last_stages()) == {"stage_a", "xfer_up", "xfer_down"}
    snap = rec.stage_snapshot()
    assert snap["stage.stage_a"]["count"] == 1 and snap["cycle"]["count"] == 1
    notes = {c.name: c.args for c in rec.last()[0].root.children if c.name.startswith("xfer")}
    assert notes == {"xfer_up": {"bytes": 1234}, "xfer_down": {"bytes": 99}}
    TRANSFER_STATS.reset()


def test_metrics_histogram_counter_gauge():
    from armada_tpu.ops import metrics as jax_metrics
    from armada_tpu_torch.ops import metrics as t_metrics

    def script(m):
        reg = m.MetricsRegistry("t")
        h = reg.histogram("lat")
        for v in (0.001, 0.002, 0.5, 3.0, float("nan"), -1.0):
            h.record(v)
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        with pytest.raises(TypeError):
            reg.counter("lat")
        return reg.snapshot(), h.quantile(0.5), h.quantile(0.0)

    assert script(t_metrics) == script(jax_metrics)


def test_runtime_modules_import_no_jax():
    """The new runtime modules import neither jax nor the JAX package (the
    package walk in test_torch_boundary covers them too)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import armada_tpu_torch.analysis.tsan, armada_tpu_torch.core.logging\n"
        "import armada_tpu_torch.core.faults, armada_tpu_torch.core.watchdog\n"
        "import armada_tpu_torch.ops.metrics, armada_tpu_torch.ops.trace\n"
        "import armada_tpu_torch.scheduler.quarantine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'armada_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_data_device_follows_the_supervisor():
    sup = t_watchdog.supervisor()
    assert t_watchdog.data_device("cpu") == torch.device("cpu")
    assert t_watchdog.data_device("cuda") == torch.device("cuda")
    sup.record_failure("drill")
    assert t_watchdog.data_device("cuda") == torch.device("cpu")
    assert collections.Counter(s.fallbacks for s in [sup]) == {1: 1}
