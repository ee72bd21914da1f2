"""The mesh serving plane on one card (armada_tpu_torch.parallel.serving and
mesh_slab) against the JAX package's, on the CPU.

- The 4 x 2 mesh: the port's sharded round equals JAX `sharded_schedule_round`
  on the virtual mesh in every RoundResult field.
- Churn (after tests/test_mesh_serving.py:230-272, seed 0): the same seeded
  loadgen op stream (armada_tpu.loadgen.workload) through the port's
  MeshDeviceDeltaCache over an 8-shard mesh, the port's DeviceDeltaCache,
  and the JAX package's MeshDeviceDeltaCache on the virtual mesh: every
  cycle the three decide the same, and the port's sharded resident problem
  equals bundle.materialize() and the JAX package's sharded resident
  problem, field by field -- including a slab-growing burst cycle (a full
  re-upload) and the shadow pipeline's content prefetch.
- The node bucket aligns to the mesh multiple; the ladder walks 8 -> 4 ->
  2 -> off and restore() returns to 8; every transition fires the reset
  hooks, and the feed replaces its caches.  A mesh cache that is not
  replaced keeps its resident problem across a ladder move that divides it.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch
import pytest

from armada_tpu.core.types import JobSpec as JJobSpec
from armada_tpu.core.types import NodeSpec as JNodeSpec
from armada_tpu.core.types import Queue as JQueue
from armada_tpu.loadgen.workload import (
    CancelOp,
    MixConfig,
    ReprioritizeOp,
    SubmitOp,
    WorkloadGenerator,
)
from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic
from armada_tpu.parallel.mesh import make_mesh as jax_make_mesh
from armada_tpu.parallel.mesh import sharded_schedule_round as jax_sharded
from armada_tpu.parallel.mesh_slab import MeshDeviceDeltaCache as JaxMeshCache
from armada_tpu.parallel.serving import mesh_serving as jax_mesh_serving
from armada_tpu.parallel.serving import reset_mesh_serving as jax_reset_mesh_serving
from armada_tpu_torch.core import watchdog
from armada_tpu_torch.core.config import PoolConfig, PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob
from armada_tpu_torch.models import decode_result
from armada_tpu_torch.models.fair_scheduler import schedule_round
from armada_tpu_torch.models.incremental import IncrementalBuilder, _node_bucket
from armada_tpu_torch.models.slab import DeviceDeltaCache
from armada_tpu_torch.models.state import result_to_numpy
from armada_tpu_torch.models.xfer import TRANSFER_STATS
from armada_tpu_torch.parallel import make_mesh, mesh_serving, reset_mesh_serving
from armada_tpu_torch.parallel.mesh import sharded_schedule_round
from armada_tpu_torch.parallel.mesh_slab import MeshDeviceDeltaCache
from armada_tpu_torch.scheduler.incremental_algo import IncrementalProblemFeed
from test_mesh_serving import ChurnWorld as JaxChurnWorld
from test_mesh_serving import make_config as jax_make_config


@pytest.fixture(autouse=True)
def _fresh_mesh_state():
    """Mesh serving is process-global in both packages: every test starts
    and leaves disarmed."""
    reset_mesh_serving()
    jax_reset_mesh_serving()
    yield
    reset_mesh_serving()
    jax_reset_mesh_serving()


def make_config(**kw) -> SchedulingConfig:
    """The port's twin of tests/test_mesh_serving.py's make_config."""
    return SchedulingConfig(
        shape_bucket=64,
        priority_classes={
            "low": PriorityClass("low", priority=100, preemptible=True),
            "high": PriorityClass("high", priority=1000, preemptible=False),
        },
        default_priority_class="high",
        maximum_scheduling_burst=16,
        **kw,
    )


def test_sharded_round_equals_jax_4x2():
    """4 x 2 (the job axis padded and laid out, the node axis split): the
    port's sharded round equals the JAX package's in every field."""
    problem, meta = jax_synthetic(num_nodes=22, num_gangs=60, num_queues=4, num_runs=9,
                                  max_gang_cardinality=2, seed=7)
    kw = dict(num_levels=meta["num_levels"], max_slots=meta["max_slots"],
              slot_width=meta["slot_width"])
    ref = jax_sharded(problem, jax_make_mesh(node_shards=4, job_shards=2), **kw, commit_k=1)
    got = result_to_numpy(sharded_schedule_round(
        problem, make_mesh("cpu", node_shards=4, job_shards=2), **kw, commit_k=1))
    assert got.g_state.shape[0] % 2 == 0 and got.alloc.shape[1] % 4 == 0
    for name, a, b in zip(got._fields, ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert int(got.scheduled_count) > 0


class PortChurnWorld:
    """The port's arm of the churn: a builder and a cache, driven by the
    same loadgen ops as the JAX package's ChurnWorld."""

    def __init__(self, cfg, nodes, queues, cache):
        self.builder = IncrementalBuilder(cfg, "default", queues)
        self.builder.set_nodes(nodes)
        self.cache = cache
        self.spec_of = {}
        self.leased = set()

    def submit_specs(self, specs):
        for s in specs:
            self.spec_of[s.id] = s
        self.builder.submit_many(specs)

    def cancel(self, jid):
        self.builder.remove(jid)
        self.builder.unlease(jid)
        self.spec_of.pop(jid, None)
        self.leased.discard(jid)

    def reprioritize(self, jid, priority):
        spec = self.spec_of.get(jid)
        if spec is None or jid in self.leased:
            return
        spec = dataclasses.replace(spec, priority=priority)
        self.spec_of[jid] = spec
        self.builder.remove(jid)
        self.builder.submit_many([spec])

    def cycle(self):
        bundle, ctx = self.builder.assemble_delta()
        dev = self.cache.apply(bundle)
        # the round learns of the mesh from its caller
        res = schedule_round(dev, num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                             slot_width=ctx.slot_width, device="cpu",
                             mesh=getattr(self.cache, "mesh", None))
        return bundle, dev, decode_result(res, ctx)

    def apply(self, outcome):
        self.builder.remove_many(outcome.scheduled.keys())
        leases = []
        for jid, nid in outcome.scheduled.items():
            spec = self.spec_of.get(jid)
            if spec is not None:
                leases.append(RunningJob(job=spec, node_id=nid))
                self.leased.add(jid)
        self.builder.lease_many(leases)
        for jid in outcome.preempted:
            self.builder.unlease(jid)
            self.leased.discard(jid)


def _specs_from_ops(JF, F, gen, ops, seq, tick):
    """tests/test_mesh_serving.py's _specs_from_ops, making each submitted
    spec twice: for the JAX package (JF) and for the port (F)."""
    jsubmits, submits, cancels, reprios = [], [], [], []
    for op in ops:
        if isinstance(op, SubmitOp):
            ids = []
            for item in op.items:
                i = seq[0]
                seq[0] += 1
                kw = dict(id=f"lg{i:06d}", queue=op.queue, priority=item.priority,
                          priority_class="low" if item.priority % 2 else "high",
                          submit_time=float(tick * 1000 + i % 1000), gang_id=item.gang_id,
                          gang_cardinality=item.gang_cardinality)
                res = {"cpu": item.resources["cpu"], "memory": "1"}
                jsubmits.append(JJobSpec(resources=JF.from_mapping(res), **kw))
                submits.append(JobSpec(resources=F.from_mapping(res), **kw))
                ids.append(kw["id"])
            gen.note_submitted(op.queue, ids)
        elif isinstance(op, CancelOp):
            cancels.extend(op.job_ids)
        elif isinstance(op, ReprioritizeOp):
            reprios.append((op.job_ids, op.priority))
    return jsubmits, submits, cancels, reprios


def test_mesh_churn_bit_equal_to_single_card_and_jax():
    """Seed 0's loadgen churn, five cycles with a slab-growing burst at
    cycle 3 and a content prefetch after cycle 2: the port's mesh cache,
    the port's single-card cache and the JAX package's mesh cache decide
    the same every cycle, and the port's sharded resident problem equals
    bundle.materialize() and the JAX package's resident problem."""
    mesh_serving().configure(8)
    jax_mesh_serving().configure(8)
    jcfg = jax_make_config()
    cfg = make_config()
    JF, F = jcfg.resource_list_factory(), cfg.resource_list_factory()
    jnodes = [JNodeSpec(id=f"n{i}", pool="default",
                        total_resources=JF.from_mapping({"cpu": "16", "memory": "64"}))
              for i in range(12)]
    nodes = [NodeSpec(id=f"n{i}", pool="default",
                      total_resources=F.from_mapping({"cpu": "16", "memory": "64"}))
             for i in range(12)]
    jqueues = [JQueue(f"q-{i}", weight=1.0 + i) for i in range(3)]
    queues = [Queue(f"q-{i}", weight=1.0 + i) for i in range(3)]
    jax_mesh = JaxChurnWorld(jcfg, JF, jnodes, jqueues, JaxMeshCache())
    single = PortChurnWorld(cfg, nodes, queues, DeviceDeltaCache(device="cpu"))
    mesh = PortChurnWorld(cfg, nodes, queues, MeshDeviceDeltaCache(device="cpu"))
    gen = WorkloadGenerator(MixConfig(num_queues=3, queue_prefix="q", gang_fraction=0.2),
                            seed=0)
    seq = [0]
    total = 0
    for cyc in range(5):
        ops = gen.next_ops(14 if cyc != 3 else 90)
        jsubmits, submits, cancels, reprios = _specs_from_ops(JF, F, gen, ops, seq, cyc)
        if cyc == 3:
            # slab-growing burst past the 64-slot bucket: a full re-upload
            burst = [dict(id=f"burst0-{i}", queue=f"q-{i % 3}", priority_class="high",
                          submit_time=float(5000 + i)) for i in range(80)]
            res = {"cpu": "1", "memory": "1"}
            jsubmits = jsubmits + [JJobSpec(resources=JF.from_mapping(res), **kw) for kw in burst]
            submits = submits + [JobSpec(resources=F.from_mapping(res), **kw) for kw in burst]
        for w, subs in ((jax_mesh, jsubmits), (single, submits), (mesh, submits)):
            w.submit_specs(subs)
            for jid in cancels:
                w.cancel(jid)
            for jids, prio in reprios:
                for jid in jids:
                    w.reprioritize(jid, prio)
        bundle_j, dev_j, out_j = jax_mesh.cycle()
        _b1, _d1, out_1 = single.cycle()
        bundle_m, dev_m, out_m = mesh.cycle()
        if cyc == 3:
            assert mesh.cache.last_apply == "full"  # the burst grew the slab
        truth = bundle_m.materialize()
        for name, d, h, j in zip(dev_m._fields, dev_m, truth, dev_j):
            np.testing.assert_array_equal(d.numpy(), np.asarray(h),
                                          err_msg=f"cycle {cyc}: resident vs materialize {name}")
            np.testing.assert_array_equal(d.numpy(), np.asarray(j),
                                          err_msg=f"cycle {cyc}: resident vs JAX mesh {name}")
        for o in (out_1, out_m):
            assert o.scheduled == out_j.scheduled, f"cycle {cyc} diverged"
            assert o.preempted == out_j.preempted
            assert sorted(o.failed) == sorted(out_j.failed)
        for w, o in ((jax_mesh, out_j), (single, out_1), (mesh, out_m)):
            w.apply(o)
        total += len(out_m.scheduled)
        if cyc == 2:
            for w in (jax_mesh, single, mesh):
                w.builder.prefetch_content(w.cache)
    assert mesh.cache.mesh_devices == 8
    assert mesh.cache.content_prefetches == single.cache.content_prefetches
    assert total > 10


def test_mesh_cache_counts_sharded_uploads():
    """A full upload through the mesh cache counts the node-axis fields'
    per-shard bytes (TRANSFER_STATS), as the JAX package's does."""
    mesh_serving().configure(8)
    cfg = make_config()
    F = cfg.resource_list_factory()
    b = IncrementalBuilder(cfg, "default", [Queue("q0")])
    b.set_nodes([NodeSpec(id=f"n{i}", pool="default",
                          total_resources=F.from_mapping({"cpu": "16", "memory": "64"}))
                 for i in range(12)])
    b.submit_many([JobSpec(id="a1", queue="q0", priority_class="high", submit_time=0.0,
                           resources=F.from_mapping({"cpu": "1", "memory": "1"}))])
    bundle, _ = b.assemble_delta()
    TRANSFER_STATS.reset()
    cache = MeshDeviceDeltaCache(device="cpu")
    dev = cache.apply(bundle)
    snap = TRANSFER_STATS.snapshot()
    assert cache.last_apply == "full" and cache.mesh_devices == 8
    assert snap["up_sharded_transfers"] == 4  # node_total, node_type, node_ok, ban_mask
    assert snap["up_chip_bytes"] < snap["up_bytes"]
    assert dev.node_total.shape[0] % 8 == 0


def test_mesh_cache_keeps_its_resident_problem_across_a_dividing_ladder_move():
    """On one card every mesh lays the problem out as one card does: a
    ladder move to a mesh that divides the resident node axis (or to no
    mesh) keeps the resident problem, and the next delta scatters onto it."""
    mesh_serving().configure(8)
    cfg = make_config()
    F = cfg.resource_list_factory()
    b = IncrementalBuilder(cfg, "default", [Queue("q0")])
    b.set_nodes([NodeSpec(id=f"n{i}", pool="default",
                          total_resources=F.from_mapping({"cpu": "16", "memory": "64"}))
                 for i in range(12)])
    cache = MeshDeviceDeltaCache(device="cpu")
    for step, rung in enumerate((lambda: None, lambda: mesh_serving().degrade("drill"),
                                 lambda: mesh_serving().degrade("drill"),
                                 lambda: mesh_serving().degrade("drill"))):
        rung()
        b.submit_many([JobSpec(id=f"a{step}", queue="q0", priority_class="high",
                               submit_time=float(step),
                               resources=F.from_mapping({"cpu": "1", "memory": "1"}))])
        bundle, _ = b.assemble_delta()
        dev = cache.apply(bundle)
        assert cache.last_apply == ("full" if step == 0 else "scatter"), step
        assert cache.mesh_devices == (8, 4, 2, 0)[step]
        for name, d, h in zip(dev._fields, dev, bundle.materialize()):
            np.testing.assert_array_equal(d.numpy(), np.asarray(h), err_msg=f"{step}: {name}")
    assert cache.resets == 0


def test_round_reruns_on_a_smaller_mesh_from_host_tables():
    """The degrade ladder's rung (models._run_round_on_mesh): the same
    round re-run from host tables over a smaller mesh decides as the round
    run through run_round_on_device on the serving mesh and on one card."""
    from armada_tpu.models import build_problem as jax_build_problem
    from armada_tpu_torch.models import _run_round_on_mesh, _round_env, run_round_on_device
    from test_round_scheduler import job, make_config as round_config, node

    cfg = round_config(shape_bucket=16)
    nodes = [node(cfg, f"n{i}", cpu="2", memory="4Gi") for i in range(10)]
    jobs = [job(cfg, f"a{i}", "A", cpu="1") for i in range(14)] + [
        job(cfg, f"g-{i}", "B", cpu="1", gang_id="g", gang_cardinality=3) for i in range(3)]
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes,
                                     queues=[JQueue("A"), JQueue("B")], queued_jobs=jobs)
    _, single = run_round_on_device(problem, ctx, cfg, device="cpu")
    mesh_serving().configure(8)
    kw, _ = _round_env(problem, ctx, cfg, False, torch.device("cpu"))
    assert kw["mesh"].devices.size == 8
    _, served = run_round_on_device(problem, ctx, cfg, device="cpu")
    _, rerun = _run_round_on_mesh(problem, ctx, cfg, kw, mesh_serving().degrade("drill"))
    for o in (served, rerun):
        assert o.scheduled == single.scheduled and sorted(o.failed) == sorted(single.failed)
    assert len(single.scheduled) == 17  # the 14 singles and the 3-member gang


def test_node_bucket_aligns_to_mesh_multiple():
    assert _node_bucket(64) == 64  # mesh off: unchanged
    mesh_serving().configure(8)
    assert _node_bucket(64) == 64
    assert _node_bucket(60) == 64  # rounded up to the 8-multiple
    mesh_serving().configure(6)
    assert _node_bucket(64) % 6 == 0
    cfg = SchedulingConfig(
        shape_bucket=60,
        priority_classes={"high": PriorityClass("high", priority=1000, preemptible=False)},
        default_priority_class="high",
        maximum_scheduling_burst=16,
    )
    mesh_serving().configure(8)
    F = cfg.resource_list_factory()
    b = IncrementalBuilder(cfg, "default", [Queue("q0")])
    b.set_nodes([NodeSpec(id=f"n{i}", pool="default",
                          total_resources=F.from_mapping({"cpu": "16", "memory": "64"}))
                 for i in range(5)])
    b.submit_many([JobSpec(id="a1", queue="q0", priority_class="high", submit_time=0.0,
                           resources=F.from_mapping({"cpu": "1", "memory": "1"}))])
    bundle, _ctx = b.assemble_delta()
    assert bundle.materialize().node_total.shape[0] % 8 == 0


def test_mesh_ladder_walks_and_exhausts():
    ms = mesh_serving()
    ms.configure(8)
    assert ms.device_count() == 8 and ms.axis_multiple() == 8
    assert ms.serving_mesh("cpu").devices.size == 8
    assert ms.degrade("t1").devices.size == 4
    assert ms.degrade("t2").devices.size == 2
    assert ms.degrade("t3") is None  # exhausted: the single-card path
    assert ms.serving_mesh("cpu") is None
    snap = ms.snapshot()
    assert snap["degrades"] == 3 and snap["devices"] == 0
    assert ms.axis_multiple() == 8  # alignment stays the configured size
    assert ms.restore()
    assert ms.snapshot()["devices"] == 8 and ms.snapshot()["restores"] == 1
    assert ms.serving_mesh("cpu").devices.size == 8


def test_ladder_fires_reset_hooks_and_the_feed_replaces_its_caches():
    """Every rung fires the reset hooks; the feed's hook replaces each
    pool's cache with a fresh one (a mesh cache while the mesh is armed,
    sharded over the current rung at its first apply); the promotion gate
    can hold a restore back."""
    ms = mesh_serving()
    ms.configure(8)
    cfg = make_config(pools=(PoolConfig("default"),))
    feed = IncrementalProblemFeed(cfg, device="cpu")
    first = feed.devcaches["default"]
    assert isinstance(first, MeshDeviceDeltaCache)
    assert ms.serving_mesh("cpu").devices.size == 8  # what the first apply resolves
    fired = []

    class Probe:
        def hook(self):
            fired.append(1)

    probe = Probe()
    watchdog.add_reset_hook(probe.hook)
    assert ms.degrade("drill").devices.size == 4
    assert fired == [1]
    second = feed.devcaches["default"]
    assert second is not first and isinstance(second, MeshDeviceDeltaCache)
    watchdog.set_promotion_gate(lambda: "quarantined")
    try:
        assert not ms.restore()
        assert feed.devcaches["default"] is second
    finally:
        watchdog.set_promotion_gate(None)
    assert ms.restore()
    assert fired == [1, 1] and feed.devcaches["default"] is not second
    # hooks are held weakly: a dropped probe is not called again
    del probe
    gc.collect()
    ms.degrade("drill again")
    assert fired == [1, 1]
    ms.configure(0)
    feed.reset_device_state()
    assert type(feed.devcaches["default"]) is DeviceDeltaCache
