"""The node-axis mesh on one card (armada_tpu_torch.parallel.mesh) against
the JAX package's sharded round on the 8-device virtual CPU mesh.

The same numpy problems (the JAX package's build_problem) go through JAX
`sharded_schedule_round` over an 8 x 1 mesh of the conftest's virtual
devices and through the port's `sharded_schedule_round` over
`make_mesh("cpu", node_shards=8)`, where the round is the plain version on
the padded problem.  Every RoundResult field must be equal, f32 bit for
bit, kernel_iters included; the JAX single-device round on the same
problem must equal both (sharding only distributes the reductions).  The
worlds follow tests/test_parallel_sharding.py:49-91: a fair split, a gang,
preemption; and a burst of singles at K = 1 and at ARMADA_COMMIT_K=8.  The
four worlds share one shape and one set of statics, so the JAX package
compiles its sharded round twice in this file (K = 1 and K = 8).  The 4 x 2 mesh and
the serving plane are in tests/test_torch_mesh_serving.py.
"""

import functools

import jax
import numpy as np
import pytest

from armada_tpu.core.types import Queue, RunningJob
from armada_tpu.models import build_problem as jax_build_problem
from armada_tpu.models.fair_scheduler import schedule_round as jax_round
from armada_tpu.parallel.mesh import make_mesh as jax_make_mesh
from armada_tpu.parallel.mesh import pad_problem as jax_pad_problem
from armada_tpu.parallel.mesh import sharded_schedule_round as jax_sharded
from armada_tpu_torch.models.fair_scheduler import schedule_round
from armada_tpu_torch.models.state import result_to_numpy
from armada_tpu_torch.parallel import (
    AXIS_JOBS,
    AXIS_NODES,
    make_mesh,
    pad_problem,
    problem_shardings,
    shard_problem,
    sharded_schedule_round,
)
from test_round_scheduler import job, make_config, node

# one shape for every world: 48-wide buckets on every axis
BUCKET = 48
# common statics (wide enough for the gang world's 6 members)
STATICS = dict(max_slots=16, slot_width=8)


def _fair_split():
    cfg = make_config(shape_bucket=BUCKET)
    nodes = [node(cfg, f"n{i}", cpu="1", memory="2Gi") for i in range(10)]
    jobs = [job(cfg, f"a{i}", "A", cpu="1") for i in range(10)] + [
        job(cfg, f"b{i}", "B", cpu="1") for i in range(10)
    ]
    return cfg, nodes, [Queue("A"), Queue("B")], jobs, ()


def _gang():
    cfg = make_config(shape_bucket=BUCKET)
    nodes = [node(cfg, f"n{i}", cpu="2", memory="4Gi") for i in range(4)]
    jobs = [job(cfg, f"g-{i}", "A", cpu="1", gang_id="g", gang_cardinality=6) for i in range(6)]
    return cfg, nodes, [Queue("A")], jobs, ()


def _preemption():
    cfg = make_config(shape_bucket=BUCKET, protected_fraction_of_fair_share=0.5)
    nodes = [node(cfg, f"n{i}", cpu="1", memory="2Gi") for i in range(4)]
    running = [
        RunningJob(job(cfg, f"a{i}", "A", cpu="1", pc="p0"), node_id=f"n{i}") for i in range(4)
    ]
    newjobs = [job(cfg, f"b{i}", "B", cpu="1", pc="p0") for i in range(4)]
    return cfg, nodes, [Queue("A"), Queue("B")], newjobs, running


def _burst():
    cfg = make_config(shape_bucket=BUCKET)
    nodes = [node(cfg, f"n{i}", cpu="4", memory="8Gi") for i in range(12)]
    queues = [Queue(q) for q in "ABCD"]
    jobs = [job(cfg, f"{q}{i}", q, cpu="1") for i in range(10) for q in "ABCD"]
    return cfg, nodes, queues, jobs, ()


WORLDS = {"fair_split": _fair_split, "gang": _gang, "preemption": _preemption,
          "burst": _burst}


@functools.lru_cache(maxsize=None)
def _problem(name):
    cfg, nodes, queues, jobs, running = WORLDS[name]()
    problem, ctx = jax_build_problem(cfg, pool="default", nodes=nodes, queues=queues,
                                     queued_jobs=jobs, running=running)
    return problem, dict(num_levels=len(ctx.ladder) + 2, **STATICS)


def _assert_equal(ref, got, what):
    for name, a, b in zip(got._fields, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}.{name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("commit_k,world", [
    (1, "fair_split"), (1, "gang"), (1, "preemption"), (1, "burst"), (8, "burst"),
])
def test_sharded_round_equals_jax_8x1(commit_k, world, monkeypatch):
    """8 x 1: the port's sharded round equals the JAX package's on the
    virtual mesh in every field, and both equal the single-device round."""
    monkeypatch.setenv("ARMADA_COMMIT_K", str(commit_k))
    problem, meta = _problem(world)
    assert problem.node_total.shape[0] == BUCKET  # one shape for every world
    ref = jax_sharded(problem, jax_make_mesh(node_shards=8), **meta, commit_k=commit_k)
    got = result_to_numpy(sharded_schedule_round(problem, make_mesh("cpu", node_shards=8),
                                                 **meta))
    _assert_equal(ref, got, f"{world} K={commit_k} (JAX sharded)")
    single = jax_round(problem, **meta, commit_k=commit_k, cache_slots=0, batch_k=1, unroll=1)
    _assert_equal(single, got, f"{world} K={commit_k} (JAX single-device)")
    assert int(got.scheduled_count) > 0
    if commit_k > 1:
        assert int(got.kernel_iters) < int(got.iterations)


def test_mesh_keeps_the_jax_names():
    """make_mesh gives what the JAX package's callers read: the axis sizes
    and the shard count; a mesh over two cards waits for such a machine."""
    mesh = make_mesh("cpu", node_shards=4, job_shards=2)
    assert mesh.shape[AXIS_NODES] == 4 and mesh.shape[AXIS_JOBS] == 2
    assert mesh.devices.size == 8 and mesh.devices.shape == (4, 2)
    assert make_mesh(["cpu"] * 8).shape[AXIS_NODES] == 8
    assert make_mesh("cpu", node_shards=4) == make_mesh("cpu", node_shards=4)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        make_mesh(["cuda:0", "cuda:1"], node_shards=2)
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 8, node_shards=3)


def test_problem_shardings_keep_the_jax_table():
    """problem_shardings names, field for field, the axis the JAX package's
    NamedShardings split (None: not split)."""
    from armada_tpu.parallel.mesh import problem_shardings as jax_shardings

    ours = problem_shardings(make_mesh("cpu", node_shards=4, job_shards=2))
    ref = jax_shardings(jax_make_mesh(node_shards=4, job_shards=2))
    assert ours._fields == ref._fields
    for name, spec, sh in zip(ours._fields, ours, ref):
        assert tuple(spec) == tuple(sh.spec), name


@pytest.mark.parametrize("node_multiple,job_multiple", [(7, 6), (8, 1), (3, 2)])
def test_pad_problem_equals_jax(node_multiple, job_multiple):
    """pad_problem pads as the JAX package does (inert lanes), field by field."""
    from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic

    problem, _ = jax_synthetic(num_nodes=24, num_gangs=40, num_queues=4, num_runs=10, seed=3)
    ref = jax_pad_problem(problem, node_multiple, job_multiple)
    got = pad_problem(problem, node_multiple, job_multiple)
    _assert_equal(ref, got, f"pad {node_multiple}x{job_multiple}")


def test_pad_problem_lanes_inert():
    """Padding node/gang/run axes to awkward multiples changes nothing the
    round decides (after tests/test_mesh_serving.py:388-426): padded gang
    lanes end absent, padded run lanes never evict."""
    from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic

    problem, meta = jax_synthetic(num_nodes=24, num_gangs=40, num_queues=4, num_runs=10, seed=3)
    kw = dict(num_levels=meta["num_levels"], max_slots=meta["max_slots"],
              slot_width=meta["slot_width"], device="cpu")
    G, RJ = problem.g_req.shape[0], problem.run_req.shape[0]
    padded = pad_problem(problem, node_multiple=7, job_multiple=6)
    assert padded.node_total.shape[0] % 7 == 0
    assert padded.g_req.shape[0] % 6 == 0 and padded.run_req.shape[0] % 6 == 0
    base = result_to_numpy(schedule_round(problem, **kw))
    pad = result_to_numpy(schedule_round(padded, **kw))
    for name in ("slot_gang", "slot_nodes", "slot_counts", "n_slots", "q_alloc", "iterations",
                 "termination", "scheduled_count", "kernel_iters"):
        np.testing.assert_array_equal(getattr(base, name), getattr(pad, name), err_msg=name)
    np.testing.assert_array_equal(base.g_state, pad.g_state[:G])
    np.testing.assert_array_equal(base.run_evicted, pad.run_evicted[:RJ])
    assert (pad.g_state[G:] == 3).all()
    assert not pad.run_evicted[RJ:].any()


def test_shard_problem_autopads_non_divisible():
    """A 3-shard mesh over axes that do not divide by 3 pads instead of
    raising, and the sharded round still equals the single round
    (after tests/test_mesh_serving.py:428-454)."""
    from armada_tpu.models.synthetic import synthetic_problem as jax_synthetic

    problem, meta = jax_synthetic(num_nodes=20, num_gangs=32, num_queues=3, num_runs=8, seed=5)
    kw = dict(num_levels=meta["num_levels"], max_slots=meta["max_slots"],
              slot_width=meta["slot_width"])
    mesh = make_mesh("cpu", node_shards=3)
    assert problem.node_total.shape[0] % 3 != 0
    sharded_in = shard_problem(problem, mesh)
    assert sharded_in.node_total.shape[0] % 3 == 0
    single = result_to_numpy(schedule_round(problem, **kw, device="cpu"))
    sharded = result_to_numpy(sharded_schedule_round(problem, mesh, **kw))
    for name in ("slot_gang", "slot_nodes", "slot_counts", "n_slots", "q_alloc",
                 "scheduled_count", "iterations", "kernel_iters"):
        np.testing.assert_array_equal(getattr(single, name), getattr(sharded, name),
                                      err_msg=name)
    # the round learns of the mesh from its caller, and refuses a problem
    # whose node axis does not divide into it
    with pytest.raises(ValueError, match="divide"):
        schedule_round(problem, **kw, device="cpu", mesh=mesh)


def test_jax_virtual_mesh_is_there():
    """The JAX side of this file runs on the conftest's 8 virtual devices."""
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n", [2, 6, 8, 16, 24, 32, 64])
def test_serving_clamp_is_the_cluster_owner(n):
    """parallel/serving.py `_cluster_limit` halves a configured shard count
    to a cluster the card can launch by kernels/round.py's owner of the
    cluster size; off the card it keeps the configured count (JAX
    parity)."""
    import torch

    from armada_tpu_torch.kernels.round import choose_cluster_size
    from armada_tpu_torch.parallel.serving import _cluster_limit

    cap = lambda s: 128 // s if s <= 16 else 0  # noqa: E731
    cuda = torch.device("cuda")
    got = _cluster_limit(n, cuda, capacity=cap)
    halved = n
    while halved >= 2 and cap(halved) < 1:
        halved = halved // 2 if halved % 2 == 0 else 1
    assert got == halved
    sizes = [n >> i for i in range(8) if n >> i >= 2 and n % (1 << i) == 0]
    assert got == choose_cluster_size(None, 1, capacity=cap, device="cuda", sizes=sizes)
    assert _cluster_limit(n, torch.device("cpu")) == n
