"""Synthetic dense scheduling problems, built straight as tensors.

For benchmarks and compile checks at reference scale (1M queued jobs x 50k
nodes, BASELINE.json) the host-object path (core.types -> models.problem
build_problem) would spend minutes materialising Python dataclasses; production
rounds keep state device-resident between cycles anyway (the reference's jobDb
cache, scheduler.go:240-246), so scale testing goes straight to the dense form.
Shapes/semantics are identical to build_problem's output.

`synthetic_world` is the spec-level twin: JobSpec/NodeSpec objects for
end-to-end round benchmarks (build_problem + upload + kernel + decode), the
number the reference's 5s round budget is actually comparable to.  Both use the
same RNG calls as the JAX package's synthetic.py, so one seed gives the same
arrays and specs in both packages.
"""

from __future__ import annotations

import numpy as np

from armada_tpu_torch.core.config import (
    FloatingResource, PoolConfig, PriorityClass, SchedulingConfig,
)
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue, RunningJob, Taint, Toleration
from armada_tpu_torch.models.problem import SchedulingProblem, queue_ordered_gang_index

_INF = np.float32(3.0e38)


# bidstore-style price bands for market benchmarks (pkg/bidstore enumerates
# a small fixed band set; prices are per (queue, band))
SYNTHETIC_BANDS = tuple(f"band{i}" for i in range(8))


def synthetic_bid_price(job) -> float:
    """Deterministic (queue, band) pricer for market benchmarks: stable
    across runs/cycles, spreads bands across queues so the serving
    permutation is non-trivial."""
    import zlib

    h = zlib.crc32(f"{job.queue}/{job.price_band}".encode())
    return 1.0 + (h % 97) / 10.0


def synthetic_world(
    *,
    num_nodes: int,
    num_jobs: int,
    num_queues: int,
    num_runs: int = 0,
    seed: int = 0,
    shape_bucket: int = 8192,
    market: bool = False,
):
    """(config, nodes, queues, specs, running, spec_factory): a JobSpec-level
    world mirroring synthetic_problem's distribution.

    `spec_factory(n, t0)` mints n fresh queued specs with submit times after
    t0 -- the per-cycle arrival delta for steady-state benchmarks.  ResourceList
    instances are shared across jobs of the same shape so 1M specs stay cheap.
    shape_bucket defaults high so +-1000-job deltas never change the padded
    tensor shapes (one compile serves every measured cycle).

    `market=True` marks the pool market-driven and stamps every spec with one
    of 8 price bands (pkg/bidstore-style); pair with a (queue, band) pricer
    such as `synthetic_bid_price`.
    """
    rng = np.random.default_rng(seed)
    config = SchedulingConfig(
        shape_bucket=shape_bucket,
        priority_classes={
            "batch": PriorityClass("batch", priority=100, preemptible=True),
            "prod": PriorityClass("prod", priority=1000, preemptible=False),
        },
        default_priority_class="batch",
        pools=(
            PoolConfig("default", market_driven=market, spot_price_cutoff=0.9),
        ),
    )
    factory = config.resource_list_factory()

    queues = [Queue(f"q{i:03d}", 1.0) for i in range(num_queues)]
    nodes = []
    node_shapes = {}
    for i in range(num_nodes):
        cores = int(rng.choice([16, 32, 64, 96]))
        rl = node_shapes.get(cores)
        if rl is None:
            rl = factory.from_mapping({"cpu": str(cores), "memory": str(cores * 4)})
            node_shapes[cores] = rl
        nodes.append(NodeSpec(id=f"n{i:06d}", pool="default", total_resources=rl))

    job_shapes = {}

    def _req(cpu_m: int, mem: int):
        rl = job_shapes.get((cpu_m, mem))
        if rl is None:
            rl = factory.from_mapping({"cpu": f"{cpu_m}m", "memory": str(mem)})
            job_shapes[(cpu_m, mem)] = rl
        return rl

    probs = 1.0 / np.arange(1, num_queues + 1)
    probs /= probs.sum()
    counter = [0]

    def spec_factory(n: int, t0: float) -> list:
        qs = rng.choice(num_queues, size=n, p=probs)
        cpus = rng.choice([500, 1000, 2000, 4000], size=n)
        memm = rng.choice([2, 4, 8], size=n)
        pcs = rng.random(n) < 0.7
        subs = t0 + rng.random(n)
        bands = rng.integers(0, len(SYNTHETIC_BANDS), n) if market else None
        out = []
        base = counter[0]
        counter[0] += n
        for i in range(n):
            out.append(
                JobSpec(
                    id=f"j{base + i:09d}",
                    queue=f"q{qs[i]:03d}",
                    priority_class="batch" if pcs[i] else "prod",
                    submit_time=float(subs[i]),
                    resources=_req(int(cpus[i]), int(cpus[i] // 1000 * memm[i] + 1)),
                    price_band=SYNTHETIC_BANDS[bands[i]] if market else "",
                )
            )
        return out

    specs = spec_factory(num_jobs, 0.0)
    running = []
    if num_runs:
        run_nodes = rng.integers(0, num_nodes, num_runs)
        run_cpus = rng.choice([500, 1000, 2000], size=num_runs)
        run_pc = rng.random(num_runs) < 0.5
        run_q = rng.integers(0, num_queues, num_runs)
        for i in range(num_runs):
            running.append(
                RunningJob(
                    job=JobSpec(
                        id=f"r{i:08d}",
                        queue=f"q{run_q[i]:03d}",
                        priority_class="batch" if run_pc[i] else "prod",
                        submit_time=-1.0,
                        resources=_req(int(run_cpus[i]), 4),
                    ),
                    node_id=f"n{run_nodes[i]:06d}",
                )
            )
    return config, nodes, queues, specs, running, spec_factory


def synthetic_problem(
    *,
    num_nodes: int,
    num_gangs: int,
    num_queues: int,
    num_runs: int = 0,
    num_resources: int = 4,
    num_keys: int = 16,
    num_node_types: int = 8,
    type_sensitive_frac: float = 0.0,
    max_gang_cardinality: int = 1,
    global_burst: int = 1_000,
    perq_burst: int = 1_000,
    node_pad_to: int = 1,
    gang_pad_to: int = 1,
    seed: int = 0,
) -> tuple[SchedulingProblem, dict]:
    """A realistic mixed workload: heterogeneous nodes, skewed queue demand.

    Returns (problem, meta) where meta carries the kernel's static shape args
    (num_levels, max_slots, slot_width).
    """
    rng = np.random.default_rng(seed)
    R = num_resources

    def pad(n, to):
        return max(to, ((n + to - 1) // to) * to)

    N = pad(num_nodes, node_pad_to)
    G = pad(num_gangs, gang_pad_to)
    RJ = pad(max(num_runs, 1), gang_pad_to)
    Q = num_queues

    # Nodes: capacity vectors like (cpu cores*1000m, memory GiB, gpu, storage).
    base = np.array([16_000, 64, 0, 500], np.float32)[:R]
    node_total = np.zeros((N, R), np.float32)
    mult = rng.choice([1.0, 2.0, 4.0, 6.0], size=(num_nodes, 1)).astype(np.float32)
    node_total[:num_nodes] = base[None, :] * mult
    has_gpu = rng.random(num_nodes) < 0.2
    if R >= 3:
        node_total[:num_nodes, 2] = np.where(has_gpu, 8.0, 0.0)
    node_type = np.zeros((N,), np.int32)
    node_type[:num_nodes] = rng.integers(0, num_node_types, num_nodes)
    node_ok = np.zeros((N,), bool)
    node_ok[:num_nodes] = True

    # Static fit: most keys fit most types; a few restrictive keys.
    compat = rng.random((num_keys, num_node_types)) < 0.9
    compat[0] = True  # the common key
    # Heterogeneity (type_sensitive_frac > 0): a fraction of keys declare a
    # per-type throughput profile -- their compat additionally whitelists the
    # profiled types and their bias row tiers them by 1/throughput (the
    # builder-side semantics of core/keys.type_score_tables, synthesized
    # directly in table form here).  key 0 stays the insensitive common key.
    compat_pre_type = compat.copy()
    key_type_row = np.zeros((num_keys,), np.int32)
    type_bias = np.zeros((1, num_node_types), np.float32)
    if type_sensitive_frac > 0 and num_keys > 1 and num_node_types > 1:
        sens = np.where(rng.random(num_keys - 1) < type_sensitive_frac)[0] + 1
        if sens.shape[0]:
            TR = int(sens.shape[0]) + 1
            type_bias = np.zeros((TR, num_node_types), np.float32)
            for row, ki in enumerate(sens, start=1):
                key_type_row[ki] = row
                admits = rng.random(num_node_types) < 0.6
                admits[rng.integers(0, num_node_types)] = True
                thr = rng.choice([0.5, 1.0, 2.0, 4.0], size=num_node_types)
                type_bias[row] = np.where(
                    admits,
                    (
                        (np.float32(1.0) / thr.astype(np.float32) - np.float32(1.0))
                        * np.float32(1024.0)
                    ),
                    0.0,
                ).astype(np.float32)
                compat[ki] &= admits

    # Gangs: skewed queue popularity (zipf-ish), small requests.
    g_queue = np.zeros((G,), np.int32)
    probs = 1.0 / np.arange(1, Q + 1)
    probs /= probs.sum()
    g_queue[:num_gangs] = rng.choice(Q, size=num_gangs, p=probs)
    g_req = np.zeros((G, R), np.float32)
    cpu = rng.choice([500, 1000, 2000, 4000], size=num_gangs).astype(np.float32)
    memf = cpu / 1000.0 * rng.choice([2, 4, 8], size=num_gangs)
    g_req[:num_gangs, 0] = cpu
    if R >= 2:
        g_req[:num_gangs, 1] = memf
    if R >= 3:
        g_req[:num_gangs, 2] = (rng.random(num_gangs) < 0.05).astype(np.float32)
    g_card = np.zeros((G,), np.int32)
    g_card[:num_gangs] = (
        rng.integers(1, max_gang_cardinality + 1, num_gangs)
        if max_gang_cardinality > 1
        else 1
    )
    g_level = np.zeros((G,), np.int32)
    g_level[:num_gangs] = rng.integers(1, 3, num_gangs)
    g_key = np.full((G,), -1, np.int32)
    g_key[:num_gangs] = rng.integers(0, num_keys, num_gangs)
    g_pc = np.zeros((G,), np.int32)
    g_pc[:num_gangs] = g_level[:num_gangs] - 1
    # per-queue FIFO order
    g_order = np.zeros((G,), np.int32)
    order_all = np.argsort(g_queue[:num_gangs], kind="stable")
    rank = np.empty(num_gangs, np.int64)
    counts = np.bincount(g_queue[:num_gangs], minlength=Q)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank[order_all] = np.arange(num_gangs) - starts[g_queue[:num_gangs][order_all]]
    g_order[:num_gangs] = rank
    g_run = np.full((G,), -1, np.int32)
    g_valid = np.zeros((G,), bool)
    g_valid[:num_gangs] = True

    # Running jobs (optional): bound to random nodes at level >= 1.
    run_req = np.zeros((RJ, R), np.float32)
    run_node = np.zeros((RJ,), np.int32)
    run_level = np.ones((RJ,), np.int32)
    run_queue = np.zeros((RJ,), np.int32)
    run_pc = np.zeros((RJ,), np.int32)
    run_preemptible = np.zeros((RJ,), bool)
    run_gang = np.full((RJ,), -1, np.int32)
    run_valid = np.zeros((RJ,), bool)
    if num_runs:
        run_req[:num_runs, 0] = rng.choice([500, 1000, 2000], size=num_runs)
        if R >= 2:
            run_req[:num_runs, 1] = run_req[:num_runs, 0] / 250.0
        run_node[:num_runs] = rng.integers(0, num_nodes, num_runs)
        run_level[:num_runs] = rng.integers(1, 3, num_runs)
        run_queue[:num_runs] = rng.integers(0, Q, num_runs)
        run_pc[:num_runs] = run_level[:num_runs] - 1
        run_preemptible[:num_runs] = rng.random(num_runs) < 0.5
        run_valid[:num_runs] = True

    gq_gang, q_start, q_len = queue_ordered_gang_index(g_queue, g_order, num_gangs, G, Q)

    total_pool = node_total[:num_nodes].sum(axis=0, dtype=np.float64).astype(np.float32)
    drf_mult = np.ones((R,), np.float32)
    scale = node_total.max(axis=0)
    inv_scale = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-9), 0.0).astype(np.float32)

    C = 2
    q_weight = np.ones((Q,), np.float32)
    # constrained demand share ~ demand / total (uncapped)
    demand = np.zeros((Q, R), np.float64)
    np.add.at(demand, g_queue[:num_gangs], (g_req[:num_gangs] * g_card[:num_gangs, None]).astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total_pool > 0, demand / np.maximum(total_pool, 1e-9), 0.0)
    q_cds = np.clip(frac.max(axis=1), 0.0, None).astype(np.float32)

    problem = SchedulingProblem(
        node_total=node_total,
        node_type=node_type,
        node_ok=node_ok,
        run_req=run_req,
        run_node=run_node,
        run_level=run_level,
        run_queue=run_queue,
        run_pc=run_pc,
        run_preemptible=run_preemptible,
        run_gang=run_gang,
        run_valid=run_valid,
        g_req=g_req,
        g_card=g_card,
        g_level=g_level,
        g_queue=g_queue,
        g_key=g_key,
        g_pc=g_pc,
        g_order=g_order,
        g_run=g_run,
        g_valid=g_valid,
        g_absent=np.zeros_like(g_valid),
        g_price=np.zeros((G,), np.float32),
        g_spot_price=np.zeros((G,), np.float32),
        gq_gang=gq_gang,
        q_start=q_start,
        q_len=q_len,
        q_weight=q_weight,
        q_cds=q_cds,
        q_penalty=np.zeros((Q, R), np.float32),
        compat=compat,
        total_pool=total_pool,
        drf_mult=drf_mult,
        inv_scale=inv_scale,
        round_cap=np.full((R,), _INF, np.float32),
        pc_queue_cap=np.full((C, R), _INF, np.float32),
        protected_fraction=np.float32(1.0),
        global_burst=np.int32(global_burst),
        perq_burst=np.full((Q,), perq_burst, np.int32),
        node_axes=np.ones((R,), np.float32),
        float_total=np.zeros((R,), np.float32),
        market=np.bool_(False),
        spot_cutoff=np.float32(_INF),
        ban_mask=np.zeros((1, N), bool),
        g_ban_row=np.zeros((G,), np.int32),
        type_bias=type_bias,
        key_type_row=key_type_row,
        compat_pre_type=compat_pre_type,
    )
    meta = dict(
        num_levels=3,
        max_slots=max(1, min(num_gangs, global_burst)),
        slot_width=max(1, min(max_gang_cardinality, N)),
    )
    return problem, meta


def variety_world(seed: int, *, num_nodes: int = 200, num_jobs: int = 600, num_queues: int = 6,
                  num_running: int = 120, gangs: int = 20, max_card: int = 12,
                  market: bool = False, shape_bucket: int = 32):
    """A world that reaches every data-dependent branch of the round: gangs
    (some confined to one zone), retry bans, taints and selectors,
    unschedulable nodes, a floating resource, per-(queue, class) caps, a
    round cap, per-queue bursts, away runs, fair-share eviction and, with
    market=True, bid ordering with a spot-price crossing.  Returns
    (config, build_problem keyword arguments)."""
    rng = np.random.default_rng(seed)
    config = SchedulingConfig(
        shape_bucket=shape_bucket,
        priority_classes={
            "low": PriorityClass("low", priority=100, preemptible=True,
                                 maximum_resource_fraction_per_queue={"cpu": 0.3}),
            "high": PriorityClass("high", priority=1000, preemptible=False),
        },
        default_priority_class="high",
        protected_fraction_of_fair_share=0.5,
        floating_resources=(FloatingResource("conns", pools={"default": num_jobs // 8}),),
        maximum_resource_fraction_to_schedule={"cpu": 0.6, "memory": 1.0},
        maximum_scheduling_burst=10 * num_jobs,
        maximum_per_queue_scheduling_burst=max(4, num_jobs // num_queues),
        indexed_node_labels=("zone",),
        pools=(PoolConfig("default", market_driven=market, spot_price_cutoff=0.02),),
    )
    F = config.resource_list_factory()
    zones = ("a", "b", "c")
    nodes = []
    for i in range(num_nodes):
        tainted = rng.random() < 0.1
        nodes.append(NodeSpec(
            id=f"n{i:05d}", pool="default",
            total_resources=F.from_mapping({"cpu": int(rng.choice([8, 16, 32])),
                                            "memory": int(rng.choice([32, 64]))}),
            labels={"zone": zones[int(rng.integers(3))]},
            taints=(Taint("gpu", "true", "NoSchedule"),) if tainted else (),
            unschedulable=bool(rng.random() < 0.03),
        ))
    queues = [Queue(f"q{i:02d}", float(rng.choice([1.0, 2.0]))) for i in range(num_queues)]
    jobs, banned = [], {}
    t = 0.0
    for i in range(num_jobs):
        t += 0.001 + float(rng.random()) * 0.01
        res = {"cpu": int(rng.choice([1, 2, 4])), "memory": int(rng.choice([2, 4]))}
        if rng.random() < 0.1:
            res["conns"] = 1
        jid = f"j{i:06d}"
        jobs.append(JobSpec(
            id=jid, queue=f"q{int(rng.integers(num_queues)):02d}",
            priority_class=str(rng.choice(["low", "high"])), submit_time=t,
            resources=F.from_mapping(res),
            node_selector={"zone": "a"} if rng.random() < 0.1 else {},
            tolerations=(Toleration("gpu", "Equal", "true", "NoSchedule"),)
            if rng.random() < 0.2 else (),
        ))
        if rng.random() < 0.05:
            banned[jid] = [f"n{int(rng.integers(num_nodes)):05d}" for _ in range(3)]
    for g in range(gangs):
        t += 0.01
        card = int(rng.integers(2, max_card + 1))
        uniform = "zone" if rng.random() < 0.3 else ""
        for m in range(card):
            jobs.append(JobSpec(
                id=f"g{g:04d}m{m:02d}", queue=f"q{g % num_queues:02d}",
                priority_class="high", submit_time=t,
                resources=F.from_mapping({"cpu": 2, "memory": 2}),
                gang_id=f"gang{g}", gang_cardinality=card,
                gang_node_uniformity_label=uniform,
            ))
    running = []
    for i in range(num_running):
        away = bool(rng.random() < 0.2)
        running.append(RunningJob(
            job=JobSpec(
                id=f"r{i:06d}", queue=f"q{int(rng.integers(num_queues)):02d}",
                priority_class="low" if (away or rng.random() < 0.7) else "high",
                submit_time=-100.0 + i * 0.001,
                resources=F.from_mapping({"cpu": int(rng.choice([1, 2, 4])), "memory": 2}),
            ),
            node_id=f"n{int(rng.integers(num_nodes)):05d}", away=away,
        ))
    prices = {q.name: float(rng.integers(1, 10)) for q in queues}
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=jobs, running=running,
              banned_nodes=banned,
              bid_price_of=(lambda job: prices[job.queue]) if market else None)
    return config, kw
