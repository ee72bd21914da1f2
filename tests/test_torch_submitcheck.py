"""The port's SubmitChecker: static schedulability at validation time.

The twins of tests/test_submitcheck.py against
armada_tpu_torch.scheduler.submitcheck. Its end-to-end case (an impossible
job fails at validation, through the control plane) is held in
tests/test_torch_service.py, whose scenario fails a gang too big for any
node at validation in both packages.
"""

import pytest

from armada_tpu_torch.core.config import PoolConfig, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, Taint, Toleration
from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
from armada_tpu_torch.scheduler.submitcheck import SubmitChecker

CFG = SchedulingConfig(
    shape_bucket=32,
    pools=(PoolConfig("cpu-pool"), PoolConfig("gpu-pool")),
)
F = CFG.resource_list_factory()


def snapshot(ex_id="ex1", pool="cpu-pool", num=2, cpu="8", mem="32", taints=(), labels=None):
    nodes = tuple(
        NodeSpec(
            id=f"{ex_id}-n{i}",
            pool=pool,
            executor=ex_id,
            total_resources=F.from_mapping({"cpu": cpu, "memory": mem}),
            taints=tuple(taints),
            labels=labels or {},
        )
        for i in range(num)
    )
    return ExecutorSnapshot(id=ex_id, pool=pool, nodes=nodes, last_update_ns=1)


def job(cpu="2", mem="2", **kw):
    return JobSpec(
        id=kw.pop("id", "j1"),
        queue="q",
        resources=F.from_mapping({"cpu": cpu, "memory": mem}),
        **kw,
    )


@pytest.fixture
def checker():
    c = SubmitChecker(CFG)
    c.update_executors([snapshot()])
    return c


def test_feasible_job_passes_with_pools(checker):
    res = checker.check_gang([job()])
    assert res.ok and res.pools == ("cpu-pool",)


def test_oversized_job_rejected_with_gap(checker):
    res = checker.check_gang([job(cpu="999")])
    assert not res.ok
    assert "exceeds every node's capacity" in res.reason
    assert "cpu" in res.reason


def test_gang_larger_than_fleet_rejected(checker):
    members = [job(cpu="4", id=f"g{i}") for i in range(5)]  # fleet fits 4
    res = checker.check_gang(members)
    assert not res.ok
    assert "4 of 5" in res.reason


def test_gang_that_fits_passes(checker):
    members = [job(cpu="4", id=f"g{i}") for i in range(4)]
    assert checker.check_gang(members).ok


def test_selector_mismatch_rejected(checker):
    res = checker.check_gang([job(node_selector={"zone": "mars"})])
    assert not res.ok


def test_selector_match_and_taints():
    c = SubmitChecker(CFG)
    c.update_executors(
        [
            snapshot(
                taints=(Taint("dedicated", "ml", "NoSchedule"),),
                labels={"zone": "east"},
            )
        ]
    )
    # intolerant job blocked by the taint
    assert not c.check_gang([job()]).ok
    # tolerating + matching selector passes
    ok = c.check_gang(
        [
            job(
                tolerations=(Toleration("dedicated", "Equal", "ml", "NoSchedule"),),
                node_selector={"zone": "east"},
            )
        ]
    )
    assert ok.ok


def test_requested_pool_must_exist(checker):
    res = checker.check_gang([job(pools=("gpu-pool",))])
    assert not res.ok and "gpu-pool" in res.reason


def test_multi_pool_fleet_reports_fitting_pools():
    c = SubmitChecker(CFG)
    c.update_executors(
        [snapshot("ex1", "cpu-pool"), snapshot("ex2", "gpu-pool", cpu="16")]
    )
    res = c.check_gang([job(cpu="12")])
    assert res.ok and res.pools == ("gpu-pool",)
    res = c.check_gang([job(cpu="2")])
    assert res.pools == ("cpu-pool", "gpu-pool")


def test_cache_invalidated_on_fleet_change():
    c = SubmitChecker(CFG)
    c.update_executors([snapshot(cpu="8")])


@pytest.mark.parametrize("seed", range(4))
def test_verdicts_match_the_jax_package(seed):
    """Random fleets (taints, labels, uniformity domains, two pools) and
    random gangs, with and without banned nodes: the port's verdicts,
    pools and reasons are the JAX package's."""
    import numpy as np

    import armada_tpu.core.config as jc
    import armada_tpu.core.types as jt
    import armada_tpu.scheduler.executors as jex
    import armada_tpu.scheduler.submitcheck as jsc

    def make(C, T, X, SC):
        cfg = C.SchedulingConfig(shape_bucket=32, pools=(C.PoolConfig("a"), C.PoolConfig("b")))
        f = cfg.resource_list_factory()
        rng = np.random.default_rng(seed)
        snaps = []
        for e in range(3):
            pool = "a" if e < 2 else "b"
            nodes = tuple(
                T.NodeSpec(
                    id=f"ex{e}-n{i}", pool=pool, executor=f"ex{e}",
                    total_resources=f.from_mapping({"cpu": str(int(rng.choice([4, 8, 16]))),
                                                    "memory": str(int(rng.choice([16, 64])))}),
                    taints=(T.Taint("gpu", "true", "NoSchedule"),) if rng.random() < 0.2 else (),
                    labels={"rack": f"r{int(rng.integers(0, 3))}"} if rng.random() < 0.8 else {},
                )
                for i in range(int(rng.integers(5, 15)))
            )
            snaps.append(X.ExecutorSnapshot(id=f"ex{e}", pool=pool, nodes=nodes, last_update_ns=1))
        checker = SC.SubmitChecker(cfg)
        checker.update_executors(snaps)
        node_ids = [n.id for s in snaps for n in s.nodes]
        cases = []
        for k in range(60):
            card = int(rng.choice([1, 1, 2, 4, 9]))
            kw = dict(queue="q", gang_cardinality=card,
                      resources=f.from_mapping({"cpu": str(int(rng.choice([1, 3, 8, 17]))),
                                                "memory": str(int(rng.choice([1, 8, 40])))}))
            if rng.random() < 0.3:
                kw["gang_node_uniformity_label"] = "rack"
            if rng.random() < 0.2:
                kw["tolerations"] = (T.Toleration(key="gpu", operator="Exists"),)
            if rng.random() < 0.2:
                kw["node_selector"] = {"rack": "r1"}
            if rng.random() < 0.3:
                kw["pools"] = ("b",) if rng.random() < 0.5 else ("a",)
            members = [T.JobSpec(id=f"j{k}-{m}", **kw) for m in range(min(card, 3))]
            banned = tuple(rng.choice(node_ids, size=int(rng.integers(0, 12)), replace=False))
            cases.append((members, banned))
        return [checker.check_gang(m, banned_nodes=b) for m, b in cases] + [
            checker.check_gang(m) for m, _ in cases]

    import armada_tpu_torch.core.config as tc
    import armada_tpu_torch.core.types as tt
    import armada_tpu_torch.scheduler.executors as tex
    import armada_tpu_torch.scheduler.submitcheck as tsc

    want = make(jc, jt, jex, jsc)
    got = make(tc, tt, tex, tsc)
    assert [(r.ok, r.pools, r.reason) for r in got] == [(r.ok, r.pools, r.reason) for r in want]
    assert any(r.ok for r in want) and any(not r.ok for r in want)
