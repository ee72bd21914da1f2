"""The port's simulator (armada_tpu_torch.simulator) and config parsers
against the JAX package's, on the CPU.

- Every testdata/golden/*.yaml world goes through the port's
  `Simulator(device="cpu")` and must give the trace the reference's own
  simulator test table expects, unarmed and with ARMADA_CACHE_SLOTS,
  ARMADA_COMMIT_K and ARMADA_BATCH_K armed (the golden config runs
  prefer-large ordering, which keeps commit_k and batch_k at 1).
- On the testdata/simulator cluster x workload specs and on worlds after
  tests/test_simulator.py's, the port's events, cycle stats and totals equal
  the JAX simulator's (which runs its CPU default, the cached round).
- The config parsers equal the JAX parsers on the mappings and YAML the
  JAX tests use; the CLI writes the same JSONL.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

import armada_tpu.simulator as jsim
import armada_tpu_torch.simulator as tsim
from armada_tpu.core import config as jcfg
from armada_tpu_torch.core import config as tcfg
from test_golden_traces import GOLDEN, KIND, golden_config
from test_simulator import BASIC_WORKLOAD, TINY_CLUSTER, sim_config

REPO = Path(__file__).resolve().parent.parent
SPECS = REPO / "testdata" / "simulator"
K11_ENV = ("ARMADA_CACHE_SLOTS", "ARMADA_COMMIT_K", "ARMADA_BATCH_K")


def port_config(cfg):
    """The port's SchedulingConfig with the same values as a JAX one."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["priority_classes"] = {
        name: tcfg.PriorityClass(**dataclasses.asdict(pc))
        for name, pc in cfg.priority_classes.items()
    }
    fields["pools"] = tuple(
        tcfg.PoolConfig(**{**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)},
                           "gangs_to_price": tuple(
                               (n, tcfg.GangDefinition(**dataclasses.asdict(g)))
                               for n, g in p.gangs_to_price)})
        for p in cfg.pools)
    fields["floating_resources"] = tuple(
        tcfg.FloatingResource(**dataclasses.asdict(fr)) for fr in cfg.floating_resources)
    return tcfg.SchedulingConfig(**fields)


def _clear_k11(monkeypatch):
    for name in K11_ENV:
        monkeypatch.delenv(name, raising=False)


# --- the golden traces ----------------------------------------------------------------


@pytest.mark.parametrize("arm", ["unarmed", "ARMADA_CACHE_SLOTS=64", "ARMADA_COMMIT_K=8",
                                 "ARMADA_BATCH_K=8"])
@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_golden_trace(monkeypatch, path, arm):
    _clear_k11(monkeypatch)
    if arm != "unarmed":
        name, value = arm.split("=")
        monkeypatch.setenv(name, value)
    doc = yaml.safe_load(path.read_text())
    sim = tsim.Simulator(
        tsim.cluster_spec_from_dict(doc["cluster"]),
        tsim.workload_spec_from_dict(doc["workload"]),
        port_config(golden_config()),
        schedule_interval_s=10.0,
        device="cpu",
    )
    result = sim.run()

    def of(jid):
        return sim.templates[sim.job_template[jid]].template

    actual = [[KIND[kind], of(jid).queue, of(jid).job_set] for (_, kind, jid) in result.events]
    assert actual == [list(e) for e in doc["expected"]], path.stem
    assert not result.never_scheduled


# --- the port's simulator against the JAX simulator ---------------------------------------


def _run_both(cluster_doc, workload_doc, cfg, **kw):
    ref = jsim.Simulator(jsim.cluster_spec_from_dict(cluster_doc),
                         jsim.workload_spec_from_dict(workload_doc), cfg, **kw).run()
    got = tsim.Simulator(tsim.cluster_spec_from_dict(cluster_doc),
                         tsim.workload_spec_from_dict(workload_doc), port_config(cfg),
                         device="cpu", **kw).run()
    assert got.events == ref.events
    assert [dataclasses.asdict(c) for c in got.cycles] == [dataclasses.asdict(c) for c in ref.cycles]
    for name in ("makespan", "total_scheduled", "total_preempted", "total_succeeded",
                 "total_failed", "never_scheduled", "success_time_by_job"):
        assert getattr(got, name) == getattr(ref, name), name
    return got


def _load(path):
    return yaml.safe_load(path.read_text())


@pytest.mark.parametrize("cluster", ["tiny", "two-pools"])
@pytest.mark.parametrize("workload", ["basic", "dag"])
def test_testdata_specs_equal_the_jax_simulator(monkeypatch, cluster, workload):
    _clear_k11(monkeypatch)
    got = _run_both(_load(SPECS / "clusters" / f"{cluster}.yaml"),
                    _load(SPECS / "workloads" / f"{workload}.yaml"), jcfg.SchedulingConfig())
    assert got.total_succeeded > 0


def _one_queue(name, seed, templates):
    return dict(name=name, randomSeed=seed, queues=[
        dict(name=q, weight=1, jobTemplates=tl) for q, tl in templates])


def _tmpl(tid, number, cpu, runtime, **extra):
    return dict(id=tid, number=number, runtimeDistribution=dict(minimum=runtime),
                requirements=dict(resourceRequirements=dict(requests=dict(cpu=cpu,
                                                                          memory="1Gi"))),
                **extra)


# tests/test_simulator.py's worlds: contention, preemption of a late queue,
# gangs, dependencies, repeats
WORLDS = {
    "basic": (yaml.safe_load(BASIC_WORKLOAD), {}),
    "contention": (_one_queue("contention", 7, [("A", [_tmpl("tA", 12, 4, "10m")]),
                                                ("B", [_tmpl("tB", 12, 4, "10m")])]), {}),
    "preempt": (_one_queue("preempt", 3, [
        ("hog", [_tmpl("th", 8, 4, "2h", priorityClassName="armada-preemptible")]),
        ("late", [_tmpl("tl", 8, 4, "2h", priorityClassName="armada-preemptible",
                        earliestSubmitTime="15m")])]),
        dict(protected_fraction_of_fair_share=0.5)),
    "gangs": (_one_queue("gangs", 5, [("G", [_tmpl("tg", 8, 8, "5m", gangCardinality=4)])]),
              {}),
    "dag": (_one_queue("dag", 9, [("D", [
        _tmpl("stage1", 4, 1, "5m"),
        _tmpl("stage2", 4, 1, "5m", dependencies=["stage1"],
              earliestSubmitTimeFromDependencyCompletion="1m")])]), {}),
    "repeat": (_one_queue("repeat", 11, [("R", [
        _tmpl("tr", 2, 1, "1m", repeat=dict(numTimes=3, period="30m"))])]), {}),
}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_simulator_worlds_equal_the_jax_simulator(monkeypatch, name):
    _clear_k11(monkeypatch)
    workload_doc, overrides = WORLDS[name]
    got = _run_both(yaml.safe_load(TINY_CLUSTER), workload_doc, sim_config(**overrides))
    assert got.total_succeeded > 0
    if name == "preempt":
        assert got.total_preempted >= 2


def test_armed_simulator_equals_the_jax_simulator(monkeypatch):
    """The basic world with the port's fit cache armed against the JAX
    simulator's CPU default (its cached round)."""
    _clear_k11(monkeypatch)
    monkeypatch.setenv("ARMADA_CACHE_SLOTS", "64")
    workload_doc, overrides = WORLDS["basic"]
    _run_both(yaml.safe_load(TINY_CLUSTER), workload_doc, sim_config(**overrides))


def test_simulator_refuses_the_card_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sim = tsim.Simulator(tsim.cluster_spec_from_dict(yaml.safe_load(TINY_CLUSTER)),
                         tsim.workload_spec_from_dict(yaml.safe_load(BASIC_WORKLOAD)),
                         port_config(sim_config()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run()


# --- the config parsers ------------------------------------------------------------------------


CONFIG_DICTS = [
    {"publishMetricEvents": True},
    {"experimentalIndicativeShare": {"basePriorities": [1, 2]}},
    {"pools": [{"name": "default", "shortJobPenaltyCutoff": "2m"}]},
    {"nodeQuarantineFailureThreshold": 5, "nodeQuarantineWindow": "2m",
     "nodeQuarantineCooldown": "10m"},
    {"pools": [{"name": "market", "marketDriven": True, "spotPriceCutoff": 0.5,
                "gangsToPrice": {"g8": {"size": 8, "priorityClassName": "low",
                                        "resources": {"cpu": "4"},
                                        "tolerations": [{"key": "gpu", "operator": "Exists"}]}}},
               {"name": "batch", "awayPools": ["market"]}],
     "floatingResources": [{"name": "storage-connections",
                            "pools": [{"name": "batch", "quantity": 25}]}],
     "priorityClasses": {"low": {"priority": 100, "preemptible": True,
                                 "maximumResourceFractionPerQueue": {"cpu": 0.5}}},
     "MAXIMUMSCHEDULINGBURST": 17, "supportedResourceTypes": [{"name": "cpu",
                                                               "resolution": "1m"}],
     "executorTimeout": "1h30m", "indexedTaints": ["gpu"]},
]


def _same(a, b):
    return json.dumps(dataclasses.asdict(a), sort_keys=True, default=str) == \
        json.dumps(dataclasses.asdict(b), sort_keys=True, default=str)


@pytest.mark.parametrize("i", range(len(CONFIG_DICTS)))
def test_config_from_dict_equals_the_jax_parser(i):
    d = CONFIG_DICTS[i]
    assert _same(tcfg.scheduling_config_from_dict(d), jcfg.scheduling_config_from_dict(d))


def test_config_from_yaml_and_durations_equal_the_jax_parser(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"scheduling": CONFIG_DICTS[-1]}))
    for p in (str(path), str(REPO / "deployment" / "config.yaml")):
        assert _same(tcfg.scheduling_config_from_yaml(p), jcfg.scheduling_config_from_yaml(p))
    for d in ("5m", "90s", "1h30m", "250ms", 45, "", None, "2d"):
        assert tcfg.parse_duration_s(d) == jcfg.parse_duration_s(d)
    for bad in ("5parsecs", "m5"):
        with pytest.raises(ValueError):
            tcfg.parse_duration_s(bad)
    with pytest.raises(ValueError):
        tcfg.scheduling_config_from_dict({"experimentalIndicativeShare": {"basePriorities": [0]}})


# --- the CLI --------------------------------------------------------------------------------------


def test_cli_writes_the_jax_clis_jsonl(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    for name in K11_ENV:
        env.pop(name, None)
    args = ["--clusters", str(SPECS / "clusters" / "two-pools.yaml"),
            "--workloads", str(SPECS / "workloads" / "basic.yaml")]
    outs = {}
    for pkg, extra in (("armada_tpu", []), ("armada_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / f"{pkg}.jsonl"
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.simulator", *args,
                               "--output", str(out), *extra],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = out.read_text()
    assert outs["armada_tpu_torch"] == outs["armada_tpu"]
    assert outs["armada_tpu"].count("\n") > 1
