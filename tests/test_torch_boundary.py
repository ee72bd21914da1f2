"""The port's boundaries: imports, devices, and where the kernels run.

- armada_tpu_torch and chip_smoke.py import neither jax nor the JAX package.
- With no card, the entry points refuse to run unless the caller passes
  device="cpu", and chip_smoke.py exits non-zero printing no result.
- A kernel wrapper given CPU tensors runs the plain version and leaves the
  launch counters alone.
- On a machine with a card, the `cuda`-marked test holds every kernel
  against its plain version (it skips here, where there is no card).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_FORBIDDEN = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
    "or m == 'jaxlib' or m == 'armada_tpu' or m.startswith('armada_tpu.'))\n"
    "assert not bad, bad\n"
)


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import armada_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(armada_tpu_torch.__path__, 'armada_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n" + _FORBIDDEN
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert not (n == "jax" or n.startswith("jax.") or n == "armada_tpu"
                        or n.startswith("armada_tpu.")), n
    out = _run("import sys\nimport chip_smoke\n" + _FORBIDDEN)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def _world():
    from armada_tpu_torch.models.synthetic import synthetic_world

    return synthetic_world(num_nodes=20, num_jobs=60, num_queues=3, num_runs=5,
                           shape_bucket=32)


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from armada_tpu_torch.models import run_scheduling_round
    from armada_tpu_torch.models.fair_scheduler import schedule_round
    from armada_tpu_torch.models.synthetic import synthetic_problem

    config, nodes, queues, specs, running, _ = _world()
    kw = dict(pool="default", nodes=nodes, queues=queues, queued_jobs=specs, running=running)
    with pytest.raises(RuntimeError):
        run_scheduling_round(config, **kw)
    outcome = run_scheduling_round(config, **kw, device="cpu")
    assert outcome.scheduled
    problem, meta = synthetic_problem(num_nodes=10, num_gangs=30, num_queues=2)
    with pytest.raises(RuntimeError):
        schedule_round(problem, **meta)
    assert int(schedule_round(problem, **meta, device="cpu").n_slots) > 0


def test_cpu_tensors_take_the_plain_version():
    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels import compact as kc
    from armada_tpu_torch.kernels import fair_shares as kf
    from armada_tpu_torch.kernels import round as kr
    from armada_tpu_torch.models.fair_scheduler import (
        compact_result_plain, resolve_round_statics, schedule_round_plain,
    )
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    kernels.reset_launches()
    w = torch.tensor([1.0, 2.0, 0.0, 0.5])
    c = torch.tensor([0.1, 0.5, 0.0, 0.9])
    for a, b in zip(kf.fair_shares(w, c), fair_shares_plain(w, c)):
        assert torch.equal(a, b)
    problem, meta = synthetic_problem(num_nodes=20, num_gangs=60, num_queues=3, num_runs=5,
                                      max_gang_cardinality=3)
    p = problem_from_numpy(problem, "cpu")
    max_it = resolve_round_statics(p)
    got = kr.schedule_round(p, **meta, max_iterations=max_it)
    want = schedule_round_plain(p, **meta, max_iterations=max_it)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    buf = kc.compact_result(got, 60, 5, fcap=16, ecap=4)
    assert torch.equal(buf, compact_result_plain(got, 60, 5, fcap=16, ecap=4))
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Run on a machine with a card:
    `python -m pytest --noconftest -m cuda tests/test_torch_boundary.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke
    from armada_tpu_torch.models.synthetic import synthetic_problem

    dev = torch.device("cuda", 0)
    chip_smoke.check_fair_shares(dev)
    chip_smoke.check_compact(dev)
    problem, meta = synthetic_problem(num_nodes=300, num_gangs=2000, num_queues=16,
                                      num_runs=100, max_gang_cardinality=8, seed=3)
    chip_smoke.check_round("synthetic", problem, meta, dev)
