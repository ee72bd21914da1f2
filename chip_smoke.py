"""Drive the PyTorch/CUDA port of the scheduling round on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from armada_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, then runs the main path --
`armada_tpu_torch.models.run_scheduling_round` on a synthetic world of 1M
jobs x 50k nodes x 64 queues with 25k running jobs -- and holds its outcome
against the same problem run through the plain version on the card.

Output: progress lines, then a `{"kernels": [...]}` JSON line, the card's
name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", ...}}`.  Details go to
chiprun_out/chip_smoke.json.  Any failed phase exits non-zero with the error.
Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bandwidth and f32
# rate outside the tensor cores.  The bounds below are computed from these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_WORLD = dict(num_nodes=50_000, num_jobs=1_000_000, num_queues=64, num_runs=25_000, seed=0)
# the main path also reports indicative shares for new queues at these base
# priorities (water-filling at the padded Q + 1)
INDICATIVE_PRIORITIES = (1, 2)
KB_SYNTH = dict(num_nodes=5_000, num_gangs=100_000, num_queues=64, num_runs=2_500,
                max_gang_cardinality=8, seed=0)
KB_MARKET = dict(num_nodes=2_000, num_jobs=20_000, num_queues=16, num_runs=1_000, seed=1,
                 market=True)
KB_EVICT = dict(num_nodes=5_000, num_jobs=50_000, num_queues=64, num_runs=10_000, seed=2)
VARIETY = dict(num_nodes=3_000, num_jobs=30_000, num_queues=32, num_running=3_000, gangs=300,
               max_card=16, shape_bucket=1024)

SOURCES = {
    "fair_shares": ("armada_tpu_torch/csrc/fair_shares.cu", "armada_tpu/ops/fairness.py:95"),
    "round": ("armada_tpu_torch/csrc/round.cu", "armada_tpu/models/fair_scheduler.py:1842"),
    "compact": ("armada_tpu_torch/csrc/compact.cu", "armada_tpu/models/fair_scheduler.py:109"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> tuple[float, object]:
    """Mean device milliseconds of fn() over reps runs (after one warm-up),
    timed with CUDA events; returns (ms, last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def round_profile(fn) -> list:
    """[(kernel name, launches, device ms)] of one call of fn, largest
    first, from torch.profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, e.count, us / 1e3))
    if not rows:
        raise AssertionError("torch.profiler recorded no device time for the round")
    return sorted(rows, key=lambda r: -r[2])


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tensor_bytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def max_err(a, b) -> float:
    """Max |a - b| between a kernel's and its plain version's outputs (two
    RoundResults, every field but kernel_iters, or two tensors).  The kernels
    are held to exact equality, so any difference raises and the value
    returned is 0.0."""
    import torch

    if isinstance(a, torch.Tensor):
        pairs = [("tensor", a, b)]
    else:
        pairs = [(f, getattr(a, f), getattr(b, f)) for f in a._fields if f != "kernel_iters"]
    err = 0.0
    for name, x, y in pairs:
        x = x.detach().cpu()
        y = y.detach().cpu()
        if x.shape != y.shape:
            raise AssertionError(f"{name}: shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.dtype.is_floating_point:
            if not torch.equal(x, y):
                d = (x.double() - y.double()).abs().max().item()
                raise AssertionError(f"{name}: kernel and plain differ (max |d| = {d})")
        elif not torch.equal(x, y):
            n = int((x != y).sum())
            raise AssertionError(f"{name}: kernel and plain differ in {n} entries")
    return err


# --- phases ----------------------------------------------------------------------


def check_fair_shares(dev) -> dict:
    import torch

    from armada_tpu_torch.kernels.fair_shares import fair_shares
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    out = {}
    # multiples of 32, the 8-lane spare sum (25..32) and split-padding
    # windows (Q + 1, as the indicative shares run it)
    for Q in (25, 31, 32, 33, 64, 257, 1024, 8193):
        rng = np.random.default_rng(Q)
        w = torch.as_tensor(rng.choice([0.0, 0.5, 1.0, 2.0, 3.7], Q).astype(np.float32), device=dev)
        c = torch.as_tensor((rng.random(Q) * rng.choice([0.01, 0.1, 1.0], Q)).astype(np.float32),
                            device=dev)
        k = fair_shares(w, c)
        pl = fair_shares_plain(w, c)
        torch.cuda.synchronize()
        for x, y in zip(k, pl):
            max_err(x, y)
        out[Q] = "equal"
        log(f"K-A fair_shares Q={Q}: kernel == plain")
    return out


def fake_result(G: int, RJ: int, S: int, W: int, N: int, dev, seed: int = 0):
    """A RoundResult with random decision masks (for the compaction check)."""
    import torch

    from armada_tpu_torch.models.fair_scheduler import RoundResult

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    i32 = np.int32
    return RoundResult(
        g_state=t(rng.integers(0, 4, G).astype(i32)),
        slot_gang=t(rng.integers(0, G, S).astype(i32)),
        slot_nodes=t(rng.integers(0, N + 1, (S, W)).astype(i32)),
        slot_counts=t(rng.integers(0, 3, (S, W)).astype(i32)),
        n_slots=t(np.int32(S)),
        run_evicted=t(rng.random(RJ) < 0.3),
        run_rescheduled=t(rng.random(RJ) < 0.5),
        alloc=t(np.zeros((1, 1, 1), np.float32)),
        q_alloc=t(np.zeros((1, 1), np.float32)),
        iterations=t(np.int32(1234)),
        termination=t(np.int32(1)),
        scheduled_count=t(np.int32(999)),
        spot_price=t(np.float32(2.5)),
        q_killed=t(np.zeros(1, bool)),
        kernel_iters=t(np.int32(1234)),
    )


def check_compact(dev) -> None:
    import torch

    from armada_tpu_torch.kernels.compact import compact_result
    from armada_tpu_torch.models.fair_scheduler import compact_result_plain

    G, RJ = 1_048_576, 32_768
    r = fake_result(G, RJ, 1000, 8, 57_344, dev)
    for real_g, real_r, fcap, ecap in ((G - 1000, RJ - 100, 8192, 8192), (G, RJ, G, RJ)):
        k = compact_result(r, real_g, real_r, fcap=fcap, ecap=ecap)
        p = compact_result_plain(r, real_g, real_r, fcap=fcap, ecap=ecap)
        torch.cuda.synchronize()
        max_err(k, p)
    log(f"K-C compact G={G} RJ={RJ}: kernel == plain (capped and uncapped lists)")


def check_round(name: str, problem, meta: dict, dev) -> dict:
    """Kernel round vs plain round on the card: every field but kernel_iters."""
    import torch

    from armada_tpu_torch.kernels.round import schedule_round
    from armada_tpu_torch.models.fair_scheduler import schedule_round_plain
    from armada_tpu_torch.models.state import problem_from_numpy

    dp = problem_from_numpy(problem, dev)
    G = int(dp.g_req.shape[0])
    Q = int(dp.q_weight.shape[0])
    kw = dict(meta, max_iterations=2 * G + Q + 8)
    k = schedule_round(dp, **kw)
    torch.cuda.synchronize()
    p = schedule_round_plain(dp, **kw)
    torch.cuda.synchronize()
    max_err(k, p)
    info = dict(
        iterations=int(k.iterations), scheduled=int(k.scheduled_count),
        evicted=int(k.run_evicted.sum()), rescheduled=int(k.run_rescheduled.sum()),
        termination=int(k.termination), spot_price=float(k.spot_price),
    )
    log(f"K-B round [{name}]: kernel == plain {info}")
    return info


def round_meta(ctx) -> dict:
    return dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots, slot_width=ctx.slot_width)


def world_problem(spec: dict, protected=None):
    from armada_tpu_torch.models.problem import build_problem
    from armada_tpu_torch.models.synthetic import synthetic_bid_price, synthetic_world

    config, nodes, queues, specs, running, _ = synthetic_world(**spec)
    if protected is not None:
        config = dataclasses.replace(config, protected_fraction_of_fair_share=protected)
    bid = synthetic_bid_price if spec.get("market") else None
    return build_problem(config, pool="default", nodes=nodes, queues=queues,
                         queued_jobs=specs, running=running, bid_price_of=bid)


def main_path(dev) -> dict:
    """The entry point at reference scale, then its stages timed on their own
    and the plain version on the same problem."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels.compact import compact_result
    from armada_tpu_torch.kernels.fair_shares import fair_shares
    from armada_tpu_torch.kernels.round import schedule_round
    from armada_tpu_torch.models import run_scheduling_round
    from armada_tpu_torch.models.fair_scheduler import (
        compact_result_plain, schedule_round_plain,
    )
    from armada_tpu_torch.models.problem import (
        COMPACT_ECAP, COMPACT_FCAP, begin_decode, build_problem, queue_stats_from_result,
    )
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_world
    from armada_tpu_torch.ops.fairness import fair_shares_plain, theoretical_share

    t0 = time.perf_counter()
    config, nodes, queues, specs, running, _ = synthetic_world(**MAIN_WORLD)
    config = dataclasses.replace(config, indicative_share_base_priorities=INDICATIVE_PRIORITIES)
    world_s = time.perf_counter() - t0
    log(f"main path: world built in {world_s:.1f} s")

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outcome = run_scheduling_round(
        config, pool="default", nodes=nodes, queues=queues, queued_jobs=specs,
        running=running, device=dev,
    )
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"main path: run_scheduling_round {entry_s:.2f} s; scheduled {len(outcome.scheduled)} "
        f"preempted {len(outcome.preempted)} failed {len(outcome.failed)} "
        f"iterations {outcome.num_iterations} termination {outcome.termination}; "
        f"launches {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    # the same stages, timed one by one
    t0 = time.perf_counter()
    problem, ctx = build_problem(config, pool="default", nodes=nodes, queues=queues,
                                 queued_jobs=specs, running=running)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = problem_from_numpy(problem, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    meta = round_meta(ctx)
    G = int(dp.g_req.shape[0])
    Q = int(dp.q_weight.shape[0])
    N, R = (int(x) for x in dp.node_total.shape)
    RJ = int(dp.run_req.shape[0])
    kw = dict(meta, max_iterations=2 * G + Q + 8)
    round_ms, result = cuda_ms(lambda: schedule_round(dp, **kw), reps=3)
    t0 = time.perf_counter()
    decoded = begin_decode(result, ctx)()
    decode_s = time.perf_counter() - t0
    iters = int(result.iterations)
    log(f"main path stages: build_problem {build_s:.2f} s, upload {upload_s:.3f} s, "
        f"round kernels {round_ms:.2f} ms, decode {decode_s:.3f} s; N={N} G={G} Q={Q} RJ={RJ} "
        f"iterations {iters}")
    if decoded.scheduled != outcome.scheduled or sorted(decoded.preempted) != sorted(outcome.preempted):
        raise AssertionError("the timed stages disagree with the entry point's outcome")

    # the plain version on the same problem, on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = schedule_round_plain(dp, **kw)
    torch.cuda.synchronize()
    plain_round_ms = (time.perf_counter() - t0) * 1e3
    err_round = max_err(result, plain)
    plain_out = begin_decode(plain, ctx)()
    if (plain_out.scheduled != outcome.scheduled
            or sorted(plain_out.preempted) != sorted(outcome.preempted)
            or list(plain_out.failed) != list(outcome.failed)
            or plain_out.num_iterations != outcome.num_iterations
            or plain_out.termination != outcome.termination):
        raise AssertionError("plain version's outcome differs from the kernels' outcome")
    log(f"main path: plain round on the card {plain_round_ms:.1f} ms; outcome equal")

    # the entry point's share stats ran on the card (K-A at Q and Q + 1);
    # hold them against the plain version on CPU tensors
    plain_stats = queue_stats_from_result(plain._replace(q_alloc=plain.q_alloc.cpu()), problem,
                                          ctx)
    w_cpu, c_cpu = dp.q_weight.cpu(), dp.q_cds.cpu()
    plain_shares = {p: theoretical_share(w_cpu, c_cpu, float(p)) for p in INDICATIVE_PRIORITIES}
    if plain_stats != outcome.queue_stats:
        raise AssertionError("queue stats differ between the card and the plain version")
    if plain_shares != outcome.indicative_shares:
        raise AssertionError(f"indicative shares differ: card {outcome.indicative_shares} "
                             f"plain {plain_shares}")
    log(f"main path: queue stats and indicative shares {outcome.indicative_shares} equal "
        "the plain version's")
    if not all(np.isfinite(result.alloc.cpu().numpy()).ravel()):
        raise AssertionError("non-finite allocatable in the round's result")

    # where the round's device time goes, kernel by kernel
    profile_rows = round_profile(lambda: schedule_round(dp, **kw))
    log("main path: round device time by kernel (ms): " + ", ".join(
        f"{name.split('(')[0]} {ms:.3f}" for name, _, ms in profile_rows[:6]))

    # K-A at the main path's shape
    fa_ms, fa = cuda_ms(lambda: fair_shares(dp.q_weight, dp.q_cds), reps=20)
    fa_plain_ms, fa_plain = cuda_ms(lambda: fair_shares_plain(dp.q_weight, dp.q_cds), reps=3)
    err_fa = max(max_err(x, y) for x, y in zip(fa, fa_plain))
    # K-C at the main path's shape
    fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)
    args = (result, ctx.num_real_gangs, ctx.num_real_runs)
    kc_ms, kc = cuda_ms(lambda: compact_result(*args, fcap=fcap, ecap=ecap), reps=20)
    kc_plain_ms, kc_plain = cuda_ms(lambda: compact_result_plain(*args, fcap=fcap, ecap=ecap),
                                    reps=5)
    err_kc = max_err(kc, kc_plain)

    # bounds: each input byte read once, each output written once; the round
    # also reads, per iteration, the two allocatable rows of every node and
    # the cursor window of every live queue (those holding gangs): 16 steps of
    # gang index (4 bytes), key (4), key-bad flag (1) and state (4)
    fa_b = bound_ms(tensor_bytes(dp.q_weight, dp.q_cds) + 3 * Q * 4, 10 * 20 * Q)
    prob_bytes = tensor_bytes(*[getattr(dp, f) for f in dp._fields])
    out_bytes = tensor_bytes(*[getattr(result, f) for f in result._fields])
    live_q = int((dp.q_len > 0).sum())
    per_iter = 2 * N * R * 4 + live_q * 16 * 13
    kb_b = bound_ms(prob_bytes + out_bytes + iters * per_iter, iters * 2 * N * R * 6)
    kc_b = bound_ms(
        tensor_bytes(result.g_state, result.run_evicted, result.run_rescheduled,
                     result.slot_gang, result.slot_nodes, result.slot_counts) + kc.numel() * 4,
        G + 2 * RJ,
    )
    rows = []
    for name, ms, pms, err, (bms, by) in (
        ("fair_shares", fa_ms, fa_plain_ms, err_fa, fa_b),
        ("round", round_ms, plain_round_ms, err_round, kb_b),
        ("compact", kc_ms, kc_plain_ms, err_kc, kc_b),
    ):
        src, rep = SOURCES[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=err, equal=err == 0.0, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=None,
        ))
    stages = dict(profile=profile_rows, world_s=world_s, entry_s=entry_s, build_problem_s=build_s,
                  upload_s=upload_s, round_ms=round_ms, decode_s=decode_s,
                  plain_round_ms=plain_round_ms, iterations=iters, N=N, G=G, Q=Q, RJ=RJ,
                  live_queues=live_q, indicative_shares=outcome.indicative_shares,
                  scheduled=len(outcome.scheduled), preempted=len(outcome.preempted),
                  failed=len(outcome.failed), termination=outcome.termination)
    return dict(rows=rows, stages=stages, launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from armada_tpu_torch.kernels import build as kbuild
    from armada_tpu_torch.models.synthetic import synthetic_problem

    smi = smi_line()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kbuild.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built and loaded in {build_s:.1f} s (nvcc {kbuild.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    report: dict = dict(card=smi, build_s=build_s, build_log=kbuild.BUILD_INFO.get("log", ""))

    report["fair_shares"] = check_fair_shares(dev)
    check_compact(dev)
    sp, meta = synthetic_problem(**KB_SYNTH)
    report["round_synthetic"] = check_round("synthetic_problem", sp, meta, dev)
    mp, mctx = world_problem(KB_MARKET)
    report["round_market"] = check_round("market world", mp, round_meta(mctx), dev)
    ep, ectx = world_problem(KB_EVICT, protected=0.0)
    report["round_evict"] = check_round("eviction world", ep, round_meta(ectx), dev)
    if report["round_evict"]["evicted"] == 0:
        raise AssertionError("the eviction world evicted nothing")
    from armada_tpu_torch.models.problem import build_problem
    from armada_tpu_torch.models.synthetic import variety_world

    for market in (False, True):
        config, kw = variety_world(7, **VARIETY, market=market)
        vp, vctx = build_problem(config, **kw)
        name = "variety market world" if market else "variety world"
        report[name] = check_round(name, vp, round_meta(vctx), dev)

    mp_report = main_path(dev)
    report.update(mp_report)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": mp_report["rows"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
