"""Drive the PyTorch/CUDA port of the scheduling round on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from armada_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, then runs the main path --
`armada_tpu_torch.models.run_scheduling_round` on a synthetic world of 1M
jobs x 50k nodes x 64 queues with 25k running jobs -- and holds its outcome
against the same problem run through the plain version on the card.  Then
the incremental path over the same world: the steady-state cycle
(IncrementalBuilder -> assemble_delta -> DeviceDeltaCache.apply, kernel K-H
-> run_round_on_device with verification, K-I, on every round and the
explain pass, K-J, on its cadence -> decisions applied back), one warm and
three steady cycles, each kernel held against its plain version on the
cycle's own state.  A small world runs that path first, to fail fast.

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
    "slab": ("armada_tpu_torch/csrc/slab.cu", "armada_tpu/models/slab.py:258"),
    "verify": ("armada_tpu_torch/csrc/verify.cu", "armada_tpu/models/verify.py:272"),
    "explain": ("armada_tpu_torch/csrc/explain.cu", "armada_tpu/models/explain.py:205"),
}
# The incremental path: the steady-state cycle over the main path's world
# (bench.py's _e2e_bench shape): one warm cycle (full upload), then steady
# cycles, each submitting BURST fresh specs and applying the decisions back;
# verification armed on every round, explain at serve's interval.
BURST = 1000
# 38k jobs and 2k runs leave room in the 8,192-row slab buckets for the
# cycles' submits and leases, so the steady cycles scatter (no slab growth)
SMALL_WORLD = dict(num_nodes=2_000, num_jobs=38_000, num_queues=16, num_runs=2_000, seed=5)
STEADY_CYCLES = 3
EXPLAIN_INTERVAL = 10


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


def main_path(dev, world) -> dict:
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
    from armada_tpu_torch.ops.fairness import fair_shares_plain, theoretical_share

    config, nodes, queues, specs, running, _ = world["world"]
    config = dataclasses.replace(config, indicative_share_base_priorities=INDICATIVE_PRIORITIES)
    world_s = world["seconds"]

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
    for k in ("fair_shares", "round", "compact"):
        if launches[k] <= 0:
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
    return dict(rows=rows, stages=stages, launches=launches, outcome=outcome)


# --- the incremental path --------------------------------------------------------


class uncounted:
    """Context in which kernel launches and host-device copies do not add to
    the path's counters: timing replays and kernel-versus-plain comparisons
    are not work of the path."""

    def __enter__(self):
        from armada_tpu_torch import kernels
        from armada_tpu_torch.models.xfer import TRANSFER_STATS

        self.saved = dict(kernels.LAUNCHES)
        self.xfer = TRANSFER_STATS.snapshot()

    def __exit__(self, *exc):
        from armada_tpu_torch import kernels
        from armada_tpu_torch.models.xfer import TRANSFER_STATS

        kernels.LAUNCHES.update(self.saved)
        for k, v in self.xfer.items():
            setattr(TRANSFER_STATS, k, v)
        return False


def problems_equal(a, b, what: str) -> float:
    """Every field of two SchedulingProblems equal (dtype, shape, values);
    raises on any difference, so the max |difference| returned is 0.0."""
    import torch

    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        y = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: field {name} differs")
    return 0.0


class PlainTwin:
    """Runs one apply (or content prefetch) of a DeviceDeltaCache a second
    time through K-H's plain version, on the same previous problem, and
    keeps the padded inputs for timing replays."""

    def __init__(self, cache):
        from armada_tpu_torch.models.slab import apply_delta_plain

        self.args = None

        def recording(*a, **kw):
            self.args = (a, kw)
            return apply_delta_plain(*a, **kw)

        self.twin = cache.fork(recording)


class CheckedPrefetch:
    """The devcache the builder's prefetch_content sees: forwards the content
    scatter to the cache (kernel K-H) and keeps what check() needs to run it
    again through the plain version once the round is done -- a comparison
    inside the round's shadow would make the host wait for the round."""

    def __init__(self, cache):
        self.cache = cache
        self.twin = None
        self.kw = None
        self.ok = False
        self.seconds = 0.0  # host time of the kernel's scatter_content

    def scatter_content(self, **kw):
        t0 = time.perf_counter()
        self.twin = PlainTwin(self.cache)  # the state before the scatter
        self.ok = self.cache.scatter_content(**kw)
        self.kw = kw
        self.seconds = time.perf_counter() - t0
        return self.ok

    def check(self) -> bool:
        """Run the same prefetch through the plain version and hold the two
        resident problems equal; call before the builder changes again."""
        if self.kw is None:
            return False
        with uncounted():
            ok_plain = self.twin.twin.scatter_content(**self.kw)
            if self.ok != ok_plain:
                raise AssertionError("prefetch: kernel and plain caches disagree on the guard")
            if self.ok:
                problems_equal(self.cache.resident, self.twin.twin.resident,
                               "K-H prefetch vs plain")
        return self.ok


def slab_bytes(args) -> int:
    """K-H's bound in bytes: each real dirty row read from the bundle and
    written once (sentinel padding excluded), the index vectors, and for a
    splice the [G] order vector read and written plus its three vectors."""
    import torch

    (prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args), kw = args
    G, RJ = int(prev.g_req.shape[0]), int(prev.run_req.shape[0])
    kg = int((sg_idx != G).sum())
    kr = int((rr_idx != RJ).sum())
    total = 4 * (kg + kr)
    for cols, k in ((sg_cols, kg), (rr_cols, kr), (ev_cols, kr)):
        for t in cols.values():
            total += 2 * k * int(t[0].numel() * t.element_size())
    total += 2 * tensor_bytes(*fulls.values()) if fulls else 0
    if kw["splice"]:
        total += 2 * 4 * G + 3 * 4 * int((gq_args[0] != G).sum() + (gq_args[1] != G).sum())
    return total


def verify_sum_bound(dp, result) -> dict:
    """The exactness premise of K-I's f32 atomics: every term integral and
    every per-node and per-queue sum below 2^24 (computed in f64)."""
    import torch

    f64 = torch.float64
    holds = dp.run_valid & (~result.run_evicted | result.run_rescheduled)
    placed = result.g_state == 1
    terms = [dp.run_req[holds], dp.g_req[placed]]
    integral = all(bool((t == t.floor()).all()) for t in terms)
    N, R = dp.node_total.shape
    used = torch.zeros((N, R), dtype=f64, device=dp.g_req.device)
    used.index_add_(0, dp.run_node[holds].long(), dp.run_req[holds].to(f64))
    Q = result.q_alloc.shape[0]
    expq = torch.zeros((Q, R), dtype=f64, device=dp.g_req.device)
    expq.index_add_(0, dp.run_queue[holds].long(), dp.run_req[holds].to(f64))
    node_used = dp.node_total.to(f64) - result.alloc[0].to(f64)
    out = dict(integral=integral, max_node_sum=float(max(used.max(), node_used.max())),
               max_queue_sum=float(max(expq.max(), result.q_alloc.double().max())))
    out["below_2_24"] = max(out["max_node_sum"], out["max_queue_sum"]) < 2 ** 24
    return out


def incremental_path(dev, world, main_outcome) -> dict:
    """The steady-state incremental cycle over the main path's world:
    IncrementalBuilder -> assemble_delta -> DeviceDeltaCache.apply (K-H) ->
    run_round_on_device (K-B, K-C, K-I every round, K-J on explain rounds)
    -> decisions applied back; with the prefetch of the next submits in the
    round's shadow.  Every check raises on failure."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels.explain import explain_round
    from armada_tpu_torch.kernels.round import schedule_round as round_kernel
    from armada_tpu_torch.kernels.slab import apply_delta
    from armada_tpu_torch.kernels.verify import verify_round
    from armada_tpu_torch.models import begin_decode, run_round_on_device
    from armada_tpu_torch.models import explain as X
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import (
        resolve_round_statics, schedule_round_plain,
    )
    from armada_tpu_torch.models.incremental import IncrementalBuilder
    from armada_tpu_torch.models.slab import DeviceDeltaCache, apply_delta_plain
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    from armada_tpu_torch.core.types import RunningJob

    config, nodes, queues, specs, running, spec_factory = world["world"]
    t0 = time.perf_counter()
    builder = IncrementalBuilder(config, "default", queues)
    builder.set_nodes(nodes)
    builder.submit_many(specs)
    builder.lease_many(running)
    load_s = time.perf_counter() - t0
    log(f"incremental path: builder loaded in {load_s:.1f} s ({len(specs)} specs, "
        f"{len(running)} runs)")
    spec_of = {sp.id: sp for sp in specs}
    cache = DeviceDeltaCache(device=dev)
    V.reset_verify_state()
    vtok = V.arm_default(True)
    etok = X.arm_default(EXPLAIN_INTERVAL)
    X.reset_cadence()
    cycles = []
    prev_fulls: dict = {}
    checks = dict(kh_scatter=0, kh_splice=0, kh_prefetch=0, ki_equal=0, kj_equal=0)
    replay = {}
    try:
        kernels.reset_launches()
        for c in range(1 + STEADY_CYCLES):
            t_now = 100.0 + 100.0 * c
            TRANSFER_STATS.reset()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            bundle, ctx = builder.assemble_delta()
            asm_s = time.perf_counter() - t0
            with uncounted():
                truth = bundle.materialize()  # before any further builder mutation
            plain = PlainTwin(cache) if cache.resident is not None else None
            before = cache.fork() if cache.resident is not None else None
            pdp = None
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            dp = cache.apply(bundle)
            ev[1].record()
            torch.cuda.synchronize(dev)
            apply_ms = ev[0].elapsed_time(ev[1])
            rows = int(bundle.sg_idx.shape[0] + bundle.rr_idx.shape[0])
            # whole fields whose host object changed since the last bundle
            # (the cache re-sends exactly those), with their bytes
            resent = {n: int(np.asarray(a).nbytes) for n, a in bundle.fulls.items()
                      if prev_fulls.get(n) is not a}
            prev_fulls = dict(bundle.fulls)
            with uncounted():
                problems_equal(dp, truth, f"cycle {c}: resident vs materialize()")
                if cache.last_apply == "scatter":
                    pdp = plain.twin.apply(bundle)
                    problems_equal(dp, pdp, f"cycle {c}: K-H vs plain")
                    checks["kh_scatter"] += 1
                    checks["kh_splice"] += bundle.gq_splice is not None
                    replay["slab"] = plain.args
                    # the same cycle with the order vector shipped whole (no splice)
                    whole = dataclasses.replace(
                        bundle, gq_splice=None, fulls={**bundle.fulls, "gq_gang": truth.gq_gang})
                    k2 = before.fork().apply(whole)
                    p2 = PlainTwin(before).twin.apply(whole)
                    problems_equal(k2, p2, f"cycle {c}: K-H (whole gq) vs plain")
                    problems_equal(k2, truth, f"cycle {c}: K-H (whole gq) vs materialize()")
                    checks["kh_whole"] = checks.get("kh_whole", 0) + 1
            prefetch = CheckedPrefetch(cache)
            sh: dict = {}

            def shadow(c=c, t_now=t_now, prefetch=prefetch, sh=sh):
                # ev[2] completes when the round, K-C, K-I and K-J that the
                # dispatch enqueued have run; the host times below say
                # whether this work finished while they still ran
                ev[2].record()
                t_s = time.perf_counter()
                fresh = spec_factory(BURST, t_now)
                for sp in fresh:
                    spec_of[sp.id] = sp
                t_f = time.perf_counter()
                builder.submit_many(fresh)
                t_p = time.perf_counter()
                prefetch.rows = builder.prefetch_content(prefetch)
                t_e = time.perf_counter()
                sh.update(dispatch_s=t_s - t1, specs_s=t_f - t_s, submit_s=t_p - t_f,
                          prefetch_s=t_e - t_p, end_s=t_e - t1,
                          round_busy_at_end=not ev[2].query())

            t1 = time.perf_counter()
            ev[3].record()
            result, outcome = run_round_on_device(
                bundle.stats_view(), ctx, config, device=dev, device_problem=dp,
                shadow_work=(shadow,),
            )
            torch.cuda.synchronize(dev)
            round_s = time.perf_counter() - t1
            # the device time of the dispatched work, from the round's start
            # (the stream is idle at ev[3]) to the shadow's start
            sh["dispatched_device_ms"] = ev[3].elapsed_time(ev[2])
            if prefetch.check():
                checks["kh_prefetch"] += 1
            t2 = time.perf_counter()
            builder.remove_many(outcome.scheduled.keys())
            leases = [RunningJob(job=spec_of.pop(j), node_id=n)
                      for j, n in outcome.scheduled.items() if j in spec_of]
            builder.lease_many(leases)
            for jid in outcome.preempted:
                builder.unlease(jid)
            back_s = time.perf_counter() - t2
            kw = dict(num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                      slot_width=ctx.slot_width, max_iterations=0)
            with uncounted():
                kw["max_iterations"] = resolve_round_statics(dp)
                fin = begin_decode(result, ctx)
                fin.fetch()  # re-stashes this result's compact bytes for the verdict
                t3 = time.perf_counter()
                fin()  # the host decode alone, from the fetched buffer
                decode_s = time.perf_counter() - t3
                compact = fin.dispatched[0]
                vin = V.verify_inputs(dp, result, compact, ctx.num_real_gangs)
                ver_ms, vk = cuda_ms(lambda: verify_round(*vin), reps=3)
                vp = V.verify_kernel_plain(*vin)
                max_err(vk, vp)
                rnd_ms, _ = cuda_ms(lambda: round_kernel(dp, **kw), reps=1)
                V.verdict_of(vk.cpu().numpy(), ctx)
                checks["ki_equal"] += 1
                bound = verify_sum_bound(dp, result)
                if not (bound["integral"] and bound["below_2_24"]):
                    raise AssertionError(f"cycle {c}: K-I's exactness premise fails: {bound}")
            if c == 0:
                # check 1: the warm cycle decides what the main path decided
                m = main_outcome
                if (outcome.scheduled != m.scheduled
                        or sorted(outcome.preempted) != sorted(m.preempted)
                        or sorted(outcome.rescheduled) != sorted(m.rescheduled)
                        or sorted(outcome.failed) != sorted(m.failed)):
                    raise AssertionError("warm incremental cycle differs from the main path")
                if outcome.explain is None:
                    raise AssertionError("the warm cycle was not an explain round")
            cyc = dict(cycle=c, apply=cache.last_apply, splice=bundle.gq_splice is not None,
                       assemble_delta_s=asm_s, apply_ms=apply_ms, round_ms=rnd_ms,
                       verify_ms=ver_ms, round_wall_s=round_s, decode_s=decode_s,
                       shadow=sh, prefetch_scatter_s=prefetch.seconds,
                       apply_back_s=back_s, rows_scattered=rows,
                       prefetched_rows=int(getattr(prefetch, "rows", 0) or 0),
                       scheduled=len(outcome.scheduled), preempted=len(outcome.preempted),
                       failed=len(outcome.failed), explained=outcome.explain is not None,
                       verify_sum_bound=bound, transfers=TRANSFER_STATS.snapshot(),
                       fulls_resent=resent,
                       splice_len=[int(v.shape[0]) for v in bundle.gq_splice[:2]]
                       if bundle.gq_splice is not None else None)
            cycles.append(cyc)
            last = dict(dp=dp, pdp=pdp, result=result, ctx=ctx, kw=kw, vin=vin,
                        outcome=outcome)
            log(f"incremental cycle {c}: {cache.last_apply} apply ({rows} rows, splice "
                f"{bundle.gq_splice is not None}), assemble_delta {asm_s:.3f} s, apply "
                f"{apply_ms:.3f} ms, round {rnd_ms:.2f} ms, verify {ver_ms:.4f} ms, "
                f"run_round_on_device {round_s:.3f} s (of it the decode {decode_s:.3f} s), "
                f"apply-back {back_s:.3f} s; scheduled {len(outcome.scheduled)} preempted "
                f"{len(outcome.preempted)} failed {len(outcome.failed)} explain "
                f"{outcome.explain is not None}")
            log(f"incremental cycle {c} shadow: dispatched device work "
                f"{sh['dispatched_device_ms']:.2f} ms; host: dispatch {sh['dispatch_s']:.4f} s, "
                f"then specs {sh['specs_s']:.4f} s, submit {sh['submit_s']:.4f} s, prefetch "
                f"{sh['prefetch_s']:.4f} s (K-H scatter_content {prefetch.seconds:.4f} s), "
                f"shadow ends {sh['end_s']:.4f} s after the dispatch began; round still "
                f"running then: {sh['round_busy_at_end']}")
        launches = dict(kernels.LAUNCHES)
        log(f"incremental path launches: {launches}")
        for k in ("round", "compact", "slab", "verify", "explain"):
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the incremental path")
        if (checks["kh_scatter"] < STEADY_CYCLES or checks["kh_prefetch"] == 0
                or checks["kh_splice"] == 0 or checks.get("kh_whole", 0) == 0):
            raise AssertionError(f"K-H forms not all exercised: {checks}")
        if V.verify_state().failures or V.verify_state().rounds < 1 + STEADY_CYCLES:
            raise AssertionError(f"verification: {V.verify_state().snapshot()}")

        with uncounted():
            dp, result, ctx, kw = last["dp"], last["result"], last["ctx"], last["kw"]
            # check 4b: a corrupted result is refused
            bad_counts = result.slot_counts.clone()
            bad_counts[0, 0] += 1
            bad = result._replace(slot_counts=bad_counts)
            fin = begin_decode(bad, ctx)
            vd = V.dispatch_verify(dp, bad, fin.dispatched, ctx)
            fin.fetch()
            try:
                V.finish_verify(vd, ctx)
                raise AssertionError("a corrupted round passed verification")
            except V.RoundVerificationError as e:
                refused = list(e.sites)
            log(f"incremental path: corrupted round refused ({refused})")

            # check 5: K-J on the last cycle's state, kernel vs plain
            xin = X.explain_inputs(dp, result, ctx.num_real_gangs)
            K = int(dp.compat.shape[0])
            G = int(result.g_state.shape[0])
            kcap, fcap = min(K, X._EXPLAIN_KCAP), min(G, X._EXPLAIN_FCAP)
            kj_ms, kj = cuda_ms(lambda: explain_round(*xin, kcap=kcap, fcap=fcap), reps=5)
            kj_plain_ms, kj_plain = cuda_ms(
                lambda: X.explain_kernel_plain(*xin, kcap=kcap, fcap=fcap), reps=1)
            err_kj = max_err(kj, kj_plain)
            checks["kj_equal"] += 1

            # check 6: the last steady cycle again, through the plain versions
            # of K-H, K-B and K-I on the card: the same decisions
            pdp = last["pdp"]  # the last steady cycle's problem, applied by plain K-H
            t0 = time.perf_counter()
            pres = schedule_round_plain(pdp, **kw)
            torch.cuda.synchronize(dev)
            plain_round_s = time.perf_counter() - t0
            pfin = begin_decode(pres, ctx)
            pfin.fetch()
            pbuf = V.verify_kernel_plain(*V.verify_inputs(pdp, pres, pfin.dispatched[0],
                                                          ctx.num_real_gangs))
            V.verdict_of(pbuf.cpu().numpy(), ctx)
            pout = pfin()
            o = last["outcome"]
            if (pout.scheduled != o.scheduled or sorted(pout.preempted) != sorted(o.preempted)
                    or sorted(pout.failed) != sorted(o.failed)):
                raise AssertionError("the plain versions decide the last cycle differently")
            log(f"incremental path: last cycle through the plain K-B/K-I on the card "
                f"({plain_round_s:.2f} s): same decisions")

            # timings at the path's shapes
            a, akw = replay["slab"]
            kh_ms, kh = cuda_ms(lambda: apply_delta(*a, **akw), reps=10)
            kh_plain_ms, kh_plain = cuda_ms(lambda: apply_delta_plain(*a, **akw), reps=3)
            err_kh = problems_equal(kh, kh_plain, "K-H replay vs plain")
            ki_ms, ki = cuda_ms(lambda: verify_round(*last["vin"]), reps=10)
            ki_plain_ms, ki_p = cuda_ms(lambda: V.verify_kernel_plain(*last["vin"]), reps=3)
            err_ki = max_err(ki, ki_p)
    finally:
        V.disarm_default(vtok)
        X.disarm_default(etok)

    N, R = (int(x) for x in dp.node_total.shape)
    Q = int(result.q_alloc.shape[0])
    T = int(dp.compat_pre_type.shape[1])
    kh_b = bound_ms(slab_bytes(replay["slab"]), 0)
    ki_b = bound_ms(tensor_bytes(*[t for t in last["vin"][:-1]]) + 64, 0)
    kj_len = int(kj.numel())
    kj_bytes = tensor_bytes(dp.compat, dp.compat_pre_type, dp.node_type, dp.node_ok,
                            dp.node_total, dp.node_axes, dp.g_req, dp.g_card, dp.g_queue,
                            dp.g_key, dp.g_run, dp.g_valid, dp.g_absent, result.g_state,
                            result.alloc[0], result.q_killed) + 4 * kj_len
    kj_b = bound_ms(kj_bytes, 3 * K * N * R)
    rows = []
    for name, ms, pms, err, (bms, by) in (("slab", kh_ms, kh_plain_ms, err_kh, kh_b),
                                          ("verify", ki_ms, ki_plain_ms, err_ki, ki_b),
                                          ("explain", kj_ms, kj_plain_ms, err_kj, kj_b)):
        src, rep = SOURCES[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=err, equal=err == 0.0, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=None,
        ))
    log(f"incremental path kernels: K-H {kh_ms:.4f} ms (plain {kh_plain_ms:.2f}), "
        f"K-I {ki_ms:.4f} ms (plain {ki_plain_ms:.2f}), K-J {kj_ms:.4f} ms "
        f"(plain {kj_plain_ms:.1f}); N={N} G={G} Q={Q} K={K} T={T}")
    return dict(rows=rows, launches=launches, cycles=cycles, checks=checks,
                load_s=load_s, refused=refused, N=N, G=G, Q=Q, K=K, T=T,
                plain_round_s=plain_round_s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from armada_tpu_torch.kernels import build as kbuild
    from armada_tpu_torch.models.synthetic import synthetic_problem, synthetic_world

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

    # the incremental path on a small world first: every check, in seconds
    from armada_tpu_torch.models import run_scheduling_round

    small = synthetic_world(**SMALL_WORLD)
    sc, sn, sq, ss, sr, _ = small
    small_out = run_scheduling_round(sc, pool="default", nodes=sn, queues=sq, queued_jobs=ss,
                                     running=sr, device=dev)
    report["incremental_small"] = incremental_path(dev, dict(world=small), small_out)

    t0 = time.perf_counter()
    world = dict(world=synthetic_world(**MAIN_WORLD))
    world["seconds"] = time.perf_counter() - t0
    log(f"main path: world built in {world['seconds']:.1f} s")
    mp_report = main_path(dev, world)
    main_outcome = mp_report.pop("outcome")
    report.update(mp_report)
    inc = incremental_path(dev, world, main_outcome)
    report["incremental"] = inc
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": mp_report["rows"] + inc["rows"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
