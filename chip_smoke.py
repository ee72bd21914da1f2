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
cycle's own state and on adversarial cases at the path's widths (K-H: a
slot two groups write, unsorted and negative indices, all-sentinel groups,
splices with no inserts or no removals; K-J: every node of one type, an
empty type, T = 1, node types outside [0, T); K-I, solo and stacked:
slots' gangs repeated, negative or past G or past the real-gang count,
n_slots outside [0, S], NaN and +-inf in alloc0 and q_alloc, no runs, an
empty and an odd compact buffer, and a corruption aimed at each invariant
and at the fingerprint); K-H is timed without the
splice in turns with index_put per field, each of K-H, K-J and K-I split
into host ms, device operations and device ms by kernel (`call_split`), and
K-J's per-type chain floor measured.  A small world runs that path first,
to fail fast.  `python3 chip_smoke.py --split` runs only that split, on
the main world's steady apply, explain pass and verification, and the
stacked K-I on seven lanes at the pools path's widths (`split_main`); with
K-A at the main path's Q = 8,192 and 8,193 and on 7 lanes of 64 (and its
chain floor), K-C on the steady cycle's round result and K-F on the seven
lanes.  Before any path, K-A, K-C and K-F are held against their plain
versions on their adversarial cases (`fair_shares_adversarial`,
`compact_adversarial`), and the main and pools paths split them beside
their rows.
Then the pools path: the same world split over 8 pools and driven through
FairSchedulingAlgo.schedule over a JobDb and an IncrementalProblemFeed, a
fill and three steady cycles with ARMADA_POOL_PARALLEL=1 (the seven
shape-matched pools stacked into one launch: K-E, K-D, K-F, the stacked
K-I, K-G) and =0, which must decide the same; its kernels are held against
their plain versions on small windows of lanes (and K-E and K-G on an
adversarial table) before the main path, and on a steady cycle's own
state, where K-E and K-G are also timed in turns with torch.stack and
t[i].clone() per field, and every K-E and K-G call inside the cycles is
timed.  Right after the main path, the loop-shapes
path: the main problem again through run_round_on_device with
ARMADA_COMMIT_K=8 (the multi-commit extension, K10), which must decide as
the K=1 round did, and with prefer-large ordering; a 1M-gang problem with
node-type bias; run_scheduling_round with node-type scores and both arms of
the pools serving loop at K=1 and 8 on small worlds; and K11, the main
problem with the per-key fit cache (ARMADA_CACHE_SLOTS=64) and the pick
chain (ARMADA_BATCH_K=8), each deciding as the uncached round, timed beside
it.  Those branches are held against their plain versions on small
problems, solo and stacked, before the main path.  Last, the simulator
path: Simulator.run on the card, a small world with gangs and preemption
through the kernels and through the plain versions, and a two-pool world
of 10,000 nodes and 100,000 jobs uncached and cached, whose traces must be
equal.  The mesh path (the node-axis mesh on one card): K-K, the round
whose placement loop runs as a thread-block cluster over 2, 4, 8 and 16
node shards, on the main problem equal to K-B and timed beside it, on a
tie-heavy world and every loop shape against the plain version; the steady
cycle through MeshDeviceDeltaCache at 8 shards beside the single-card
cycle, decision for decision (K-H under the mesh cache, the counterpart of
K-L); and the main world at commit_k and batch_k 32 (the wide
instantiations) and the round's water-fill at Q that are not multiples of
32.  The market path, after the pools path: bench.py's market deployment
(1M jobs x 50k nodes x 64 queues, seed 7, 8 price bands, the pool market
driven with spot_price_cutoff 0.9) loaded through a JobDb with an
IncrementalProblemFeed and served by FairSchedulingAlgo with a
StaticBidPriceProvider, two priced gang shapes, the optimiser and priority
overrides on 8 queues, verification on: a fill and three steady cycles of
1,000 specs, four queues' bids moving before the second; the rounds of
the first steady cycle and of the moved cycle equal their plain versions
on the same device problem in every field, every steady cycle's resident
problem equals the host tables (the scatter after the move included), and
each cycle prints its wall,
K-B's ms, the pricer's, the idealised sweep's, the realised values' and
the optimiser's ms, the indicative prices, the spot price and the
optimiser's placements.  Its small worlds run early (`market_small`):
KB_MARKET's world through the legacy route (the idealised mega-node round
on the card) and the columnar one, a two-pool world with priority
overrides and the optimiser's world, each through FairSchedulingAlgo on
the card and with device="cpu", which must agree.

Output: progress lines, then a `{"kernels": [...]}` JSON line, the card's
name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", ...}}`.  Details go to
chiprun_out/chip_smoke.json.  Any failed phase exits non-zero with the error.
Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import types

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
    "round_stacked": ("armada_tpu_torch/csrc/round.cu",
                      "armada_tpu/models/fair_scheduler.py:1788"),
    "stack": ("armada_tpu_torch/csrc/lanes.cu", "armada_tpu/models/__init__.py:658"),
    "compact_stacked": ("armada_tpu_torch/csrc/compact.cu", "armada_tpu/models/problem.py:1501"),
    "lane_slice": ("armada_tpu_torch/csrc/lanes.cu", "armada_tpu/models/problem.py:1596"),
    "verify_stacked": ("armada_tpu_torch/csrc/verify.cu", "armada_tpu/models/verify.py:496"),
    "round_multi_commit": ("armada_tpu_torch/csrc/round.cu",
                           "armada_tpu/models/fair_scheduler.py:773"),
    "round_fit_cache": ("armada_tpu_torch/csrc/round.cu",
                        "armada_tpu/models/fair_scheduler.py:515"),
    "round_batch_k": ("armada_tpu_torch/csrc/round.cu",
                      "armada_tpu/models/fair_scheduler.py:1081"),
    "round_sharded": ("armada_tpu_torch/csrc/round_cluster.cu",
                      "armada_tpu/parallel/mesh.py:253"),
    "slab_sharded": ("armada_tpu_torch/csrc/slab.cu", "armada_tpu/parallel/mesh_slab.py:49"),
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


def cuda_ms_quiet(fn, reps: int = 3) -> tuple[float, object]:
    """`cuda_ms` with the collector off: a pass over a large world's host
    objects (the 1M-job builder's) can outlast a call whose own host and
    device work is ~0.1 ms, and it is the process's cost, not the call's."""
    gc.disable()
    try:
        return cuda_ms(fn, reps)
    finally:
        gc.enable()


def round_profile(fn, attempts: int = 3, calls: int = 1) -> list:
    """[(kernel name, launches a call, device ms a call)] of `calls` calls of
    fn in one session, largest first, from torch.profiler's CUDA activity.
    A session that recorded no device time is run again (seen on the card:
    CUPTI delivered no activity records for a short session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((e.key, e.count / calls, us / 1e3 / calls))
        if rows:
            return sorted(rows, key=lambda r: -r[2])
    raise AssertionError("torch.profiler recorded no device time for the round")


# The sections of a placement-loop step in the profile build (csrc/round.cuh
# ROUND_STEP_PROFILE, enum PS_*), then the counters after them.
STEP_SECTIONS = ("window", "keys", "pick", "gate", "node", "cluster", "commit", "after", "end")
ROUND_SOURCES = ("round.cu", "round_wide.cu", "round_cluster.cu")


_PROFILE_BUILD: dict = {}


def start_profile_build() -> None:
    """Build the profile library (round_profile_library) on a thread, beside
    the shipped build; round_profile_library waits for it."""
    import threading

    def run():
        try:
            _profile_build()
        except Exception as e:  # re-raised where the library is asked for
            _PROFILE_BUILD["error"] = e

    _PROFILE_BUILD["thread"] = threading.Thread(target=run, daemon=True)
    _PROFILE_BUILD["thread"].start()


def _profile_build():
    from armada_tpu_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / f"libround-profile-{kbuild._digest()}.so"
    if not out.exists():
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in ROUND_SOURCES:
            obj = kbuild.BUILD_DIR / f"profile-{src}.o"
            procs.append((obj, subprocess.Popen(
                [kbuild._nvcc(), *kbuild.FLAGS, "-DROUND_STEP_PROFILE", "-c",
                 str(kbuild.SRC_DIR / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for obj, proc in procs:
            o, e = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc of the profile build failed:\n{o}{e}")
        done = subprocess.run(
            [kbuild._nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
             str(out), *[str(o) for o, _ in procs]], capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"link of the profile build failed:\n{done.stdout}{done.stderr}")
    return out


def round_profile_library():
    """round.cu, round_wide.cu and round_cluster.cu built with
    -DROUND_STEP_PROFILE into a library of their own (one nvcc a source, all
    started together), loaded with ctypes and bound as kernels/build.py binds
    the shipped one."""
    import ctypes

    if "lib" in _PROFILE_BUILD:
        return _PROFILE_BUILD["lib"]
    if "thread" in _PROFILE_BUILD:
        _PROFILE_BUILD["thread"].join()
        if "error" in _PROFILE_BUILD:
            raise _PROFILE_BUILD["error"]
    lib = ctypes.CDLL(str(_profile_build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, args in (("armada_round_prologue", [vp, vp]),
                       ("armada_round_main", [vp, vp, vp, ci, vp]),
                       ("armada_round_sharded_main", [vp, ci, vp, vp, ci, vp]),
                       ("armada_round_cluster_max", [vp, ci]),
                       ("armada_round_args_size", []),
                       ("armada_round_step_profile", [vp, ci]),
                       ("armada_round_step_profile_slots", [])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ci
    lib.armada_round_wide_need.argtypes = [ci, ci, vp]
    lib.armada_round_wide_need.restype = None
    _PROFILE_BUILD["lib"] = lib
    return lib


def step_profile(dp, kw: dict, shards: int) -> dict:
    """One solo round of `dp` through the profile build at `shards` CTAs
    (1: the single-CTA form): us a step per section of lane 0's rank-0 CTA
    (clock64 cycles scaled by the loop's globaltimer nanoseconds), barriers
    a step, steps and the loop's device ms."""
    import ctypes

    import torch

    from armada_tpu_torch.kernels import round as KR

    lib = round_profile_library()
    saved = KR.library
    KR.library = lambda: lib
    try:
        with uncounted():
            KR._launch(dp, 0, shards=shards, **kw)
            torch.cuda.synchronize()
        n = lib.armada_round_step_profile_slots()
        vals = (ctypes.c_longlong * n)()
        rc = lib.armada_round_step_profile(vals, 1 if shards > 1 else 0)
        if rc:
            raise RuntimeError(f"reading the step profile failed (cudaError_t {rc})")
    finally:
        KR.library = saved
    vals = list(vals)
    k = len(STEP_SECTIONS)
    steps, barriers, loop_ns, loop_cyc = vals[k:k + 4]
    scale = loop_ns / max(loop_cyc, 1) / 1e3 / max(steps, 1)
    us = {name: vals[i] * scale for i, name in enumerate(STEP_SECTIONS)}
    return dict(shards=shards, steps=steps, barriers_per_step=barriers / max(steps, 1),
                loop_ms=loop_ns / 1e6, us_per_step=us, us_step_total=sum(us.values()))


def log_step_profile(what: str, prof: dict) -> None:
    log(f"step profile [{what}, S={prof['shards']}]: {prof['steps']} steps, loop "
        f"{prof['loop_ms']:.2f} ms, {prof['us_step_total']:.2f} us a step, "
        f"{prof['barriers_per_step']:.1f} barriers a step; us a step: " + ", ".join(
            f"{k} {v:.2f}" for k, v in prof["us_per_step"].items()))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tensor_bytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def max_err(a, b) -> float:
    """Max |a - b| between a kernel's and its plain version's outputs (two
    RoundResults, every field, kernel_iters included, or two tensors).  The
    kernels are held to exact equality, so any difference raises and the
    value returned is 0.0."""
    import torch

    if isinstance(a, torch.Tensor):
        pairs = [("tensor", a, b)]
    else:
        pairs = [(f, getattr(a, f), getattr(b, f)) for f in a._fields]
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


def check_compact(dev) -> None:
    import torch

    from armada_tpu_torch.kernels.compact import compact_result
    from armada_tpu_torch.models.fair_scheduler import RoundResult, compact_result_plain
    from armada_tpu_torch.models.synthetic import compact_arrays

    G, RJ = 1_048_576, 32_768
    r = RoundResult(**{f: torch.as_tensor(v, device=dev)
                       for f, v in compact_arrays(G, RJ, 1000, 8).items()})
    for real_g, real_r, fcap, ecap in ((G - 1000, RJ - 100, 8192, 8192), (G, RJ, G, RJ)):
        k = compact_result(r, real_g, real_r, fcap=fcap, ecap=ecap)
        p = compact_result_plain(r, real_g, real_r, fcap=fcap, ecap=ecap)
        torch.cuda.synchronize()
        max_err(k, p)
    log(f"K-C compact G={G} RJ={RJ}: kernel == plain (capped and uncapped lists)")


def fair_shares_adversarial(dev) -> dict:
    """K-A on its adversarial cases (models/synthetic.py
    adversarial_fair_share_cases: every Q of WATERFILL_ADVERSARIAL_Q, all
    weights zero, every queue achieved in the first iteration, max_iterations
    reached, an unallocated share that overflows, a NaN weight, 1 and 7
    lanes), kernel against plain version bit for bit on the card, and each
    case's loop as its name says (the plain version's iteration count and
    achieved queues)."""
    import torch

    from armada_tpu_torch.kernels.fair_shares import (
        fair_shares, fair_shares_lanes_plain, form_of,
    )
    from armada_tpu_torch.models.synthetic import adversarial_fair_share_cases
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    out = {}
    for name, w, c, mi, expect in adversarial_fair_share_cases():
        wt, ct = torch.as_tensor(w, device=dev), torch.as_tensor(c, device=dev)
        k = fair_shares(wt, ct, max_iterations=mi)
        if wt.dim() == 2:
            p = fair_shares_lanes_plain(wt, ct, mi)
            stats = {}
        else:
            stats = {}
            p = fair_shares_plain(wt, ct, mi, stats=stats)
        torch.cuda.synchronize()
        for x, y in zip(k, p):
            # every bit of every number; a NaN against a NaN (its payload is
            # the arithmetic unit's, not the algorithm's)
            nan = torch.isnan(x)
            if not (torch.equal(nan, torch.isnan(y))
                    and torch.equal(x.view(torch.int32)[~nan], y.view(torch.int32)[~nan])):
                raise AssertionError(f"K-A [{name}]: kernel and plain differ")
        if "iterations" in expect and stats["iterations"] != expect["iterations"]:
            raise AssertionError(f"K-A [{name}]: {stats['iterations']} iterations, expected "
                                 f"{expect['iterations']}")
        if expect.get("first_all") and stats["achieved"][0] != int((wt > 0).sum()):
            raise AssertionError(f"K-A [{name}]: {stats['achieved'][0]} queues achieved in the "
                                 "first iteration, not every weighted one")
        out[name] = dict(form=form_of(int(wt.shape[-1])), iterations=stats.get("iterations"))
    log(f"K-A fair_shares adversarial: {len(out)} cases, kernel == plain bit for bit (a NaN "
        f"against a NaN) "
        f"(forms {sorted({v['form'] for v in out.values()})})")
    return out


def compact_adversarial(dev) -> dict:
    """K-C and K-F on their adversarial cases (models/synthetic.py
    adversarial_compact_cases: failed gangs at the cap, one past it and
    none; real counts of 0 and of the whole axis; every flag set; no runs;
    lanes with different real counts), at widths that are not multiples of
    a tile (solo, and 7 lanes at the pools path's widths) and at the main
    path's (a multiple), word for word against the plain versions."""
    import torch

    from armada_tpu_torch.kernels.compact import (
        compact_result, compact_result_stacked, compact_result_stacked_plain,
    )
    from armada_tpu_torch.models.fair_scheduler import RoundResult, compact_result_plain
    from armada_tpu_torch.models.problem import COMPACT_FCAP
    from armada_tpu_torch.models.synthetic import adversarial_compact_cases

    out = {}
    for G, RJ, S, W, P in ((1_000_003, 40_961, 1_000, 8, 0), (901_120, 32_768, 1_000, 1, 0),
                           (155_651, 8_195, 125, 4, 7)):
        for name, arrs, rg, rr, fcap, ecap in adversarial_compact_cases(G, RJ, S, W,
                                                                        cap=COMPACT_FCAP,
                                                                        lanes=P):
            r = RoundResult(**{f: torch.as_tensor(v, device=dev) for f, v in arrs.items()})
            if P:
                k = compact_result_stacked(r, rg, rr, fcap=fcap, ecap=ecap)
                p = compact_result_stacked_plain(r, rg, rr, fcap=fcap, ecap=ecap)
            else:
                k = compact_result(r, rg, rr, fcap=fcap, ecap=ecap)
                p = compact_result_plain(r, rg, rr, fcap=fcap, ecap=ecap)
            torch.cuda.synchronize()
            max_err(k, p)
            out[f"{name} G={G} RJ={r.run_evicted.shape[-1]} P={P}"] = p[..., 5:8].tolist()
    log(f"K-C/K-F compact adversarial: {len(out)} cases, kernel == plain word for word")
    return out


def round_forms(p, kw: dict, lanes: int = 0):
    """(S, the round at S, the round at S = 1) for a solo (`lanes` 0) or
    stacked round of `p` at the resolved statics `kw`: S is the cluster
    size kernels/round.py's owner picks (choose_cluster_size), S = 1 the
    single-CTA form, both through the wrapper's launch sequence."""
    from armada_tpu_torch.kernels import round as KR

    S = KR._owner_size(p, max(lanes, 1), kw)
    return (S, lambda: KR._launch(p, lanes, shards=S, **kw),
            lambda: KR._launch(p, lanes, shards=1, **kw))


def forms_in_turns(p, kw: dict, lanes: int = 0, reps: int = 2) -> dict:
    """The owner's cluster size against S = 1 in turns (S = 1, chosen,
    chosen, S = 1; CUDA events, `reps` rounds a turn), the two equal in
    every field; launches uncounted."""
    S, chosen, single = round_forms(p, kw, lanes)
    ms: dict = {"single": [], "chosen": []}
    out = {}
    with uncounted():
        for key, fn in (("single", single), ("chosen", chosen), ("chosen", chosen),
                        ("single", single)):
            t, out[key] = cuda_ms(fn, reps=reps)
            ms[key].append(t)
        max_err(out["chosen"], out["single"])
    return dict(S=S, single_ms=ms["single"], chosen_ms=ms["chosen"],
                single_mean=float(np.mean(ms["single"])), chosen_mean=float(np.mean(ms["chosen"])),
                result=out["chosen"])


def check_round(name: str, problem, meta: dict, dev, **statics) -> dict:
    """Kernel round vs plain round on the card, every field (kernel_iters
    included), at the loop shape `statics` (prefer_large, commit_k) asks
    for: the round at the cluster size its owner picks, and (where that is
    above 1) the single-CTA form too.  `problem` is a numpy problem or one
    on the card."""
    import torch

    from armada_tpu_torch.kernels import round as KR
    from armada_tpu_torch.models.fair_scheduler import round_statics, schedule_round_plain
    from armada_tpu_torch.models.state import problem_from_numpy

    dp = problem if isinstance(problem.g_req, torch.Tensor) else problem_from_numpy(problem, dev)
    kw = dict(meta, **round_statics(dp, **statics))
    k = KR.schedule_round(dp, **kw)
    S = KR.last_cluster_size()
    torch.cuda.synchronize()
    p = schedule_round_plain(dp, **kw)
    torch.cuda.synchronize()
    max_err(k, p)
    if S > 1:
        with uncounted():
            max_err(KR._launch(dp, 0, shards=1, **kw), p)
    info = dict(
        iterations=int(k.iterations), kernel_iters=int(k.kernel_iters),
        scheduled=int(k.scheduled_count),
        evicted=int(k.run_evicted.sum()), rescheduled=int(k.run_rescheduled.sum()),
        termination=int(k.termination), spot_price=float(k.spot_price), cluster=S,
    )
    shape = " ".join(f"{a}={b}" for a, b in statics.items())
    log(f"K-B round [{name}{' ' + shape if shape else ''}]: kernel (S={S}"
        f"{' and S=1' if S > 1 else ''}) == plain {info}")
    return info


def window_problem(seed: int = 0, num_queues: int = 100):
    """A small synthetic problem (models/synthetic.py adversarial_windows)
    whose queue windows stress the placement loop's window walk, with
    `num_queues` live queues: more than a block has half-warps at 100."""
    from armada_tpu_torch.models.synthetic import adversarial_windows, synthetic_problem

    p, meta = synthetic_problem(num_nodes=300, num_gangs=2_000, num_queues=num_queues,
                                num_runs=200, global_burst=1_600, perq_burst=1_600, seed=seed)
    return adversarial_windows(p), meta


def check_windows(dev) -> dict:
    """The adversarial windows (window_problem) at every loop shape, solo at
    the owner's cluster size and at S = 1, and on a 3-lane stack; each
    equal to the plain version in every field."""
    from armada_tpu_torch.models.state import problem_from_numpy

    out = {}
    wp, wmeta = window_problem(0)
    wdp = problem_from_numpy(wp, dev)
    for statics in (dict(), dict(commit_k=LOOP_COMMIT_K), dict(batch_k=8), dict(cache_slots=8),
                    dict(prefer_large=True)):
        out["windows " + str(statics)] = check_round("adversarial windows", wdp, wmeta, dev,
                                                     **statics)
    base = out["windows {}"]
    if base["iterations"] < 100:
        raise AssertionError(f"the window problem ran {base['iterations']} iterations")
    lanes = [problem_from_numpy(window_problem(s, num_queues=40)[0], dev) for s in (1, 2, 3)]
    for statics in (dict(),):
        out["windows stacked " + str(statics)] = _stacked_check("adversarial windows", lanes,
                                                                wmeta, dev, **statics)
    return out


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
    for k in ("fair_shares", "round", "compact", "round_clustered"):
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
    # a second warm-up: the cluster's replicas grow the caching allocator
    # on the first rounds at this shape (cudaMalloc is not the kernels' time);
    # and no collector pass over the 1M-job world's objects inside the timed
    # rounds, whose device work is now shorter than such a pass
    schedule_round(dp, **kw)
    gc.disable()
    try:
        round_ms, result = cuda_ms(lambda: schedule_round(dp, **kw), reps=3)
    finally:
        gc.enable()
    from armada_tpu_torch.kernels.round import last_cluster_size

    cluster = last_cluster_size()
    t0 = time.perf_counter()
    decoded = begin_decode(result, ctx)()
    decode_s = time.perf_counter() - t0
    iters = int(result.iterations)
    log(f"main path stages: build_problem {build_s:.2f} s, upload {upload_s:.3f} s, "
        f"round kernels {round_ms:.2f} ms (the loop as clusters of {cluster} CTAs), decode "
        f"{decode_s:.3f} s; N={N} G={G} Q={Q} RJ={RJ} iterations {iters}")
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
    fa_b = fair_shares_bound(dp.q_weight, dp.q_cds)
    prob_bytes = tensor_bytes(*[getattr(dp, f) for f in dp._fields])
    out_bytes = tensor_bytes(*[getattr(result, f) for f in result._fields])
    live_q = int((dp.q_len > 0).sum())
    per_iter = 2 * N * R * 4 + live_q * 16 * 13
    kb_b = bound_ms(prob_bytes + out_bytes + iters * per_iter, iters * 2 * N * R * 6)
    kc_b = compact_bound(result, kc)
    fa_split = split_bound("K-A split (the main path, Q = 8,192)",
                           lambda: fair_shares(dp.q_weight, dp.q_cds), fa_b)
    fa_chain = fair_shares_chain_floor(dp.q_weight, dp.q_cds)
    kc_split = split_bound("K-C split (the main path)",
                           lambda: compact_result(*args, fcap=fcap, ecap=ecap), kc_b)
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
    rows[1]["cluster_size"] = cluster
    rows[0].update(split_fields(fa_split), chain_floor_ms=fa_chain["chain_floor_ms"],
                   chain=fa_chain)
    rows[2].update(split_fields(kc_split))
    stages = dict(profile=profile_rows, world_s=world_s, entry_s=entry_s, build_problem_s=build_s,
                  upload_s=upload_s, round_ms=round_ms, decode_s=decode_s,
                  plain_round_ms=plain_round_ms, iterations=iters, N=N, G=G, Q=Q, RJ=RJ,
                  live_queues=live_q, indicative_shares=outcome.indicative_shares,
                  scheduled=len(outcome.scheduled), preempted=len(outcome.preempted),
                  failed=len(outcome.failed), termination=outcome.termination)
    state = dict(config=config, problem=problem, ctx=ctx, dp=dp, outcome=outcome)
    return dict(rows=rows, stages=stages, launches=launches, outcome=outcome, state=state)


# --- the loop-shapes path: multi-commit (K10), node-type bias, prefer-large ----

# The multi-commit width armed on this path (ARMADA_COMMIT_K)
LOOP_COMMIT_K = 8
# The bias problem at full width: the soak default share of type-sensitive
# jobs (armada_tpu/loadgen/soak.py:91), gangs up to 8
HETERO_PROBLEM = dict(num_nodes=50_000, num_gangs=1_000_000, num_queues=64, num_runs=25_000,
                      num_node_types=8, type_sensitive_frac=0.3, max_gang_cardinality=8, seed=0)
# small problems the new branches are held on first, before the main path
LOOP_BURST = dict(num_nodes=2_000, num_gangs=20_000, num_queues=64, num_runs=0,
                  global_burst=1_000, perq_burst=1_000, max_gang_cardinality=1, seed=3)
LOOP_HETERO = dict(num_nodes=2_000, num_gangs=20_000, num_queues=32, num_runs=500,
                   num_node_types=8, type_sensitive_frac=0.3, max_gang_cardinality=4, seed=1)
# four queues: long same-queue chains that reach the end of the cursor window
LOOP_FEWQ = dict(num_nodes=500, num_gangs=6_000, num_queues=4, num_runs=0, global_burst=1_000,
                 perq_burst=1_000, max_gang_cardinality=1, seed=5)
LOOP_LANES = dict(num_nodes=1_000, num_gangs=6_000, num_queues=40, num_runs=400,
                  max_gang_cardinality=2, type_sensitive_frac=0.3, seed=4)
# the entry points' small worlds: node types and type scores on a synthetic
# world, and a four-pool split of another for the serving loop
ENTRY_WORLD = dict(num_nodes=1_200, num_jobs=24_000, num_queues=16, num_runs=600, seed=9,
                   shape_bucket=1024)
ENTRY_TYPES = ("v4", "v5e", "v6", "")
ENTRY_POOL_NODES = (300, 300, 300, 300)


def _lanes_of(dp, P: int) -> list:
    """P device problems of one shape from one: queue weights rolled, nodes
    and gangs masked differently in each lane."""
    import torch

    dev = dp.g_req.device
    lanes = [dp]
    for i in range(1, P):
        r = np.random.default_rng(100 + i)
        lanes.append(dp._replace(
            q_weight=torch.roll(dp.q_weight, i),
            node_ok=dp.node_ok & torch.as_tensor(r.random(dp.node_ok.shape[0]) > 0.05 * i,
                                                 device=dev),
            g_valid=dp.g_valid & torch.as_tensor(r.random(dp.g_valid.shape[0]) > 0.1 * i,
                                                 device=dev),
        ))
    return lanes


def check_loop_kernels(dev) -> dict:
    """The round's loop shapes against their plain versions on the card,
    on small problems, every RoundResult field: K10 at K = 8 and 16 on a
    burst of singles, the node-type bias (TR > 1) at K = 1 and 8,
    prefer-large on gangs and on evictees; then K-D with each on windows of
    3 lanes, each lane equal to the solo K-B round; then K11
    (check_k11_kernels)."""
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem

    out = {}
    bp, bmeta = synthetic_problem(**LOOP_BURST)
    bdp = problem_from_numpy(bp, dev)
    for k in (1, LOOP_COMMIT_K, 16):
        out[f"burst K={k}"] = check_round("burst", bdp, bmeta, dev, commit_k=k)
    if 2 * out[f"burst K={LOOP_COMMIT_K}"]["kernel_iters"] > out["burst K=1"]["kernel_iters"]:
        raise AssertionError(f"K={LOOP_COMMIT_K} did not halve the burst's trips: {out}")
    hp, hmeta = synthetic_problem(**LOOP_HETERO)
    if hp.type_bias.shape[0] < 2:
        raise AssertionError("the hetero problem has no type-sensitive key")
    hdp = problem_from_numpy(hp, dev)
    for k in (1, LOOP_COMMIT_K):
        out[f"hetero K={k}"] = check_round("hetero", hdp, hmeta, dev, commit_k=k)
    sp, smeta = synthetic_problem(**KB_SYNTH)
    out["prefer-large gangs"] = check_round("synthetic_problem", sp, smeta, dev,
                                            prefer_large=True)
    ep, ectx = world_problem(KB_EVICT, protected=0.0)
    out["prefer-large evict"] = check_round("eviction world", ep, round_meta(ectx), dev,
                                            prefer_large=True)
    if out["prefer-large evict"]["evicted"] == 0:
        raise AssertionError("the prefer-large eviction world evicted nothing")
    lp, lmeta = synthetic_problem(**LOOP_LANES)
    lanes = _lanes_of(problem_from_numpy(lp, dev), 3)
    for statics in (dict(commit_k=LOOP_COMMIT_K), dict(prefer_large=True)):
        key = "stacked " + " ".join(f"{a}={b}" for a, b in statics.items())
        out[key] = _stacked_check("loop lanes (TR > 1)", lanes, lmeta, dev, **statics)
    out.update(check_k11_kernels(dev, bdp, bmeta, hdp, hmeta, lanes, lmeta, out))
    out.update(check_windows(dev))
    return out


def check_k11_kernels(dev, bdp, bmeta, hdp, hmeta, lanes, lmeta, loop: dict) -> dict:
    """K11, the decision-neutral loop bodies, against the plain version on
    small problems, every RoundResult field: the fit cache at 4 slots (key
    collisions, misses, overwrites) and 64 on the burst problem, an eviction
    world, TR > 1, at commit_k 8 and with prefer-large; the pick chain at
    batch_k 8 with and without TR > 1 and on the eviction world; unroll 4;
    and 3-lane stacks with the cache and with the chain.  Each must also
    equal the uncached round but for kernel_iters: the burst's, the hetero
    problem's and the prefer-large one's are `loop`'s (check_loop_kernels
    held those rounds against the plain version already)."""
    from armada_tpu_torch.kernels.round import cache_stats
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem

    out = {}

    def case(name, dp, meta, base=None, **statics):
        info = check_round(name, dp, meta, dev, **statics)
        if statics.get("cache_slots"):
            info["cache_hits"], info["cache_misses"] = cache_stats()[0]
            if info["cache_hits"] + info["cache_misses"] == 0:
                raise AssertionError(f"{name} {statics}: the fit cache was never consulted")
        if base is not None:
            for k in ("iterations", "scheduled", "evicted", "rescheduled", "termination"):
                if info[k] != base[k]:
                    raise AssertionError(f"{name} {statics}: {k} {info[k]} != uncached {base[k]}")
        out[f"{name} " + " ".join(f"{a}={b}" for a, b in statics.items())] = info
        return info

    burst = out["burst base"] = loop["burst K=1"]
    for slots in (4, 64):
        if case("burst", bdp, bmeta, burst, cache_slots=slots)["cache_hits"] == 0:
            raise AssertionError(f"the burst's fit cache never hit at {slots} slots")
    case("burst", bdp, bmeta, burst, cache_slots=64, commit_k=LOOP_COMMIT_K)
    ib = case("burst", bdp, bmeta, burst, batch_k=8)
    if 2 * ib["kernel_iters"] > burst["kernel_iters"]:
        raise AssertionError(f"batch_k 8 did not halve the burst's trips: {ib}")
    case("burst", bdp, bmeta, burst, unroll=4)
    fp, fmeta = synthetic_problem(**LOOP_FEWQ)
    fdp = problem_from_numpy(fp, dev)
    fewq = check_round("four queues", fdp, fmeta, dev)
    for k in (8, 16):
        case("four queues", fdp, fmeta, fewq, batch_k=k)
    ep, ectx = world_problem(KB_EVICT, protected=0.0)
    emeta = round_meta(ectx)
    edp = problem_from_numpy(ep, dev)
    evict = out["eviction world"] = check_round("eviction world", edp, emeta, dev)
    case("eviction world", edp, emeta, evict, cache_slots=4)
    case("eviction world", edp, emeta, evict, batch_k=8)
    het = loop["hetero K=1"]
    case("hetero", hdp, hmeta, het, cache_slots=4)
    case("hetero", hdp, hmeta, het, cache_slots=64, commit_k=LOOP_COMMIT_K)
    case("hetero", hdp, hmeta, het, batch_k=8)
    sp, smeta = synthetic_problem(**KB_SYNTH)
    sdp = problem_from_numpy(sp, dev)
    pl = loop["prefer-large gangs"]
    case("synthetic_problem", sdp, smeta, pl, cache_slots=4, prefer_large=True)
    for statics in (dict(cache_slots=4), dict(batch_k=8)):
        key = "stacked " + " ".join(f"{a}={b}" for a, b in statics.items())
        out[key] = _stacked_check("loop lanes (TR > 1)", lanes, lmeta, dev, **statics)
    return out


def _typed_world(spec: dict):
    """synthetic_world with its nodes cycling through ENTRY_TYPES and every
    third queued job declaring throughputs for two of the types."""
    from armada_tpu_torch.models.synthetic import synthetic_world

    config, nodes, queues, specs, running, factory = synthetic_world(**spec)
    nodes = [dataclasses.replace(n, node_type=ENTRY_TYPES[i % len(ENTRY_TYPES)])
             for i, n in enumerate(nodes)]
    rng = np.random.default_rng(spec["seed"])
    typed = []
    for i, s in enumerate(specs):
        if i % 3 == 0:
            a, b = rng.choice(3, 2, replace=False)
            s = dataclasses.replace(s, node_type_scores=(
                (ENTRY_TYPES[a], float(rng.choice([1.0, 2.0, 4.0]))),
                (ENTRY_TYPES[b], float(rng.choice([1.0, 2.0, 4.0])))))
        typed.append(s)
    return config, nodes, queues, typed, running, factory


def _outcome_view(o) -> tuple:
    return (sorted(o.scheduled.items()), sorted(o.preempted), sorted(o.rescheduled),
            list(o.failed), o.num_iterations, o.termination, o.spot_price)


def _with_env(env: dict, fn):
    """fn() with the environment variables of `env` set, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _small_pool_arm(dev, world: dict, fresh: list, parallel: bool, commit_k: int) -> dict:
    """FairSchedulingAlgo over the entry world split into 4 pools: a fill
    cycle and one steady cycle that submits `fresh`, with ARMADA_COMMIT_K =
    commit_k."""
    from armada_tpu_torch import kernels
    from armada_tpu_torch import models as M
    from armada_tpu_torch.jobdb.job import Job

    os.environ["ARMADA_POOL_PARALLEL"] = "1" if parallel else "0"
    os.environ["ARMADA_COMMIT_K"] = str(commit_k)
    try:
        M.reset_stack_cache()
        cfg, jdb, feed, algo, executors, names = pools_world(
            world, dev, pool_nodes=ENTRY_POOL_NODES, bucket=1024)
        kernels.reset_launches()
        decisions = []
        for c in range(2):
            txn = jdb.write_txn()
            if c:
                txn.upsert([Job(spec=dataclasses.replace(s, pools=(names[i % 4],)), queued=True,
                                validated=True, pools=(names[i % 4],))
                            for i, s in enumerate(fresh)])
            res = algo.schedule(txn, executors, POOL_NOW_NS)
            decisions.append(([(job.id, run.id, run.node_id) for job, run in res.scheduled],
                              sorted(job.id for job, _ in res.preempted)))
            txn.commit()
        return dict(decisions=decisions, launches=dict(kernels.LAUNCHES))
    finally:
        os.environ.pop("ARMADA_POOL_PARALLEL", None)
        os.environ.pop("ARMADA_COMMIT_K", None)


def loop_shapes_path(dev, main: dict) -> dict:
    """The loop shapes at full width.  K10: the main path's own problem
    through run_round_on_device with ARMADA_COMMIT_K = 8, which must decide
    as the K = 1 round did, and K-B at K = 8 against its plain version and
    timed beside K = 1.  The node-type bias: a 1M-gang synthetic problem
    with TR > 1 at K = 1 and 8.  Prefer-large: the main problem through
    run_round_on_device with enablePreferLargeJobOrdering.  The entry points
    on small worlds: run_scheduling_round with node types and type scores,
    and both arms of the pools serving loop, at K = 1 and 8."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels.round import schedule_round
    from armada_tpu_torch.models import run_round_on_device, run_scheduling_round
    from armada_tpu_torch.models.fair_scheduler import round_statics, schedule_round_plain
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem, synthetic_world

    config, problem, ctx, dp = main["config"], main["problem"], main["ctx"], main["dp"]
    meta = round_meta(ctx)
    k1_outcome = main["outcome"]
    report: dict = {}

    # K10 on the main world, through the entry point the serving loop calls
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res8, out8 = _with_env(dict(ARMADA_COMMIT_K=LOOP_COMMIT_K), lambda: run_round_on_device(
        problem, ctx, config, device=dev, device_problem=dp))
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for k in ("round", "round_multi_commit", "fair_shares", "compact"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the loop-shapes path")
    with uncounted():
        res1, out1 = _with_env(dict(ARMADA_COMMIT_K=1), lambda: run_round_on_device(
            problem, ctx, config, device=dev, device_problem=dp))
    if _outcome_view(out8) != _outcome_view(out1) or \
            _outcome_view(out1) != _outcome_view(k1_outcome):
        raise AssertionError("the K = 8 round decides differently from the K = 1 round")
    max_err(res8, res1._replace(kernel_iters=res8.kernel_iters))
    iters, trips = int(res8.iterations), int(res8.kernel_iters)
    if trips >= iters:
        raise AssertionError(f"K = 8 took {trips} trips for {iters} steps")
    with uncounted():
        kw1 = dict(meta, **round_statics(dp, commit_k=1))
        kw8 = dict(meta, **round_statics(dp, commit_k=LOOP_COMMIT_K))
        ms = {1: [], LOOP_COMMIT_K: []}
        for k, kw in ((1, kw1), (LOOP_COMMIT_K, kw8), (LOOP_COMMIT_K, kw8), (1, kw1)):
            t, r = cuda_ms(lambda kw=kw: schedule_round(dp, **kw), reps=2)
            ms[k].append(t)
            if k == LOOP_COMMIT_K:
                r8 = r
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain8 = schedule_round_plain(dp, **kw8)
        torch.cuda.synchronize()
        plain8_ms = (time.perf_counter() - t0) * 1e3
        max_err(r8, plain8)
    k1_ms, k8_ms = float(np.mean(ms[1])), float(np.mean(ms[LOOP_COMMIT_K]))
    report["k10_main"] = dict(entry_s=entry_s, iterations=iters, kernel_iters=trips,
                              commits_per_trip=iters / trips, k1_ms=ms[1], k8_ms=ms[LOOP_COMMIT_K],
                              plain8_ms=plain8_ms, k1_us_per_trip=k1_ms * 1e3 / iters,
                              k8_us_per_trip=k8_ms * 1e3 / trips, launches=launches)
    log(f"loop shapes [K10, main world]: run_round_on_device at K={LOOP_COMMIT_K} "
        f"{entry_s:.2f} s, decisions equal K=1; iterations {iters}, kernel_iters {trips} "
        f"({iters / trips:.2f} commits per trip); K-B {k1_ms:.2f} ms at K=1 "
        f"({k1_ms * 1e3 / iters:.1f} us a trip), {k8_ms:.2f} ms at K={LOOP_COMMIT_K} "
        f"({k8_ms * 1e3 / trips:.1f} us a trip); plain K={LOOP_COMMIT_K} on the card "
        f"{plain8_ms:.0f} ms, equal in every field; launches {launches}")

    # the node-type bias at full width
    with uncounted():
        t0 = time.perf_counter()
        hp, hmeta = synthetic_problem(**HETERO_PROBLEM)
        hdp = problem_from_numpy(hp, dev)
        build_s = time.perf_counter() - t0
        TR = int(hdp.type_bias.shape[0])
        if TR < 2:
            raise AssertionError("the full-width hetero problem has no type-sensitive key")
        het = {}
        for k in (1, LOOP_COMMIT_K):
            kw = dict(hmeta, **round_statics(hdp, commit_k=k))
            t, kres = cuda_ms(lambda kw=kw: schedule_round(hdp, **kw), reps=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pres = schedule_round_plain(hdp, **kw)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            max_err(kres, pres)
            het[k] = dict(ms=t, plain_ms=pms, iterations=int(kres.iterations),
                          kernel_iters=int(kres.kernel_iters), result=kres)
        max_err(het[LOOP_COMMIT_K]["result"]._replace(kernel_iters=het[1]["result"].kernel_iters),
                het[1]["result"])
        for v in het.values():
            v.pop("result")
    report["hetero"] = dict(TR=TR, build_s=build_s, **{f"K={k}": v for k, v in het.items()})
    log(f"loop shapes [node-type bias, 1M gangs x 50k nodes, TR={TR}]: kernel == plain at K=1 "
        f"({het[1]['ms']:.2f} ms, {het[1]['iterations']} iterations) and K={LOOP_COMMIT_K} "
        f"({het[LOOP_COMMIT_K]['ms']:.2f} ms, {het[LOOP_COMMIT_K]['kernel_iters']} trips); "
        f"K={LOOP_COMMIT_K} == K=1 but for kernel_iters")

    # prefer-large on the main world, through the entry point
    pl_config = dataclasses.replace(config, enable_prefer_large_job_ordering=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, pl_out = run_round_on_device(problem, ctx, pl_config, device=dev, device_problem=dp)
    torch.cuda.synchronize()
    pl_entry_s = time.perf_counter() - t0
    if kernels.LAUNCHES["round"] <= 0:
        raise AssertionError("the prefer-large round did not launch the round kernel")
    with uncounted():
        kwp = dict(meta, **round_statics(dp, prefer_large=True))
        pl_ms, kres = cuda_ms(lambda: schedule_round(dp, **kwp), reps=2)
        t0 = time.perf_counter()
        pplain = schedule_round_plain(dp, **kwp)
        torch.cuda.synchronize()
        pl_plain_ms = (time.perf_counter() - t0) * 1e3
        max_err(kres, pplain)
    report["prefer_large"] = dict(entry_s=pl_entry_s, ms=pl_ms, plain_ms=pl_plain_ms,
                                  iterations=int(kres.iterations),
                                  scheduled=len(pl_out.scheduled),
                                  differs_from_default=_outcome_view(pl_out) != _outcome_view(
                                      k1_outcome))
    log(f"loop shapes [prefer-large, main world]: run_round_on_device {pl_entry_s:.2f} s, "
        f"scheduled {len(pl_out.scheduled)}; K-B {pl_ms:.2f} ms == plain ({pl_plain_ms:.0f} ms) "
        f"in every field; differs from the default order: "
        f"{report['prefer_large']['differs_from_default']}")

    # the entry points on small worlds
    tw = _typed_world(ENTRY_WORLD)
    tc, tn, tq, ts, tr, _ = tw
    outs = {k: _with_env(dict(ARMADA_COMMIT_K=k), lambda: run_scheduling_round(
        tc, pool="default", nodes=tn, queues=tq, queued_jobs=ts, running=tr, device=dev))
        for k in (1, LOOP_COMMIT_K)}
    if _outcome_view(outs[1]) != _outcome_view(outs[LOOP_COMMIT_K]):
        raise AssertionError("run_scheduling_round with type scores: K = 8 decides differently")
    if not outs[1].scheduled:
        raise AssertionError("the typed world scheduled nothing")
    world = dict(world=synthetic_world(**dict(ENTRY_WORLD, seed=10)))
    fresh = world["world"][5](400, 1e6)
    arms = {(par, k): _small_pool_arm(dev, world, fresh, par, k)
            for par in (True, False) for k in (1, LOOP_COMMIT_K)}
    base = arms[(False, 1)]["decisions"]
    for key, arm in arms.items():
        if arm["decisions"] != base:
            raise AssertionError(f"pools serving loop {key}: decisions differ from serial K=1")
    par8 = arms[(True, LOOP_COMMIT_K)]["launches"]
    if par8["round_stacked"] <= 0 or par8["round_multi_commit"] <= 0:
        raise AssertionError(f"the parallel arm at K=8 did not stack multi-commit rounds: {par8}")
    if arms[(False, LOOP_COMMIT_K)]["launches"]["round_multi_commit"] <= 0:
        raise AssertionError("the serial arm at K=8 ran no multi-commit round")
    report["entry"] = dict(
        typed=dict(scheduled=len(outs[1].scheduled), iterations=outs[1].num_iterations,
                   kernel_iters={k: o.kernel_iters for k, o in outs.items()}),
        pools={f"{'parallel' if p else 'serial'} K={k}": a["launches"]
               for (p, k), a in arms.items()})
    log(f"loop shapes [entry points]: run_scheduling_round with node-type scores decides the "
        f"same at K=1 and K={LOOP_COMMIT_K} (kernel_iters "
        f"{outs[1].kernel_iters} -> {outs[LOOP_COMMIT_K].kernel_iters}); FairSchedulingAlgo, "
        f"4 pools, serial and parallel arms at K=1 and K={LOOP_COMMIT_K}: the same decisions; "
        f"parallel K={LOOP_COMMIT_K} launches {par8}")

    # the kernels line: K10 is the round's multi-commit body, measured as
    # the K = 8 round on the main world; its bound is K-B's at K = 8's trips
    N, R = (int(x) for x in dp.node_total.shape)
    live_q = int((dp.q_len > 0).sum())
    per_trip = 2 * N * R * 4 + live_q * 16 * 13
    io = tensor_bytes(*dp) + tensor_bytes(*res8)
    bms, by = bound_ms(io + trips * per_trip, trips * 2 * N * R * 6)
    src, rep = SOURCES["round_multi_commit"]
    row = dict(name="round_multi_commit", route="cuda", source=src, replaces=rep,
               launches=launches["round_multi_commit"], max_abs_err=0.0, equal=True, ms=k8_ms,
               plain_ms=plain8_ms, bound_ms=bms, bound_by=by, library_ms=None)
    k11 = k11_main_world(dev, main, k1_outcome)
    report["k11_main"] = k11["report"]
    return dict(rows=[row] + k11["rows"], report=report)


# The fit cache's slots and the pick chain's length armed on the main world
K11_SLOTS = 64
K11_BATCH_K = 8



def k11_main_world(dev, main: dict, k1_outcome) -> dict:
    """K11 at full width: the main path's own problem (no second build)
    through run_round_on_device with ARMADA_CACHE_SLOTS = 64 and with
    ARMADA_BATCH_K = 8, each deciding as the uncached round did; K-B timed
    uncached and cached in turns (0, 64, 64, 0) and at batch_k 8 once, CUDA
    events, each against its plain version on the card."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels.round import cache_stats, schedule_round
    from armada_tpu_torch.models import run_round_on_device
    from armada_tpu_torch.models.fair_scheduler import (
        block_size, round_statics, schedule_round_plain,
    )

    config, problem, ctx, dp = main["config"], main["problem"], main["ctx"], main["dp"]
    meta = round_meta(ctx)
    N, R = (int(x) for x in dp.node_total.shape)
    live_q = int((dp.q_len > 0).sum())
    per_iter = 2 * N * R * 4 + live_q * 16 * 13
    report, rows, launches = {}, [], {}
    for name, env in (("round_fit_cache", dict(ARMADA_CACHE_SLOTS=K11_SLOTS)),
                      ("round_batch_k", dict(ARMADA_CACHE_SLOTS=0, ARMADA_BATCH_K=K11_BATCH_K))):
        kernels.reset_launches()
        res, out = _with_env(env, lambda: run_round_on_device(
            problem, ctx, config, device=dev, device_problem=dp))
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        if launches[name][name] <= 0 or launches[name]["round"] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main world: "
                                 f"{launches[name]}")
        if _outcome_view(out) != _outcome_view(k1_outcome):
            raise AssertionError(f"{name}: the main world decides differently from the "
                                 "uncached round")
        report[name] = dict(iterations=int(res.iterations), kernel_iters=int(res.kernel_iters))
    with uncounted():
        kw0 = dict(meta, **round_statics(dp, cache_slots=0, batch_k=1, commit_k=1))
        kws = _with_env(dict(ARMADA_CACHE_SLOTS=K11_SLOTS), lambda: dict(
            meta, **round_statics(dp, cache_slots=-1, batch_k=1, commit_k=1)))
        kwb = dict(meta, **round_statics(dp, cache_slots=0, batch_k=K11_BATCH_K, commit_k=1))
        S = kws["cache_slots"]
        ms = {0: [], S: []}
        for key, kw in ((0, kw0), (S, kws), (S, kws), (0, kw0)):
            t, r = cuda_ms(lambda kw=kw: schedule_round(dp, **kw), reps=2)
            ms[key].append(t)
            if key == S:
                rs = r
                hits, misses = cache_stats()[0]
            else:
                r0 = r
        bk_ms, rb = cuda_ms(lambda: schedule_round(dp, **kwb), reps=2)
        max_err(rs, r0)
        max_err(rb._replace(kernel_iters=r0.kernel_iters), r0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps = schedule_round_plain(dp, **kws)
        torch.cuda.synchronize()
        plain_s_ms = (time.perf_counter() - t0) * 1e3
        max_err(rs, ps)
        t0 = time.perf_counter()
        pb = schedule_round_plain(dp, **kwb)
        torch.cuda.synchronize()
        plain_b_ms = (time.perf_counter() - t0) * 1e3
        max_err(rb, pb)
    iters = int(r0.iterations)
    btrips = int(rb.kernel_iters)
    m0, mS = float(np.mean(ms[0])), float(np.mean(ms[S]))
    B = block_size(N)
    NB = N // B
    io = tensor_bytes(*dp) + tensor_bytes(*r0)
    window = iters * live_q * 16 * 13
    cached_bytes = io + window + misses * per_iter + hits * (NB * 4 + B * 5)
    cached_ops = misses * 2 * N * R * 6 + hits * (NB + B)
    bms_c, by_c = bound_ms(cached_bytes, cached_ops)
    bms_b, by_b = bound_ms(io + iters * per_iter, iters * 2 * N * R * 6)
    report.update(
        slots=S, block=B, hits=hits, misses=misses, iterations=iters, uncached_ms=ms[0],
        cached_ms=ms[S], uncached_us_per_iter=m0 * 1e3 / iters,
        cached_us_per_iter=mS * 1e3 / iters, batch_k=K11_BATCH_K, batch_ms=bk_ms,
        batch_trips=btrips, batch_us_per_trip=bk_ms * 1e3 / btrips, plain_cached_ms=plain_s_ms,
        plain_batch_ms=plain_b_ms, launches=launches)
    log(f"loop shapes [K11, main world]: resolved cache_slots {S} (block {B}); K-B uncached "
        f"{m0:.2f} ms ({m0 * 1e3 / iters:.1f} us an iteration), cached {mS:.2f} ms "
        f"({mS * 1e3 / iters:.1f} us an iteration; {hits} hits, {misses} misses) in turns "
        f"{ms}; batch_k {K11_BATCH_K} {bk_ms:.2f} ms in {btrips} trips "
        f"({bk_ms * 1e3 / btrips:.1f} us a trip); each equal to its plain version on the card "
        f"({plain_s_ms:.0f} ms, {plain_b_ms:.0f} ms) and deciding as the uncached round")
    for name, t, pms, (bms, by) in (("round_fit_cache", mS, plain_s_ms, (bms_c, by_c)),
                                    ("round_batch_k", bk_ms, plain_b_ms, (bms_b, by_b))):
        src, rep = SOURCES[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name][name], max_abs_err=0.0, equal=True, ms=t,
                         plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None))
    return dict(rows=rows, report=report)



def cluster_path(dev, main: dict) -> dict:
    """The redesigned step on the main path's own problem: K-B and every
    loop shape the loop-shapes path drives (K10 at K = 8, prefer-large,
    K11's cache at 64 slots and its pick chain at batch_k 8) at the cluster
    size the owner picks, timed in turns against S = 1 (forms_in_turns,
    equal in every field), and the per-section step profile of the
    ROUND_STEP_PROFILE build: K-B at S = 1 and every shape at its S."""
    from armada_tpu_torch.models.fair_scheduler import round_statics

    dp, ctx = main["dp"], main["ctx"]
    meta = round_meta(ctx)
    base = dict(cache_slots=0, batch_k=1, commit_k=1)
    shapes = (("K-B", base), ("K10 commit_k 8", dict(base, commit_k=LOOP_COMMIT_K)),
              ("prefer-large", dict(base, prefer_large=True)),
              ("K11 cached", dict(base, cache_slots=-1)),
              ("K11 batch_k 8", dict(base, batch_k=K11_BATCH_K)))
    report = {}
    for name, st in shapes:
        kw = _with_env(dict(ARMADA_CACHE_SLOTS=K11_SLOTS),
                       lambda st=st: dict(meta, **round_statics(dp, **st)))
        t = forms_in_turns(dp, kw)
        trips = int(t.pop("result").kernel_iters)
        t.update(kernel_iters=trips, single_us_per_trip=t["single_mean"] * 1e3 / trips,
                 chosen_us_per_trip=t["chosen_mean"] * 1e3 / trips)
        log(f"cluster path [{name}, main world]: S=1 {t['single_ms']} ms, S={t['S']} "
            f"{t['chosen_ms']} ms in turns ({t['single_us_per_trip']:.2f} against "
            f"{t['chosen_us_per_trip']:.2f} us a trip, {trips} trips); equal in every field")
        t["profile"] = {}
        for S in ((1, t["S"]) if name == "K-B" else (t["S"],)):
            prof = step_profile(dp, kw, S)
            log_step_profile(name, prof)
            t["profile"][S] = prof
        report[name] = t
    return report


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


def slab_copy_bytes(args) -> int:
    """The functional copies' bytes of one K-H call: every touched field of
    the previous problem (after `fulls`) read once and written once."""
    from armada_tpu_torch.models.slab import _EV_FIELDS, _RR_FIELDS, _SG_FIELDS

    (prev, *_, fulls, _gq), _kw = args
    f = {**prev._asdict(), **fulls}
    return 2 * tensor_bytes(*[f[n] for n in dict.fromkeys(_SG_FIELDS + _EV_FIELDS + _RR_FIELDS)])


def slab_adversarial(args) -> list:
    """K-H's adversarial cases on the incremental path's own apply (its
    widths and rows), as (name, args, kw): a gang row on an evictee slot
    the evictee group also writes (the later group wins), the index vectors
    and their rows out of ascending order, negative indices, every group all
    sentinel, and splices with no inserts and with no removals.  No slot is
    written twice within a group (the plain version's index_put leaves that
    order open on a card)."""
    import torch

    (prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args), kw = args
    G, RJ = int(prev.g_req.shape[0]), int(prev.run_req.shape[0])
    ev_base = int(kw["ev_base"])
    dev = sg_idx.device
    rng = np.random.default_rng(9)
    sg = sg_idx.cpu().numpy().copy()
    rr = rr_idx.cpu().numpy().copy()
    real_rr = np.flatnonzero(rr < RJ)
    taken = set(np.where(sg < 0, sg + G, sg)[sg < G].tolist())
    ev_slots = [int(rr[i]) + ev_base for i in real_rr if 0 <= int(rr[i]) + ev_base < G
                and int(rr[i]) + ev_base not in taken][:16]
    pads = np.flatnonzero(sg == G)
    cross = sg.copy()
    cross[pads[:len(ev_slots)]] = ev_slots
    neg = sg.copy()
    free_pads = pads[len(ev_slots):]
    for p, v in zip(free_pads[:2], (-1, -G)):
        if (v + G) not in taken:
            neg[p] = v
    rneg = rr.copy()
    if (RJ - 1) not in set(rr.tolist()):
        rneg[np.flatnonzero(rr == RJ)[:1]] = -1
    perm_g, perm_r = rng.permutation(len(sg)), rng.permutation(len(rr))

    def t(x):
        return torch.as_tensor(x, device=dev)

    def perm(cols, p):
        return {n: c[t(p)] for n, c in cols.items()}

    base = (prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args)
    cases = [
        ("cross_group", (prev, t(cross)) + base[2:], kw),
        ("unsorted", (prev, t(sg[perm_g]), perm(sg_cols, perm_g), t(rr[perm_r]),
                      perm(rr_cols, perm_r), perm(ev_cols, perm_r), fulls, gq_args), kw),
        ("negative", (prev, t(neg), sg_cols, t(rneg), rr_cols, ev_cols, fulls, gq_args), kw),
        ("all_sentinel", (prev, torch.full_like(sg_idx, G), sg_cols, torch.full_like(rr_idx, RJ),
                          rr_cols, ev_cols, fulls, gq_args), kw),
    ]
    if kw["splice"]:
        rem, ins, val = gq_args
        cases += [
            ("no_inserts", base[:7] + ((rem, torch.full_like(ins, G), torch.zeros_like(val)),), kw),
            ("no_removals", base[:7] + ((torch.full_like(rem, G), ins, val),), kw),
        ]
    return cases


def explain_adversarial(xin) -> list:
    """K-J's adversarial cases on the incremental path's last explain
    inputs (its widths), as (name, inputs): every node of one type (each
    free-capacity sum past 2^24: the longest chain there is), a type with
    no nodes, T = 1, and node types outside [0, T) (JAX's index rules)."""
    import torch

    x = list(xin)
    compat, pre, node_type = x[0], x[1], x[2]
    T = int(compat.shape[1])
    cases = [("one_type", x[:2] + [torch.zeros_like(node_type)] + x[3:])]
    if T > 1:
        cases.append(("empty_type", x[:2] + [torch.where(node_type == 1, 0, node_type)] + x[3:]))
    cases.append(("t1", [compat[:, :1].contiguous(), pre[:, :1].contiguous(),
                         torch.zeros_like(node_type)] + x[3:]))
    nt = node_type.clone()
    nt[::7] = -1
    nt[1::11] = T
    nt[2::13] = T + 5
    nt[3::17] = -T - 1
    cases.append(("index_rule", x[:2] + [nt] + x[3:]))
    return cases


def verify_adversarial(vin) -> dict:
    """K-I's adversarial cases (models/synthetic.py adversarial_verify_cases)
    on the incremental path's last verification inputs (its widths): each
    through the solo kernel and, as a stack of three lanes with different
    real-gang counts, the stacked one, against the plain versions word for
    word (raises on a difference).  Returns each case's flags."""
    from armada_tpu_torch.kernels.verify import (
        verify_round, verify_round_stacked, verify_round_stacked_plain,
    )
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.synthetic import (
        adversarial_verify_cases, corrupted_verify_inputs, stacked_verify_case,
    )

    def both(a, real) -> tuple:
        k = verify_round(*a, real)
        max_err(k, V.verify_kernel_plain(*a, real))
        st, reals = stacked_verify_case(a, real)
        ks = verify_round_stacked(*st, reals)
        max_err(ks, verify_round_stacked_plain(st[:18] + [st[18][:, 0]] + st[19:], reals))
        return k, ks

    out = {}
    for name, a, real in adversarial_verify_cases(vin[:-1], vin[-1]):
        out[name] = [int(x) for x in both(a, real)[1][:, 1]]
    for bit, a in corrupted_verify_inputs(vin[:-1], vin[-1]):
        k, ks = both(a, vin[-1])
        if not (int(k[1]) >> bit) & 1 or not (int(ks[0, 1]) >> bit) & 1:
            raise AssertionError(f"K-I: the corruption aimed at {V.CHECK_NAMES[bit]} did not "
                                 f"fire ({int(k[1])}, {int(ks[0, 1])})")
        out[f"fires_{V.CHECK_NAMES[bit]}"] = int(k[1])
    clean = verify_round(*vin).cpu().numpy()
    flipped = vin[21].cpu().numpy().copy()
    flipped[len(flipped) // 2] ^= np.int32(1 << 20)
    try:
        V.verdict_of(clean, types.SimpleNamespace(last_compact_np=flipped))
        raise AssertionError("K-I: a flipped compact buffer passed the fingerprint")
    except V.RoundVerificationError as e:
        if e.sites != (V.SITE_FINGERPRINT,):
            raise
    out["fires_fingerprint"] = True
    return out


def adversarial_checks(slab_args, xin, kcap: int, fcap: int, vin) -> dict:
    """Each adversarial case of K-H, K-J and K-I (solo and stacked), kernel
    against plain on the card, every field / every i32 of the buffer
    (raises on a difference)."""
    import torch

    from armada_tpu_torch.kernels.explain import explain_round
    from armada_tpu_torch.kernels.slab import apply_delta
    from armada_tpu_torch.models.explain import explain_kernel_plain
    from armada_tpu_torch.models.slab import apply_delta_plain

    out = {}
    with uncounted():
        for name, a, kw in slab_adversarial(slab_args):
            before = [t.clone() for t in a[0]]
            problems_equal(apply_delta(*a, **kw), apply_delta_plain(*a, **kw), f"K-H {name}")
            for f, x, y in zip(a[0]._fields, a[0], before):
                if not torch.equal(x, y):
                    raise AssertionError(f"K-H {name}: the previous problem's {f} was written")
            out[f"slab_{name}"] = True
        for name, xi in explain_adversarial(xin):
            t0 = time.perf_counter()
            k = explain_round(*xi, kcap=kcap, fcap=fcap)
            p = explain_kernel_plain(*xi, kcap=kcap, fcap=fcap)
            max_err(k, p)
            torch.cuda.synchronize()
            out[f"explain_{name}"] = time.perf_counter() - t0
        out.update({f"verify_{k}": v for k, v in verify_adversarial(vin).items()})
    log(f"adversarial cases, kernel equal to plain: {sorted(out)}")
    return out


def slab_in_turns(args, reps: int = 10) -> dict:
    """K-H without the splice (splice=False: the library has no splice)
    in turns with `slab_library` on the same inputs: library, kernel,
    kernel, library, each the mean of `reps` calls between CUDA events,
    the collector off."""
    from armada_tpu_torch.kernels.slab import apply_delta

    (prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, _), kw = args
    kw = dict(kw, splice=False)
    kernel = lambda: apply_delta(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, (), **kw)  # noqa: E731
    library = slab_library(args)
    with uncounted():
        l1 = cuda_ms_quiet(library, reps)[0]
        k1 = cuda_ms_quiet(kernel, reps)[0]
        k2 = cuda_ms_quiet(kernel, reps)[0]
        l2 = cuda_ms_quiet(library, reps)[0]
    log(f"K-H without the splice in turns with index_put per field, ms a call over {reps} "
        f"calls: library {l1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, library {l2:.4f}")
    return dict(library_ms=[l1, l2], kernel_ms=[k1, k2], library_mean_ms=(l1 + l2) / 2,
                kernel_mean_ms=(k1 + k2) / 2)


def fadd_latency(device) -> tuple:
    """(cycles, max MHz, current MHz): the f32 add's dependent latency,
    measured on the card (`armada_fadd_cycles`, clock64 around a chain of
    2^20 adds), and the card's maximum and current SM clocks from
    nvidia-smi."""
    import torch

    from armada_tpu_torch.kernels.build import check, library, stream_handle

    buf = torch.zeros(2, dtype=torch.int64, device=device)
    n = 1 << 20
    check(library().armada_fadd_cycles(buf.data_ptr(), n, stream_handle()), "fadd chain")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    mhz_max, mhz_now = (float(v) for v in smi.stdout.strip().splitlines()[0].split(","))
    return int(buf[0]) / n, mhz_max, mhz_now


def chain_floor(xin) -> dict:
    """K-J's chain floor: the longest type's node count (node_type under
    the scatter's rule) x the f32 add's dependent latency over the card's
    maximum SM clock (`fadd_latency`)."""
    import torch

    T = int(xin[0].shape[1])
    nt = xin[2].long()
    nt = torch.where(nt < 0, nt + T, nt)
    counts = torch.bincount(nt[(nt >= 0) & (nt < T)], minlength=T)
    longest = int(counts.max())
    cycles, mhz_max, mhz_now = fadd_latency(xin[2].device)
    ms = longest * cycles / (mhz_max * 1e3)
    log(f"K-J chain floor: longest type {longest} nodes x {cycles:.3f} cycles an add / "
        f"{mhz_max:.0f} MHz (nvidia-smi clocks.max.sm; clocks.sm {mhz_now:.0f}) = {ms:.5f} ms")
    return dict(longest_type_nodes=longest, fadd_cycles=cycles, sm_clock_max_mhz=mhz_max,
                sm_clock_now_mhz=mhz_now, chain_floor_ms=ms)


def ordered_sum_chain(n: int) -> int:
    """Dependent adds of an ordered sum of n values (ops/fairness.py
    ordered_sum): a window of 32 a level, then the last <= 32."""
    return n if n <= 32 else 32 + ordered_sum_chain(-(-n // 32))


def fair_shares_chain_floor(w, c) -> dict | None:
    """K-A's chain floor on rows (w, c), [Q] or [P, Q]: the dependent adds
    of the ordered sums these rows need (the plain version's count, the
    longest lane's: the weights' sum, which is also the first iteration's
    total active weight, the later iterations' totals, and a spare sum an
    iteration that still runs; `ordered_sum_chain(Q)` adds each) x the f32
    add's latency over the card's maximum SM clock.  None on a tree whose
    plain version does not count them (the parent's)."""
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    rows = (w, c) if w.dim() == 2 else (w[None], c[None])
    its, sums = [], []
    for wi, ci in zip(*(r.cpu() for r in rows)):
        stats: dict = {}
        try:
            fair_shares_plain(wi, ci, stats=stats)
        except TypeError:
            return None
        its.append(stats["iterations"])
        sums.append(max(stats["iterations"], 1) + stats.get("spare_sums", 0))
    Q = int(w.shape[-1])
    sums = max(sums)
    adds = sums * ordered_sum_chain(Q)
    cycles, mhz_max, mhz_now = fadd_latency(w.device)
    ms = adds * cycles / (mhz_max * 1e3)
    log(f"K-A chain floor at Q={Q}: {max(its)} iterations, {sums} sums of "
        f"{ordered_sum_chain(Q)} dependent adds x {cycles:.3f} cycles an add / {mhz_max:.0f} MHz "
        f"= {ms:.5f} ms")
    return dict(iterations=max(its), sums=sums, adds_a_sum=ordered_sum_chain(Q), adds=adds,
                fadd_cycles=cycles, sm_clock_max_mhz=mhz_max, sm_clock_now_mhz=mhz_now,
                chain_floor_ms=ms)


SPLIT_REPS = 20
SPLIT_PROFILE_CALLS = 5  # calls in one profiler session (one short session can record none)


def call_split(fn) -> dict:
    """Where one call of fn goes: host ms of single calls (the stream
    drained before each: the wrapper's plan and enqueue), the device
    operations (kernels, copies, memsets) of a call and their device ms by
    name (torch.profiler, over SPLIT_PROFILE_CALLS calls), the mean over
    SPLIT_REPS back-to-back calls
    between CUDA events (`cuda_ms`: a host slower than the stream sets its
    pace), and the device ms of a call alone behind a long spin kernel
    (`launch_ms` hot behind a spin of four times the reps' host time: the
    host's enqueue is off the clock)."""
    host = host_ms(fn, SPLIT_REPS)
    spin = int(4 * SPLIT_REPS * float(np.median(host)) * 2e6)  # ~2 GHz cycles
    try:
        prof = round_profile(fn, attempts=5, calls=SPLIT_PROFILE_CALLS)
    except AssertionError:  # the profiler saw nothing: not measured, not a fault
        prof = None
    return dict(host_ms_median=float(np.median(host)), host_ms_min=min(host),
                host_ms_max=max(host),
                device_ops=sum(n for _, n, _ in prof) if prof else None,
                device_ms_by_name=[[k, n, ms] for k, n, ms in prof or ()],
                device_ms_sum=sum(ms for _, _, ms in prof) if prof else None,
                events_ms=cuda_ms(fn, SPLIT_REPS)[0],
                events_quiet_ms=cuda_ms_quiet(fn, SPLIT_REPS)[0],
                alone_ms=launch_ms(fn, "hot", None, SPLIT_REPS, max(spin, 3_000_000)))


def log_split(what: str, s: dict) -> None:
    top = "; ".join(f"{k[:60]} x{n:g} {ms:.4f}" for k, n, ms in s["device_ms_by_name"][:8])
    dev = ("device operations not measured (the profiler saw none)" if s["device_ops"] is None
           else f"{s['device_ops']} device operations, device {s['device_ms_sum']:.4f} ms ({top})")
    log(f"{what}: host {s['host_ms_median']:.4f} ms a call [{s['host_ms_min']:.4f}-"
        f"{s['host_ms_max']:.4f}], {dev}; events over {SPLIT_REPS} calls "
        f"{s['events_ms']:.4f} ms a call ({s['events_quiet_ms']:.4f} with the collector off), "
        f"a call alone {s['alone_ms']:.4f} ms")


def slab_library(args):
    """The library's K-H without the splice: one out-of-place
    `Tensor.index_put` per touched field (the evictee rows of a gang field
    then in place on that copy), the sentinel and out-of-range rows masked
    off once, here, outside the timed call.  Returns the timed function."""
    import torch

    from armada_tpu_torch.models.slab import _EV_FIELDS, _RR_FIELDS, _SG_FIELDS
    from armada_tpu_torch.ops.scatter import jax_index

    (prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, _), kw = args
    G, RJ = int(prev.g_req.shape[0]), int(prev.run_req.shape[0])
    base = prev._asdict()
    base.update(fulls)
    ev_idx = torch.where(rr_idx >= RJ, torch.full_like(rr_idx, G), rr_idx + int(kw["ev_base"]))
    groups = []
    for idx, cols, names, n in ((sg_idx, sg_cols, _SG_FIELDS, G), (rr_idx, rr_cols, _RR_FIELDS, RJ),
                                (ev_idx, ev_cols, _EV_FIELDS, G)):
        i, ok = jax_index(idx, n)
        groups.append((i[ok], {f: cols[f][ok] for f in names}))

    def library():
        out = dict(base)
        fresh = set()
        for i, cols in groups:
            for f, rows in cols.items():
                if f in fresh:
                    out[f].index_put_((i,), rows)
                else:
                    out[f] = out[f].index_put((i,), rows)
                    fresh.add(f)
        return out

    return library


def split_world(dev, world) -> dict:
    """A warm cycle and one steady cycle of BURST fresh specs (submitted
    before the steady cycle's bundle, so their rows ride it) over `world`
    through DeviceDeltaCache (K-H) and run_round_on_device, explain armed:
    the steady apply's inputs and the explain pass's."""
    import torch

    from armada_tpu_torch.core.types import RunningJob
    from armada_tpu_torch.kernels.slab import apply_delta
    from armada_tpu_torch.models import explain as X
    from armada_tpu_torch.models import begin_decode, run_round_on_device
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.incremental import IncrementalBuilder
    from armada_tpu_torch.models.slab import DeviceDeltaCache

    config, nodes, queues, specs, running, spec_factory = world["world"]
    builder = IncrementalBuilder(config, "default", queues)
    builder.set_nodes(nodes)
    builder.submit_many(specs)
    builder.lease_many(running)
    spec_of = {sp.id: sp for sp in specs}
    cache = DeviceDeltaCache(device=dev)
    seen = {}

    def recording(*a, **kw):
        seen["slab"] = (a, kw)
        return apply_delta(*a, **kw)

    for c in range(2):
        if c:
            fresh = spec_factory(BURST, 200.0)
            for sp in fresh:
                spec_of[sp.id] = sp
            builder.submit_many(fresh)
            cache = cache.fork(recording)
        bundle, ctx = builder.assemble_delta()
        dp = cache.apply(bundle)
        result, outcome = run_round_on_device(bundle.stats_view(), ctx, config, device=dev,
                                              device_problem=dp, explain_enabled=False)
        builder.remove_many(outcome.scheduled.keys())
        builder.lease_many([RunningJob(job=spec_of.pop(j), node_id=n)
                            for j, n in outcome.scheduled.items() if j in spec_of])
        for jid in outcome.preempted:
            builder.unlease(jid)
    torch.cuda.synchronize()
    if "slab" not in seen or cache.last_apply != "scatter":
        raise AssertionError(f"the steady cycle did not scatter ({cache.last_apply})")
    K, G = int(dp.compat.shape[0]), int(result.g_state.shape[0])
    fin = begin_decode(result, ctx)
    fin.fetch()
    return dict(slab=seen["slab"], q=(dp.q_weight, dp.q_cds),
                kc=(result, ctx.num_real_gangs, ctx.num_real_runs),
                xin=X.explain_inputs(dp, result, ctx.num_real_gangs),
                kcap=min(K, X._EXPLAIN_KCAP), fcap=min(G, X._EXPLAIN_FCAP),
                vin=V.verify_inputs(dp, result, fin.dispatched[0], ctx.num_real_gangs))


# The stacked K-I's split: seven lanes at the pools path's padded widths
# (N 6,144, G 155,648, RJ 8,192 a lane; synthetic, so the split needs no
# JobDb of 2M jobs), each lane with other queue weights and node and gang
# masks (`_lanes_of`), and other real-gang counts.
SPLIT_STACK = dict(num_nodes=6_144, num_gangs=155_648, num_queues=64, num_runs=8_192, seed=3)
SPLIT_STACK_LANES = 7


def stack_split_args(dev) -> tuple:
    """(the stacked K-I's arguments, K-F's: the stacked result, real gang
    and run counts, fcap, ecap) on a stacked round (K-E, K-D, K-F) of
    SPLIT_STACK_LANES lanes of SPLIT_STACK, with other real counts a lane."""
    from armada_tpu_torch.kernels import lanes as KL
    from armada_tpu_torch.kernels.compact import compact_result_stacked
    from armada_tpu_torch.kernels.round import schedule_round_stacked
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import round_statics
    from armada_tpu_torch.models.problem import COMPACT_ECAP, COMPACT_FCAP
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem

    prob, meta = synthetic_problem(**SPLIT_STACK)
    P = SPLIT_STACK_LANES
    st = KL.stack(_lanes_of(problem_from_numpy(prob, dev), P))
    res = schedule_round_stacked(st, **dict(meta, **round_statics(st)))
    G, RJ = int(st.g_req.shape[1]), int(st.run_req.shape[1])
    real_g = [G - 7 * i for i in range(P)]
    real_r = [RJ - 3 * i for i in range(P)]
    fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)
    kf = compact_result_stacked(res, real_g, real_r, fcap=fcap, ecap=ecap)
    vin = V.verify_inputs(st, res, kf, 0)
    return (*vin[:18], res.alloc, *vin[19:22], real_g), (res, real_g, real_r, fcap, ecap)


def verify_bytes(args) -> int:
    """K-I's bound in bytes: every input read once (of a stacked round's
    [P, P1, N, R] allocatable, level 0) and the i32[16] rows written once."""
    ts = list(args[:22])
    if ts[18].dim() == 4:
        ts[18] = ts[18][:, 0]
    return tensor_bytes(*ts) + 64 * (int(ts[11].shape[0]) if ts[11].dim() == 2 else 1)


def split_fields(s: dict) -> dict:
    """A split's fields of the kernels line: host ms of a call, device
    operations, a call alone and its share of the bound."""
    return dict(host_ms=s["host_ms_median"], plan_host_ms=s["plan_ms"], device_ops=s["device_ops"],
                alone_ms=s["alone_ms"], share_of_bound_alone=s["share_of_bound_alone"])


def split_bound(what: str, fn, bound: tuple) -> dict:
    """`call_split` of fn with its bound (`bound_ms`'s pair) and a call
    alone's share of it."""
    s = call_split(fn)
    b, by = bound
    s.update(bound_ms=b, bound_by=by, share_of_bound_alone=b / s["alone_ms"], plan_ms=None)
    log_split(what, s)
    log(f"{what}: bound {b:.6f} ms ({by}); a call alone reaches {100 * b / s['alone_ms']:.2f} % "
        "of it")
    return s


def compact_bound(res, buf) -> tuple:
    """K-C's or K-F's bound on a (stacked) round result and its buffer: the
    flags and slots read once, the buffer written once; a flag an
    operation."""
    return bound_ms(tensor_bytes(res.g_state, res.run_evicted, res.run_rescheduled,
                                 res.slot_gang, res.slot_nodes, res.slot_counts) + buf.numel() * 4,
                    res.g_state.numel() + 2 * res.run_evicted.numel())


def fair_shares_bound(w, c) -> tuple:
    """K-A's bound on rows (w, c): two rows in, three out; ~20 operations a
    queue an iteration over 10 iterations."""
    return bound_ms(tensor_bytes(w, c) + 3 * w.numel() * 4, 10 * 20 * w.numel())


def decode_fairness_split(state: dict) -> dict:
    """`split_bound` of K-A at the main path's Q = 8,192 (the split world's
    queue rows padded with zero-weight queues, as build_problem pads them)
    and Q + 1 = 8,193 (an indicative share's new queue: theoretical_share
    at priority 1), and with the pools path's lane axis (7 lanes of the
    first 64 rows, rolled lane by lane), each with its chain floor; of K-C on
    the split world's round result; of K-F on `state["fstack"]`."""
    import torch

    from armada_tpu_torch.kernels.compact import compact_result, compact_result_stacked
    from armada_tpu_torch.kernels.fair_shares import fair_shares

    w, c = state["q"]
    dev = w.device

    def pad(x, n):
        return torch.cat([x, torch.zeros(n - int(x.shape[0]), dtype=x.dtype, device=dev)])

    one = torch.ones(1, dtype=w.dtype, device=dev)
    w8, c8 = pad(w, 8_192), pad(c, 8_192)
    rows = {"Q=8192": (w8, c8), "Q=8193": (torch.cat([w8, one]), torch.cat([c8, one])),
            "7x64": tuple(torch.stack([torch.roll(x[:64], i) for i in range(7)]) for x in (w, c))}
    out = {}
    for key, (a, b) in rows.items():
        s = split_bound(f"K-A split {key}", lambda a=a, b=b: fair_shares(a, b),
                        fair_shares_bound(a, b))
        s["chain"] = fair_shares_chain_floor(a, b)
        out[f"fair_shares {key}"] = s
    res, rg, rr = state["kc"]
    G, RJ = int(res.g_state.shape[0]), int(res.run_evicted.shape[0])
    from armada_tpu_torch.models.problem import COMPACT_ECAP, COMPACT_FCAP

    fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)

    def kc():
        return compact_result(res, rg, rr, fcap=fcap, ecap=ecap)

    out["compact"] = split_bound("K-C split", kc, compact_bound(res, kc()))
    out["compact"]["shape"] = dict(G=G, RJ=RJ, S=int(res.slot_gang.shape[0]),
                                   W=int(res.slot_nodes.shape[1]), fcap=fcap, ecap=ecap)
    fres, frg, frr, ffcap, fecap = state["fstack"]

    def kf():
        return compact_result_stacked(fres, frg, frr, fcap=ffcap, ecap=fecap)

    out["compact_stacked"] = split_bound("K-F split", kf, compact_bound(fres, kf()))
    out["compact_stacked"]["shape"] = dict(
        P=int(fres.g_state.shape[0]), G=int(fres.g_state.shape[1]),
        RJ=int(fres.run_evicted.shape[1]), S=int(fres.slot_gang.shape[1]),
        W=int(fres.slot_nodes.shape[2]), fcap=ffcap, ecap=fecap)
    return out


def verify_split(what: str, fn, args) -> dict:
    """`split_bound` of a K-I form, and the host ms of the wrapper's plan
    alone (`verify_plan`: checks, the cached plan, the output, the argument
    block; a tree without it, the parent's, reports None)."""
    s = split_bound(what, fn, bound_ms(verify_bytes(args), 0))
    try:
        from armada_tpu_torch.kernels.verify import verify_plan
    except ImportError:
        verify_plan = None
    if verify_plan is not None:
        lanes = int(args[11].shape[0]) if args[11].dim() == 2 else 0
        s["plan_ms"] = float(np.median(host_ms(lambda: verify_plan(args[:22], args[22],
                                                                   lanes=lanes), SPLIT_REPS)))
        log(f"{what}: the plan alone {s['plan_ms']:.4f} ms of host time")
    return s


def kernel_split(state: dict) -> dict:
    """`call_split` of K-H (the steady apply, its splice included), of K-J
    and of K-I on `split_world`'s state, with the shapes; and of the
    stacked K-I on `state["vstack"]` where the state has it."""
    from armada_tpu_torch.kernels.explain import explain_round
    from armada_tpu_torch.kernels.slab import apply_delta
    from armada_tpu_torch.kernels.verify import verify_round, verify_round_stacked

    a, akw = state["slab"]
    xin, kcap, fcap = state["xin"], state["kcap"], state["fcap"]
    dp = a[0]
    out = dict(N=int(dp.node_total.shape[0]), G=int(dp.g_req.shape[0]),
               RJ=int(dp.run_req.shape[0]), K=int(dp.compat.shape[0]),
               T=int(dp.compat_pre_type.shape[1]), splice=bool(akw["splice"]),
               rows=[int(a[1].shape[0]), int(a[3].shape[0])])
    out["slab"] = call_split(lambda: apply_delta(*a, **akw))
    log_split("K-H split", out["slab"])
    out["explain"] = call_split(lambda: explain_round(*xin, kcap=kcap, fcap=fcap))
    log_split("K-J split", out["explain"])
    vin = state["vin"]
    out["verify"] = verify_split("K-I split", lambda: verify_round(*vin), vin)
    out["verify_shape"] = dict(S=int(vin[12].shape[0]), W=int(vin[13].shape[1]),
                               L=int(vin[21].shape[0]), Q=int(vin[19].shape[0]))
    if "vstack" in state:
        vs = state["vstack"]
        out["verify_stacked"] = verify_split("K-I stacked split",
                                             lambda: verify_round_stacked(*vs), vs)
        out["verify_stacked_shape"] = dict(
            P=int(vs[11].shape[0]), N=int(vs[0].shape[1]), G=int(vs[11].shape[1]),
            RJ=int(vs[3].shape[1]), Q=int(vs[19].shape[1]), S=int(vs[12].shape[1]),
            W=int(vs[13].shape[2]), L=int(vs[21].shape[1]))
    try:
        out["chain"] = chain_floor(xin)
    except AttributeError:  # a tree without the add-latency probe (the parent's)
        pass
    return out


def explain_type_profile(xin, kcap: int, fcap: int) -> dict:
    """K-J's type kernel tile by tile: csrc/explain.cu built alone with
    -DEX_TYPE_PROFILE (block 0's clock64 marks: its chain's start and end
    and the tile's barrier, and the tile's count), one call on `xin`.
    Returns cycles an add in the chains and the tiles' cycles outside them."""
    import ctypes

    import torch

    from armada_tpu_torch.kernels import build as kbuild
    from armada_tpu_torch.kernels.build import check, stream_handle
    from armada_tpu_torch.kernels.explain import explain_plan

    out = kbuild.BUILD_DIR / f"libexplain-prof-{kbuild._digest()}.so"
    if not out.exists():
        done = subprocess.run(
            [kbuild._nvcc(), *kbuild.FLAGS, "-DEX_TYPE_PROFILE", "-shared", "-o", str(out),
             str(kbuild.SRC_DIR / "explain.cu")], capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc of the profile build failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.armada_explain.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.armada_explain_type_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    res, call = explain_plan(xin[:-1], xin[-1], kcap=kcap, fcap=fcap)
    check(lib.armada_explain(call.ctypes.data, stream_handle()), "explain kernel (profile)")
    torch.cuda.synchronize()
    marks = np.zeros(4 * 1024, np.int64)
    check(lib.armada_explain_type_profile(marks.ctypes.data, 1024), "explain profile read")
    m = marks.reshape(-1, 4)
    m = m[m[:, 2] != 0]
    chain = m[:, 1] - m[:, 0]
    tile = np.diff(m[:, 2], prepend=m[0, 0])
    adds = int(m[:, 3].sum())
    prof = dict(tiles=len(m), adds=adds, chain_cycles=int(chain.sum()),
                tile_cycles=int(tile.sum()), cycles_an_add=float(chain.sum() / max(adds, 1)),
                outside_chain_cycles=int((tile - chain).sum()))
    log(f"K-J type kernel, block 0 (profile build): {prof['tiles']} tiles, {adds} adds, "
        f"{prof['cycles_an_add']:.2f} cycles an add in the chains, {prof['chain_cycles']} of "
        f"{prof['tile_cycles']} cycles in them")
    return prof


def split_main() -> int:
    """`python3 chip_smoke.py --split`: build the kernels and the main
    world, then `kernel_split` at the incremental path's shapes (a JSON
    line, details in chiprun_out/split.json).  Runs on any tree whose
    wrappers take these arguments, so one call can split a parent's
    kernels and a change's."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from armada_tpu_torch.kernels import build as kbuild
    from armada_tpu_torch.models.synthetic import synthetic_world

    smi = smi_line()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    kbuild.library()
    world = dict(world=synthetic_world(**MAIN_WORLD))
    state = split_world(dev, world)
    state["vstack"], state["fstack"] = stack_split_args(dev)
    out = kernel_split(state)
    out["decode_fairness"] = decode_fairness_split(state)
    try:
        out["type_profile"] = explain_type_profile(state["xin"], state["kcap"], state["fcap"])
    except (AttributeError, ImportError):  # a tree without the profile build (the parent's)
        pass
    out["card"] = smi
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "split.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("slab", "explain", "verify", "verify_stacked",
                                   "decode_fairness")}))
    print(json.dumps({"decode_fairness": {
        k: {f: v.get(f) for f in ("host_ms_median", "device_ops", "device_ms_sum", "events_ms",
                                  "alone_ms", "bound_ms", "share_of_bound_alone")}
        for k, v in out["decode_fairness"].items()}}))
    print(smi)
    return 0


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
            kj_ms, kj = cuda_ms_quiet(lambda: explain_round(*xin, kcap=kcap, fcap=fcap),
                                      reps=SPLIT_REPS)
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
            kh_ms, kh = cuda_ms_quiet(lambda: apply_delta(*a, **akw), reps=SPLIT_REPS)
            kh_plain_ms, kh_plain = cuda_ms(lambda: apply_delta_plain(*a, **akw), reps=3)
            err_kh = problems_equal(kh, kh_plain, "K-H replay vs plain")
            ki_ms, ki = cuda_ms(lambda: verify_round(*last["vin"]), reps=10)
            ki_plain_ms, ki_p = cuda_ms(lambda: V.verify_kernel_plain(*last["vin"]), reps=3)
            err_ki = max_err(ki, ki_p)
            adversarial = adversarial_checks(replay["slab"], xin, kcap, fcap, last["vin"])
            kh_turns = slab_in_turns(replay["slab"])
            split = kernel_split(dict(slab=replay["slab"], xin=xin, kcap=kcap, fcap=fcap,
                                      vin=last["vin"]))
            kj_floor = split["chain"]
    finally:
        V.disarm_default(vtok)
        X.disarm_default(etok)

    N, R = (int(x) for x in dp.node_total.shape)
    Q = int(result.q_alloc.shape[0])
    T = int(dp.compat_pre_type.shape[1])
    kh_b = bound_ms(slab_bytes(replay["slab"]), 0)
    kh_copies = bound_ms(slab_bytes(replay["slab"]) + slab_copy_bytes(replay["slab"]), 0)
    ki_b = bound_ms(verify_bytes(last["vin"]), 0)
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
    rows[0].update(library_ms=kh_turns["library_mean_ms"], bound_with_copies_ms=kh_copies[0],
                   in_turns=kh_turns)
    rows[2].update(chain_floor_ms=kj_floor["chain_floor_ms"], chain=kj_floor)
    rows[1].update(split_fields(split["verify"]))
    log(f"K-H {kh_ms:.4f} ms against its bound {kh_b[0]:.5f} ms ({100 * kh_b[0] / kh_ms:.1f} %) "
        f"and, with the functional copies, {kh_copies[0]:.5f} ms ({100 * kh_copies[0] / kh_ms:.1f} "
        f"%); K-J {kj_ms:.4f} ms against its bound {kj_b[0]:.5f} ms ({kj_b[1]}) and its chain "
        f"floor {kj_floor['chain_floor_ms']:.5f} ms")
    log(f"incremental path kernels: K-H {kh_ms:.4f} ms (plain {kh_plain_ms:.2f}), "
        f"K-I {ki_ms:.4f} ms (plain {ki_plain_ms:.2f}), K-J {kj_ms:.4f} ms "
        f"(plain {kj_plain_ms:.1f}); N={N} G={G} Q={Q} K={K} T={T}")
    return dict(rows=rows, launches=launches, cycles=cycles, checks=checks,
                load_s=load_s, refused=refused, N=N, G=G, Q=Q, K=K, T=T,
                plain_round_s=plain_round_s, adversarial=adversarial, split=split)


# --- the pools path: the multi-pool serving cycle -----------------------------------

# The main world split over 8 pools (bench.py's ARMADA_BENCH_POOLS default):
# seven of 5,700 nodes and one of 10,100, 125,000 queued jobs and 3,125 runs
# each, every job restricted to its pool.  At shape_bucket 8,192 the seven
# small pools pad to 8,192 nodes and stack into one 7-lane launch; the large
# pool pads to 16,384 and dispatches solo in the same window.
POOL_NODES = (5_700,) * 7 + (10_100,)
POOL_BUCKET = 8_192
POOL_STEADY_CYCLES = 3
POOL_BURST = 1_000  # fresh specs per steady cycle, 125 a pool
# the small window the new kernels are held on first: lanes of one shape
# with different data
POOL_LANES_SYNTH = dict(num_nodes=1_000, num_gangs=6_000, num_queues=40, num_runs=400,
                        max_gang_cardinality=8)
POOL_LANES_EVICT = dict(num_nodes=1_500, num_jobs=15_000, num_queues=32, num_runs=4_000, seed=2)


def _stacked_check(name: str, lanes: list, meta: dict, dev, **statics) -> dict:
    """K-E, K-D, K-F, K-I stacked and K-G on `lanes` (device problems of one
    shape) against their plain versions on the card, and K-D's lanes
    against the solo round (K-B), every round at the loop shape `statics`
    asks for."""
    import torch

    from armada_tpu_torch.kernels import lanes as KL
    from armada_tpu_torch.kernels import round as KR
    from armada_tpu_torch.kernels.compact import (
        compact_result_stacked, compact_result_stacked_plain,
    )
    from armada_tpu_torch.kernels.round import schedule_round as round_kernel
    from armada_tpu_torch.kernels.round import schedule_round_stacked as stacked_kernel
    from armada_tpu_torch.kernels.verify import verify_round_stacked
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import (
        round_statics, schedule_round_stacked_plain,
    )
    from armada_tpu_torch.models.problem import COMPACT_ECAP, COMPACT_FCAP

    P = len(lanes)
    st = KL.stack(lanes)
    problems_equal(st, KL.stack_plain(lanes), f"{name}: K-E vs torch.stack")
    kw = dict(meta, **round_statics(st, **statics))
    k = stacked_kernel(st, **kw)
    S = KR.last_cluster_size()
    torch.cuda.synchronize()
    p = schedule_round_stacked_plain(st, **kw)
    torch.cuda.synchronize()
    max_err(k, p)
    if S > 1:
        with uncounted():
            max_err(KR._launch(st, P, shards=1, **kw), p)
    for i, lane in enumerate(lanes):
        solo = round_kernel(lane, **kw)
        max_err(KL.lane_slice(k, i), solo)
        problems_equal(KL.lane_slice(st, i), KL.slice_plain(st, i), f"{name}: K-G lane {i}")
    G, RJ = int(st.g_req.shape[1]), int(st.run_req.shape[1])
    fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)
    real_g = [G - 7 * i for i in range(P)]
    real_r = [RJ - 3 * i for i in range(P)]
    kf = compact_result_stacked(k, real_g, real_r, fcap=fcap, ecap=ecap)
    max_err(kf, compact_result_stacked_plain(k, real_g, real_r, fcap=fcap, ecap=ecap))
    vin = V.verify_inputs(st, k, kf, 0)  # alloc[0] there is lane 0: pass the whole alloc
    ki = verify_round_stacked(*vin[:18], k.alloc, *vin[19:22], real_g)
    ki_plain = torch.stack([
        V.verify_kernel_plain(*V.verify_inputs(lane, KL.lane_slice(k, i), kf[i], real_g[i]))
        for i, lane in enumerate(lanes)
    ])
    max_err(ki, ki_plain)
    info = dict(lanes=P, cluster=S, iterations=[int(x) for x in k.iterations],
                kernel_iters=[int(x) for x in k.kernel_iters],
                scheduled=[int(x) for x in k.scheduled_count],
                evicted=[int(x.sum()) for x in k.run_evicted],
                rescheduled=[int(x.sum()) for x in k.run_rescheduled])
    shape = " ".join(f"{a}={b}" for a, b in statics.items())
    log(f"K-D/K-E/K-F/K-G/K-I stacked [{name}{' ' + shape if shape else ''}]: kernels (K-D at "
        f"S={S}{' and S=1' if S > 1 else ''}) == plain, lanes == solo K-B {info}")
    return info


# The batched copy's adversarial table (K-E and K-G, csrc/lanes.cu): one
# large field of many tiles with an odd length, a zero-byte field, sources
# at odd byte offsets (views into one byte buffer), and 150 tiny fields of
# five dtypes and odd lengths -- 8 lanes, 1,224 descriptors to stack, more
# than one launch's table holds.
ADV_LANES = 8
ADV_TINY = 150
AdversarialTree = collections.namedtuple(
    "AdversarialTree", ["big", "empty", "odd8", "odd16"] + [f"t{k}" for k in range(ADV_TINY)])


def adversarial_lanes(dev, P: int = ADV_LANES) -> list:
    import torch

    dtypes = (np.bool_, np.int32, np.int16, np.float64, np.uint8)
    lanes = []
    for li in range(P):
        rng = np.random.default_rng(100 + li)
        raw = torch.as_tensor(rng.integers(0, 256, 300_017, dtype=np.uint8), device=dev)
        tiny = []
        for k in range(ADV_TINY):
            n, dt = 1 + (k * 37) % 301, dtypes[k % len(dtypes)]
            tiny.append(torch.as_tensor(rng.integers(0, 2 if dt is np.bool_ else 100, n).astype(dt),
                                        device=dev))
        lanes.append(AdversarialTree(
            torch.as_tensor(rng.standard_normal(1_000_003).astype(np.float32), device=dev),
            torch.zeros((0, 3), dtype=torch.float64, device=dev),
            raw[1 + li:100_002 + li],
            raw[2 + 2 * li:200_004 + 2 * li].view(torch.int16),
            *tiny,
        ))
    return lanes


def check_lane_copies(dev) -> dict:
    """K-E and K-G on the adversarial lanes against torch.stack and
    t[i].clone() per field, bit for bit, and no output aliasing an input."""
    from armada_tpu_torch.kernels import lanes as KL

    lanes = adversarial_lanes(dev)
    st = KL.stack(lanes)
    problems_equal(st, KL.stack_plain(lanes), "adversarial lanes: K-E vs torch.stack")
    inputs = {t.data_ptr() for tree in lanes for t in tree if t.numel()}
    for i in range(len(lanes)):
        sl = KL.lane_slice(st, i)
        problems_equal(sl, KL.slice_plain(st, i), f"adversarial lanes: K-G lane {i}")
        if any(t.numel() and t.data_ptr() in inputs for t in sl):
            raise AssertionError("adversarial lanes: a K-G output aliases an input")
    if any(t.numel() and t.data_ptr() in inputs for t in st):
        raise AssertionError("adversarial lanes: a K-E output aliases an input")
    _, table = KL.stack_plan(lanes)
    info = dict(lanes=len(lanes), fields=len(lanes[0]), descriptors=len(table),
                words=np.bincount(table["wlog"], minlength=5).tolist())
    log(f"K-E/K-G [adversarial lanes]: kernels == plain, bit for bit {info} (descriptors by "
        f"word size 1, 2, 4, 8, 16 bytes)")
    return info


def check_pool_kernels(dev) -> dict:
    """The kernels of the pools path against their plain versions on the
    card, on small windows of lanes with one shape and different data: K-E
    and K-G on the adversarial lanes; K-A with a lane axis; then gang
    lanes (synthetic_problem, three seeds) and eviction lanes (one eviction
    world, each lane with other queue weights and node and gang masks, so
    phase B runs in every lane)."""
    import torch

    from armada_tpu_torch.kernels.fair_shares import fair_shares, fair_shares_lanes_plain
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem

    out = dict(adversarial=check_lane_copies(dev))
    rng = np.random.default_rng(11)
    for P, Q in ((3, 29), (7, 64), (4, 8193)):
        w = torch.as_tensor(rng.choice([0.0, 0.5, 1.0, 2.0, 3.7], (P, Q)).astype(np.float32),
                            device=dev)
        c = torch.as_tensor((rng.random((P, Q)) * 0.1).astype(np.float32), device=dev)
        for x, y in zip(fair_shares(w, c), fair_shares_lanes_plain(w, c)):
            max_err(x, y)
    log("K-A fair_shares with a lane axis (P x Q = 3x29, 7x64, 4x8193): kernel == plain")
    lanes, meta = [], None
    for seed in range(3):
        prob, meta = synthetic_problem(**POOL_LANES_SYNTH, seed=seed)
        lanes.append(problem_from_numpy(prob, dev))
    out["gangs"] = _stacked_check("gang lanes", lanes, meta, dev)
    base, ctx = world_problem(POOL_LANES_EVICT, protected=0.0)
    lanes = _lanes_of(problem_from_numpy(base, dev), 4)
    out["evict"] = _stacked_check("eviction lanes", lanes, round_meta(ctx), dev)
    if min(out["evict"]["evicted"]) == 0 or min(out["evict"]["rescheduled"]) == 0:
        raise AssertionError(f"the eviction lanes must evict and reschedule: {out['evict']}")
    return out


def pools_world(world: dict, dev, pool_nodes=POOL_NODES, bucket: int = POOL_BUCKET):
    """(config, jdb, feed, algo, executors, names) for `world` split into
    pools of `pool_nodes` nodes each (the main world's 8-pool split by
    default), its jobs and runs loaded through a JobDb with an
    IncrementalProblemFeed attached (`load_algo`)."""
    from armada_tpu_torch.core.config import PoolConfig

    config, nodes, queues, specs, running, _ = world["world"]
    names = [f"pool{i}" for i in range(len(pool_nodes))]
    cfg = dataclasses.replace(config, pools=tuple(PoolConfig(n) for n in names),
                              shape_bucket=bucket)
    starts = np.concatenate([[0], np.cumsum(pool_nodes)])
    if starts[-1] != len(nodes):
        raise AssertionError(f"the pools split {starts[-1]} nodes, the world has {len(nodes)}")
    pool_nodes = [
        [dataclasses.replace(n, pool=names[p]) for n in nodes[starts[p]:starts[p + 1]]]
        for p in range(len(names))
    ]
    per_pool = len(specs) // len(names)
    runs_per_pool = len(running) // len(names)
    runs = []
    for i, r in enumerate(running):
        pn = pool_nodes[min(i // runs_per_pool, len(names) - 1)]
        runs.append(dataclasses.replace(r, node_id=pn[int(r.node_id[1:]) % len(pn)].id))
    jdb, feed, algo, executors = load_algo(
        cfg, [n for pn in pool_nodes for n in pn], queues, specs, runs, dev,
        pool_of=lambda i: names[min(i // per_pool, len(names) - 1)], run_tag="prun",
        collect_stats=False, now_ns=POOL_NOW_NS)
    return algo.config, jdb, feed, algo, executors, names


POOL_NOW_NS = 10**12


def _seven_lane_stack(feed, names):
    """The 7-lane group this cycle stacked: (kernel kwargs, per-pool device
    problems, stacked problem), the stack memo's entry whose lanes are the
    seven small pools' resident problems."""
    from armada_tpu_torch import models as M

    resident = [feed.devcache_for(n).resident for n in names[:7]]
    found = [(dict(key[0]), dps, st) for key, (dps, st) in M._STACK_CACHE.items()
             if len(dps) == 7 and all(a is b for a, b in zip(dps, resident))]
    if len(found) != 1:
        raise AssertionError(f"expected one 7-lane stack of this cycle, found {len(found)}")
    return found[0]


def _replay_turns(kernel, library) -> tuple:
    """K-E or K-G in turns with its library call, by the replay's method:
    library, kernel, kernel, library, each `cuda_ms` over 3 calls after a
    warm-up, with the cudaMalloc calls and collector passes of each turn
    (its warm-up included).  Returns (the turns, the last kernel result)."""
    import torch

    turns, out = dict(ms=[], cuda_mallocs=[], gc_passes=[]), None
    for fn in (library, kernel, kernel, library):
        m0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
        g0 = sum(g["collections"] for g in gc.get_stats())
        ms, res = cuda_ms(fn, reps=3)
        turns["ms"].append(ms)
        turns["cuda_mallocs"].append(torch.cuda.memory_stats().get("num_device_alloc", 0) - m0)
        turns["gc_passes"].append(sum(g["collections"] for g in gc.get_stats()) - g0)
        if fn is kernel:
            out = res
    return turns, out


def _replay_stack(kk: dict, dps, stacked) -> dict:
    """Device times of the cycle's stacked kernels on its own state (CUDA
    events), and of the seven solo K-B rounds they replace."""
    from armada_tpu_torch.kernels import lanes as KL
    from armada_tpu_torch.kernels.compact import compact_result_stacked
    from armada_tpu_torch.kernels.round import schedule_round as round_kernel
    from armada_tpu_torch.kernels.verify import verify_round_stacked
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import (
        resolve_round_statics, schedule_round_stacked,
    )
    from armada_tpu_torch.models.problem import COMPACT_ECAP, COMPACT_FCAP

    with uncounted():
        ke, st = _replay_turns(lambda: KL.stack(dps), lambda: KL.stack_plain(dps))
        kd_ms, res = cuda_ms(lambda: schedule_round_stacked(stacked, **kk), reps=1)
        kw = dict(kk, max_iterations=resolve_round_statics(dps[0]))
        solo_ms = [cuda_ms(lambda d=d: round_kernel(d, **kw), reps=1)[0] for d in dps]
        P = len(dps)
        G, RJ = int(stacked.g_req.shape[1]), int(stacked.run_req.shape[1])
        fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)
        kf_ms, kf = cuda_ms(
            lambda: compact_result_stacked(res, [G] * P, [RJ] * P, fcap=fcap, ecap=ecap), reps=5)
        vin = V.verify_inputs(stacked, res, kf, 0)
        vargs = (*vin[:18], res.alloc, *vin[19:22], [G] * P)
        ki_ms, ki = cuda_ms(lambda: verify_round_stacked(*vargs), reps=5)
        kg, _ = _replay_turns(lambda: KL.lane_slice(stacked, P - 1),
                              lambda: KL.slice_plain(stacked, P - 1))
    return dict(stack_ms=(ke["ms"][1] + ke["ms"][2]) / 2, stack_turns=ke,
                stacked_round_ms=kd_ms, solo_round_ms=solo_ms,
                solo_round_sum_ms=sum(solo_ms), compact_stacked_ms=kf_ms,
                verify_stacked_ms=ki_ms, lane_slice_ms=(kg["ms"][1] + kg["ms"][2]) / 2,
                lane_slice_turns=kg,
                iterations=[int(x) for x in res.iterations], state=(st, res, kf, ki, vargs))


class lane_call_times:
    """Times every K-E and K-G call made inside it (the wrappers in
    kernels/lanes.py, which the path imports at each call): the host's
    milliseconds around the call -- checks, the arena's allocation, the
    table, the enqueue -- and the stream's between CUDA events recorded
    around it, with the caching allocator's cudaMalloc calls and retries
    (a retry frees the cached blocks first) and the Python collector's
    passes inside the call, each with its generation and milliseconds
    (gc.callbacks).  Beside each call its library equivalent (torch.stack /
    t[i].clone() per field, the plain versions, which launch no kernel of
    the port) runs on the same inputs and is timed the same way: before
    the call on even calls, after it on odd ones; its result is dropped.
    `summary()`, after a synchronize, gives count, sums and largest."""

    NAMES = ("stack", "lane_slice")

    def __init__(self):
        self.calls = {n: [] for n in self.NAMES}
        self.gc_marks: list = []

    def _on_gc(self, phase, info):
        self.gc_marks.append((phase, info["generation"], time.perf_counter()))

    def _once(self, fn, a, kw):
        import torch

        g0 = len(self.gc_marks)
        m0 = torch.cuda.memory_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t = time.perf_counter()
        out = fn(*a, **kw)
        host_ms = (time.perf_counter() - t) * 1e3
        e1.record()
        m1 = torch.cuda.memory_stats()
        marks = self.gc_marks[g0:]
        passes = [gen for phase, gen, _ in marks if phase == "start"]
        gc_ms = 1e3 * (sum(t for phase, _, t in marks if phase == "stop")
                       - sum(t for phase, _, t in marks if phase == "start"))
        return out, dict(host_ms=host_ms, events=(e0, e1), gc_passes=passes, gc_ms=gc_ms, **{
            n: m1.get(k, 0) - m0.get(k, 0)
            for n, k in (("cuda_mallocs", "num_device_alloc"), ("alloc_retries", "num_alloc_retries"))})

    def __enter__(self):
        from armada_tpu_torch.kernels import lanes as KL

        self.saved = {n: getattr(KL, n) for n in self.NAMES}
        plain = dict(stack=KL.stack_plain, lane_slice=KL.slice_plain)

        def timed(name, fn):
            def call(*a, **kw):
                library_first = len(self.calls[name]) % 2 == 0
                if library_first:
                    lib = self._once(plain[name], a, kw)[1]
                out, rec = self._once(fn, a, kw)
                if not library_first:
                    lib = self._once(plain[name], a, kw)[1]
                self.calls[name].append((rec, lib))
                return out
            return call

        for name, fn in self.saved.items():
            setattr(KL, name, timed(name, fn))
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        from armada_tpu_torch.kernels import lanes as KL

        gc.callbacks.remove(self._on_gc)
        for name, fn in self.saved.items():
            setattr(KL, name, fn)
        return False

    @staticmethod
    def _sum(recs: list) -> dict:
        stream = [r["events"][0].elapsed_time(r["events"][1]) for r in recs]
        gens = [g for r in recs for g in r["gc_passes"]]
        return dict(host_ms_sum=sum(r["host_ms"] for r in recs),
                    host_ms_max=max((r["host_ms"] for r in recs), default=0.0),
                    stream_ms=stream, stream_ms_max=max(stream, default=0.0),
                    cuda_mallocs=sum(r["cuda_mallocs"] for r in recs),
                    alloc_retries=sum(r["alloc_retries"] for r in recs),
                    gc_passes=len(gens), gc_generations=[gens.count(g) for g in range(3)],
                    gc_ms=sum(r["gc_ms"] for r in recs),
                    host_ms_without_gc_max=max((r["host_ms"] - r["gc_ms"] for r in recs),
                                               default=0.0))

    def summary(self) -> dict:
        return {name: dict(calls=len(calls), kernel=self._sum([c[0] for c in calls]),
                           library=self._sum([c[1] for c in calls]))
                for name, calls in self.calls.items()}


def _pool_arm(dev, world: dict, fresh_by_cycle: list, parallel: bool) -> dict:
    """One arm of the pools path: the world loaded, a fill cycle and
    POOL_STEADY_CYCLES steady cycles of FairSchedulingAlgo.schedule, each
    submitting its fresh specs (`fresh_by_cycle[c - 1]`, the same in both
    arms) and committed.  Returns per-cycle decisions and timings."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch import models as M
    from armada_tpu_torch.jobdb.job import Job
    from armada_tpu_torch.models import explain as X
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.scheduler.pool_serving import (
        pool_serving_stats, reset_pool_serving_stats,
    )

    arm = "parallel" if parallel else "serial"
    os.environ["ARMADA_POOL_PARALLEL"] = "1" if parallel else "0"
    t0 = time.perf_counter()
    cfg, jdb, feed, algo, executors, names = pools_world(world, dev)
    load_s = time.perf_counter() - t0
    log(f"pools path [{arm}]: 8 pools loaded through the JobDb in {load_s:.1f} s")
    # host time of applying the decisions back (the txn upserts) and of the
    # feed overlays that follow each pool's apply, per cycle
    host = dict(apply_s=0.0, overlay_s=0.0)

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t
        return wrapper

    algo._apply_outcome = timed(algo._apply_outcome, "apply_s")
    feed.overlay = timed(feed.overlay, "overlay_s")
    reset_pool_serving_stats()
    M.reset_stack_cache()
    V.reset_verify_state()
    X.reset_cadence()
    vtok = V.arm_default(True)
    etok = X.arm_default(EXPLAIN_INTERVAL)
    cycles, decisions = [], []
    try:
        kernels.reset_launches()
        for c in range(1 + POOL_STEADY_CYCLES):
            txn = jdb.write_txn()
            if c:
                fresh = fresh_by_cycle[c - 1]
                per = POOL_BURST // len(names)
                txn.upsert([
                    Job(spec=dataclasses.replace(s, pools=(names[i // per],)), queued=True,
                        validated=True, pools=(names[i // per],))
                    for i, s in enumerate(fresh)
                ])
            before = pool_serving_stats().snapshot()
            host.update(apply_s=0.0, overlay_s=0.0)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            with lane_call_times() as lane_calls:
                res = algo.schedule(txn, executors, POOL_NOW_NS)
            torch.cuda.synchronize(dev)
            sched_s = time.perf_counter() - t1
            t2 = time.perf_counter()
            txn.commit()
            commit_s = time.perf_counter() - t2
            snap = pool_serving_stats().snapshot()
            cyc = dict(
                cycle=c, schedule_s=sched_s, commit_s=commit_s, **host,
                scheduled=len(res.scheduled), preempted=len(res.preempted),
                stacked_launches=snap["stacked_launches"] - before["stacked_launches"],
                stacked_pools=snap["stacked_pools"] - before["stacked_pools"],
                overlap_ratio=snap["last_overlap_ratio"],
                pool_round_s={ps.pool: ps.round_s for ps in res.pools},
                explained=sum(ps.outcome.explain is not None for ps in res.pools),
                lane_calls=lane_calls.summary(),
            )
            decisions.append((
                [(job.id, run.id, run.node_id) for job, run in res.scheduled],
                sorted(job.id for job, _ in res.preempted),
                [(ps.pool, len(ps.outcome.scheduled)) for ps in res.pools],
            ))
            if parallel:
                with uncounted():
                    kk, dps, stacked = _seven_lane_stack(feed, names)
                    rep = _replay_stack(kk, dps, stacked)
                cyc.update({k: v for k, v in rep.items() if k != "state"})
                cyc["replay_state"] = (kk, dps, stacked, rep["state"])
            cycles.append(cyc)
            line = (f"pools cycle {c} [{arm}]: schedule {sched_s:.3f} s (of it decisions applied "
                    f"to the txn {host['apply_s']:.3f} s, feed overlays {host['overlay_s']:.3f} s), "
                    f"commit {commit_s:.3f} s; scheduled {cyc['scheduled']} preempted {cyc['preempted']}; stacked "
                    f"launches {cyc['stacked_launches']} covering {cyc['stacked_pools']} pools; "
                    f"overlap ratio {cyc['overlap_ratio']}; per-pool round s "
                    + " ".join(f"{p}={s:.3f}" for p, s in cyc["pool_round_s"].items()))
            log(line)
            if parallel:
                log(f"pools cycle {c} [{arm}] kernels: K-D {cyc['stacked_round_ms']:.2f} ms vs "
                    f"7 solo K-B {cyc['solo_round_sum_ms']:.2f} ms (each "
                    + " ".join(f"{x:.2f}" for x in cyc["solo_round_ms"])
                    + f"), K-E {cyc['stack_ms']:.3f} ms, K-F {cyc['compact_stacked_ms']:.4f} ms, "
                    f"K-G {cyc['lane_slice_ms']:.3f} ms, K-I stacked "
                    f"{cyc['verify_stacked_ms']:.4f} ms; lane iterations {cyc['iterations']}; "
                    f"replayed in turns (library, kernel, kernel, library; 3 calls each) "
                    + ", ".join(
                        f"{k} " + " ".join(f"{v:.3f}" for v in t["ms"]) + " ms (cudaMalloc "
                        + " ".join(map(str, t["cuda_mallocs"])) + ", collector passes "
                        + " ".join(map(str, t["gc_passes"])) + ")"
                        for k, t in (("K-E", cyc["stack_turns"]), ("K-G", cyc["lane_slice_turns"]))))
                for n, d in cyc["lane_calls"].items():
                    log(f"pools cycle {c} [{arm}] {n} calls inside the cycle: {d['calls']}; "
                        + "; ".join(
                            f"{who} host {x['host_ms_sum']:.3f} ms in all, largest "
                            f"{x['host_ms_max']:.3f} ms ({x['host_ms_without_gc_max']:.3f} ms "
                            f"without the collector), stream ms "
                            + " ".join(f"{v:.3f}" for v in x["stream_ms"])
                            + f", cudaMalloc {x['cuda_mallocs']}, allocator retries "
                            f"{x['alloc_retries']}, collector passes {x['gc_passes']} (by "
                            f"generation {x['gc_generations']}) {x['gc_ms']:.3f} ms"
                            for who, x in (("kernel", d["kernel"]), ("library", d["library"]))))
        launches = dict(kernels.LAUNCHES)
        snap = pool_serving_stats().snapshot()
        padded = {n: dict(N=int(feed.devcache_for(n).resident.node_total.shape[0]),
                          G=int(feed.devcache_for(n).resident.g_req.shape[0]),
                          RJ=int(feed.devcache_for(n).resident.run_req.shape[0]))
                  for n in (names[0], names[-1])}
        if V.verify_state().failures or V.verify_state().rounds < 8 * (1 + POOL_STEADY_CYCLES):
            raise AssertionError(f"pools path verification: {V.verify_state().snapshot()}")
    finally:
        V.disarm_default(vtok)
        X.disarm_default(etok)
        os.environ.pop("ARMADA_POOL_PARALLEL", None)
    log(f"pools path [{arm}] launches: {launches}; pool serving {snap}; padded shapes {padded}")
    return dict(arm=arm, load_s=load_s, cycles=cycles, decisions=decisions, launches=launches,
                serving=snap, padded=padded)


LANE_REPS = 20
L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2


def launch_ms(fn, mode: str, flush, reps: int = LANE_REPS, spin: int = 3_000_000) -> float:
    """Median device milliseconds of fn() alone, CUDA events around each
    call.  mode "cold": `flush` is read before each call, so the L2 holds
    none of fn's bytes and no dirty lines to write back, then a short spin
    kernel lets the host enqueue the call before the card reaches it (else
    a slow host's enqueue lands between the events); "hot": back to back
    behind one long spin kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    if mode == "hot":
        torch.cuda._sleep(spin)
    marks = []
    for _ in range(reps):
        if mode == "cold":
            flush.view(torch.int64).sum()
            torch.cuda._sleep(400_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


def host_ms(fn, reps: int = LANE_REPS) -> list:
    """Host milliseconds of single calls of fn (the stream drained before
    each)."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return out


def _one_copy(src, dst, nbytes: int) -> np.ndarray:
    """A one-descriptor table of the batched copy."""
    from armada_tpu_torch.kernels import lanes as KL

    table = np.zeros(1, KL.DESC)
    table["src"], table["dst"], table["bytes"], table["wlog"] = src, dst, nbytes, 4
    return table


def lanes_one_form_library():
    """csrc/lanes.cu alone, built with -DLANES_CAP_SMALL=1000 so that every
    table launches the 32 KB block of kernel parameters (the shipped build
    launches a table of up to 120 rows from a 4 KB block), loaded with
    ctypes: the yardstick of the small form."""
    import ctypes

    from armada_tpu_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / f"liblanes-one-form-{kbuild._digest()}.so"
    if not out.exists():
        done = subprocess.run(
            [kbuild._nvcc(), *kbuild.FLAGS, "-DLANES_CAP_SMALL=1000", "-shared",
             "-o", str(out), str(kbuild.SRC_DIR / "lanes.cu")],
            capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc of the one-form lanes build failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.armada_lanes_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.armada_lanes_copy.restype = ctypes.c_int
    return lib


def lanes_forms(table, flush) -> dict:
    """K-G's table launched by the shipped build (its 4 KB block) and by
    the one-form build (32 KB), in turns (shipped, one form, one form,
    shipped): the launch alone cold and hot (`launch_ms`) and the host's
    enqueue (`host_ms`), medians."""
    from armada_tpu_torch.kernels import lanes as KL
    from armada_tpu_torch.kernels.build import check, stream_handle

    one = lanes_one_form_library()

    def one_form():
        check(one.armada_lanes_copy(table.ctypes.data, len(table), stream_handle()),
              "lanes copy kernel (one form)")

    def shipped():
        KL._copy(table)

    out = {}
    for key, fn in (("shipped", shipped), ("one_form", one_form), ("one_form", one_form),
                    ("shipped", shipped)):
        out.setdefault(key, []).append(dict(
            cold_ms=launch_ms(fn, "cold", flush), hot_ms=launch_ms(fn, "hot", flush),
            host_ms=float(np.median(host_ms(fn)))))
    log(f"lane_slice: K-G's {len(table)}-row table from the shipped build's 4 KB parameter "
        f"block against the one-form build's 32 KB, in turns, ms: "
        + "; ".join(f"{k} cold {x['cold_ms']:.4f} hot {x['hot_ms']:.4f} host {x['host_ms']:.4f}"
                    for k in ("shipped", "one_form") for x in out[k]))
    return out


def lanes_in_turns(dps, stacked, ke_bound_ms: float, kg_bound_ms: float) -> dict:
    """K-E and K-G on the pools path's own inputs (the seven lanes; lane
    P - 1 of their stack), in turns with their one-call library equivalents
    (torch.stack per field, t[i].clone() per field -- also the plain
    versions): library, kernel, kernel, library, each the mean of LANE_REPS
    calls after a warm-up (CUDA events around the calls, so a host-bound
    call counts its host time).  Then the launch alone with its table
    prebuilt, cold and hot (`launch_ms`), against the bound and beside two
    yardsticks: torch's copy_ of the same bytes as one contiguous buffer,
    and the kernel on one 16-byte descriptor (the launch's floor); and the
    host time of single calls, of their plans and of the launch alone."""
    import torch

    from armada_tpu_torch.kernels import lanes as KL

    P = len(dps)
    dev = stacked.node_total.device
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {}
    for name, kernel, library, plan, bound in (
        ("stack", lambda: KL.stack(dps), lambda: KL.stack_plain(dps),
         lambda: KL.stack_plan(dps), ke_bound_ms),
        ("lane_slice", lambda: KL.lane_slice(stacked, P - 1), lambda: KL.slice_plain(stacked, P - 1),
         lambda: KL.slice_plan(stacked, P - 1), kg_bound_ms),
    ):
        lib1 = cuda_ms(library, LANE_REPS)[0]
        k1 = cuda_ms(kernel, LANE_REPS)[0]
        k2 = cuda_ms(kernel, LANE_REPS)[0]
        lib2 = cuda_ms(library, LANE_REPS)[0]
        call_host = host_ms(kernel)
        plan_host = host_ms(plan)
        target, table = plan()  # `target`: the arena the table writes into, kept alive
        launch_host = host_ms(lambda: KL._copy(table))
        cold = launch_ms(lambda: KL._copy(table), "cold", flush)
        hot = launch_ms(lambda: KL._copy(table), "hot", flush)
        form = lanes_forms(table, flush) if name == "lane_slice" else None
        nbytes = int(table["bytes"].sum())
        src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ref = launch_ms(lambda: dst.copy_(src), "cold", flush)
        floor_table = _one_copy(src.data_ptr(), dst.data_ptr(), 16)
        floor = launch_ms(lambda: KL._copy(floor_table), "cold", flush)
        del target, src, dst
        out[name] = dict(
            kernel_ms=[k1, k2], library_ms=[lib1, lib2], ms=(k1 + k2) / 2,
            library_mean_ms=(lib1 + lib2) / 2, host_call_ms_median=float(np.median(call_host)),
            host_call_ms_max=max(call_host), host_plan_ms_median=float(np.median(plan_host)),
            host_launch_ms_median=float(np.median(launch_host)), launch_cold_ms=cold,
            launch_hot_ms=hot, bound_ms=bound, bound_share_cold=bound / cold,
            bound_share_hot=bound / hot, copy_ref_cold_ms=copy_ref, floor_cold_ms=floor,
            bytes_copied=nbytes, descriptors=len(table),
            words=np.bincount(table["wlog"], minlength=5).tolist(), forms=form,
        )
        log(f"{name} in turns on the pools path's inputs, ms a call over {LANE_REPS} calls: "
            f"library {lib1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, library {lib2:.4f}")
        log(f"{name}: the launch alone, table prebuilt ({len(table)} descriptors, {nbytes:,} "
            f"bytes): cold {cold:.4f} ms ({100 * bound / cold:.1f} % of the bound {bound:.5f} "
            f"ms), hot {hot:.4f} ms ({100 * bound / hot:.1f} %); torch copy_ of the same bytes "
            f"in one buffer, cold, {copy_ref:.4f} ms; the launch's floor (16 bytes), cold, "
            f"{floor:.4f} ms; host ms of one call: median {np.median(call_host):.4f}, largest "
            f"{max(call_host):.4f}, of it the plan {np.median(plan_host):.4f} and the launch "
            f"{np.median(launch_host):.4f}")
    return out


def pools_path(dev, world: dict, small: dict) -> dict:
    """The multi-pool serving cycle at full width: FairSchedulingAlgo over
    an IncrementalProblemFeed attached to a JobDb, 8 pools, with
    ARMADA_POOL_PARALLEL=1 (shape-matched pools stacked: K-E, K-D, K-F, the
    stacked K-I, K-G on explain rounds) and =0 (the serial loop), the same
    decisions on every cycle.  The new kernels are held against their plain
    versions on small windows first (`small`: check_pool_kernels' report,
    run before the main path to fail fast), then on a steady cycle's own
    state here."""
    import torch

    from armada_tpu_torch.kernels import lanes as KL
    from armada_tpu_torch.kernels.compact import (
        compact_result_stacked, compact_result_stacked_plain,
    )
    from armada_tpu_torch.kernels.verify import verify_round_stacked, verify_round_stacked_plain
    from armada_tpu_torch.models.fair_scheduler import schedule_round_stacked_plain

    spec_factory = world["world"][5]
    fresh_by_cycle = [spec_factory(POOL_BURST, 1e6 + 100.0 * c)
                      for c in range(1, 1 + POOL_STEADY_CYCLES)]
    t0 = time.perf_counter()
    par = _pool_arm(dev, world, fresh_by_cycle, parallel=True)
    ser = _pool_arm(dev, world, fresh_by_cycle, parallel=False)
    wall_s = time.perf_counter() - t0
    for c, (a, b) in enumerate(zip(par["decisions"], ser["decisions"])):
        if a != b:
            raise AssertionError(f"pools cycle {c}: the parallel and serial arms decide differently")
    n_cycles = 1 + POOL_STEADY_CYCLES
    for cyc in par["cycles"]:
        if cyc["stacked_launches"] < 1 or cyc["stacked_pools"] != 7:
            raise AssertionError(f"pools cycle {cyc['cycle']}: no 7-lane stacked launch: {cyc}")
    if par["serving"]["parallel_cycles"] != n_cycles or ser["serving"]["parallel_cycles"] != 0:
        raise AssertionError(f"parallel cycles: {par['serving']} / {ser['serving']}")
    if not all(cyc["scheduled"] > 0 for cyc in par["cycles"]):
        raise AssertionError("a pools cycle scheduled nothing")
    launches = par["launches"]
    for k in ("round_stacked", "stack", "compact_stacked", "verify_stacked", "lane_slice",
              "round", "compact", "verify", "slab", "fair_shares", "explain"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the pools path")
    log(f"pools path: {n_cycles} cycles, both arms decide the same; parallel arm stacked 7 "
        f"pools every cycle")

    # the last steady cycle's stacked kernels against their plain versions,
    # on the cycle's own state
    cyc = par["cycles"][-1]
    kk, dps, stacked, (st, res, kf, ki, vargs) = cyc.pop("replay_state")
    for other in par["cycles"][:-1]:
        other.pop("replay_state", None)
    from armada_tpu_torch.models.fair_scheduler import resolve_round_statics

    from armada_tpu_torch.models.fair_scheduler import round_statics

    rkw = {k: kk[k] for k in ("num_levels", "max_slots", "slot_width")}
    rkw.update(round_statics(stacked, **{k: v for k, v in kk.items() if k not in rkw}))
    kd_turns = forms_in_turns(stacked, rkw, lanes=len(dps))
    kd_turns.pop("result")
    log(f"pools path: K-D's {len(dps)} lanes at S=1 {kd_turns['single_ms']} ms, at the owner's "
        f"S={kd_turns['S']} {kd_turns['chosen_ms']} ms in turns; equal in every field")
    with uncounted():
        kw = dict(kk, max_iterations=resolve_round_statics(stacked))
        ke_plain = KL.stack_plain(dps)
        err_ke = problems_equal(st, ke_plain, "pools: K-E vs torch.stack")
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        kd_plain = schedule_round_stacked_plain(stacked, **kw)
        torch.cuda.synchronize(dev)
        kd_plain_ms = (time.perf_counter() - t1) * 1e3
        err_kd = max_err(res, kd_plain)
        P = len(dps)
        G, RJ = int(stacked.g_req.shape[1]), int(stacked.run_req.shape[1])
        from armada_tpu_torch.models.problem import COMPACT_ECAP, COMPACT_FCAP

        fcap, ecap = min(G, COMPACT_FCAP), min(RJ, COMPACT_ECAP)
        kf_plain_ms, kf_plain = cuda_ms(
            lambda: compact_result_stacked_plain(res, [G] * P, [RJ] * P, fcap=fcap, ecap=ecap),
            reps=1)
        err_kf = max_err(kf, kf_plain)
        vplain_args = (*vargs[:18], res.alloc[:, 0], *vargs[19:22])
        ki_plain_ms, ki_plain = cuda_ms(
            lambda: verify_round_stacked_plain(vplain_args, vargs[22]), reps=1)
        err_ki = max_err(ki, ki_plain)
        if int(ki[:, 1].abs().sum()) != 0:
            raise AssertionError(f"pools: the stacked verification flags the cycle: {ki}")
        kg_plain = KL.slice_plain(stacked, P - 1)
        err_kg = problems_equal(KL.lane_slice(stacked, P - 1), kg_plain, "pools: K-G vs plain")
    log(f"pools path: the last steady cycle's K-E, K-D, K-F, K-I stacked and K-G equal their "
        f"plain versions on the card (plain K-D {kd_plain_ms:.1f} ms)")

    # bounds: K-D as K-B's per lane (inputs once, outputs once, per
    # iteration two allocatable rows of every node and the live queues'
    # cursor windows), summed over the lanes; the copies and K-F / K-I read
    # and write their bytes once
    N, R = (int(x) for x in stacked.node_total.shape[1:])
    prob_bytes = tensor_bytes(*stacked)
    out_bytes = tensor_bytes(*res)
    iters = sum(cyc["iterations"])
    live_q = sum(int((d.q_len > 0).sum()) for d in dps)
    per_iter = 2 * N * R * 4
    kd_b = bound_ms(prob_bytes + out_bytes + iters * per_iter + live_q * 16 * 13 * max(cyc["iterations"]),
                    iters * 2 * N * R * 6)
    ke_b = bound_ms(2 * prob_bytes, 0)
    kg_b = bound_ms(2 * prob_bytes // P, 0)
    kf_b = compact_bound(res, kf)
    ki_b = bound_ms(verify_bytes(vargs), 0)
    with uncounted():
        turns = lanes_in_turns(dps, stacked, ke_b[0], kg_b[0])
        ki_split = verify_split("K-I stacked split (the pools path's stack)",
                                lambda: verify_round_stacked(*vargs), vargs)
        kf_split = split_bound(
            "K-F split (the pools path's stack)",
            lambda: compact_result_stacked(res, [G] * P, [RJ] * P, fcap=fcap, ecap=ecap), kf_b)
    ke, kg = turns["stack"], turns["lane_slice"]
    rows = []
    for name, ms, pms, err, (bms, by), lib in (
        ("round_stacked", cyc["stacked_round_ms"], kd_plain_ms, err_kd, kd_b, None),
        ("stack", ke["ms"], ke["library_mean_ms"], err_ke, ke_b, ke["library_mean_ms"]),
        ("compact_stacked", cyc["compact_stacked_ms"], kf_plain_ms, err_kf, kf_b, None),
        ("lane_slice", kg["ms"], kg["library_mean_ms"], err_kg, kg_b, kg["library_mean_ms"]),
        ("verify_stacked", cyc["verify_stacked_ms"], ki_plain_ms, err_ki, ki_b, None),
    ):
        src, rep = SOURCES[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=err, equal=err == 0.0, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=lib,
        ))
    rows[4].update(split_fields(ki_split))
    rows[2].update(split_fields(kf_split))
    for arm in (par, ser):
        arm.pop("decisions")
    return dict(rows=rows, small=small, parallel=par, serial=ser, wall_s=wall_s,
                N=N, G=G, RJ=RJ, P=P, lanes_in_turns=turns, stacked_round_turns=kd_turns)


# --- the market path ---------------------------------------------------------------

# bench.py's market deployment (ARMADA_BENCH_MARKET=1): the pool "default",
# market driven with spot_price_cutoff 0.9, 8 price bands; a fill cycle and
# MARKET_STEADY_CYCLES steady cycles of MARKET_BURST fresh specs each
MARKET_WORLD = dict(num_nodes=50_000, num_jobs=1_000_000, num_queues=64, num_runs=25_000,
                    seed=7, market=True)
MARKET_STEADY_CYCLES = 3
MARKET_BURST = 1_000
MARKET_OVERRIDES = 8  # queues whose fair-share weight the override provider changes
MARKET_NOW_NS = 10**12
# the steady cycle on which four queues' band-0 bids move (a new provider):
# the builder re-permutes its market tables and the round must still equal
# its plain version and the resident problem the host tables -- on that
# cycle's full upload and on the next cycle's scatter (K-H's plan cache
# across the move)
MARKET_PRICE_MOVE = 2
# the small-world checks: KB_MARKET's world through both routes, a
# two-pool world with overrides and the optimiser's world, each on the card
# and with device="cpu"; a 32-row bucket keeps the plain versions quick
MARKET_SMALL_BUCKET = 32
MARKET_SMALL_FRESH = 500
MARKET_TWO_POOLS = dict(num_nodes=400, num_jobs=3_000, num_queues=16, num_runs=400, seed=3)


def market_providers(queues, pool: str = "default", moved: int = 0, overrides: int = 0):
    """(bid provider, override provider): every (queue, band) at its
    synthetic_bid_price -- with the band-0 bids of the first `moved` queues
    tripled -- and the weights of the first `overrides` queues of `pool`
    changed (x4 and x0.25 in turn); None for no overrides."""
    from armada_tpu_torch.models.synthetic import SYNTHETIC_BANDS, synthetic_bid_price
    from armada_tpu_torch.scheduler.providers import (
        StaticBidPriceProvider, StaticPriorityOverrideProvider,
    )

    prices = {}
    for i, q in enumerate(queues):
        for b in SYNTHETIC_BANDS:
            p = synthetic_bid_price(types.SimpleNamespace(queue=q.name, price_band=b))
            prices[(q.name, b)] = 3.0 * p if (i < moved and b == SYNTHETIC_BANDS[0]) else p
    ov = None
    if overrides:
        ov = StaticPriorityOverrideProvider({
            (pool, q.name): q.weight * (4.0 if i % 2 == 0 else 0.25)
            for i, q in enumerate(queues[:overrides])
        })
    return StaticBidPriceProvider(prices), ov


def market_shapes(specs, nodes, factory) -> tuple:
    """gangs_to_price from the world's own requests: 8 members of the
    commonest request (fits), and 2 members each larger than any node (the
    pricer walks every node and finds none).  The synthetic world's nodes
    carry no labels, so no shape names a uniformity label."""
    from armada_tpu_torch.core.config import GangDefinition

    counts = collections.Counter(id(s.resources) for s in specs)
    by_id = {id(s.resources): s.resources for s in specs[:100_000]}
    common = by_id[max((k for k in counts if k in by_id), key=counts.__getitem__)]
    req = common.to_dict()
    if not np.array_equal(factory.from_mapping(req).atoms, common.atoms):
        raise AssertionError(f"the commonest request does not round-trip: {req}")
    cpu = factory.names.index("cpu")
    big = max(int(n.total_resources.atoms[cpu]) for n in nodes)
    beyond = dict(req, cpu=str(2 * big // 1000))  # atoms are millicores
    if factory.from_mapping(beyond).atoms[cpu] <= big:
        raise AssertionError("the oversized shape fits a node")
    return (("common_x8", GangDefinition(size=8, priority_class="batch", resources=req)),
            ("beyond_any_node", GangDefinition(size=2, priority_class="batch",
                                               resources=beyond)))


def load_algo(config, nodes, queues, specs, running, device, *, incremental=True, bids=None,
              overrides=None, pool_of=None, run_tag="m", collect_stats=True,
              now_ns=MARKET_NOW_NS):
    """(jdb, feed, algo, executors): the world loaded through a port JobDb --
    queued specs into pool `pool_of(i)` (the first pool by default), runs
    on their nodes' pools -- with an IncrementalProblemFeed on `device`
    when `incremental`, and FairSchedulingAlgo on `device` with the given
    providers, unlimited rate buckets (at these backlogs armed buckets bind
    against the frozen clock: bench.py's pools arm runs them so too) and
    run ids from a counter; one executor a pool, seen at `now_ns`."""
    from armada_tpu_torch.jobdb.job import Job, JobRun
    from armada_tpu_torch.jobdb.jobdb import JobDb
    from armada_tpu_torch.scheduler.algo import FairSchedulingAlgo
    from armada_tpu_torch.scheduler.executors import ExecutorSnapshot
    from armada_tpu_torch.scheduler.incremental_algo import IncrementalProblemFeed

    cfg = dataclasses.replace(
        config, incremental_problem_build=incremental,
        maximum_scheduling_rate=0.0, maximum_per_queue_scheduling_rate=0.0)
    names = [p.name for p in cfg.pools]
    node_pool = {n.id: n.pool for n in nodes}
    jobs = []
    for i, s in enumerate(specs):
        pool = (pool_of(i) if pool_of else names[0],)
        jobs.append(Job(spec=dataclasses.replace(s, pools=pool), queued=True, validated=True,
                        pools=pool))
    for r in running:
        pool = node_pool[r.node_id]
        pc = cfg.priority_class(r.job.priority_class).priority
        spec = dataclasses.replace(r.job, pools=(pool,))
        jobs.append(Job(spec=spec, queued=False, validated=True, pools=(pool,), runs=(
            JobRun(id=f"run-{spec.id}", job_id=spec.id, node_id=r.node_id, node_name=r.node_id,
                   pool=pool, scheduled_at_priority=pc, running=True),
        )))
    jdb = JobDb(cfg)
    feed = None
    if incremental:
        feed = IncrementalProblemFeed(cfg, device=device)
        feed.attach(jdb)
    txn = jdb.write_txn()
    txn.upsert(jobs)
    txn.commit()
    executors = [
        ExecutorSnapshot(id=f"ex-{p}", pool=p, nodes=tuple(n for n in nodes if n.pool == p),
                         last_update_ns=now_ns)
        for p in names
    ]
    run_ids = iter(range(10**9))
    algo = FairSchedulingAlgo(
        cfg, queues=lambda: queues, clock_ns=lambda: now_ns,
        run_id_factory=lambda: f"{run_tag}{next(run_ids):08d}", collect_stats=collect_stats,
        feed=feed, bid_prices=bids, priority_overrides=overrides, device=device)
    return jdb, feed, algo, executors


def market_view(res) -> tuple:
    """A cycle's SchedulerResult as comparable values: the ordered
    decisions, the failed ids, and every pool's round fields and market
    PoolStats fields (indicative prices, idealised and realised values)."""
    pools = []
    for ps in res.pools:
        o = ps.outcome
        pools.append((
            ps.pool, ps.market, o.spot_price, o.num_iterations, o.kernel_iters, o.termination,
            sorted((n, r.evaluated, r.schedulable, r.price, r.unschedulable_reason)
                   for n, r in ps.indicative_prices.items()),
            sorted(ps.idealised_values.items()), sorted(ps.realised_values.items()),
        ))
    return ([(j.id, r.id, r.node_id) for j, r in res.scheduled],
            sorted(j.id for j, _ in res.preempted), sorted(res.failed), pools)


def _market_cycles(algo, jdb, executors, fresh_by_cycle, pool_of=None, providers=None) -> list:
    """Drive one cycle per entry of fresh_by_cycle (None: submit nothing),
    committing each; providers[c], where given, replaces the bid provider
    before cycle c.  Returns each cycle's market_view."""
    from armada_tpu_torch.jobdb.job import Job

    names = [p.name for p in algo.config.pools]
    views = []
    for c, fresh in enumerate(fresh_by_cycle):
        if providers and providers.get(c) is not None:
            algo.bid_prices = providers[c]
        txn = jdb.write_txn()
        if fresh:
            txn.upsert([
                Job(spec=dataclasses.replace(s, pools=(pool_of(i) if pool_of else names[0],)),
                    queued=True, validated=True,
                    pools=(pool_of(i) if pool_of else names[0],))
                for i, s in enumerate(fresh)
            ])
        res = algo.schedule(txn, executors, MARKET_NOW_NS)
        views.append(market_view(res))
        txn.commit()
    return views


def _same_views(card: list, cpu: list, what: str) -> None:
    for c, (a, b) in enumerate(zip(card, cpu)):
        for k, name in enumerate(("decisions", "preempted", "failed", "pool stats")):
            if a[k] != b[k]:
                raise AssertionError(f"{what}, cycle {c}: the card and device='cpu' differ in "
                                     f"{name}")
    if len(card) != len(cpu):
        raise AssertionError(f"{what}: cycle counts differ")


def market_small(dev) -> dict:
    """The small-world market checks, each world run through the whole
    FairSchedulingAlgo on the card and with device="cpu", which must give
    equal decisions and market PoolStats:
    - KB_MARKET's world through the legacy route (the idealised mega-node
      round on the card: K-B, K-C, K-A at N = 1) for a fill cycle, and
      through the columnar route for a fill cycle and a steady cycle whose
      bids move; the two routes' idealised values agree on the fill cycle
      (the world stays below 2^24 resolution units);
    - a two-pool world with priority overrides (two cycles);
    - the optimiser's world (tests/test_optimiser.py's end-to-end case)."""
    import torch

    from armada_tpu_torch.core.config import PoolConfig, SchedulingConfig
    from armada_tpu_torch.core.types import JobSpec, NodeSpec, Queue
    from armada_tpu_torch.models.synthetic import synthetic_world

    out = {}
    config, nodes, queues, specs, running, factory_fn = synthetic_world(
        **KB_MARKET, shape_bucket=MARKET_SMALL_BUCKET)
    shapes = market_shapes(specs, nodes, config.resource_list_factory())
    config = dataclasses.replace(config, pools=(dataclasses.replace(
        config.pools[0], gangs_to_price=shapes),))
    bids, ov = market_providers(queues, overrides=4)
    moved, _ = market_providers(queues, moved=4)
    fresh = factory_fn(MARKET_SMALL_FRESH, 1e6)
    views = {}
    for route, incremental, cycles in (("legacy", False, [None]),
                                       ("columnar", True, [None, fresh])):
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            jdb, _feed, algo, ex = load_algo(config, nodes, queues, specs, running, device,
                                               incremental=incremental, bids=bids, overrides=ov)
            views[(route, where)] = _market_cycles(algo, jdb, ex, cycles, providers={1: moved})
            out[f"{route}_{where}_s"] = time.perf_counter() - t0
        _same_views(views[(route, "card")], views[(route, "cpu")], f"market world, {route}")
    leg, col = views[("legacy", "card")][0][3][0], views[("columnar", "card")][0][3][0]
    if views[("legacy", "card")][0][:2] != views[("columnar", "card")][0][:2]:
        raise AssertionError("market world: the legacy and columnar routes decide differently")
    li, ci = dict(leg[7]), dict(col[7])
    if sorted(li) != sorted(ci) or not li or not all(
            np.isclose(li[q], ci[q], rtol=1e-12, atol=0.0) for q in li):
        raise AssertionError(f"market world: idealised values differ between the routes: "
                             f"{li} / {ci}")
    if leg[6] != col[6] or leg[8] != col[8]:
        raise AssertionError("market world: indicative prices or realised values differ "
                             "between the routes")
    out["market_world"] = dict(
        scheduled=[len(v[0]) for v in views[("columnar", "card")]],
        spot_price=[v[3][0][2] for v in views[("columnar", "card")]],
        indicative=leg[6], idealised_queues=len(li), realised_queues=len(dict(leg[8])))
    log(f"market small: KB_MARKET's world, legacy (mega-node round on the card) and columnar "
        f"routes equal their device='cpu' runs; routes agree on the idealised values of "
        f"{len(li)} queues (rtol 1e-12); {out['market_world']}")

    # two pools, every job restricted to one, queue weights overridden per pool
    config2, nodes2, queues2, specs2, running2, factory2 = synthetic_world(
        **MARKET_TWO_POOLS, shape_bucket=MARKET_SMALL_BUCKET)
    half = len(nodes2) // 2
    nodes2 = [dataclasses.replace(n, pool="pa" if i < half else "pb") for i, n in enumerate(nodes2)]
    config2 = dataclasses.replace(config2, pools=(PoolConfig("pa"), PoolConfig("pb")))
    from armada_tpu_torch.scheduler.providers import StaticPriorityOverrideProvider

    ov2 = StaticPriorityOverrideProvider(
        {("pa", q.name): 6.0 for q in queues2[:3]}
        | {("pb", q.name): 0.2 for q in queues2[:3]}
        | {("pb", q.name): 3.0 for q in queues2[-3:]})
    fresh2 = factory2(200, 1e6)
    pool_of = lambda i: "pa" if i % 2 == 0 else "pb"  # noqa: E731
    got = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        jdb, _f, algo, ex = load_algo(config2, nodes2, queues2, specs2, running2, device,
                                      overrides=ov2, pool_of=pool_of)
        got[where] = _market_cycles(algo, jdb, ex, [None, fresh2], pool_of=pool_of)
    _same_views(got["card"], got["cpu"], "two-pool overrides")
    out["overrides"] = dict(scheduled=[len(v[0]) for v in got["card"]])
    log(f"market small: two pools with priority overrides equal their device='cpu' runs; "
        f"{out['overrides']}")

    # the optimiser's world: hogs fill two 8-cpu nodes, eviction is off, and
    # the optimiser preempts one node's worth for the 8-cpu job
    cfg3 = SchedulingConfig(shape_bucket=MARKET_SMALL_BUCKET,
                            protected_fraction_of_fair_share=100.0, optimiser_enabled=True,
                            default_priority_class="armada-preemptible")
    F = cfg3.resource_list_factory()
    nodes3 = [NodeSpec(id=f"n{k}", pool="default",
                       total_resources=F.from_mapping({"cpu": "8", "memory": "32"}))
              for k in range(2)]
    hogs = [JobSpec(id=f"hog-{i}", queue="hog", submit_time=0.0,
                    priority_class="armada-preemptible",
                    resources=F.from_mapping({"cpu": "2", "memory": "2"})) for i in range(8)]
    big = [JobSpec(id="big", queue="starved", submit_time=1.0,
                   priority_class="armada-preemptible",
                   resources=F.from_mapping({"cpu": "8", "memory": "8"}))]
    queues3 = [Queue("hog"), Queue("starved")]
    got = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        jdb, _f, algo, ex = load_algo(cfg3, nodes3, queues3, hogs, [], device)
        got[where] = _market_cycles(algo, jdb, ex, [None, big, None])
    _same_views(got["card"], got["cpu"], "optimiser world")
    placed, preempted = got["card"][1][0], got["card"][1][1]
    if [p[0] for p in placed] != ["big"] or len(preempted) != 4:
        raise AssertionError(f"optimiser world: {placed} / {preempted}")
    out["optimiser"] = dict(placed=placed, preempted=preempted)
    log(f"market small: the optimiser places the 8-cpu job over 4 preempted hogs, on the card "
        f"as with device='cpu'")
    return out


class _timed:
    """Wraps a callable, adding its host seconds to `self.s` (reset per cycle)."""

    def __init__(self, fn):
        self.fn = fn
        self.s = 0.0
        self.calls = 0

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t
            self.calls += 1


def market_path(dev, small: dict) -> dict:
    """bench.py's market deployment at full width through the serving cycle:
    1M jobs x 50k nodes x 64 queues (seed 7, 8 price bands) loaded through a
    JobDb with an IncrementalProblemFeed, FairSchedulingAlgo with a
    StaticBidPriceProvider, two priced gang shapes, the optimiser and
    overrides on 8 queues, verification on; a fill cycle and three steady
    cycles of 1,000 fresh specs, the bids of four queues moving before the
    second.  The first steady cycle's round (and the moved cycle's) is held
    against its plain version on the same device problem, field by field,
    and every steady cycle's resident problem against the host tables."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch import models as M
    from armada_tpu_torch.models import explain as X
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import round_statics, schedule_round_plain
    from armada_tpu_torch.models.synthetic import synthetic_world
    from armada_tpu_torch.scheduler import idealised as I
    from armada_tpu_torch.scheduler import idealised_columnar as IC

    t0 = time.perf_counter()
    config, nodes, queues, specs, running, spec_factory = synthetic_world(**MARKET_WORLD)
    world_s = time.perf_counter() - t0
    shapes = market_shapes(specs, nodes, config.resource_list_factory())
    config = dataclasses.replace(config, optimiser_enabled=True, pools=(dataclasses.replace(
        config.pools[0], gangs_to_price=shapes),))
    bids, ov = market_providers(queues, overrides=MARKET_OVERRIDES)
    moved, _ = market_providers(queues, moved=4)
    fresh_by_cycle = [None] + [spec_factory(MARKET_BURST, 1e6 + 100.0 * c)
                               for c in range(1, 1 + MARKET_STEADY_CYCLES)]
    t0 = time.perf_counter()
    jdb, feed, algo, executors = load_algo(config, nodes, queues, specs, running, dev,
                                             bids=bids, overrides=ov)
    load_s = time.perf_counter() - t0
    log(f"market path: world built in {world_s:.1f} s, loaded through the JobDb in "
        f"{load_s:.1f} s; shapes {[(n, d.size, dict(d.resources)) for n, d in shapes]}")

    # host timers around the market layer, and the optimiser's placements
    pricer = algo.gang_pricer
    t_pricer = _timed(pricer.price_pool_gangs_columnar)
    pricer.price_pool_gangs_columnar = t_pricer
    t_sweep = _timed(IC.calculate_idealised_values_columnar)
    t_value = _timed(I.value_of_jobs)
    t_opt = _timed(algo._optimise_stuck)
    algo._optimise_stuck = t_opt
    opt_placed = [0]
    apply_outcome = algo._apply_outcome

    def counting_apply(txn, outcome, *a, **kw):
        if outcome.termination == "optimiser":
            opt_placed[0] += len(outcome.scheduled)
        return apply_outcome(txn, outcome, *a, **kw)

    algo._apply_outcome = counting_apply
    # the round the feed assembled: the first K-B call of the cycle, its
    # device problem and statics (a rollback re-run would come after)
    seen: dict = {}
    round_fn = M.schedule_round

    def recording_round(p, **kw):
        r = round_fn(p, **kw)
        seen.setdefault("round", (p, kw, r))
        return r

    devcache = feed.devcache_for("default")
    cache_apply = devcache.apply

    def recording_apply(bundle):
        dp = cache_apply(bundle)
        if seen.get("want_truth"):
            with uncounted():
                seen["truth"] = (bundle.materialize(), dp, devcache.last_apply)
        return dp

    devcache.apply = recording_apply
    saved = (IC.calculate_idealised_values_columnar, I.value_of_jobs, M.schedule_round)
    IC.calculate_idealised_values_columnar = t_sweep
    I.value_of_jobs = t_value
    M.schedule_round = recording_round
    V.reset_verify_state()
    X.reset_cadence()
    vtok = V.arm_default(True)
    etok = X.arm_default(EXPLAIN_INTERVAL)
    cycles = []
    held = []
    try:
        kernels.reset_launches()
        for c, fresh in enumerate(fresh_by_cycle):
            if c == MARKET_PRICE_MOVE:
                algo.bid_prices = moved
            check = c in (1, MARKET_PRICE_MOVE)
            seen.clear()
            seen["want_truth"] = c >= 1
            for t in (t_pricer, t_sweep, t_value, t_opt):
                t.s, t.calls = 0.0, 0
            opt_placed[0] = 0
            from armada_tpu_torch.jobdb.job import Job

            txn = jdb.write_txn()
            if fresh:
                txn.upsert([Job(spec=dataclasses.replace(s, pools=("default",)), queued=True,
                                validated=True, pools=("default",)) for s in fresh])
            torch.cuda.synchronize(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t1 = time.perf_counter()
            ev[0].record()
            res = algo.schedule(txn, executors, MARKET_NOW_NS)
            ev[1].record()
            torch.cuda.synchronize(dev)
            wall_s = time.perf_counter() - t1
            cycle_device_ms = ev[0].elapsed_time(ev[1])
            txn.commit()
            (ps,) = res.pools
            dp, kw, kres = seen["round"]
            with uncounted():
                round_ms, _ = cuda_ms(lambda: round_fn(dp, **kw), reps=1)
                if c >= 1:
                    truth, tdp, how = seen["truth"]
                    problems_equal(tdp, truth, f"market cycle {c}: resident vs materialize()")
                if check:
                    statics = {k: kw[k] for k in ("prefer_large", "commit_k") if k in kw}
                    pkw = dict({k: kw[k] for k in ("num_levels", "max_slots", "slot_width")},
                               **round_statics(dp, **statics))
                    torch.cuda.synchronize(dev)
                    tp = time.perf_counter()
                    plain = schedule_round_plain(dp, **pkw)
                    torch.cuda.synchronize(dev)
                    plain_ms = (time.perf_counter() - tp) * 1e3
                    max_err(kres, plain)
                    held.append(dict(cycle=c, apply=how, plain_ms=plain_ms,
                                     kernel_iters=int(kres.kernel_iters),
                                     spot_price=float(kres.spot_price)))
            o = ps.outcome
            prices = {n: (r.schedulable, r.price, r.unschedulable_reason)
                      for n, r in ps.indicative_prices.items()}
            ideal = ps.idealised_values
            if not ideal or not all(np.isfinite(v) for v in ideal.values()):
                raise AssertionError(f"market cycle {c}: idealised values {ideal}")
            cyc = dict(
                cycle=c, wall_s=wall_s, cycle_device_ms=cycle_device_ms, round_ms=round_ms,
                apply=devcache.last_apply, pricer_ms=t_pricer.s * 1e3,
                idealised_ms=t_sweep.s * 1e3, realised_ms=t_value.s * 1e3,
                optimiser_ms=t_opt.s * 1e3, optimiser_placements=opt_placed[0],
                scheduled=len(res.scheduled), preempted=len(res.preempted),
                failed=len(o.failed), spot_price=o.spot_price, iterations=o.num_iterations,
                indicative_prices=prices, idealised_total=float(sum(ideal.values())),
                realised_total=float(sum(ps.realised_values.values())),
                idealised_queues=len(ideal), explained=o.explain is not None,
            )
            cycles.append(cyc)
            log(f"market cycle {c} [{smi_line()}]: wall {wall_s:.3f} s (device span "
                f"{cycle_device_ms:.1f} ms), {cyc['apply']} apply, round {round_ms:.2f} ms "
                f"(CUDA events, K-B replayed), pricer {cyc['pricer_ms']:.1f} ms, idealised sweep "
                f"{cyc['idealised_ms']:.1f} ms, realised values {cyc['realised_ms']:.2f} ms, "
                f"optimiser {cyc['optimiser_ms']:.1f} ms ({opt_placed[0]} placements); "
                f"scheduled {cyc['scheduled']} preempted {cyc['preempted']} failed "
                f"{cyc['failed']}; spot price {o.spot_price}; indicative prices {prices}; "
                f"idealised {cyc['idealised_total']:.1f} over {len(ideal)} queues, realised "
                f"{cyc['realised_total']:.1f}")
        launches = dict(kernels.LAUNCHES)
        vs = V.verify_state()
        if vs.failures or vs.rounds < 1 + MARKET_STEADY_CYCLES:
            raise AssertionError(f"market path verification: {vs.snapshot()}")
    finally:
        IC.calculate_idealised_values_columnar, I.value_of_jobs, M.schedule_round = saved
        V.disarm_default(vtok)
        X.disarm_default(etok)
    for k in ("round", "compact", "fair_shares", "slab", "verify", "explain"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the market path")
    if not all(cyc["scheduled"] > 0 for cyc in cycles):
        raise AssertionError("a market cycle scheduled nothing")
    if len(held) != 2:
        raise AssertionError(f"market path: {len(held)} rounds held against the plain version")
    applies = [cyc["apply"] for cyc in cycles]
    if applies[MARKET_PRICE_MOVE + 1:] and "scatter" not in applies[MARKET_PRICE_MOVE + 1:]:
        raise AssertionError(f"market path: no scatter after the price move: {applies}")
    log(f"market path: {1 + MARKET_STEADY_CYCLES} cycles ({applies}); the rounds of cycles 1 "
        f"and {MARKET_PRICE_MOVE} equal their plain versions in every field {held}, every "
        f"steady cycle's resident problem the host tables; launches {launches}")
    return dict(world_s=world_s, load_s=load_s, cycles=cycles, held=held, launches=launches,
                small=small)


# --- the simulator path --------------------------------------------------------------

# The small world: gangs and preemption after testdata/golden/
# preempted_gang_job.yaml (the reference simulator test table's 'Preempted
# Gang Job'), plus a queue of singles, under the reference's test config
# (the priority-0..3 ladder, prefer-large ordering); written as dicts, so
# that the script needs no yaml.
_REQ = lambda cpu, mem, **extra: dict(resourceRequirements=dict(  # noqa: E731
    requests=dict(cpu=cpu, memory=mem, **extra)))
SIM_SMALL_CLUSTER = dict(name="basic", clusters=[dict(
    name="Cluster1", pool="TestPool",
    nodeTemplates=[dict(number=8, totalResources=dict(resources=dict(cpu="32",
                                                                     memory="256Gi")))])])
SIM_SMALL_WORKLOAD = dict(name="w", queues=[
    dict(name="A", weight=1, jobTemplates=[dict(
        number=8, jobSet="foo", priorityClassName="priority-2", requirements=_REQ("32", "256Gi"),
        runtimeDistribution=dict(minimum="1m"), gangCardinality=8)]),
    dict(name="B", weight=1, jobTemplates=[dict(
        number=1, jobSet="bar", priorityClassName="priority-3", requirements=_REQ("32", "256Gi"),
        runtimeDistribution=dict(minimum="1m"), earliestSubmitTime="30s")]),
    dict(name="C", weight=2, jobTemplates=[dict(
        number=24, jobSet="baz", priorityClassName="priority-1", requirements=_REQ("4", "16Gi"),
        runtimeDistribution=dict(minimum="2m", tailMean="1m"), earliestSubmitTime="90s")]),
])
# The scale world: two pools, 8,000 nodes of 32 cpu / 128 Gi and 2,000 of
# 16 cpu / 64 Gi / 8 GPUs; 64 queues, 100,000 jobs from three templates a
# queue with shifted-exponential runtimes; a 10 s schedule interval, cut at
# 6 cycles (three schedule events over the two pools, so that the market
# path fits in the script's time).
SIM_QUEUES = 64
SIM_MAX_TIME_S = 25.0
SIM_SCALE_CYCLES = 6


def sim_scale_specs():
    cluster = dict(name="scale", clusters=[
        dict(name="cpu", pool="cpu", nodeTemplates=[dict(
            number=8_000, totalResources=dict(resources=dict(cpu="32", memory="128Gi")))]),
        dict(name="gpu", pool="gpu", nodeTemplates=[dict(
            number=2_000, totalResources=dict(resources={"cpu": "16", "memory": "64Gi",
                                                        "nvidia.com/gpu": "8"}))]),
    ])
    queues = []
    for q in range(SIM_QUEUES):
        queues.append(dict(name=f"q{q:02d}", weight=1 + q % 4, jobTemplates=[
            dict(id=f"q{q:02d}-small", number=1_000, jobSet="small", requirements=_REQ("1", "4Gi"),
                 runtimeDistribution=dict(minimum="2m", tailMean="10m")),
            dict(id=f"q{q:02d}-medium", number=400, jobSet="medium",
                 priorityClassName="armada-preemptible", requirements=_REQ("8", "32Gi"),
                 runtimeDistribution=dict(minimum="5m", tailMean="30m")),
            dict(id=f"q{q:02d}-gpu", number=162 + (q < 32), jobSet="gpu",
                 requirements=_REQ("4", "16Gi", **{"nvidia.com/gpu": "1"}),
                 runtimeDistribution=dict(minimum="10m", tailMean="1h")),
        ]))
    return cluster, dict(name="scale", randomSeed=7, queues=queues)


def sim_small_config():
    from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig

    pcs = {f"priority-{p}": PriorityClass(f"priority-{p}", priority=p, preemptible=p < 3)
           for p in range(4)}
    pcs["priority-2-non-preemptible"] = PriorityClass("priority-2-non-preemptible", priority=2,
                                                      preemptible=False)
    return SchedulingConfig(
        supported_resource_types=(("memory", "1Mi"), ("cpu", "1m"), ("nvidia.com/gpu", "1")),
        priority_classes=pcs, default_priority_class="priority-3",
        dominant_resource_fairness_resources=("cpu", "memory", "nvidia.com/gpu"),
        enable_prefer_large_job_ordering=True, shape_bucket=8,
        maximum_scheduling_burst=10_000, maximum_per_queue_scheduling_burst=10_000,
        maximum_resource_fraction_to_schedule={})


class plain_versions:
    """Context in which the round's kernel wrappers (K-B, K-C, K-A) run
    their plain versions on CUDA tensors: the simulator on the card, with
    no kernel."""

    def __enter__(self):
        from armada_tpu_torch.kernels import compact as KC
        from armada_tpu_torch.kernels import fair_shares as KA
        from armada_tpu_torch.kernels import round as KB
        from armada_tpu_torch.models.fair_scheduler import (
            compact_result_plain, schedule_round_plain,
        )
        from armada_tpu_torch.ops.fairness import fair_shares_plain

        def fs(w, c, *, max_iterations=10):
            if w.dim() == 2:
                return KA.fair_shares_lanes_plain(w, c, max_iterations)
            return tuple(fair_shares_plain(w, c, max_iterations))

        self.saved = [(KB, "schedule_round", KB.schedule_round),
                      (KC, "compact_result", KC.compact_result),
                      (KA, "fair_shares", KA.fair_shares)]
        KB.schedule_round = schedule_round_plain
        KC.compact_result = compact_result_plain
        KA.fair_shares = fs
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


class cycle_timer:
    """Per-round wall seconds of the simulator's rounds, split into the
    host build (build_problem) and the round kernels (K-B, CUDA events);
    the first round's problem is kept."""

    def __enter__(self):
        import torch

        from armada_tpu_torch import models as M
        from armada_tpu_torch.kernels import round as KB
        from armada_tpu_torch.simulator import simulator as SIM

        self.rows, self.first = [], None
        build0, round0, entry0 = M.build_problem, KB.schedule_round, SIM.run_scheduling_round
        cur = {}

        def build(*a, **kw):
            t0 = time.perf_counter()
            out = build0(*a, **kw)
            cur["build_s"] = time.perf_counter() - t0
            if self.first is None:
                self.first = out
            return out

        def rnd(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = round0(*a, **kw)
            e1.record()
            cur.setdefault("events", []).append((e0, e1))
            return out

        def entry(*a, **kw):
            t0 = time.perf_counter()
            out = entry0(*a, **kw)
            torch.cuda.synchronize()
            round_ms = sum(e0.elapsed_time(e1) for e0, e1 in cur.pop("events", []))
            self.rows.append(dict(pool=kw.get("pool"), wall_s=time.perf_counter() - t0,
                                  build_s=cur.pop("build_s"), round_ms=round_ms,
                                  scheduled=len(out.scheduled), preempted=len(out.preempted),
                                  kernel_iters=out.kernel_iters))
            return out

        self.saved = [(M, "build_problem", build0), (KB, "schedule_round", round0),
                      (SIM, "run_scheduling_round", entry0)]
        M.build_problem, KB.schedule_round, SIM.run_scheduling_round = build, rnd, entry
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _sim_view(result) -> tuple:
    return (result.events, [dataclasses.asdict(c) for c in result.cycles], result.makespan,
            result.total_scheduled, result.total_preempted, result.total_succeeded,
            result.total_failed, result.never_scheduled)


def simulator_path(dev) -> dict:
    """Simulator.run on the card, whole traces (SimulationResult.events)
    and per-cycle stats compared: the small world through the kernels and
    through the plain versions; the scale world uncached and with
    ARMADA_CACHE_SLOTS = 64; one cycle's problem of the scale world, kernel
    against plain."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.simulator import (
        Simulator, cluster_spec_from_dict, workload_spec_from_dict,
    )

    report = {}
    small = (cluster_spec_from_dict(SIM_SMALL_CLUSTER), workload_spec_from_dict(SIM_SMALL_WORKLOAD))
    kernels.reset_launches()
    t0 = time.perf_counter()
    sk = Simulator(*small, sim_small_config(), schedule_interval_s=10.0, device=dev).run()
    small_s = time.perf_counter() - t0
    small_launches = dict(kernels.LAUNCHES)
    if small_launches["round"] <= 0:
        raise AssertionError("the small simulation launched no round kernel")
    with uncounted(), plain_versions():
        sp = Simulator(*small, sim_small_config(), schedule_interval_s=10.0, device=dev).run()
    if _sim_view(sk) != _sim_view(sp):
        raise AssertionError("the small simulation's trace differs between kernels and plain")
    with uncounted():
        sc = _with_env(dict(ARMADA_CACHE_SLOTS=K11_SLOTS), lambda: Simulator(
            *small, sim_small_config(), schedule_interval_s=10.0, device=dev).run())
    if _sim_view(sc) != _sim_view(sk):
        raise AssertionError("the small simulation's trace differs with the fit cache armed")
    if sk.total_preempted == 0 or sk.never_scheduled:
        raise AssertionError(f"the small simulation must preempt and finish: "
                             f"{sk.total_preempted} preempted, {sk.never_scheduled} left")
    report["small"] = dict(seconds=small_s, events=len(sk.events), cycles=len(sk.cycles),
                           preempted=sk.total_preempted, succeeded=sk.total_succeeded,
                           launches=small_launches)
    log(f"simulator [small world, gangs and preemption]: {len(sk.events)} events, "
        f"{len(sk.cycles)} cycles, {sk.total_preempted} preempted, {sk.total_succeeded} "
        f"succeeded in {small_s:.2f} s; the trace equals the plain versions' and the cached one")

    cluster_doc, workload_doc = sim_scale_specs()
    scale = (cluster_spec_from_dict(cluster_doc), workload_spec_from_dict(workload_doc))
    njobs = sum(t.number for q in scale[1].queues for t in q.job_templates)
    nnodes = sum(t.number for c in scale[0].clusters for t in c.node_templates)
    runs = {}
    for slots in (0, K11_SLOTS):
        kernels.reset_launches()
        with cycle_timer() as timer:
            t0 = time.perf_counter()
            res = _with_env(dict(ARMADA_CACHE_SLOTS=slots), lambda: Simulator(
                *scale, SchedulingConfig(), schedule_interval_s=10.0, max_time_s=SIM_MAX_TIME_S,
                device=dev).run())
            wall = time.perf_counter() - t0
        runs[slots] = dict(result=res, wall_s=wall, rows=timer.rows, first=timer.first,
                           launches=dict(kernels.LAUNCHES))
        log(f"simulator [scale world, {nnodes} nodes x {njobs} jobs, cache_slots {slots}]: "
            f"{len(res.cycles)} cycles in {wall:.1f} s; per cycle (pool, wall s, build s, "
            f"round ms): " + ", ".join(
                f"({r['pool']}, {r['wall_s']:.2f}, {r['build_s']:.2f}, {r['round_ms']:.1f})"
                for r in timer.rows))
    if len(runs[0]["result"].cycles) != SIM_SCALE_CYCLES:
        raise AssertionError(f"the scale world ran {len(runs[0]['result'].cycles)} cycles, not "
                             f"{SIM_SCALE_CYCLES}")
    if _sim_view(runs[0]["result"]) != _sim_view(runs[K11_SLOTS]["result"]):
        raise AssertionError("the scale world's trace differs with the fit cache armed")
    if runs[K11_SLOTS]["launches"]["round_fit_cache"] <= 0:
        raise AssertionError("the cached scale run launched no cached round")
    # the first cycle's problem (the busiest), kernel against plain,
    # uncached and cached
    problem, ctx = runs[K11_SLOTS]["first"]
    one = {}
    with uncounted():
        for slots in (0, K11_SLOTS):
            one[slots] = check_round("simulator cycle", problem, round_meta(ctx), dev,
                                     cache_slots=slots)
    report["scale"] = dict(
        nodes=nnodes, jobs=njobs, one_cycle=one,
        **{f"cache_slots={k}": dict(wall_s=v["wall_s"], cycles=v["rows"],
                                    launches=v["launches"],
                                    scheduled=v["result"].total_scheduled,
                                    events=len(v["result"].events))
           for k, v in runs.items()})
    log(f"simulator [scale world]: traces equal uncached and cached "
        f"({runs[0]['result'].total_scheduled} scheduled, {len(runs[0]['result'].events)} events); "
        f"one cycle's problem (N={int(problem.node_total.shape[0])}, "
        f"G={int(problem.g_req.shape[0])}): kernel == plain uncached and cached")
    return report


# --- the mesh path: the node-axis mesh on one card (K-K, K-L) -------------------

# K-K's cluster sizes on the main problem (16 where the card launches it),
# and the serving mesh of the steady cycle
MESH_SHARDS = (2, 4, 8, 16)
MESH_SERVE = 8
# small worlds every loop shape of K-K is held on, at MESH_SERVE shards
MESH_BURST = dict(num_nodes=2_048, num_gangs=8_000, num_queues=64, num_runs=0,
                  global_burst=400, perq_burst=400, seed=3)
MESH_GANGS = dict(num_nodes=2_048, num_gangs=8_000, num_queues=64, num_runs=1_000,
                  global_burst=400, max_gang_cardinality=8, seed=0)
MESH_HETERO = dict(num_nodes=2_048, num_gangs=8_000, num_queues=32, num_runs=500,
                   global_burst=400, num_node_types=8, type_sensitive_frac=0.3,
                   max_gang_cardinality=4, seed=1)
MESH_EVICT = dict(num_nodes=2_048, num_jobs=20_000, num_queues=32, num_runs=4_000, seed=2,
                  shape_bucket=1_024)
# the widths above the narrow instantiations' tables (commit_k, batch_k), and
# one whose [E x E] tables exceed the card's memory
WIDE_K = 32
WIDE_BEYOND = 1 << 20
# the round's own water-fill at Q that are not multiples of 32: the 8-lane
# spare sum (25..31) and two windows with the padding split (33..63), each
# padding parity and its ends
WATERFILL_Q = (25, 28, 31, 33, 34, 47, 48, 62, 63)


def _mesh(dev, shards: int):
    from armada_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dev, node_shards=shards)


def check_sharded(name: str, problem, meta: dict, dev, shards, **statics) -> dict:
    """K-K at each shard count against the plain version on the card, every
    RoundResult field (kernel_iters included), and K-B against it too."""
    import torch

    from armada_tpu_torch.kernels.round import schedule_round
    from armada_tpu_torch.models.fair_scheduler import round_statics, schedule_round_plain
    from armada_tpu_torch.models.state import problem_from_numpy

    dp = problem if isinstance(problem.g_req, torch.Tensor) else problem_from_numpy(problem, dev)
    kw = dict(meta, **round_statics(dp, **statics))
    p = schedule_round_plain(dp, **kw)
    max_err(schedule_round(dp, **kw), p)
    for s in shards:
        k = schedule_round(dp, mesh=_mesh(dev, s), **kw)
        torch.cuda.synchronize()
        max_err(k, p)
    info = dict(iterations=int(p.iterations), kernel_iters=int(p.kernel_iters),
                scheduled=int(p.scheduled_count), evicted=int(p.run_evicted.sum()))
    shape = " ".join(f"{a}={b}" for a, b in statics.items())
    log(f"K-K [{name}{' ' + shape if shape else ''}] S={list(shards)}: kernel == K-B == plain "
        f"{info}")
    return info


def check_mesh_kernels(dev) -> dict:
    """K-K on small problems, every loop shape, at MESH_SERVE shards (and
    every cluster size on a tie-heavy world: identical nodes, so nearly
    every node argmin is a tie across every shard boundary), each equal to
    the plain version; then the wide instantiations (commit_k and batch_k
    WIDE_K) solo and on a 3-lane stack, and the round's water-fill at Q in
    WATERFILL_Q, each K-B against the plain version."""
    from armada_tpu_torch.kernels.round import cluster_capacity, schedule_round
    from armada_tpu_torch.models.fair_scheduler import round_statics
    from armada_tpu_torch.models.state import problem_from_numpy
    from armada_tpu_torch.models.synthetic import synthetic_problem

    out = {}
    shards = tuple(s for s in MESH_SHARDS if s < 16 or cluster_capacity(s) > 0)
    S = (MESH_SERVE,)
    bp, bmeta = synthetic_problem(**MESH_BURST)
    ties = bp._replace(node_total=np.repeat(bp.node_total[:1], bp.node_total.shape[0], 0),
                       node_type=np.zeros_like(bp.node_type))
    tdp = problem_from_numpy(ties, dev)
    out["ties"] = check_sharded("ties", tdp, bmeta, dev, shards)
    for statics in (dict(commit_k=LOOP_COMMIT_K), dict(batch_k=8), dict(cache_slots=16)):
        out["ties " + str(statics)] = check_sharded("ties", tdp, bmeta, dev, S, **statics)
    bdp = problem_from_numpy(bp, dev)
    for statics in (dict(), dict(commit_k=16), dict(cache_slots=4), dict(unroll=4),
                    dict(cache_slots=16, commit_k=LOOP_COMMIT_K), dict(batch_k=16)):
        out["burst " + str(statics)] = check_sharded("burst", bdp, bmeta, dev, S, **statics)
    gp, gmeta = synthetic_problem(**MESH_GANGS)
    gdp = problem_from_numpy(gp, dev)
    out["gangs"] = check_sharded("gangs", gdp, gmeta, dev, shards)
    out["gangs prefer-large"] = check_sharded("gangs", gdp, gmeta, dev, S, prefer_large=True)
    hp, hmeta = synthetic_problem(**MESH_HETERO)
    hdp = problem_from_numpy(hp, dev)
    for statics in (dict(), dict(commit_k=LOOP_COMMIT_K), dict(batch_k=8), dict(cache_slots=8)):
        out["bias " + str(statics)] = check_sharded("bias", hdp, hmeta, dev, S, **statics)
    ep, ectx = world_problem(MESH_EVICT, protected=0.0)
    edp = problem_from_numpy(ep, dev)
    out["evict"] = check_sharded("eviction world", edp, round_meta(ectx), dev, S)
    if out["evict"]["evicted"] == 0:
        raise AssertionError("the mesh eviction world evicted nothing")
    # A1: the wide instantiations, solo and stacked
    for statics in (dict(commit_k=WIDE_K), dict(batch_k=WIDE_K)):
        out["wide " + str(statics)] = check_round("burst", bdp, bmeta, dev, **statics)
        out["wide bias " + str(statics)] = check_round("bias", hdp, hmeta, dev, **statics)
    lp, lmeta = synthetic_problem(**LOOP_LANES)
    lanes = _lanes_of(problem_from_numpy(lp, dev), 3)
    for statics in (dict(commit_k=WIDE_K), dict(batch_k=WIDE_K)):
        out["wide stacked " + str(statics)] = _stacked_check("loop lanes (TR > 1)", lanes,
                                                             lmeta, dev, **statics)
    # a width whose tables exceed the card's memory raises with the bytes it
    # needs (the wrapper does not clamp to Q; round_statics does)
    kw = dict(bmeta, **round_statics(bdp))
    kw["commit_k"] = WIDE_BEYOND
    try:
        schedule_round(bdp, **kw)
    except RuntimeError as e:
        if f"commit_k={WIDE_BEYOND}" not in str(e) or "bytes of scratch" not in str(e):
            raise
        log(f"K-B round [burst commit_k={WIDE_BEYOND}]: raises: {e}")
        out["wide beyond the card"] = str(e)
    else:
        raise AssertionError(f"commit_k={WIDE_BEYOND} launched; its tables exceed the card")
    # A2: the round's own water-fill at Q not a multiple of 32
    for q in WATERFILL_Q:
        qp, qmeta = synthetic_problem(num_nodes=512, num_gangs=4_000, num_queues=q,
                                      num_runs=300, global_burst=300, seed=q)
        if int(qp.q_weight.shape[0]) != q:
            raise AssertionError(f"the water-fill problem has Q={qp.q_weight.shape[0]}, not {q}")
        out[f"waterfill Q={q}"] = check_round(f"water-fill Q={q}", qp, qmeta, dev)
    return out


def mesh_main(dev, main: dict, plain_round_ms: float) -> dict:
    """K-K and the wide instantiations on the main path's own problem (no
    second build).  K-K at every cluster size equal to K-B in every field
    (K-B equal to its plain version on the main path), timed in turns with
    K-B (K-B, 2, 4, 8, 16, 16, 8, 4, 2, K-B; CUDA events).  Then
    run_round_on_device at ARMADA_COMMIT_K and ARMADA_BATCH_K = WIDE_K, each
    deciding as the K = 1 round did, its round equal to the plain version's
    in every field (kernel_iters included) and timed."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels import round as KR
    from armada_tpu_torch.kernels.round import cluster_capacity, schedule_round
    from armada_tpu_torch.models import run_round_on_device
    from armada_tpu_torch.models.fair_scheduler import round_statics, schedule_round_plain

    config, problem, ctx, dp = main["config"], main["problem"], main["ctx"], main["dp"]
    meta = round_meta(ctx)
    kw = dict(meta, **round_statics(dp, cache_slots=0, batch_k=1, commit_k=1))
    shards = [s for s in MESH_SHARDS if s < 16 or cluster_capacity(s) > 0]
    report: dict = dict(shards=shards, capacity={s: cluster_capacity(s) for s in MESH_SHARDS})
    with uncounted():
        kb = schedule_round(dp, **kw)
        for s in shards:
            max_err(schedule_round(dp, mesh=_mesh(dev, s), **kw), kb)
        log(f"mesh path [main world]: K-K at S={shards} == K-B, every field "
            f"(cluster capacity {report['capacity']})")
        ms: dict = {}
        for s in [1] + shards + shards[::-1] + [1]:
            if s > 1:
                mesh = _mesh(dev, s)
                t, _ = cuda_ms(lambda mesh=mesh: schedule_round(dp, mesh=mesh, **kw), reps=3)
            else:  # K-B's single-CTA form
                t, _ = cuda_ms(lambda: KR._launch(dp, 0, shards=1, **kw), reps=3)
            ms.setdefault(s, []).append(t)
    iters = int(kb.iterations)
    report.update(ms=ms, iterations=iters,
                  us_per_iter={s: float(np.mean(v)) * 1e3 / iters for s, v in ms.items()})
    log("mesh path [main world]: ms in turns " + ", ".join(
        f"{'K-B at S=1' if s == 1 else f'S={s}'} {v}" for s, v in ms.items())
        + f"; {iters} iterations")

    # A1: the main world at WIDE_K
    k1 = main["outcome"]
    wide: dict = {}
    for name, env, statics in (
            ("commit_k", dict(ARMADA_COMMIT_K=str(WIDE_K)), dict(commit_k=WIDE_K)),
            ("batch_k", dict(ARMADA_CACHE_SLOTS="0", ARMADA_BATCH_K=str(WIDE_K)),
             dict(batch_k=WIDE_K))):
        kernels.reset_launches()
        res, out = _with_env(env, lambda: run_round_on_device(
            problem, ctx, config, device=dev, device_problem=dp))
        torch.cuda.synchronize()
        if _outcome_view(out) != _outcome_view(k1):
            raise AssertionError(f"{name}={WIDE_K}: the main world decides differently from K=1")
        with uncounted():
            kww = dict(meta, **round_statics(dp, cache_slots=0, **statics))
            t, kr = cuda_ms(lambda: schedule_round(dp, **kww), reps=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pr = schedule_round_plain(dp, **kww)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            max_err(kr, pr)
            max_err(res, pr)
        wide[name] = dict(ms=t, plain_ms=pms, kernel_iters=int(kr.kernel_iters),
                          iterations=int(kr.iterations), us_per_trip=t * 1e3 / int(kr.kernel_iters))
        log(f"mesh path [A1, main world]: {name}={WIDE_K} decides as K=1; K-B {t:.2f} ms in "
            f"{int(kr.kernel_iters)} trips ({t * 1e3 / int(kr.kernel_iters):.1f} us a trip), "
            f"equal to its plain version ({pms:.0f} ms), kernel_iters included")
    # the narrow instantiations' widest form (shared-memory tables, 16)
    # beside the wide ones' narrowest (scratch, 17), in turns
    with uncounted():
        for name in ("commit_k", "batch_k"):
            turns: dict = {}
            for k in (16, 17, 17, 16):
                kwk = dict(meta, **round_statics(dp, cache_slots=0, **{name: k}))
                t, r = cuda_ms(lambda kwk=kwk: schedule_round(dp, **kwk), reps=2)
                turns.setdefault(k, []).append(dict(ms=t, trips=int(r.kernel_iters),
                                                    us_per_trip=t * 1e3 / int(r.kernel_iters)))
            wide[f"{name} 16 vs 17"] = turns
            log(f"mesh path [A1, main world]: {name} 16 (shared-memory tables) vs 17 (scratch) "
                f"in turns: {turns}")
    report["wide"] = wide
    N, R = (int(x) for x in dp.node_total.shape)
    live_q = int((dp.q_len > 0).sum())
    per_iter = 2 * N * R * 4 + live_q * 16 * 13
    bms, by = bound_ms(tensor_bytes(*dp) + tensor_bytes(*kb) + iters * per_iter,
                       iters * 2 * N * R * 6)
    report.update(bound_ms=bms, bound_by=by, plain_ms=plain_round_ms)
    return report


def mesh_cycle_path(dev, world) -> dict:
    """The steady cycle through MeshDeviceDeltaCache at MESH_SERVE shards,
    beside the single-card cycle on the same world, cycle by cycle: two
    IncrementalBuilders fed the same specs, each cycle's round through
    run_round_on_device (verification armed) -- with the serving mesh armed
    for the mesh arm (K-H under the mesh cache, K-K) and disarmed for the
    single arm (K-H, K-B).  Every cycle must decide the same in both; the
    mesh arm's resident problem must equal bundle.materialize(), and its
    K-H equal the plain apply."""
    import torch

    from armada_tpu_torch import kernels
    from armada_tpu_torch.core.types import RunningJob
    from armada_tpu_torch.kernels.slab import apply_delta
    from armada_tpu_torch.models import run_round_on_device
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.incremental import IncrementalBuilder
    from armada_tpu_torch.models.slab import DeviceDeltaCache, apply_delta_plain
    from armada_tpu_torch.parallel.mesh_slab import MeshDeviceDeltaCache
    from armada_tpu_torch.parallel.serving import mesh_serving

    config, nodes, queues, specs, running, spec_factory = world["world"]
    ms = mesh_serving()
    arms = {}
    for arm in ("single", "mesh"):
        ms.configure(MESH_SERVE if arm == "mesh" else 0)
        b = IncrementalBuilder(config, "default", queues)
        b.set_nodes(nodes)
        b.submit_many(specs)
        b.lease_many(running)
        cache = (MeshDeviceDeltaCache(device=dev) if arm == "mesh"
                 else DeviceDeltaCache(device=dev))
        arms[arm] = dict(builder=b, cache=cache, spec_of={sp.id: sp for sp in specs})
    V.reset_verify_state()
    vtok = V.arm_default(True)
    launches = {k: 0 for k in kernels.LAUNCHES}
    cycles = []
    replay = None
    try:
        for c in range(1 + STEADY_CYCLES):
            fresh = spec_factory(BURST, 100.0 + 100.0 * c) if c else []
            outs = {}
            for arm in ("single", "mesh"):
                a = arms[arm]
                ms.configure(MESH_SERVE if arm == "mesh" else 0)
                if fresh:
                    for sp in fresh:
                        a["spec_of"][sp.id] = sp
                    a["builder"].submit_many(fresh)
                bundle, ctx = a["builder"].assemble_delta()
                with uncounted():
                    truth = bundle.materialize()
                    twin = PlainTwin(a["cache"]) if a["cache"].resident is not None else None
                if arm == "mesh":
                    kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dp = a["cache"].apply(bundle)
                result, outcome = run_round_on_device(bundle.stats_view(), ctx, config,
                                                      device=dev, device_problem=dp)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if arm == "mesh":
                    for k, v in kernels.LAUNCHES.items():
                        launches[k] += v
                    with uncounted():
                        problems_equal(dp, truth, f"mesh cycle {c}: resident vs materialize()")
                        if a["cache"].last_apply == "scatter":
                            problems_equal(dp, twin.twin.apply(bundle),
                                           f"mesh cycle {c}: K-H under the mesh cache vs plain")
                            replay = (twin.args, a["cache"].mesh)
                        if a["cache"].mesh_devices != MESH_SERVE:
                            raise AssertionError(f"mesh cycle {c}: the cache holds "
                                                 f"{a['cache'].mesh_devices} shards")
                outs[arm] = (outcome, wall, a["cache"].last_apply)
                a["builder"].remove_many(outcome.scheduled.keys())
                a["builder"].lease_many([RunningJob(job=a["spec_of"].pop(j), node_id=n)
                                         for j, n in outcome.scheduled.items()
                                         if j in a["spec_of"]])
                for jid in outcome.preempted:
                    a["builder"].unlease(jid)
            (o1, w1, ap1), (o2, w2, ap2) = outs["single"], outs["mesh"]
            if _outcome_view(o1) != _outcome_view(o2):
                raise AssertionError(f"mesh cycle {c}: the mesh decides differently from the "
                                     "single card")
            cycles.append(dict(cycle=c, single_s=w1, mesh_s=w2, single_apply=ap1,
                               mesh_apply=ap2, scheduled=len(o2.scheduled),
                               preempted=len(o2.preempted), failed=len(o2.failed)))
            log(f"mesh cycle {c}: {ap2} apply; single card {w1:.3f} s, mesh of {MESH_SERVE} "
                f"{w2:.3f} s (apply + run_round_on_device); same decisions "
                f"(scheduled {len(o2.scheduled)}, preempted {len(o2.preempted)}, failed "
                f"{len(o2.failed)})")
        if V.verify_state().failures or V.verify_state().rounds < 2 * (1 + STEADY_CYCLES):
            raise AssertionError(f"verification: {V.verify_state().snapshot()}")
    finally:
        V.disarm_default(vtok)
        ms.configure(0)
    log(f"mesh path launches (the mesh arm's cycles): {launches}")
    for k in ("round_sharded", "slab_sharded", "fair_shares", "compact", "verify"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the mesh path")
    if launches["round"] or launches["slab"]:
        raise AssertionError(f"the mesh arm launched single-card kernels: {launches}")
    if replay is None:
        raise AssertionError("the mesh cycle never scattered")
    (a, akw), mesh = replay
    with uncounted():
        kl_ms, kl = cuda_ms_quiet(lambda: apply_delta(*a, **akw, mesh=mesh), reps=SPLIT_REPS)
        kl_plain_ms, kl_plain = cuda_ms(lambda: apply_delta_plain(*a, **akw), reps=3)
        problems_equal(kl, kl_plain, "K-H under the mesh cache: replay vs plain")
    kl_turns = slab_in_turns(replay[0])
    kl_b = bound_ms(slab_bytes(replay[0]), 0)
    kl_copies = bound_ms(slab_bytes(replay[0]) + slab_copy_bytes(replay[0]), 0)
    log(f"K-H under the mesh cache: {kl_ms:.4f} ms against its bound {kl_b[0]:.5f} ms and, with "
        f"the functional copies, {kl_copies[0]:.5f} ms")
    return dict(cycles=cycles, launches=launches, kl_ms=kl_ms, kl_plain_ms=kl_plain_ms,
                kl_bound=kl_b, kl_bound_with_copies=kl_copies[0], kl_turns=kl_turns)


def mesh_rows(main_mesh: dict, cyc: dict) -> list:
    rows = []
    src, rep = SOURCES["round_sharded"]
    rows.append(dict(
        name="round_sharded", route="cuda", source=src, replaces=rep,
        launches=cyc["launches"]["round_sharded"], max_abs_err=0.0, equal=True,
        ms=float(np.mean(main_mesh["ms"][MESH_SERVE])), plain_ms=main_mesh["plain_ms"],
        bound_ms=main_mesh["bound_ms"], bound_by=main_mesh["bound_by"], library_ms=None))
    src, rep = SOURCES["slab_sharded"]
    bms, by = cyc["kl_bound"]
    rows.append(dict(
        name="slab_sharded", route="cuda", source=src, replaces=rep,
        launches=cyc["launches"]["slab_sharded"], max_abs_err=0.0, equal=True, ms=cyc["kl_ms"],
        plain_ms=cyc["kl_plain_ms"], bound_ms=bms, bound_by=by,
        library_ms=cyc["kl_turns"]["library_mean_ms"],
        bound_with_copies_ms=cyc["kl_bound_with_copies"], in_turns=cyc["kl_turns"]))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from armada_tpu_torch.kernels import build as kbuild
    from armada_tpu_torch.models.synthetic import synthetic_problem, synthetic_world

    t_start = time.perf_counter()
    smi = smi_line()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    start_profile_build()
    kbuild.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built and loaded in {build_s:.1f} s (nvcc {kbuild.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    report: dict = dict(card=smi, build_s=build_s, build_log=kbuild.BUILD_INFO.get("log", ""))
    phase_s: dict = {}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    report["fair_shares"] = check_fair_shares(dev)
    report["fair_shares_adversarial"] = fair_shares_adversarial(dev)
    check_compact(dev)
    report["compact_adversarial"] = compact_adversarial(dev)
    pools_small = check_pool_kernels(dev)
    mark("small pool kernels")
    loop_small = check_loop_kernels(dev)
    mark("small loop kernels")
    mesh_small = check_mesh_kernels(dev)
    mark("small mesh kernels")
    sp, meta = synthetic_problem(**KB_SYNTH)
    report["round_synthetic"] = check_round("synthetic_problem", sp, meta, dev)
    mp, mctx = world_problem(KB_MARKET)
    report["round_market"] = check_round("market world", mp, round_meta(mctx), dev)
    # the eviction world's round was held against the plain version by
    # check_k11_kernels (the same world, the same statics)
    report["round_evict"] = loop_small["eviction world"]
    if report["round_evict"]["evicted"] == 0:
        raise AssertionError("the eviction world evicted nothing")
    from armada_tpu_torch.models.problem import build_problem
    from armada_tpu_torch.models.synthetic import variety_world

    for market in (False, True):
        config, kw = variety_world(7, **VARIETY, market=market)
        vp, vctx = build_problem(config, **kw)
        name = "variety market world" if market else "variety world"
        report[name] = check_round(name, vp, round_meta(vctx), dev)

    # the market cycle's small worlds, each on the card and with device="cpu"
    market_small_report = market_small(dev)
    mark("market small worlds")

    # the incremental path on a small world first: every check, in seconds
    from armada_tpu_torch.models import run_scheduling_round

    small = synthetic_world(**SMALL_WORLD)
    sc, sn, sq, ss, sr, _ = small
    small_out = run_scheduling_round(sc, pool="default", nodes=sn, queues=sq, queued_jobs=ss,
                                     running=sr, device=dev)
    report["incremental_small"] = incremental_path(dev, dict(world=small), small_out)
    mark("small rounds and incremental")

    t0 = time.perf_counter()
    world = dict(world=synthetic_world(**MAIN_WORLD))
    world["seconds"] = time.perf_counter() - t0
    log(f"main path: world built in {world['seconds']:.1f} s")
    mp_report = main_path(dev, world)
    main_outcome = mp_report.pop("outcome")
    main_state = mp_report.pop("state")
    report.update(mp_report)
    mark("main path")
    loop = loop_shapes_path(dev, main_state)
    report["loop_shapes"] = dict(small=loop_small, **loop["report"])
    mark("loop-shapes path")
    report["cluster"] = cluster_path(dev, main_state)
    mark("cluster path (S = 1 against the owner's S, step profiles)")
    mesh_m = mesh_main(dev, main_state, mp_report["stages"]["plain_round_ms"])
    mark("mesh path, main world")
    del main_state
    inc = incremental_path(dev, world, main_outcome)
    report["incremental"] = inc
    mark("incremental path")
    mesh_cyc = mesh_cycle_path(dev, world)
    report["mesh"] = dict(small=mesh_small, main=mesh_m, cycle=mesh_cyc)
    mark("mesh path, steady cycle")
    pools = pools_path(dev, world, pools_small)
    report["pools"] = pools
    mark("pools path")
    del world
    report["market"] = market = market_path(dev, market_small_report)
    mark("market path")
    report["simulator"] = simulator_path(dev)
    mark("simulator path")
    report["phase_s"] = phase_s
    report["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: {report['total_s']:.1f} s in all, the kernels' build included")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    rows = (mp_report["rows"] + loop["rows"] + inc["rows"] + pools["rows"]
            + mesh_rows(mesh_m, mesh_cyc))
    for row in rows:
        # the market path's launches beside each row's own path's
        if row["name"] in ("round", "compact", "fair_shares", "slab", "verify", "explain"):
            row["market_launches"] = market["launches"][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(split_main() if sys.argv[1:] == ["--split"] else main())
